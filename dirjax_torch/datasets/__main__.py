"""Dataset inspection CLI (the port's copy of ``dirjax/datasets/__main__.py``,
which it mirrors; working replacement for the reference's broken
``python -m dirtorch.datasets`` viewer, datasets/__main__.py): prints the
dataset summary and, for query datasets, a per-query ground-truth digest.
"""

import sys

from . import create

if __name__ == "__main__":
    if len(sys.argv) < 2:
        print("usage: python -m dirjax_torch.datasets \"<dataset spec>\" [query_idx]")
        sys.exit(1)
    db = create(sys.argv[1])
    print(db)
    try:
        qdb = db.get_query_db()
    except NotImplementedError:
        qdb = None
    if qdb is not None and len(sys.argv) > 2:
        q = int(sys.argv[2])
        print(f"\nQuery {q}: {qdb.get_key(q)}")
        if hasattr(db, "get_query_roi"):
            print("  roi:", db.get_query_roi(q))
        def show(mode, gt):
            print(f"  [{mode}] positives: {(gt == 1).sum()}  "
                  f"junk: {(gt == 0).sum()}  negatives: {(gt == -1).sum()}")

        try:
            if hasattr(db, "relevants"):
                # Oxford-style GT: Revisited flavor has no 'classic' mode
                modes = ("easy", "medium", "hard") if db.relevants is None \
                    else ("classic",)
                for mode in modes:
                    show(mode, db.get_query_groundtruth(q, "AP", mode))
            else:
                show("label", db.get_query_groundtruth(q))
        except Exception as e:
            print("  no AP ground truth:", e)
