"""Serving-index CLI (counterpart of ``dirjax/cli/index.py``): build, grow,
prune and query a dense :class:`~dirjax_torch.serving.RetrievalIndex` from
``.npy`` descriptor files. Flags, index files and the query JSON are
dirjax's, so the two CLIs interoperate:

    python -m dirjax_torch.index build --descs feats.dbdescs.npy \\
        --keys db.txt --int8 --out index.npz --gpu 0
    python -m dirjax_torch.index query --index index.npz \\
        --descs feats.qdescs.npy -k 10 --aqe 10 3 --out-json hits.json --gpu 0

``--gpu -1`` runs on the CPU. The binary, PQ and IVF kinds and ``tune`` are
not ported yet and exit with a message naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json

_NOT_PORTED = {"--binary": "M9", "--pq": "M10", "--ivf": "M11", "tune": "M11"}


def _not_ported(what: str):
    raise SystemExit(f"{what} is not ported to dirjax_torch yet (ROADMAP "
                     f"{_NOT_PORTED[what]}); use python -m dirjax.index")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Build / query a dirjax_torch serving index")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--gpu", type=int, default=0, nargs="+",
                        help="CUDA device id; -1 selects the CPU")
    sub = parser.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", parents=[common],
                       help="build an index from descriptors")
    b.add_argument("--descs", required=True,
                   help="(N, D) .npy descriptor matrix (dbdescs)")
    b.add_argument("--keys", default="",
                   help="one key per line (e.g. the ImageList file); "
                        "omit for positional-index results")
    b.add_argument("--int8", action="store_true",
                   help="store the database int8-quantized (half the bytes "
                        "of bf16)")
    for flag in ("--binary", "--pq", "--ivf"):
        b.add_argument(flag, type=int, default=0,
                       help=f"not ported yet (ROADMAP {_NOT_PORTED[flag]})")
    b.add_argument("--out", required=True, help="output .npz index path")

    a = sub.add_parser("add", parents=[common],
                       help="append rows to an existing index")
    a.add_argument("--index", required=True, help=".npz from `build`")
    a.add_argument("--descs", required=True,
                   help="(N, D) .npy descriptor matrix to append")
    a.add_argument("--keys", default="",
                   help="one key per line for the new rows "
                        "(required for keyed indexes)")
    a.add_argument("--out", default="",
                   help="output path (default: rewrite --index in place)")

    r = sub.add_parser("remove", parents=[common],
                       help="delete rows from an index (tombstones; "
                            "--compact reclaims memory but renumbers)")
    r.add_argument("--index", required=True, help=".npz from `build`")
    r.add_argument("--keys", default="",
                   help="file with one key per line to remove (keyed indexes)")
    r.add_argument("--indices", type=int, nargs="*", default=None,
                   help="row indices to remove")
    r.add_argument("--compact", action="store_true",
                   help="physically drop tombstoned rows (renumbers result "
                        "indices; key lookups are unaffected)")
    r.add_argument("--out", default="",
                   help="output path (default: rewrite --index in place)")

    sub.add_parser("tune", help="not ported yet (ROADMAP M11)")

    q = sub.add_parser("query", parents=[common], help="query an index")
    q.add_argument("--index", required=True, help=".npz from `build`")
    q.add_argument("--descs", required=True,
                   help="(Nq, D) .npy query descriptors (qdescs)")
    q.add_argument("-k", "--topk", type=int, default=10)
    q.add_argument("--aqe", type=int, nargs=2, metavar=("K", "ALPHA"),
                   default=None, help="alpha-query-expansion before ranking")
    q.add_argument("--int8-queries", action="store_true",
                   help="int8-quantize queries too (int8 indexes only)")
    q.add_argument("--out-json", default="",
                   help="write results as JSON (default: print)")
    return parser


def _read_keys(path: str, n: int):
    if not path:
        return None
    with open(path) as f:
        keys = [ln.split()[0] for ln in f if ln.strip()]
    if len(keys) != n:
        raise SystemExit(f"{len(keys)} keys != {n} descriptors")
    return keys


def main(argv=None):
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd == "tune":
        _not_ported("tune")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    from .common import setup_device

    device = setup_device(args.gpu)

    import numpy as np
    import torch

    from ..serving import RetrievalIndex

    if args.cmd == "build":
        for flag in ("--binary", "--pq", "--ivf"):
            if getattr(args, flag[2:]):
                _not_ported(flag)
        descs = np.load(args.descs)
        keys = _read_keys(args.keys, len(descs))
        index = RetrievalIndex(descs, keys=keys, device=device,
                               dtype=torch.int8 if args.int8 else torch.bfloat16)
        index.save(args.out)
        kind = "int8" if args.int8 else "bf16"
        print(f"built index: {index.n} x {index.dim} "
              f"({kind}{', keyed' if keys else ''}) -> {args.out}")
        return index

    index = RetrievalIndex.load(args.index, device=device)
    if args.cmd == "add":
        descs = np.load(args.descs)
        index.add(descs, keys=_read_keys(args.keys, len(descs)))
        out = args.out or args.index
        index.save(out)
        print(f"added {len(descs)} rows -> {index.n} x {index.dim} -> {out}")
        return index

    if args.cmd == "remove":
        if args.keys and args.indices is not None:
            raise SystemExit("remove: pass --keys OR --indices, not both")
        if args.keys:
            with open(args.keys) as f:
                n_rm = index.remove(keys=[ln.split()[0] for ln in f if ln.strip()])
        elif args.indices is not None:
            n_rm = index.remove(indices=args.indices)
        else:
            raise SystemExit("remove: pass --keys or --indices")
        msg = f"removed {n_rm} rows ({index.n_removed} tombstoned"
        if args.compact:
            index.compact()
            msg = f"removed {n_rm} rows (compacted to {index.n}"
        out = args.out or args.index
        index.save(out)
        print(msg + f") -> {out}")
        return index

    q = np.load(args.descs)
    aqe = ({"k": args.aqe[0], "alpha": float(args.aqe[1])}
           if args.aqe else None)
    vals, idxs = index.search(q, k=args.topk, aqe=aqe,
                              int8_queries=args.int8_queries)
    out = {"scores": vals.tolist(), "indices": idxs.tolist()}
    if index.keys is not None:
        out["keys"] = index.lookup(idxs)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f)
        print(f"wrote {len(q)} query results to {args.out_json}")
    else:
        for qi in range(len(q)):
            hits = out["keys"][qi] if "keys" in out else out["indices"][qi]
            print(f"query {qi}: {hits[:args.topk]}")
    return out


if __name__ == "__main__":
    main()
