"""One-command mAP-oracle validation (the port's copy of the repository's
``validate_oracle.py``, which it mirrors; run the moment data + checkpoints
land).

The reference's de-facto integration test is the exact stdout of one command
(reference README.md:110-117):

    python -m dirtorch.test_dir --dataset RParis6K \
        --checkpoint Resnet101-AP-GeM.pt --whiten Landmarks_clean \
        --whitenp 0.25 --gpu 0
    >> mAP-easy = 0.907568, mAP-medium = 0.803098, mAP-hard = 0.608556

This module runs the dirjax_torch equivalent of that command, on the card
unless ``--gpu -1``, and diffs the three
numbers against the oracle (±0.002 by default). It is environment-gated —
it needs $DB_ROOT pointing at the RParis6K images/ground-truth and the
released Resnet101-AP-GeM.pt checkpoint — and says exactly what's missing
when it can't run.

Usage:
    python -m dirjax_torch.validate_oracle --checkpoint /path/to/Resnet101-AP-GeM.pt
    python -m dirjax_torch.validate_oracle     # looks in $DIR_ROOT, $PWD
"""

from __future__ import annotations

import argparse
import os
import sys

ORACLE = {"mAP-easy": 0.907568, "mAP-medium": 0.803098, "mAP-hard": 0.608556}
CKPT_NAME = "Resnet101-AP-GeM.pt"


def find_checkpoint(explicit: str) -> str | None:
    if explicit:
        return explicit if os.path.isfile(explicit) else None
    for root in filter(None, [os.environ.get("DIR_ROOT"), os.getcwd(),
                              os.path.join(os.getcwd(), "checkpoints")]):
        cand = os.path.join(root, CKPT_NAME)
        if os.path.isfile(cand):
            return cand
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", default="",
                    help=f"path to {CKPT_NAME} (default: $DIR_ROOT, $PWD)")
    ap.add_argument("--dataset", default="RParis6K")
    ap.add_argument("--tol", type=float, default=0.002)
    ap.add_argument("--gpu", type=int, default=0, help="-1 forces CPU")
    args = ap.parse_args(argv)

    missing = []
    db_root = os.environ.get("DB_ROOT")
    if not db_root:
        missing.append("$DB_ROOT is unset (must point at the benchmark "
                       "datasets directory containing paris6k/)")
    elif not os.path.isdir(db_root):
        missing.append(f"$DB_ROOT={db_root!r} is not a directory")

    ckpt = find_checkpoint(args.checkpoint)
    if ckpt is None:
        missing.append(f"checkpoint {CKPT_NAME} not found (pass --checkpoint "
                       "or set $DIR_ROOT)")
    if missing:
        print("CANNOT RUN — environment not staged:")
        for m in missing:
            print("  -", m)
        return 2

    from .cli.test_dir import main as test_dir_main

    res = test_dir_main([
        "--dataset", args.dataset, "--checkpoint", ckpt,
        "--whiten", "Landmarks_clean", "--whitenp", "0.25",
        "--gpu", str(args.gpu),
    ])

    ok = True
    for key, want in ORACLE.items():
        got = res.get(key)
        if got is None:
            print(f"FAIL {key}: missing from results {sorted(res)}")
            ok = False
            continue
        delta = abs(float(got) - want)
        status = "PASS" if delta <= args.tol else "FAIL"
        ok &= status == "PASS"
        print(f"{status} {key}: got {got:.6f}, oracle {want:.6f} "
              f"(|delta| = {delta:.6f}, tol {args.tol})")
    print("ORACLE", "REPRODUCED" if ok else "NOT REPRODUCED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
