"""Readings that set a cell's correctness limits, on the card, in one process:
the numbers the check compares for the program and for the control (the
reference one precision step below the configuration's, in the program's
place) over several seeds, at the cell's own size and load.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 5 \
        --sides program,control

Prints one JSON line a run: seed, side, the compared numbers, and whether the
run was correct under the cell's present limits. The benchmark's own runs
never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sides", default="program,control")
    args = ap.parse_args(argv)

    import torch

    from harness import controls, runner, spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for side in args.sides.split(","):
            hook = controls.control if side == "control" else None
            t0 = time.perf_counter()
            ctx = runner.Ctx(cell, seed, args.seconds, False, "cuda", program_hook=hook)
            res = runner.run_cell(ctx, t0)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "checks": res["checks"], "correct": res["correct"],
                              "attempted": res["attempted"], "failed": res["failed"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
