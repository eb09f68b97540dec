"""Run one cell of BENCHMARK.json once, on the machine it is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs drawn from the seed on the card, the program
built and warmed up on this cell's shapes) is timed as ``setup_s``; then the
window runs for ``--seconds``; then what the window produced is compared
with the plain reference. ``--trace 1`` profiles a steady slice of the
window and reports the per-layer metrics instead of the end-to-end ones.
The last line of standard output is the result; the numbers compared and
their limits end standard error. Without a CUDA card (or with fewer cards
than the cell asks for) it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import runner, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    ctx = runner.Ctx(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    result = runner.run_cell(ctx, T_START)
    banned = runner.banned_modules()
    if banned:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {banned}",
              file=sys.stderr)
        return 3
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
