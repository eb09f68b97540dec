"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

A generator (``benchmark/generators/<kind>.py``) provides ``setup(ctx)``,
``window(ctx, state)`` and ``check(ctx, state, window)``; this module times
set-up, reads the device's memory peak once the window has closed, has the
generator free the program and compare with the reference, reads the per-layer
metrics with their readers, and prints. Everything a run prints about
correctness ends standard error, and the result is the last line of
standard output.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import hostload, spec, trace

# top-level module names that may not be loaded in the process that prints
# the result: the JAX package and JAX itself
BANNED = ("jax", "jaxlib", "flax", "dirjax")


@dataclass
class Ctx:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    # (kind, program object, extras) -> the object the window drives; the
    # control and the planted faults of the tests put theirs in here
    program_hook: Optional[Callable] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def hook(self, kind: str, program, **extras):
        return program if self.program_hook is None else self.program_hook(kind, program, extras)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit    # False for NaN


@dataclass
class Window:
    """What the measured window gave: end-to-end values by metric name, the
    requests or images attempted and failed, the traced slice and the
    benchmark's own spans for the per-layer readers, lines for the log, and
    a reason the window itself is unsound (a generator behind its schedule)."""

    values: Dict[str, float]
    attempted: int
    failed: int
    trace: object = None
    spans: Dict[str, list] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    unsound: str = ""


@dataclass
class Reading:
    """What a per-layer metric reader sees."""

    cell: spec.Cell
    trace: object
    spans: Dict[str, list]

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def spans_outside_slice(self, name: str) -> list:
        """The spans ``name`` of the window that began outside the traced
        slice, where the profiler's own cost does not slow the host."""
        if self.trace is None:
            return list(self.spans.get(name, []))
        lo, hi = self.trace.host_start, self.trace.host_stop
        return [s for s in self.spans.get(name, []) if not lo <= s[0] < hi]

    def spans_in_slice(self, name: str) -> list:
        """The spans ``name`` (tuples whose first two fields are start and
        end, ``time.perf_counter``) that began inside the traced slice."""
        if self.trace is None:
            return []
        lo, hi = self.trace.host_start, self.trace.host_stop
        return [s for s in self.spans.get(name, []) if lo <= s[0] < hi]


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one of BANNED, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def device_info(device: str, peak_bytes: int) -> dict:
    import torch

    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}


def run_cell(ctx: Ctx, t_start: float) -> dict:
    """Run the cell once; returns the result object (not printed)."""
    import torch

    gen = spec.generator(ctx.cell)
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = gen.setup(ctx)
    traced = ctx.trace or any(m["source"] == "device_trace" for m in ctx.cell.end_to_end)
    if traced and ctx.device == "cuda":
        trace.warm_profiler()
    setup_s = time.perf_counter() - t_start
    host_ms = hostload.probe()
    win = gen.window(ctx, state)
    win.notes.append(hostload.note(host_ms))
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    checks = gen.check(ctx, state, win)
    for line in win.notes:
        print(line, file=sys.stderr)
    correct = (not win.unsound and win.failed == 0 and bool(checks)
               and all(c.ok for c in checks))
    metrics: Dict[str, dict] = {}
    if win.unsound:
        pass   # a window that did not run as the mix says reports nothing
    elif ctx.trace:
        reading = Reading(ctx.cell, win.trace, win.spans)
        for m in ctx.cell.per_layer:
            value = spec.metric_reader(ctx.cell.root, m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(win.values, setup_s=setup_s)
        for m in ctx.cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(win.attempted), "failed": int(win.failed),
              "metrics": metrics, "device": device_info(ctx.device, peak)}
    if ctx.trace and win.trace is not None:
        t = win.trace
        print(f"trace: slice {t.window_s!r} s (host {t.host_stop - t.host_start!r} s), "
              f"device busy {t.busy_s!r} s, {len(t.events)} device events", file=sys.stderr)
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": [[n, s] for n, s in t.device_ops()],
                               "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
    if win.unsound:
        print(f"unsound window: {win.unsound}", file=sys.stderr)
    result["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit} for c in checks}
    return result


def _number(x: float):
    """``x``, or its name where JSON has no number for it (nan, inf)."""
    return x if x == x and abs(x) != float("inf") else str(x)


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
