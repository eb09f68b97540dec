"""A steady slice of the window under ``torch.profiler``, reduced to what the
per-layer metrics read: device intervals, their busy union, kernels by name,
and the idle gaps named by what the host was doing.

Only the device is traced (CUDA activity, no CPU ops), so the host runs
nearly as it does untraced. The host's side comes from the benchmark's own
spans around its calls into the program (``time.perf_counter``); one marker
kernel launched right after a synchronise at the slice's start ties that
clock to the trace's. The trace is written to ``TMPDIR``, read back and
deleted; a slice of a few seconds stays well under a GiB.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "spin_kernel"          # torch.cuda._sleep's kernel: the clock anchor
ANCHOR_CYCLES = 1000
TOP = 10

HostSpan = Tuple[float, float, str]   # start, end (perf_counter s), what the host did


@dataclass
class DeviceEvent:
    name: str
    cat: str
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclass
class Trace:
    """A traced slice: its length, device events clipped to it, their busy
    union, its ends on the host's clock (``time.perf_counter``), and its idle
    gaps summed by what the host was doing."""

    window_s: float
    busy_s: float
    events: List[DeviceEvent]
    host_start: float
    host_stop: float
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernels(self, pattern: str) -> List[DeviceEvent]:
        """Kernels whose name matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        return [e for e in self.events if e.cat == "kernel" and rx.search(e.name)]

    def seconds(self, events) -> float:
        return sum(e.dur_us for e in events) / 1e6

    def memcpys(self, kind: str) -> List[DeviceEvent]:
        """Copies of ``kind`` ("HtoD", "DtoH", "DtoD")."""
        return [e for e in self.events if e.cat == "gpu_memcpy" and kind in e.name]

    def device_ops(self) -> List[Tuple[str, float]]:
        """The device operations that took most time, in seconds."""
        total: Dict[str, float] = defaultdict(float)
        for e in self.events:
            total[short_name(e.name)] += e.dur_us / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])[:TOP]


def short_name(name: str) -> str:
    """A kernel's name without its template and call arguments."""
    name = re.sub(r"^void ", "", name)
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut].strip()[:120]


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    return busy


def idle_gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The gaps in [lo, hi] that no interval covers."""
    gaps, reach = [], lo
    for a, b in sorted(intervals):
        if a > reach:
            gaps.append((reach, min(a, hi)))
        reach = max(reach, b)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


def host_activity(host: Sequence[HostSpan], at: float, outside: str) -> str:
    """The innermost host span running at ``at``; ``outside`` if none."""
    best: Optional[Tuple[float, str]] = None
    for a, b, name in host:
        if a <= at <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else outside


def reduce_trace(events: list, host_start: float, host_stop: float,
                 host: Sequence[HostSpan] = (), outside: str = "outside the spans") -> Trace:
    """A chrome trace's device events reduced to the slice: from the anchor
    kernel's start, as long as the host's ``host_start``..``host_stop``.
    Without an anchor the slice is the events' extent, and the host clock is
    taken to start with it."""
    anchors = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
               and ANCHOR in e.get("name", "")]
    if anchors:
        lo = min(e["ts"] for e in anchors)
        hi = lo + (host_stop - host_start) * 1e6
    else:
        stamps = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        lo, hi = min(a for a, _ in stamps), max(b for _, b in stamps)
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS or ANCHOR in e["name"]:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi)
        if b > a:
            dev.append(DeviceEvent(e["name"], e["cat"], a, b - a))
    spans = [(e.start_us, e.end_us) for e in dev]
    on_trace = [((a - host_start) * 1e6 + lo, (b - host_start) * 1e6 + lo, name)
                for a, b, name in host]
    named: Dict[str, float] = defaultdict(float)
    for a, b in idle_gaps(spans, lo, hi):
        named[host_activity(on_trace, (a + b) / 2, outside)] += (b - a) / 1e6
    gaps = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(window_s=(hi - lo) / 1e6, busy_s=busy_union(spans) / 1e6, events=dev,
                 host_start=host_start, host_stop=host_stop, idle_gaps=gaps)


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def warm_profiler() -> None:
    """Start and stop the profiler once: its first start initialises CUPTI,
    which takes seconds and would otherwise stall the window."""
    import torch

    with _profiler():
        torch.cuda._sleep(ANCHOR_CYCLES)
        torch.cuda.synchronize()


class Slice:
    """Profiles for ``length`` seconds from the first ``tick`` at or after
    ``start`` (``time.perf_counter``). ``tick`` is called from the thread
    that drives the window; it starts and stops the profiler when due.
    Disabled, it does nothing."""

    def __init__(self, enabled: bool, start: float, length: float):
        self.enabled, self.start_at, self.length = enabled, start, length
        self.stop_at = start + length
        self._prof = None
        self.host_start = self.host_stop = None
        self.trace: Optional[Trace] = None

    def tick(self, now: Optional[float] = None) -> None:
        """Start or stop the profiler when due."""
        if not self.enabled or self.host_stop is not None:
            return
        now = time.perf_counter() if now is None else now
        if self._prof is None and now >= self.start_at:
            self._begin()
        elif self._prof is not None and now >= self.stop_at:
            self._stop()

    def _begin(self) -> None:
        import torch

        self._prof = _profiler()
        self._prof.start()
        torch.cuda.synchronize()
        self.host_start = time.perf_counter()
        torch.cuda._sleep(ANCHOR_CYCLES)
        self.stop_at = self.host_start + self.length

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.host_stop = time.perf_counter()
        self._prof.stop()

    def end(self, host: Sequence[HostSpan] = (), outside: str = "outside the spans") -> None:
        """Stop the profiler if it still runs, and reduce its trace, naming
        idle gaps by the host spans ``host`` (``outside`` between them)."""
        if self._prof is None:
            return
        if self.host_stop is None:
            self._stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.trace = reduce_trace(events, self.host_start, self.host_stop, host, outside)
