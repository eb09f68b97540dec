"""How fast the host ran one thread of Python just before and just after a
window, and how many threads the process had: one line for the log, so runs
that read far apart can be told apart by the host's speed. The card's
machine reads 0 for the host's CPU times and context switches
(``/proc/stat``, ``getrusage``), so the probe times a fixed piece of work
itself."""

from __future__ import annotations

import threading
import time

PROBE_LOOPS = 1_000_000


def probe() -> float:
    """Milliseconds for a fixed loop of interpreted integer work."""
    t0 = time.perf_counter()
    x = 0
    for i in range(PROBE_LOOPS):
        x = (x + i * i) & 0xFFFF
    return (time.perf_counter() - t0) * 1e3


def note(before_ms: float) -> str:
    """The line for a window that ``before_ms`` was read just ahead of."""
    return (f"host: probe ms before the window {before_ms!r}, after {probe()!r} "
            f"({PROBE_LOOPS} loops, one thread); {threading.active_count()} Python threads")
