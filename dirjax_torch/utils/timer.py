"""Minimal tic/toc wall-clock timers (the port's copy of
``dirjax/utils/timer.py``, which it mirrors; reference
``utils/convenient.py:139-156``) plus a context-manager flavor that waits
for the card's queued work before reading the clock, and the program's
spans.

Spans name the host time of each layer of the program (the loader's
decode, the extractor's upload and forward launches, the conv wrapper, the
ViT's embedding and blocks, the batcher's queue wait, the index's launch
and pull, the server's front). A
span is the tuple ``(id, parent, start, end, n)``: ``start`` and ``end`` on
``time.perf_counter`` (seconds), ``n`` the work it carried (images, rows,
requests), ``parent`` the id of the :func:`span` open on the same thread
when it began, or 0.

They are recorded the way ``torch.profiler.record_function`` is: only while
a ``torch.profiler`` session runs, or after :func:`enable` (until
:func:`disable`). Otherwise a span site reads one flag and returns: no
clock read, no allocation, no lock. Each name keeps its newest
:data:`CAPACITY` spans; :func:`dropped` counts what it lost. Appends are
safe from any thread and take no lock until a ring is full.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from torch.autograd import profiler as _profiler

_TIMERS: dict = {}

#: spans kept per name; the older ones are dropped and counted
CAPACITY = 65536

Span = Tuple[int, int, float, float, int]   # id, parent, start, end, n

_enabled = False
_ids = itertools.count(1)
_local = threading.local()                  # .top: the id of the open span()
_rings: Dict[str, deque] = {}
_dropped: Dict[str, int] = {}
_trim_lock = threading.Lock()


def tic(name: str = "default") -> None:
    _TIMERS[name] = time.perf_counter()


def toc(name: str = "default") -> float:
    """Seconds elapsed since the matching :func:`tic`."""
    return time.perf_counter() - _TIMERS[name]


@contextmanager
def timed(label: str, results: dict | None = None, sync=None):
    """Context manager measuring wall-clock seconds.

    ``sync``: optional callable run before stopping the clock — pass
    ``sync=torch.cuda.synchronize`` so the card's queued work is included
    (PyTorch returns before the card finishes).
    """
    start = time.perf_counter()
    yield
    if sync is not None:
        sync()
    elapsed = time.perf_counter() - start
    if results is not None:
        results[label] = elapsed


# --- spans -----------------------------------------------------------------

def enable() -> None:
    """Record spans from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a ``torch.profiler`` session runs."""
    global _enabled
    _enabled = False


def recording() -> bool:
    """True after :func:`enable`, or while a ``torch.profiler`` session runs
    (its start sets ``torch.autograd.profiler._is_profiler_enabled``)."""
    return _enabled or _profiler._is_profiler_enabled


def _append(name: str, rec: Span) -> None:
    ring = _rings.get(name)
    if ring is None:
        ring = _rings.setdefault(name, deque())
    ring.append(rec)
    if len(ring) > CAPACITY:
        with _trim_lock:
            while len(ring) > CAPACITY:
                ring.popleft()
                _dropped[name] = _dropped.get(name, 0) + 1


def record(name: str, start: float, end: float, n: int = 1) -> None:
    """Record a span whose ends the caller took (``time.perf_counter``), with
    no parent. It records whether or not :func:`recording` holds: the
    caller asks first."""
    _append(name, (next(_ids), 0, start, end, n))


class _Open:
    """A recording :func:`span`: its thread's open span while it runs."""

    __slots__ = ("name", "n", "id", "parent", "start")

    def __init__(self, name: str, n: int):
        self.name, self.n = name, n

    def __enter__(self):
        self.id = next(_ids)
        self.parent = getattr(_local, "top", 0)
        _local.top = self.id
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _local.top = self.parent
        _append(self.name, (self.id, self.parent, self.start, end, self.n))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, n: int = 1):
    """``with span("extract.forward", len(images)): ...`` records the block's
    host time under ``name``; spans begun inside it, on its thread, name it
    as their parent."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, n)


def begin() -> Optional[tuple]:
    """The start of a span to :func:`end` later, perhaps on another thread,
    or None when not recording. Such a span is no thread's open span, so it
    is the parent of none."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return None
    return (next(_ids), getattr(_local, "top", 0), time.perf_counter())


def end(token: Optional[tuple], name: str, n: int = 1) -> None:
    """Record the span :func:`begin` gave ``token`` under ``name``; nothing
    when ``token`` is None."""
    if token is not None:
        _append(name, (token[0], token[1], token[2], time.perf_counter(), n))


def spans(name: str) -> List[Span]:
    """A snapshot of the spans kept under ``name``, oldest first."""
    ring = _rings.get(name)
    return list(ring)[-CAPACITY:] if ring is not None else []


def dropped(name: str) -> int:
    """Spans of ``name`` the ring let go since the last :func:`clear`."""
    return _dropped.get(name, 0)


def clear() -> None:
    """Empty every ring and the drop counts."""
    for ring in list(_rings.values()):
        ring.clear()
    _dropped.clear()
