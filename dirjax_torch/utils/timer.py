"""Minimal tic/toc wall-clock timers (the port's copy of
``dirjax/utils/timer.py``, which it mirrors; reference
``utils/convenient.py:139-156``) plus a context-manager flavor that waits
for the card's queued work before reading the clock."""

from __future__ import annotations

import time
from contextlib import contextmanager

_TIMERS: dict = {}


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
