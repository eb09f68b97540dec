"""The program's own spans (``dirjax_torch.utils.timer``), read by the
per-layer metrics of the host path.

The program records a span only while a ``torch.profiler`` session runs or
after ``timer.enable()``; the traced slice (``harness/trace.py``) is such a
session, so the spans of a ``--trace 1`` run are the slice's. They are on
``time.perf_counter``, the clock of the slice's ``host_start`` and
``host_stop``. Each reading returns None where there is no trace, no span of
the name began in the slice, the program's ring of that name dropped spans,
or the program records no spans at all.
"""

from __future__ import annotations

from typing import List, Optional


def in_slice(r, name: str) -> Optional[List[tuple]]:
    """The program's spans ``name`` (id, parent, start, end, n) that began in
    ``[host_start, host_stop)`` of the reading's traced slice."""
    if r.trace is None:
        return None
    from dirjax_torch.utils import timer

    spans, dropped = getattr(timer, "spans", None), getattr(timer, "dropped", None)
    if spans is None or dropped is None or dropped(name) > 0:
        return None
    lo, hi = r.trace.host_start, r.trace.host_stop
    got = [s for s in spans(name) if lo <= s[2] < hi]
    return got or None


def mean_s(r, name: str) -> Optional[float]:
    """Mean length in seconds of the spans ``name`` of the slice."""
    got = in_slice(r, name)
    return None if got is None else sum(s[3] - s[2] for s in got) / len(got)


def mean_ms(r, name: str) -> Optional[float]:
    s = mean_s(r, name)
    return None if s is None else s * 1e3


def mean_us(r, name: str) -> Optional[float]:
    s = mean_s(r, name)
    return None if s is None else s * 1e6


def front_us(r) -> Optional[float]:
    """A request's host time in the server's front: the mean ``server.parse``
    (the frame's read after its length, the decode, the submit) plus the
    mean ``server.reply`` (the keys, the bytes, the send)."""
    parse, reply = mean_us(r, "server.parse"), mean_us(r, "server.reply")
    return None if parse is None or reply is None else parse + reply
