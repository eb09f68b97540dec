"""Top-k search of a descriptor index through the program's index server.

Set-up draws the configuration's database from the seed on the card
(``harness/rows.py``), builds the program's ``RetrievalIndex`` in the
configuration's dtype from it, wraps the index in a proxy that times and
counts each ``search`` the batcher dispatches, and starts the program's
``IndexServer`` on it in this process (the configuration's batcher
settings), listening on loopback TCP at a port the kernel picks, and warms
every query count the mix can make. The load generator's child processes
(``harness/loadgen.py``) start first, so their imports overlap all that;
then they connect through the program's ``Client`` and warm their
connections.

The window is the mix's open loop (Poisson arrivals at a fixed rate; the
95th percentile of every request's latency from its scheduled send time to
its reply) or closed loop (connections each keeping requests in flight; the
query rows answered within the window over its length). The check compares
a sample of the answers, drawn from the seed, with an exact fp32 top-k over
the same rows made again from the seed.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from harness import loadgen, rows, trace
from harness.runner import Check, Window
from reference import topk as ref_topk

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
# what the host was doing during an idle gap of the device
IN_SEARCH = "in RetrievalIndex.search (a dispatch's host path)"
OUTSIDE_SEARCH = "outside any search (server front, batcher, replies)"


class TimedIndex:
    """The index as the batcher sees it: each ``search`` timed with its
    result on the host (span "search": start, end, query rows)."""

    def __init__(self, inner):
        self.inner = inner
        self.spans: List[tuple] = []
        self.dim = inner.dim
        self.dtype = getattr(inner, "dtype", None)   # read by upload_bf16's warning

    def search(self, queries, k: int = 10, **opts):
        t0 = time.perf_counter()
        out = self.inner.search(queries, k=k, **opts)
        self.spans.append((t0, time.perf_counter(), len(queries)))
        return out

    def lookup(self, idxs):
        return self.inner.lookup(idxs)


@dataclass
class State:
    rows: rows.IndexRows
    index: object
    server: object
    thread: threading.Thread
    load: loadgen.Load
    outcomes: list = None


def _plans(ctx, address: str) -> List[loadgen.Plan]:
    mix = ctx.mix
    n = int(mix["processes"])
    common = dict(address=address, seed=ctx.seed, loop=mix["loop"], seconds=ctx.seconds,
                  k=int(mix["k"]), rows_per_request=int(mix["rows_per_request"]),
                  warm_requests=int(mix["warm_requests"]))
    plans = []
    for c in range(n):
        sample = int(mix["sample_requests"]) // n + (c < int(mix["sample_requests"]) % n)
        conns = int(mix["connections"]) // n + (c < int(mix["connections"]) % n)
        if mix["loop"] == "open":
            plans.append(loadgen.Plan(child=c, rate_per_s=float(mix["rate_per_s"]) / n,
                                      connections=conns, sample=sample, **common))
        else:
            plans.append(loadgen.Plan(child=c, connections=conns,
                                      in_flight=int(mix["in_flight"]), sample=sample, **common))
    return plans


def setup(ctx) -> State:
    from dirjax_torch.serving import RetrievalIndex
    from dirjax_torch.server import IndexServer

    cfg, mix = ctx.config, ctx.mix
    n = int(mix["processes"])
    load = loadgen.Load(n)
    db = rows.IndexRows(cfg["index"], ctx.seed, ctx.device)
    full = db.all()
    pool = rows.queries(full, int(mix["query_pool"]), float(mix["perturbed_share"]),
                        float(mix["perturb_sigma"]), ctx.seed)
    program = RetrievalIndex(full, dtype=DTYPES[cfg["index"]["dtype"]], device=ctx.device)
    del full
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    index = ctx.hook("index", program, rows=db, config=cfg)
    srv = cfg["server"]
    timed = TimedIndex(index)
    # warm every query count the batcher can dispatch for this mix
    per = int(mix["rows_per_request"])
    rng = np.random.default_rng(0)
    for nq in range(per, int(srv["max_batch"]) + 1, per):
        index.search(rng.standard_normal((nq, db.dim)).astype(np.float32), k=int(mix["k"]))
    server = IndexServer(timed, "127.0.0.1:0", max_batch=int(srv["max_batch"]),
                         max_wait_ms=float(srv["max_wait_ms"]), pipeline=int(srv["pipeline"]),
                         upload_bf16=bool(srv["upload_bf16"]))
    thread = threading.Thread(target=server.serve_forever, name="bench-server", daemon=True)
    thread.start()
    load.give(_plans(ctx, server.address), [pool[c::n] for c in range(n)])
    load.wait_ready()
    timed.spans.clear()
    return State(rows=db, index=timed, server=server, thread=thread, load=load)


def window(ctx, st: State) -> Window:
    mix = ctx.mix
    t0 = time.perf_counter() + 0.2
    st.load.start(t0)
    end = t0 + ctx.seconds
    tracer = trace.Slice(ctx.trace, *_slice_times(t0, ctx.seconds, mix))
    if ctx.trace:
        time.sleep(max(0.0, tracer.start_at - time.perf_counter()))
        tracer.tick()
        time.sleep(max(0.0, tracer.stop_at - time.perf_counter()))
        tracer.tick()
    outs = st.load.results(timeout=ctx.seconds + loadgen.DRAIN_S + 120)
    tracer.end([(a, b, IN_SEARCH) for a, b, _ in st.index.spans], OUTSIDE_SEARCH)
    st.outcomes = outs
    sched = np.concatenate([o.scheduled for o in outs])
    done = np.concatenate([o.done for o in outs])
    nrows = np.concatenate([o.rows for o in outs]).astype(np.int64)
    sent, failed = sum(o.sent for o in outs), sum(o.failed for o in outs)
    notes = [f"search: {sent} requests sent, {failed} failed, {int(np.isnan(done).sum())} "
             f"without a reply, {int(nrows.sum())} query rows"]
    for o in outs:
        notes += [f"search: error {e}" for e in o.errors[:5]]
    values, unsound = {}, ""
    lat = (done - sched) * 1e3
    answered = ~np.isnan(done)
    if mix["loop"] == "open":
        late = np.concatenate([o.late for o in outs]) * 1e3
        p99_late, max_late = float(np.percentile(late, 99)), float(late.max())
        notes.append(f"search: generator lateness ms p50 {float(np.median(late))!r} "
                     f"p99 {p99_late!r} max {max_late!r} (limit p99 "
                     f"{mix['late_p99_limit_ms']})")
        if p99_late > float(mix["late_p99_limit_ms"]):
            unsound = f"the generator fell behind its schedule (p99 {p99_late:.3f} ms late)"
        full = np.where(answered, lat, np.inf)
        values["search_p95_ms"] = float(np.percentile(full, 95))
        from_send = np.where(answered, lat - late, np.inf)
        first = sched < t0 + ctx.seconds / 2   # a growing backlog shows as a later half slower
        notes.append(f"search: latency ms p50 {float(np.percentile(full, 50))!r} "
                     f"p95 {values['search_p95_ms']!r} p99 {float(np.percentile(full, 99))!r}; "
                     f"from the actual send p50 {float(np.percentile(from_send, 50))!r} "
                     f"p95 {float(np.percentile(from_send, 95))!r} "
                     f"over {len(full)} requests at {mix['rate_per_s']} /s; p50 of the "
                     f"first half {float(np.percentile(full[first], 50))!r}, of the second "
                     f"{float(np.percentile(full[~first], 50))!r}; answered within the "
                     f"window {int((done <= end).sum()) / ctx.seconds!r} /s")
    else:
        in_window = answered & (done <= end)
        values["search_qps"] = float(nrows[in_window].sum()) / ctx.seconds
        edges = np.linspace(t0, end, 5)
        per = [float(nrows[answered & (done > a) & (done <= b)].sum()) / (b - a)
               for a, b in zip(edges[:-1], edges[1:])]
        notes.append(f"search: query rows/s by quarter of the window {[round(x) for x in per]}")
        notes.append(f"search: {int(in_window.sum())} requests answered in the window, "
                     f"latency ms p50 {float(np.nanpercentile(lat, 50))!r} "
                     f"p95 {float(np.nanpercentile(lat, 95))!r}")
    _stop_server(st)
    return Window(values=values, attempted=sent, failed=int((~answered).sum()),
                  trace=tracer.trace, spans={"search": list(st.index.spans)}, notes=notes,
                  unsound=unsound)


def _slice_times(t0: float, seconds: float, mix: dict):
    lo = t0 + float(mix["trace_from"]) * seconds
    return lo, min(float(mix["trace_seconds"]), 0.5 * seconds)


def _stop_server(st: State) -> None:
    from dirjax_torch.server import Client

    with Client(st.server.address) as c:
        c.shutdown_server()
    st.thread.join(timeout=30)


def check(ctx, st: State, win: Window) -> List[Check]:
    """The sampled answers against an exact fp32 top-k over the same rows:
    ``rank_gap``, the widest gap by which a returned row's exact score lies
    below the k-th best exact score of its query (2 for an id out of range or
    repeated); ``score_gap``, the widest gap between a returned score and the
    exact score of the row it names."""
    st.index = st.server = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    qs, vals, ids = [], [], []
    for o in st.outcomes:
        for q, v, i in zip(o.sample_queries, o.sample_vals, o.sample_ids):
            qs.append(q)
            vals.append(v)
            ids.append(i)
    if not qs:
        return [Check("rank_gap", float("nan"), _limit(ctx, "rank_gap"))]
    q = torch.from_numpy(np.concatenate(qs)).to(ctx.device)
    v = np.concatenate(vals).astype(np.float64)
    i = np.concatenate(ids).astype(np.int64)
    k = int(ctx.mix["k"])
    kth, exact = ref_topk.exact(st.rows.rows, st.rows.n, q, torch.from_numpy(i), k,
                                rows.BLOCK)
    kth, exact = kth.cpu().numpy().astype(np.float64), exact.cpu().numpy().astype(np.float64)
    bad = np.isnan(exact).any(axis=1) | (i.shape[1] != k) | np.array(
        [len(set(r)) != len(r) for r in i])
    gaps = np.where(bad, 2.0, np.maximum(0.0, kth - np.nan_to_num(exact, nan=-2.0).min(axis=1)))
    score = np.abs(np.nan_to_num(exact, nan=np.inf) - v).max(axis=1)
    print(f"search: {len(i)} sampled query rows, {int(bad.sum())} with ids out of range or "
          f"repeated; rank gap max {float(gaps.max())!r}, score gap max {float(score.max())!r}",
          file=sys.stderr)
    return [Check("rank_gap", float(gaps.max()), _limit(ctx, "rank_gap")),
            Check("score_gap", float(score.max()), _limit(ctx, "score_gap"))]


def _limit(ctx, name: str) -> float:
    return float(ctx.cell.limits.get(name, float("nan")))
