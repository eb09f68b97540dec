"""The search load generator: child processes, each with its own connections
to the server through the program's ``Client``.

Open loop: each child sends its share of a Poisson stream on a schedule
drawn from the seed, over its connections in turn, whatever the replies do,
and times each request from its scheduled send time to its reply; how late
each send left is recorded.
Closed loop: each connection keeps ``in_flight`` requests outstanding, and
sends the next as soon as one is answered. Every child keeps a sample of
its answers, drawn from the seed, for the check against the reference.
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np

# a sender thread waits on the replies' reader for at most this long, so a
# scheduled send is not held up by the interpreter lock's default 5 ms slice
SWITCH_INTERVAL_S = 1e-4
SPIN_S = 2e-4                   # time.sleep overshoots by up to ~0.1 ms
DRAIN_S = 60.0


@dataclass
class Plan:
    """One child's share of the load."""

    address: str
    child: int
    seed: int
    loop: str                   # "open" | "closed"
    seconds: float
    k: int
    rows_per_request: int
    rate_per_s: float = 0.0     # open loop: this child's rate
    connections: int = 1        # connections of this child (open loop: in turn)
    in_flight: int = 1          # closed loop: requests outstanding a connection
    sample: int = 0             # answers kept for the check
    warm_requests: int = 8


@dataclass
class Outcome:
    """What a child saw, in ``time.perf_counter`` seconds (one clock for
    every process of the machine)."""

    sent: int = 0
    failed: int = 0
    errors: List[str] = field(default_factory=list)
    scheduled: List[float] = field(default_factory=list)   # per request
    done: List[float] = field(default_factory=list)        # per request, nan if failed
    late: List[float] = field(default_factory=list)        # open loop: send - schedule
    rows: List[int] = field(default_factory=list)          # per request
    sample_queries: list = field(default_factory=list)
    sample_vals: list = field(default_factory=list)
    sample_ids: list = field(default_factory=list)


class _Reservoir:
    """A sample of fixed size over answers in the order they come, drawn
    from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen = size, 0
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.lock = threading.Lock()

    def offer(self, item) -> None:
        with self.lock:
            self.seen += 1
            if len(self.items) < self.size:
                self.items.append(item)
                return
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.items[j] = item


def _requests(pool: np.ndarray, rows: int):
    """The i-th request's query rows: consecutive pool rows, cycling."""
    def take(i: int) -> np.ndarray:
        start = (i * rows) % len(pool)
        return np.take(pool, range(start, start + rows), axis=0, mode="wrap")
    return take


def child_main(pipe) -> None:
    """Run one child: import the client while the server is set up, take the
    plan and the query rows, connect, warm up, report ready, wait for the
    start time, drive the load, drain, and send back an Outcome."""
    from dirjax_torch.server import Client

    plan, pool = pipe.recv()
    sys.setswitchinterval(SWITCH_INTERVAL_S)
    take = _requests(pool, plan.rows_per_request)
    clients = [Client(plan.address) for _ in range(max(1, plan.connections))]
    for c in clients:
        for i in range(plan.warm_requests):
            c.search(take(i), k=plan.k)
    pipe.send("ready")
    t0 = pipe.recv()
    out = Outcome()
    keep = _Reservoir(plan.sample, plan.seed * 7919 + plan.child)
    lock = threading.Lock()
    end = t0 + plan.seconds

    def record(slot: int, queries: np.ndarray, fut) -> None:
        now = time.perf_counter()
        try:
            vals, ids = fut.result()
        except Exception as exc:   # a reply that says the request failed
            with lock:
                out.failed += 1
                out.errors.append(repr(exc)[:200])
            return
        out.done[slot] = now
        if out.scheduled[slot] < end:
            keep.offer((queries, vals, ids))

    def new_slot(scheduled: float, rows: int) -> int:
        with lock:
            out.scheduled.append(scheduled)
            out.done.append(float("nan"))
            out.rows.append(rows)
            out.sent += 1
            return len(out.scheduled) - 1

    if plan.loop == "open":
        rng = np.random.default_rng([plan.seed, plan.child])
        t, i = t0, 0
        while True:
            t += rng.exponential(1.0 / plan.rate_per_s)
            if t >= end:
                break
            while True:   # sleep to within SPIN_S of the send, then yield until due
                wait = t - time.perf_counter()
                if wait <= 0:
                    break
                time.sleep(wait - SPIN_S if wait > SPIN_S else 0)
            q = take(i)
            slot = new_slot(t, len(q))
            out.late.append(time.perf_counter() - t)
            fut = clients[i % len(clients)].search_async(q, k=plan.k)
            fut.add_done_callback(lambda f, s=slot, q=q: record(s, q, f))
            i += 1
    else:
        counter = iter(range(1 << 62))
        counter_lock = threading.Lock()

        def connection(client) -> None:
            room = threading.Semaphore(plan.in_flight)
            while True:
                room.acquire()
                now = time.perf_counter()
                if now >= end:
                    return
                with counter_lock:
                    i = next(counter)
                q = take(i)
                slot = new_slot(now, len(q))
                fut = client.search_async(q, k=plan.k)
                fut.add_done_callback(
                    lambda f, s=slot, q=q: (record(s, q, f), room.release()))

        while time.perf_counter() < t0:
            time.sleep(1e-3)
        threads = [threading.Thread(target=connection, args=(c,)) for c in clients]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    deadline = time.perf_counter() + DRAIN_S
    while time.perf_counter() < deadline:
        with lock:
            pending = sum(1 for d in out.done if d != d) - out.failed
        if pending <= 0:
            break
        time.sleep(5e-3)
    for c in clients:
        c.close()
    for queries, vals, ids in keep.items:
        out.sample_queries.append(queries)
        out.sample_vals.append(vals)
        out.sample_ids.append(ids)
    pipe.send(out)
    pipe.close()


class Load:
    """Child processes driving one window of load at a server. They start
    at once, so their imports overlap the server's set-up; ``give`` hands
    them their plans and query rows once the server listens."""

    def __init__(self, children: int):
        ctx = mp.get_context("spawn")
        self.pipes, self.procs = [], []
        for _ in range(children):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=child_main, args=(child,), daemon=True)
            proc.start()
            child.close()
            self.pipes.append(parent)
            self.procs.append(proc)

    def give(self, plans: List[Plan], pools: List[np.ndarray]) -> None:
        for pipe, plan, pool in zip(self.pipes, plans, pools):
            pipe.send((plan, pool))

    def wait_ready(self, timeout: float = 300.0) -> None:
        for pipe, proc in zip(self.pipes, self.procs):
            if not pipe.poll(timeout):
                raise RuntimeError(f"load child {proc.pid} did not become ready")
            if pipe.recv() != "ready":
                raise RuntimeError("load child sent something other than ready")

    def start(self, t0: float) -> None:
        for pipe in self.pipes:
            pipe.send(t0)

    def results(self, timeout: float) -> List[Outcome]:
        outs = []
        for pipe, proc in zip(self.pipes, self.procs):
            if not pipe.poll(timeout):
                raise RuntimeError(f"load child {proc.pid} sent no outcome")
            outs.append(pipe.recv())
        self.join()
        return outs

    def join(self) -> None:
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
