"""Dynamic-batching serving front-end for dirjax indexes.

The port's own copy of ``dirjax/server.py``, which it mirrors: dirjax_torch
imports nothing of the JAX package, so it carries this jax-free host module
itself. The wire protocol is byte-identical, so a client of either package
talks to a server of either. Five differences: :meth:`Client.close` shuts its
socket down before closing it, ``upload_bf16`` makes each batch a CPU
``torch.bfloat16`` tensor (dirjax makes an ``ml_dtypes`` array, and the port
does not need that package), ``main`` lives in :mod:`dirjax_torch.serve`,
and the batcher keeps no latency window: the port's spans
(:mod:`dirjax_torch.utils.timer`) time each request's queue wait
(``batcher.wait``) and its whole stay in the server, from its frame's length
to its reply's send (``server.request``, with ``server.parse`` and
``server.reply`` inside), and :meth:`DynamicBatcher.warmup` searches at 1 and
``max_batch`` rows alone: the port's indexes pad to no ladder of query
counts.

The reference toolbox stops at offline evaluation
(``dirtorch/test_dir.py`` — one process, one score matrix);
production retrieval looks different: many concurrent clients each
holding one or a few queries, while each search reads the whole
database (IVF: its probed cells), a cost that a batch of queries
shares.

:class:`DynamicBatcher` closes that gap: concurrent ``search`` calls are
coalesced into one ``index.search`` call per *(k, options)* signature,
released either when ``max_batch`` query rows are pending or when the
oldest request has waited ``max_wait_ms`` — the classic
throughput/latency knob of a serving system. Client threads only
enqueue: one batcher thread forms the batches, and it or ``pipeline``
worker threads make every index call.

:class:`IndexServer` / :class:`Client` put a process boundary around the
batcher: a Unix-domain socket (or TCP — pass ``host:port``) with a
length-prefixed JSON+raw-float32 protocol (no HTTP stack, no pickle),
so extraction workers, RPC shims, or remote hosts can share one
resident index. ``python -m dirjax_torch.serve`` is the CLI entry point.

Works with every index family in :mod:`dirjax_torch.serving` (flat bf16/int8,
binary, PQ, IVF-PQ): options (``aqe``, ``nprobe``, ``int8_queries``,
``rerank_factor``, ...) pass through per request and batch only with
identical signatures.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .utils import timer

__all__ = ["DynamicBatcher", "IndexServer", "Client"]


def _parse_addr(addr: str):
    """``host:port`` -> ``(AF_INET, (host, port))``; anything else is a
    Unix-domain socket path. A bare ``:port`` listens on all interfaces;
    paths containing ``/`` are always treated as UDS."""
    host, sep, port = addr.rpartition(":")
    if sep and port.isdigit() and "/" not in addr:
        return socket.AF_INET, (host or "0.0.0.0", int(port))
    return socket.AF_UNIX, addr


def _to_bf16(qs: np.ndarray) -> torch.Tensor:
    """A coalesced fp32 batch as a CPU ``torch.bfloat16`` tensor (rounded to
    nearest even, as ``ml_dtypes`` rounds): the index casts it as its tier
    needs."""
    return torch.from_numpy(qs).to(torch.bfloat16)


def _freeze(v):
    """Hashable canonical form of a request option value."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


class DynamicBatcher:
    """Coalesce concurrent search requests into large device batches.

    Parameters
    ----------
    index:
        anything with ``search(queries, k=..., **opts) -> (vals, idxs)``
        over ``(nq, dim)`` query matrices (all :mod:`dirjax_torch.serving`
        index classes qualify).
    max_batch:
        dispatch as soon as this many query *rows* are pending for one
        signature; a coalesced batch never exceeds it.
    max_wait_ms:
        latency bound — the oldest pending request never waits longer
        than this for co-travellers before dispatch.
    pipeline:
        batches dispatched concurrently (worker threads). A synchronous
        batcher pays the FULL submit->result round trip per batch —
        upload, launches, device time, result pull — serially; with
        ``pipeline`` workers, batch N+1's upload and launches overlap
        batch N's device time and pull, so sustained throughput
        approaches the device's rather than one round trip's (the
        kernels' launchers are safe from several host threads, and the
        card runs the work of one stream in order). 1 restores the
        strictly serial batcher.
    upload_bf16:
        convert coalesced batches to bfloat16 on the HOST before the
        device transfer — halves the query-upload bytes.
        Numerically identical for bf16-database indexes (their search
        casts queries to bf16 anyway); for int8/PQ/IVF/binary it rounds
        the query to 8 mantissa bits BEFORE scoring — far below those
        tiers' own quantization noise, but not bit-identical, hence
        opt-in. Do NOT combine it with a full-precision fp32 dense
        ``RetrievalIndex``: that tier ranks at fp32 HIGHEST precision
        specifically to avoid bf16 truncation (mAP-relevant), and
        rounding the queries on upload reintroduces
        exactly that loss — the constructor warns in this combination.
    """

    def __init__(self, index, max_batch: int = 256,
                 max_wait_ms: float = 2.0, pipeline: int = 3,
                 upload_bf16: bool = False):
        assert max_batch >= 1 and max_wait_ms >= 0.0 and pipeline >= 1
        self.index = index
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.upload_bf16 = bool(upload_bf16)
        if self.upload_bf16:
            d = getattr(index, "dtype", None)   # fp32 dense RetrievalIndex
            if isinstance(d, torch.dtype):
                is_fp32 = d == torch.float32
            else:
                try:
                    is_fp32 = d is not None and np.dtype(d) == np.float32
                except TypeError:
                    is_fp32 = False
            if is_fp32:
                import warnings

                warnings.warn(
                    "upload_bf16 with a full-precision fp32 dense index "
                    "rounds queries to 8 mantissa bits before an otherwise "
                    "HIGHEST-precision ranking — the exact truncation that "
                    "tier exists to avoid (mAP-relevant). Serve a "
                    "bf16/int8 index instead, or drop upload_bf16.",
                    stacklevel=2)
        self._lock = threading.Lock()
        #: signature -> list of (queries, nrows, Future, t0, k, opts)
        self._queues: Dict[Any, list] = {}
        self._event = threading.Event()
        self._stopping = False
        # counted under _lock as requests arrive and as batches are formed
        self.stats = {"requests": 0, "rows": 0, "batches": 0,
                      "batched_rows": 0}
        self._pool = ThreadPoolExecutor(
            max_workers=int(pipeline),
            thread_name_prefix="dirjax-dispatch") if pipeline > 1 else None
        self._thread = threading.Thread(
            target=self._loop, name="dirjax-batcher", daemon=True)
        self._thread.start()

    # --- client API ------------------------------------------------------

    def submit(self, queries, k: int = 10, **opts) -> Future:
        """Enqueue a request; the Future resolves to this request's own
        ``(vals, idxs)`` slice of the coalesced batch."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        assert q.ndim == 2, f"queries must be (nq, dim), got {q.shape}"
        dim = getattr(self.index, "dim", q.shape[1])
        if q.shape[1] != dim:
            raise ValueError(
                f"query dim {q.shape[1]} != index dim {dim}")
        fut: Future = Future()
        sig = (int(k), _freeze(opts))
        with self._lock:
            if self._stopping:
                raise RuntimeError("batcher is closed")
            self._queues.setdefault(sig, []).append(
                (q, len(q), fut, time.perf_counter(), int(k), opts))
            self.stats["requests"] += 1
            self.stats["rows"] += len(q)
        self._event.set()
        return fut

    def search(self, queries, k: int = 10, **opts
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(queries, k=k, **opts).result()

    def close(self) -> None:
        """Flush every pending request, then stop the dispatcher."""
        with self._lock:
            self._stopping = True
        self._event.set()
        self._thread.join()

    # --- dispatcher ------------------------------------------------------

    def _take_ready(self, drain: bool):
        """Pop (sig, requests) batches that are due; return them plus the
        next deadline among the queues left pending."""
        now = time.perf_counter()
        ready, deadline = [], None
        with self._lock:
            for sig in list(self._queues):
                reqs = self._queues[sig]
                rows = sum(r[1] for r in reqs)
                due = drain or rows >= self.max_batch \
                    or now - reqs[0][3] >= self.max_wait
                if not due:
                    deadline = (reqs[0][3] + self.max_wait if deadline
                                is None else min(deadline,
                                                 reqs[0][3] + self.max_wait))
                    continue
                take, taken_rows = [], 0
                # never OVERSHOOT max_batch by coalescing: it is the
                # caller's bound on a batch (and the most warmup() ran). A
                # single request larger than max_batch still dispatches whole —
                # splitting one caller's matrix is not ours to do.
                while reqs and (not take
                                or taken_rows + reqs[0][1]
                                <= self.max_batch):
                    take.append(reqs.pop(0))
                    taken_rows += take[-1][1]
                ready.append((sig, take))
                self.stats["batches"] += 1
                self.stats["batched_rows"] += taken_rows
                if reqs:   # leftovers: due again immediately
                    deadline = now
                else:
                    del self._queues[sig]
        return ready, deadline

    def _dispatch(self, requests) -> None:
        if timer.recording():   # each request's wait from submit to here
            start = time.perf_counter()
            for r in requests:
                timer.record("batcher.wait", r[3], start, r[1])
        qs = np.concatenate([r[0] for r in requests])
        if self.upload_bf16:
            qs = _to_bf16(qs)
        k, opts = requests[0][4], requests[0][5]
        try:
            vals, idxs = self.index.search(qs, k=k, **opts)
        except Exception as exc:  # propagate to every caller in the batch
            for _, _, fut, _, _, _ in requests:
                fut.set_exception(exc)
            return
        vals, idxs = np.asarray(vals), np.asarray(idxs)
        off = 0
        for _, n, fut, _, _, _ in requests:
            fut.set_result((vals[off:off + n], idxs[off:off + n]))
            off += n

    def warmup(self, k: int = 10, **opts) -> None:
        """Search once at 1 row and once at ``max_batch`` rows for one
        ``(k, opts)`` signature, the least and the most a coalesced batch
        holds, so that first-call costs (the kernel library's build and
        load, the allocator's first blocks) are paid before live traffic.
        Call once per signature a deployment will serve."""
        dim = self.index.dim
        rng = np.random.default_rng(0)
        for b in sorted({1, self.max_batch}):
            qs = rng.standard_normal((b, dim)).astype(np.float32)
            if self.upload_bf16:   # match the dispatch dtype signature
                qs = _to_bf16(qs)
            self.index.search(qs, k=k, **opts)

    def _loop(self) -> None:
        while True:
            drain = self._stopping
            ready, deadline = self._take_ready(drain)
            for _, requests in ready:
                if self._pool is not None:
                    self._pool.submit(self._dispatch, requests)
                else:
                    self._dispatch(requests)
            if drain and not ready:
                if self._pool is not None:   # flush in-flight batches
                    self._pool.shutdown(wait=True)
                return
            if ready:            # more work may already be due
                continue
            timeout = None if deadline is None \
                else max(0.0, deadline - time.perf_counter())
            self._event.wait(timeout)
            self._event.clear()


# --- wire protocol --------------------------------------------------------
# frame := uint32_be(len(meta_json)) + meta_json + payload bytes
# request meta:  {"k", "shape": [n, d], "keys": bool, "opts": {...}}
#                payload = float32 queries (n*d*4 bytes)
#                {"cmd": "shutdown"} stops the server.
# response meta: {"shape": [n, k], "keys": [[...]]|null} or {"error": str}
#                payload = float32 scores + int32 indices


def _send_frame(sock: socket.socket, meta: dict, payload: bytes = b"") -> None:
    mb = json.dumps(meta).encode()
    sock.sendall(struct.pack("!I", len(mb)) + mb + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame"
                                  if buf else "peer closed")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket, nbytes=lambda meta: 0):
    (mlen,) = struct.unpack("!I", _recv_exact(sock, 4))
    meta = json.loads(_recv_exact(sock, mlen))
    return meta, _recv_exact(sock, nbytes(meta))


def _payload_len(meta: dict) -> int:
    if "shape" not in meta:
        return 0
    n, d = meta["shape"]
    if "k" in meta:                       # request: float32 queries
        return n * d * 4
    return n * d * 4 + n * d * 4          # response: f32 scores + i32 idxs


class IndexServer:
    """Socket front of a :class:`DynamicBatcher` — a Unix-socket path or
    a ``host:port`` TCP address (``:port`` alone binds all interfaces;
    port 0 lets the kernel pick — read ``server.address``).

    One thread per connection; all of them feed the single batcher, so
    concurrent clients are what *creates* the large device batches.
    """

    def __init__(self, index, socket_path: str, max_batch: int = 256,
                 max_wait_ms: float = 2.0, pipeline: int = 3,
                 upload_bf16: bool = False):
        self.batcher = DynamicBatcher(index, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms,
                                      pipeline=pipeline,
                                      upload_bf16=upload_bf16)
        family, bind_to = _parse_addr(socket_path)
        self.socket_path = socket_path if family == socket.AF_UNIX else None
        if self.socket_path and os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            self._sock.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._sock.bind(bind_to)
        if family == socket.AF_INET:   # port 0 -> kernel-chosen; publish it
            host, port = self._sock.getsockname()
            self.address = f"{host}:{port}"
        else:
            self.address = socket_path
        self._sock.listen(64)
        self._shutdown = threading.Event()

    def serve_forever(self) -> None:
        """Accept loop; returns after a client sends ``shutdown``."""
        self._sock.settimeout(0.2)
        conns = []
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            conns.append(t)
        self._sock.close()
        for t in conns:
            t.join(timeout=2.0)
        self.batcher.close()
        if self.socket_path and os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

    def _handle(self, conn: socket.socket) -> None:
        # Pipelined per-connection protocol: the recv loop SUBMITS each
        # request to the batcher without waiting for its result, and a
        # per-connection sender thread writes responses back in request
        # order as their futures resolve. One client can therefore keep
        # many requests in flight on one socket (Client.search_async) —
        # without this, a connection serializes on the full batch round
        # trip per request and single-client throughput is bounded by
        # latency, not the batcher (PERF_NOTES "Index server").
        from queue import SimpleQueue

        sendq: SimpleQueue = SimpleQueue()

        def sender():
            while True:
                job = sendq.get()
                if job is None:
                    return
                try:
                    job()
                except OSError:      # client went away mid-response
                    return

        st = threading.Thread(target=sender, daemon=True,
                              name="dirjax-conn-sender")
        st.start()

        def respond(fut, want_keys, request, n):
            try:
                vals, idxs = fut.result()
            except Exception as exc:
                _send_frame(conn, {"error": f"{type(exc).__name__}: "
                                            f"{exc}"})
                return
            reply = timer.begin()
            keys = None
            if want_keys:
                try:
                    keys = self.batcher.index.lookup(idxs)
                except Exception as exc:
                    _send_frame(conn, {"error": str(exc)})
                    return
            _send_frame(
                conn, {"shape": list(vals.shape), "keys": keys},
                np.ascontiguousarray(vals, np.float32).tobytes()
                + np.ascontiguousarray(idxs, np.int32).tobytes())
            timer.end(reply, "server.reply", n)
            timer.end(request, "server.request", n)

        try:
            while not self._shutdown.is_set():
                # a request's spans start once its frame's length is in:
                # server.request to its reply's send, server.parse to its
                # submit to the batcher
                try:
                    (mlen,) = struct.unpack("!I", _recv_exact(conn, 4))
                    request = timer.begin()
                    parse = timer.begin()
                    meta = json.loads(_recv_exact(conn, mlen))
                    payload = _recv_exact(conn, _payload_len(meta))
                except (ConnectionError, struct.error):
                    break
                if meta.get("cmd") == "shutdown":
                    sendq.put(lambda: _send_frame(conn, {"ok": True}))
                    self._shutdown.set()
                    break
                try:
                    n, d = meta["shape"]
                    q = np.frombuffer(payload, np.float32).reshape(n, d)
                    fut = self.batcher.submit(q, k=meta.get("k", 10),
                                              **meta.get("opts", {}))
                except Exception as exc:
                    msg = f"{type(exc).__name__}: {exc}"
                    sendq.put(lambda m=msg: _send_frame(conn,
                                                        {"error": m}))
                    continue
                timer.end(parse, "server.parse", n)
                sendq.put(functools.partial(respond, fut,
                                            bool(meta.get("keys")),
                                            request, n))
        finally:
            sendq.put(None)   # flush in-order, then close
            st.join()
            conn.close()


class Client:
    """Client for :class:`IndexServer` (one socket, reusable,
    thread-safe).

    ``search`` blocks; ``search_async`` returns a
    :class:`concurrent.futures.Future` immediately, so ONE client can
    keep many requests in flight on one connection — the server reads
    and submits them to the batcher as they arrive and streams the
    responses back in request order. Without pipelining, a connection is
    bounded by the full batch round trip per request (latency, not
    throughput); with it, a single client process can saturate the
    batcher that previously needed one thread+socket per in-flight
    request (PERF_NOTES "Index server")."""

    def __init__(self, socket_path: str, connect_timeout: float = 10.0):
        family, addr = _parse_addr(socket_path)
        self._lock = threading.Lock()          # guards sends + _pending
        self._pending: deque = deque()         # (Future, want_keys)
        self._reader: Optional[threading.Thread] = None
        self._dead: Optional[Exception] = None   # set before reader exits
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        t0 = time.monotonic()
        while True:   # the server may still be binding
            try:
                self._sock.connect(addr)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                if time.monotonic() - t0 > connect_timeout:
                    raise
                time.sleep(0.02)

    # --- wire -------------------------------------------------------------

    def _submit(self, meta: dict, payload: bytes, want_keys: bool
                ) -> Future:
        fut: Future = Future()
        with self._lock:   # keeps send order == pending order
            if self._dead is not None:
                # the reader died on connection loss and will never
                # resolve new futures — a send can still "succeed" into
                # a half-closed TCP socket, which would hang the caller
                raise ConnectionError(
                    f"connection lost: {self._dead}") from self._dead
            if self._reader is None:
                self._reader = threading.Thread(
                    target=self._read_loop, daemon=True,
                    name="dirjax-client-reader")
                self._reader.start()
            entry = (fut, want_keys)
            self._pending.append(entry)
            try:
                _send_frame(self._sock, meta, payload)
            except BaseException:
                try:
                    self._pending.remove(entry)
                except ValueError:
                    pass
                raise
            if self._dead is not None:
                # the reader set _dead BEFORE draining, so a drain that
                # missed this just-appended entry is impossible to race
                # past this check: either the drain resolved it, or we
                # see _dead here and fail it ourselves
                try:
                    self._pending.remove(entry)
                except ValueError:
                    pass   # the drain already resolved it
                if not fut.done():
                    # done() then set_exception is check-then-act against
                    # the reader's drain (which never takes _lock): if
                    # both pass the check, the loser's set_exception must
                    # be a no-op, not an exception that kills the drain
                    try:
                        fut.set_exception(ConnectionError(
                            f"connection lost: {self._dead}"))
                    except InvalidStateError:
                        pass
        return fut

    def _read_loop(self) -> None:
        # deque.append/popleft are atomic, so the reader never touches
        # _lock — a sender blocked mid-sendall can therefore never stall
        # the draining of responses (bidirectional-pressure deadlock).
        while True:
            try:
                rmeta, payload = _recv_frame(self._sock, _payload_len)
            except Exception as exc:
                self._dead = exc   # BEFORE draining — _submit re-checks
                while True:
                    try:
                        fut, _ = self._pending.popleft()
                    except IndexError:
                        return
                    if not fut.done():
                        # _submit's own loss path races this drain on the
                        # same future; a lost race must be a no-op — an
                        # unhandled InvalidStateError here would kill the
                        # drain mid-way and strand the remaining futures
                        try:
                            fut.set_exception(
                                ConnectionError(f"connection lost: {exc}"))
                        except InvalidStateError:
                            pass
            fut, want_keys = self._pending.popleft()
            try:
                fut.set_result(self._parse(rmeta, payload, want_keys))
            except Exception as exc:
                fut.set_exception(exc)

    @staticmethod
    def _parse(rmeta: dict, payload: bytes, want_keys: bool):
        if "error" in rmeta:
            raise RuntimeError(f"server error: {rmeta['error']}")
        if rmeta.get("ok"):           # shutdown acknowledgement
            return True
        n, kk = rmeta["shape"]
        vals = np.frombuffer(payload[:n * kk * 4], np.float32
                             ).reshape(n, kk)
        idxs = np.frombuffer(payload[n * kk * 4:], np.int32
                             ).reshape(n, kk)
        if want_keys:
            return vals, idxs, rmeta["keys"]
        return vals, idxs

    # --- API --------------------------------------------------------------

    def search_async(self, queries, k: int = 10, keys: bool = False,
                     **opts) -> Future:
        """Fire a request without waiting; the Future resolves to
        ``(vals, idxs)`` (plus key lists if ``keys=True``). Responses
        come back in request order, errors resolve the matching Future."""
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        if q.ndim == 1:
            q = q[None, :]
        meta = {"k": int(k), "shape": list(q.shape), "keys": bool(keys),
                "opts": opts}
        return self._submit(meta, q.tobytes(), bool(keys))

    def search(self, queries, k: int = 10, keys: bool = False,
               **opts):
        """(vals, idxs) — plus the key lists if ``keys=True``."""
        return self.search_async(queries, k=k, keys=keys, **opts).result()

    def shutdown_server(self) -> None:
        self._submit({"cmd": "shutdown"}, b"", False).result()

    def close(self) -> None:
        # on Linux, closing a socket does not interrupt a recv() blocked in
        # another thread; shutting it down first ends the reader's recv()
        # at once instead of after the 5 s join below
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:   # not connected, or the peer already closed it
            pass
        self._sock.close()
        if self._reader is not None:
            self._reader.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

