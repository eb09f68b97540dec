"""``python -m dirjax_torch.serve`` — serve an index over a Unix socket
(or ``host:port``) with dynamic batching (counterpart of
``dirjax/server.py::main``).

The batcher, the socket server, the wire protocol and the client are the
port's own copy of dirjax's (:mod:`dirjax_torch.server`), re-exported here,
so any client of either package talks to this server. The index is a
:class:`~dirjax_torch.serving.RetrievalIndex`,
:class:`~dirjax_torch.serving.BinaryIndex`,
:class:`~dirjax_torch.serving.PQIndex` or
:class:`~dirjax_torch.serving.IVFPQIndex` loaded onto ``--gpu``; per-request
options (``aqe``, ``nprobe``, ``rerank_factor``, ...) pass through.

    python -m dirjax_torch.index build --descs db.npy --int8 --out index.npz
    python -m dirjax_torch.serve --index index.npz --socket /tmp/dirjax.sock

``DynamicBatcher(pipeline > 1)`` calls ``search`` from several threads; each
launches on the current CUDA stream of the index's device.
``--upload-bf16`` hands each coalesced batch to the index as a CPU
``torch.bfloat16`` tensor. At exit it prints the requests' latency
percentiles, each from its frame's arrival to its reply's send (the
``server.request`` spans of the newest 65,536 requests).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from .server import Client, DynamicBatcher, IndexServer
from .utils import timer

__all__ = ["Client", "DynamicBatcher", "IndexServer", "main"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve a dirjax_torch index with dynamic batching")
    parser.add_argument("--index", required=True,
                        help=".npz from `python -m dirjax_torch.index build` "
                             "(or dirjax's): dense, binary, PQ or IVF")
    parser.add_argument("--socket", required=True,
                        help="Unix-domain socket path, or host:port for TCP")
    parser.add_argument("--max-batch", type=int, default=256,
                        help="dispatch at this many pending query rows")
    parser.add_argument("--max-wait-ms", type=float, default=2.0,
                        help="max time the oldest request waits for "
                             "co-travellers")
    parser.add_argument("--upload-bf16", action="store_true",
                        help="convert batches to bfloat16 on the host "
                             "before the device transfer (halves query "
                             "upload bytes; identical results for bf16 "
                             "indexes, sub-quantization-noise rounding "
                             "for int8/PQ/IVF/binary; avoid with an fp32 "
                             "dense index — it truncates the queries that "
                             "tier ranks at full precision)")
    parser.add_argument("--pipeline", type=int, default=3,
                        help="batches dispatched concurrently (1 = strictly "
                             "serial dispatch)")
    parser.add_argument("--gpu", type=int, default=0, nargs="+",
                        help="CUDA device id; -1 selects the CPU")
    parser.add_argument("--warmup-k", type=int, default=None, metavar="K",
                        help="run one top-K search per batch size the batcher "
                             "warms (1 and --max-batch) before accepting "
                             "traffic")
    return parser


def main(argv: Optional[list] = None) -> IndexServer:
    args = build_parser().parse_args(argv)
    from .cli.common import setup_device
    from .serving import RetrievalIndex

    device = setup_device(args.gpu)
    index = RetrievalIndex.load(args.index, device=device)
    server = IndexServer(index, args.socket, max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms, pipeline=args.pipeline,
                         upload_bf16=args.upload_bf16)
    name = type(index).__name__
    if args.warmup_k is not None:
        print(f"warming {name} for k={args.warmup_k} ...", flush=True)
        server.batcher.warmup(k=args.warmup_k)
    print(f"serving {name} ({index.n} x {index.dim}) on {server.address} "
          f"(max_batch={args.max_batch}, max_wait={args.max_wait_ms} ms)",
          flush=True)
    timer.enable()
    server.serve_forever()
    s = server.batcher.stats
    mean = s["batched_rows"] / max(1, s["batches"])
    print(f"served {s['requests']} requests ({s['rows']} query rows) in "
          f"{s['batches']} batches (mean batch {mean:.1f})")
    lat = latency_ms(timer.spans("server.request"))
    timer.disable()
    if lat:
        print("latency ms: " + "  ".join(f"{k} {v:.2f}" for k, v in lat.items()))
    return server


def latency_ms(spans) -> dict:
    """p50, p90, p99, mean and max of the spans' lengths in ms; empty for
    no span."""
    if not spans:
        return {}
    ms = np.array([s[3] - s[2] for s in spans]) * 1e3
    return {"p50": float(np.percentile(ms, 50)), "p90": float(np.percentile(ms, 90)),
            "p99": float(np.percentile(ms, 99)), "mean": float(ms.mean()),
            "max": float(ms.max())}


if __name__ == "__main__":
    main()
