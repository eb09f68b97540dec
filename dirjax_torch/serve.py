"""``python -m dirjax_torch.serve`` — serve an index over a Unix socket
(or ``host:port``) with dynamic batching (counterpart of
``dirjax/server.py::main``).

The batcher, the socket server, the wire protocol and the client are the
port's own copy of dirjax's (:mod:`dirjax_torch.server`), re-exported here,
so any client of either package talks to this server. The index is a
:class:`~dirjax_torch.serving.RetrievalIndex` or
:class:`~dirjax_torch.serving.BinaryIndex` loaded onto ``--gpu``.

    python -m dirjax_torch.index build --descs db.npy --int8 --out index.npz
    python -m dirjax_torch.serve --index index.npz --socket /tmp/dirjax.sock

``DynamicBatcher(pipeline > 1)`` calls ``search`` from several threads; each
launches on the current CUDA stream of the index's device.

Left out: ``--upload-bf16`` (not ported yet, ROADMAP M8).
"""

from __future__ import annotations

import argparse
from typing import Optional

from .server import Client, DynamicBatcher, IndexServer

__all__ = ["Client", "DynamicBatcher", "IndexServer", "main"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve a dirjax_torch index with dynamic batching")
    parser.add_argument("--index", required=True,
                        help=".npz from `python -m dirjax_torch.index build` "
                             "(or dirjax's): dense or binary")
    parser.add_argument("--socket", required=True,
                        help="Unix-domain socket path, or host:port for TCP")
    parser.add_argument("--max-batch", type=int, default=256,
                        help="dispatch at this many pending query rows")
    parser.add_argument("--max-wait-ms", type=float, default=2.0,
                        help="max time the oldest request waits for "
                             "co-travellers")
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
                         max_wait_ms=args.max_wait_ms, pipeline=args.pipeline)
    name = type(index).__name__
    if args.warmup_k is not None:
        print(f"warming {name} for k={args.warmup_k} ...", flush=True)
        server.batcher.warmup(k=args.warmup_k)
    print(f"serving {name} ({index.n} x {index.dim}) on {server.address} "
          f"(max_batch={args.max_batch}, max_wait={args.max_wait_ms} ms)",
          flush=True)
    server.serve_forever()
    s = server.batcher.stats
    mean = s["batched_rows"] / max(1, s["batches"])
    print(f"served {s['requests']} requests ({s['rows']} query rows) in "
          f"{s['batches']} batches (mean batch {mean:.1f})")
    lat = server.batcher.latency_stats()
    if lat:
        print("latency ms: " + "  ".join(f"{k[:-3]} {v:.2f}" for k, v in lat.items()))
    return server


if __name__ == "__main__":
    main()
