"""Serving-index CLI (counterpart of ``dirjax/cli/index.py``): build, grow,
prune, tune and query a :class:`~dirjax_torch.serving.RetrievalIndex`,
:class:`~dirjax_torch.serving.BinaryIndex`, :class:`~dirjax_torch.serving.PQIndex`
or :class:`~dirjax_torch.serving.IVFPQIndex` from ``.npy`` descriptor files.
Flags, index files and the query JSON are dirjax's, so the two CLIs
interoperate:

    python -m dirjax_torch.index build --descs feats.dbdescs.npy \\
        --keys db.txt --int8 --out index.npz --gpu 0
    python -m dirjax_torch.index build --descs feats.dbdescs.npy --pq 32 \\
        --pq-rerank --out pq.npz --gpu 0
    python -m dirjax_torch.index build --descs feats.dbdescs.npy --ivf 1024 \\
        --out ivf.npz --gpu 0
    python -m dirjax_torch.index tune --index ivf.npz --descs q.npy \\
        --db-descs feats.dbdescs.npy --target 0.9 --apply --gpu 0
    python -m dirjax_torch.index query --index index.npz \\
        --descs feats.qdescs.npy -k 10 --aqe 10 3 --out-json hits.json --gpu 0

``--gpu -1`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Build / query a dirjax_torch serving index")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--gpu", type=int, default=0, nargs="+",
                        help="CUDA device id; -1 selects the CPU")
    sub = parser.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", parents=[common],
                       help="build an index from descriptors")
    b.add_argument("--descs", required=True,
                   help="(N, D) .npy descriptor matrix (dbdescs)")
    b.add_argument("--keys", default="",
                   help="one key per line (e.g. the ImageList file); "
                        "omit for positional-index results")
    b.add_argument("--int8", action="store_true",
                   help="store the database int8-quantized (half the bytes "
                        "of bf16)")
    b.add_argument("--binary", type=int, default=0, metavar="BITS",
                   help="ITQ binary-hash the rows to BITS sign bits "
                        "(multiple of 32; -1 = the descriptor dim): BITS/8 "
                        "bytes per row, exact asymmetric ranking")
    b.add_argument("--binary-sym", action="store_true",
                   help="with --binary: rank by the symmetric Hamming score")
    b.add_argument("--pq", type=int, default=0, metavar="M",
                   help="product-quantize to M uint8 codes per row "
                        "(approximate ADC ranking); --pq-rerank keeps int8 "
                        "rows too for exact rescoring")
    b.add_argument("--pq-ksub", type=int, default=16, metavar="K",
                   help="centroids per PQ subspace (<= 256)")
    b.add_argument("--ivf", type=int, default=0, metavar="NLIST",
                   help="add an inverted file with NLIST coarse cells on top "
                        "of PQ codes (IVFADC): queries scan only --nprobe "
                        "cells. Implies --pq (default m=32)")
    b.add_argument("--nprobe", type=int, default=8,
                   help="with --ivf: default cells probed per query (recall "
                        "knob; query-time --nprobe overrides)")
    b.add_argument("--opq", action="store_true",
                   help="with --pq/--ivf: learn an OPQ rotation first")
    b.add_argument("--pq-rerank", action="store_true",
                   help="with --pq/--ivf: also keep int8 rows and exactly "
                        "rescore the ADC shortlist at query time")
    b.add_argument("--out", required=True, help="output .npz index path")

    a = sub.add_parser("add", parents=[common],
                       help="append rows to an existing index")
    a.add_argument("--index", required=True, help=".npz from `build`")
    a.add_argument("--descs", required=True,
                   help="(N, D) .npy descriptor matrix to append")
    a.add_argument("--keys", default="",
                   help="one key per line for the new rows "
                        "(required for keyed indexes)")
    a.add_argument("--out", default="",
                   help="output path (default: rewrite --index in place)")

    r = sub.add_parser("remove", parents=[common],
                       help="delete rows from an index (tombstones; "
                            "--compact reclaims memory but renumbers)")
    r.add_argument("--index", required=True, help=".npz from `build`")
    r.add_argument("--keys", default="",
                   help="file with one key per line to remove (keyed indexes)")
    r.add_argument("--indices", type=int, nargs="*", default=None,
                   help="row indices to remove")
    r.add_argument("--compact", action="store_true",
                   help="physically drop tombstoned rows (renumbers result "
                        "indices; key lookups are unaffected)")
    r.add_argument("--out", default="",
                   help="output path (default: rewrite --index in place)")

    t = sub.add_parser("tune", parents=[common],
                       help="pick the cheapest recall knobs (nprobe / "
                            "rerank_factor) meeting a recall@k target")
    t.add_argument("--index", required=True, help=".npz from `build`")
    t.add_argument("--descs", required=True,
                   help="(Nq, D) .npy query-descriptor sample to tune on")
    t.add_argument("--db-descs", default="",
                   help="raw (N, D) build-time matrix: exact ground truth is "
                        "computed from it (or pass --gt)")
    t.add_argument("--gt", default="", help="precomputed (Nq, k) exact-neighbour .npy")
    t.add_argument("-k", "--topk", type=int, default=10)
    t.add_argument("--target", type=float, default=0.95, help="recall@k target")
    t.add_argument("--apply", action="store_true",
                   help="write the tuned nprobe back into the index file")

    q = sub.add_parser("query", parents=[common], help="query an index")
    q.add_argument("--index", required=True, help=".npz from `build`")
    q.add_argument("--descs", required=True,
                   help="(Nq, D) .npy query descriptors (qdescs)")
    q.add_argument("-k", "--topk", type=int, default=10)
    q.add_argument("--nprobe", type=int, default=0,
                   help="IVF indexes: cells probed per query (0 = the index's "
                        "build-time default)")
    q.add_argument("--adc-bf16", action="store_true",
                   help="PQ/IVF indexes: round the ADC tables to bfloat16")
    q.add_argument("--aqe", type=int, nargs=2, metavar=("K", "ALPHA"),
                   default=None, help="alpha-query-expansion before ranking")
    q.add_argument("--int8-queries", action="store_true",
                   help="int8-quantize queries too (int8 indexes only)")
    q.add_argument("--out-json", default="",
                   help="write results as JSON (default: print)")
    return parser


def _read_keys(path: str, n: int):
    if not path:
        return None
    with open(path) as f:
        keys = [ln.split()[0] for ln in f if ln.strip()]
    if len(keys) != n:
        raise SystemExit(f"{len(keys)} keys != {n} descriptors")
    return keys


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .common import setup_device

    device = setup_device(args.gpu)

    import numpy as np
    import torch

    from ..serving import BinaryIndex, IVFPQIndex, PQIndex, RetrievalIndex

    if args.cmd == "build":
        # storage kinds are mutually exclusive, as in dirjax
        exclusive = [f for f, on in [("--binary", bool(args.binary)),
                                     ("--pq/--ivf", bool(args.pq or args.ivf)),
                                     ("--int8", args.int8)] if on]
        if len(exclusive) > 1:
            raise SystemExit(
                f"conflicting storage flags: {' + '.join(exclusive)} — pick "
                "one (use --pq-rerank to pair int8 rows with a PQ index)")
        descs = np.load(args.descs)
        keys = _read_keys(args.keys, len(descs))
        if args.ivf:
            index = IVFPQIndex(descs, nlist=args.ivf, m=args.pq or 32, ksub=args.pq_ksub,
                               nprobe=args.nprobe, keys=keys, opq=args.opq,
                               rerank=args.pq_rerank, device=device)
            kind = (f"ivf nlist={args.ivf} nprobe={args.nprobe} "
                    f"pq m={index.m} ksub={args.pq_ksub}"
                    + (" opq" if args.opq else "")
                    + (" +int8-rerank" if args.pq_rerank else ""))
        elif args.binary:
            index = BinaryIndex(descs, n_bits=None if args.binary < 0 else args.binary,
                                keys=keys, asym=not args.binary_sym, device=device)
            kind = (f"binary {index.n_bits} bits"
                    + (" sym" if args.binary_sym else " +asym-rescore"))
        elif args.pq:
            index = PQIndex(descs, m=args.pq, ksub=args.pq_ksub, keys=keys, opq=args.opq,
                            rerank=args.pq_rerank, device=device)
            kind = (f"pq m={args.pq} ksub={args.pq_ksub}"
                    + (" opq" if args.opq else "")
                    + (" +int8-rerank" if args.pq_rerank else ""))
        else:
            index = RetrievalIndex(descs, keys=keys, device=device,
                                   dtype=torch.int8 if args.int8 else torch.bfloat16)
            kind = "int8" if args.int8 else "bf16"
        index.save(args.out)
        print(f"built index: {index.n} x {index.dim} "
              f"({kind}{', keyed' if keys else ''}) -> {args.out}")
        return index

    index = RetrievalIndex.load(args.index, device=device)
    if args.cmd == "tune":
        from ..tuning import tune

        res = tune(index, np.load(args.descs), np.load(args.gt) if args.gt else None,
                   k=args.topk, target=args.target,
                   descriptors=np.load(args.db_descs) if args.db_descs else None)
        for params, r in res.trials:
            print(f"  {params or '(no knobs)'}: recall@{args.topk} = {r:.4f}")
        state = "meets" if res.met else "BEST EFFORT, misses"
        print(f"tuned: {res.params or '(no knobs)'} -> recall {res.recall:.4f} "
              f"({state} target {args.target})")
        if args.apply and "nprobe" in res.params:
            res.apply(index)
            index.save(args.index)
            print(f"applied nprobe={res.params['nprobe']} -> {args.index}")
        return res

    if args.cmd == "add":
        descs = np.load(args.descs)
        index.add(descs, keys=_read_keys(args.keys, len(descs)))
        out = args.out or args.index
        index.save(out)
        print(f"added {len(descs)} rows -> {index.n} x {index.dim} -> {out}")
        return index

    if args.cmd == "remove":
        if args.keys and args.indices is not None:
            raise SystemExit("remove: pass --keys OR --indices, not both")
        if args.keys:
            with open(args.keys) as f:
                n_rm = index.remove(keys=[ln.split()[0] for ln in f if ln.strip()])
        elif args.indices is not None:
            n_rm = index.remove(indices=args.indices)
        else:
            raise SystemExit("remove: pass --keys or --indices")
        msg = f"removed {n_rm} rows ({index.n_removed} tombstoned"
        if args.compact:
            index.compact()
            msg = f"removed {n_rm} rows (compacted to {index.n}"
        out = args.out or args.index
        index.save(out)
        print(msg + f") -> {out}")
        return index

    if args.adc_bf16:
        if not isinstance(index, (PQIndex, IVFPQIndex)):
            raise SystemExit("--adc-bf16 applies to PQ/IVF (ADC) indexes")
        index.compute_dtype = torch.bfloat16
    q = np.load(args.descs)
    aqe = ({"k": args.aqe[0], "alpha": float(args.aqe[1])}
           if args.aqe else None)
    if isinstance(index, (PQIndex, IVFPQIndex)) and args.int8_queries:
        raise SystemExit("--int8-queries applies to int8 indexes; this is a "
                         f"{type(index).__name__} (ADC scoring)")
    if isinstance(index, IVFPQIndex):
        vals, idxs = index.search(q, k=args.topk, aqe=aqe, nprobe=args.nprobe or None)
    elif isinstance(index, PQIndex):
        vals, idxs = index.search(q, k=args.topk, aqe=aqe)
    elif isinstance(index, BinaryIndex):
        if args.int8_queries or aqe:
            raise SystemExit("--int8-queries/--aqe don't apply to binary "
                             "indexes (Hamming scoring; expand queries "
                             "before hashing instead)")
        vals, idxs = index.search(q, k=args.topk)
    else:
        vals, idxs = index.search(q, k=args.topk, aqe=aqe,
                                  int8_queries=args.int8_queries)
    out = {"scores": vals.tolist(), "indices": idxs.tolist()}
    if index.keys is not None:
        out["keys"] = index.lookup(idxs)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f)
        print(f"wrote {len(q)} query results to {args.out_json}")
    else:
        for qi in range(len(q)):
            hits = out["keys"][qi] if "keys" in out else out["indices"][qi]
            print(f"query {qi}: {hits[:args.topk]}")
    return out


if __name__ == "__main__":
    main()
