#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dirjax_torch) once through its main paths on
one NVIDIA GPU, and check what comes out.

    python3 chip_smoke.py      # from the repository root; needs one CUDA card

Phases, each of which raises on failure:

1. build  — nvcc builds dirjax_torch/csrc/*.cu for sm_90a, one process per
   source, all started together.
2. kernel — K1, the fused GeM -> FC -> L2 head (csrc/gem_head.cu), against
   its plain PyTorch version on the card at the main-path shape
   (8, 32, 24, 2048) -> 2048: unmasked, bucket-masked, a ragged D and bf16
   input, within rtol 2e-4 / atol 2e-5, TF32 off; both timed with CUDA events.
3. top-k kernels — K2-K4 (csrc/topk.cu) against their plain versions at the
   serving shape: 1,048,576 seeded random unit rows of 2048 (fp32, bf16,
   int8 with per-row scales), nq = 256, 37 and 1, and a ragged 1,048,573
   rows. K2 at k = 10 on fp32 and bf16; K3 and K4 on bf16, int8 and
   int8 x int8 queries. Scores within atol 1e-5 (int8 x int8 exactly equal),
   an index may differ only at a near-tie within 1e-5; K4's maximum over
   each fetched block equals K3's bit for bit; rank_topk_fused against a
   dense plain top-k (k = 10 and 100). Each kernel timed against its plain
   version with CUDA events, plain/kernel/kernel/plain, and a bf16
   torch.matmul of the same operands timed as the library yardstick.
4. binary kernels — K5 and its asymmetric rescore (csrc/binary.cu) at the
   serving shape: the same 1,048,576 rows, an ITQ codec fitted on the card
   (131,072-row sample, 30 iterations; the fit time is printed) and
   2048-bit codes. K5 symmetric (exactly equal) and asymmetric (within
   1e-5) against their plain versions at nq = 256, 37 and 1 and on a ragged
   1,048,573 rows; the rescore within 1e-5 of its plain version, its block
   maxima equal to K5's bit for bit; hamming_search_fused at k = 10 and 100
   against a dense plain top-k (values, and no returned row outside the
   plain set but at a near-tie). Each kernel timed against its plain
   version with CUDA events, plain/kernel/kernel/plain.
5. serving — RetrievalIndex in bf16 and in int8 over the same rows, and a
   BinaryIndex (asymmetric) over their 2048-bit codes, each behind the
   port's IndexServer (dirjax_torch.server) on a Unix socket; several
   Clients send concurrent requests of 1-16 queries at k = 10 (K2; binary:
   K5 + rescore) and k = 100 (K3 + K4), int8 with and without int8_queries,
   and AQE. The launch counters of K2-K5 and the rescore are zeroed just
   before and must have risen just after; every answer must equal the
   index's own direct search (values within 1e-5, an index differing only
   at a near-tie). Requests, batches, latency percentiles and QPS are
   printed as information.
6. main path — a synthetic Revisited benchmark at 1024x768 and a
   resnet101_rmac (2048-D) checkpoint with seeded random weights and a fitted
   PCA go through ``dirjax_torch.cli.test_dir.main`` with whitening and
   AQE/ADBA, once in fp32 and once with --bf16. K1's launch counter must rise
   in each run. The database descriptors each run saves (--save-feats) must
   be finite unit vectors, and those of the first 4 images must match the
   port's fp32 CPU path: cosine > 0.9999 for the fp32 run, > 0.999 for the
   bf16 one. The mAPs are only checked to be finite in [0, 1]: the synthetic
   classes differ by colour, so even random weights rank them perfectly and
   mAP = 1 says nothing about the path. Prints which host decoder ran (the
   native one, or PIL where it cannot build).
7. index CLI — ``python -m dirjax_torch.index build --int8`` and ``build
   --binary 2048``, each then ``query -k 100 --gpu 0``, as subprocesses on
   65,536 rows; each JSON answer must equal the in-process search exactly.

    python3 chip_smoke.py --profile DIR   # also phase 8

8. profile — where a warm database extraction's time goes, fp32 and bf16:
   unprofiled wall (host clock), forward ms per batch of 8 (CUDA events) and
   peak memory, and a torch.profiler trace whose device intervals are merged
   into busy time and split into convolution, elementwise, copies, K1 and
   other. Writes the traces and ``profile_summary.json`` into DIR. And where
   one direct search's time goes, per serving signature at nq = 1, 16 and
   64: host ms per search and device ms by kernel
   (``serving_profile.json``).

Prints the card's name and power limit, then one JSON line with each
kernel's launches on the main paths, error against its plain version, time,
its plain version's time, its bound (the larger of its bytes over 3.35 TB/s
and its operations over the peak rate of their type on an H100 SXM) and the
time of one PyTorch call that computes the same function, where there is
one; and last a JSON line with "ok": true. Exits non-zero, printing no
result, when CUDA is not available.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

RTOL, ATOL = 2e-4, 2e-5
MAIN_SHAPE = (8, 32, 24, 2048)   # R101 C5 at 1024x768, batch 8
MAIN_D = 2048
N_REF = 4                        # database images held against the CPU path
COS_BOUND = {"fp32": 0.9999, "bf16": 0.999}
SERVE_N, SERVE_D, SERVE_NQ = 1_048_576, 2048, 256   # the serving shape
TOPK_ATOL = 1e-5
TILE_ROWS = 1024                 # rank_topk_fused's default level-0 group
CLI_N = 65_536
REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA's data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the peak
# of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
BITS = 2048                      # binary code width at the serving shape
ITQ_ITERS = 30
NO_LIBRARY = "no single PyTorch call computes this function"


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel moving ``nbytes`` (each
    input read once, each output written once) and doing ``ops`` operations
    of type ``kind``."""
    mem_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(mem_ms, op_ms),
            "bound_by": "bytes" if mem_ms >= op_ms else "operations"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_phase():
    from dirjax_torch.kernels.build import build, load_library

    res = build()
    load_library()
    for cmd in res.command:
        print("nvcc:", cmd)
    if res.command:
        print(res.log.strip())
    print(f"build: {res.path} in {res.seconds:.1f} s")
    return res


def _time_ms(fn, iters: int = 20) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after 3 warm-up calls."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(device) -> dict:
    """K1 against gem_head_reference on the card; returns its JSON entry
    without ``launches``."""
    from dirjax_torch.ops import gem_head

    g = torch.Generator(device=device).manual_seed(0)
    B, H, W, C = MAIN_SHAPE
    x = torch.rand(MAIN_SHAPE, generator=g, device=device) + 0.05
    # a bucket mask: row 0 is a 20x16-cell image on the 32x24 canvas
    mask = torch.ones((B, H, W), dtype=torch.bool, device=device)
    mask[0, 20:] = False
    mask[0, :, 16:] = False
    p = torch.tensor([3.0], device=device)
    worst = 0.0
    # the main path below gives (8, 24, 32) database and (6, 24, 32) query
    # maps: 1024x768 landscape images
    for name, d, xin, m in [
            ("unmasked", MAIN_D, x, None),
            ("masked", MAIN_D, x, mask),
            ("ragged_d", 2000, x, mask),
            ("bf16", MAIN_D, x.to(torch.bfloat16), mask),
            ("db_landscape", MAIN_D, x.reshape(B, W, H, C), None),
            ("query_bf16", MAIN_D, x[:6].reshape(6, W, H, C).to(torch.bfloat16), None)]:
        # W as the model passes it: the (C, D) view of an nn.Linear weight
        w = (torch.randn((d, C), generator=g, device=device) * C ** -0.5).T
        b = torch.randn((d,), generator=g, device=device) * 0.01
        got = gem_head.fused_gem_head(xin, p, w, b, mask=m)
        want = gem_head.gem_head_reference(xin.float(), m, p, w, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"kernel gem_head {name}: x {tuple(xin.shape)} {xin.dtype} -> "
              f"D={d}: max_abs_err {err:.3e}")
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        worst = max(worst, err)

    w = (torch.randn((MAIN_D, C), generator=g, device=device) * C ** -0.5).T
    b = torch.zeros((MAIN_D,), device=device)
    ms, plain_ms = time_in_turns(
        f"gem_head {MAIN_SHAPE}->{MAIN_D} masked fp32",
        lambda: gem_head.gem_head_reference(x, mask, p, w, b),
        lambda: gem_head.fused_gem_head(x, p, w, b, mask=mask))
    B, H, W, C = MAIN_SHAPE
    nbytes = 4 * (x.numel() + w.numel() + b.numel() + B * MAIN_D) + mask.numel()
    ops = 3 * x.numel() + 2 * B * C * MAIN_D   # pow, mean, root; then the FC
    return {"name": "gem_head", "route": "cuda",
            "source": "dirjax_torch/csrc/gem_head.cu",
            "replaces": "dirjax/ops/gem_head.py:45",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **bound(nbytes, ops, "fp32"), "library_ms": None,
            "library_note": NO_LIBRARY + " (masked GeM, FC and L2 in one pass)"}


def time_in_turns(tag: str, plain, kernel, iters: int = 20):
    """Mean ms of the kernel and of its plain version, timed in turns
    plain/kernel/kernel/plain on one card; returns (kernel_ms, plain_ms)."""
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(_time_ms(plain if which == "plain" else kernel, iters))
    print(f"timing {tag}: kernel {times['kernel']} ms, plain {times['plain']} ms")
    return float(np.mean(times["kernel"])), float(np.mean(times["plain"]))


# --- K2-K4: the dense top-k kernels at the serving shape --------------------

def unit_rows(n: int, d: int, device, seed: int, chunk: int = 65536) -> torch.Tensor:
    """(n, d) fp32 L2-normalised Gaussian rows from a seeded generator on the
    device, made chunk by chunk."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, d), device=device)
    for start in range(0, n, chunk):
        x = torch.randn((min(chunk, n - start), d), generator=g, device=device)
        out[start:start + len(x)] = x / x.norm(dim=1, keepdim=True)
    return out


def pair_scores(q, db, scales, qi, rows) -> torch.Tensor:
    """Plain scores of the (query qi, row) pairs, under the kernels' operand
    rules, scaled as the finish step scales them."""
    if q.dtype == torch.int8:
        s = (q[qi].double() * db[rows].double()).sum(1).float()
    else:
        s = (q[qi].float() * db[rows].float()).sum(1)
    return s if scales is None else s * scales[rows]


def check_scores(tag: str, got, want, exact: bool) -> float:
    """Equal -inf/NaN pattern; finite scores within TOPK_ATOL, or equal."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{tag}: non-finite entries differ")
    err = float((got - want)[fin].abs().max()) if fin.any() else 0.0
    if (exact and not torch.equal(got[fin], want[fin])) or err > TOPK_ATOL:
        raise AssertionError(f"{tag}: max abs err {err:.3e} (bound "
                             f"{'exact' if exact else TOPK_ATOL})")
    return err


def check_ranking(tag: str, got, want, score) -> float:
    """Values within TOPK_ATOL of the plain top-k's; where an index differs,
    the plain score of the returned row lies within TOPK_ATOL of the plain
    value at that rank (a near-tie). ``score(qi, rows)`` gives plain scores."""
    (got_v, got_i), (want_v, want_i) = got, want
    err = check_scores(tag + " values", got_v, want_v, exact=False)
    diff = (got_i != want_i) & torch.isfinite(want_v)
    if diff.any():
        qi, pos = diff.nonzero(as_tuple=True)
        tie = float((score(qi, got_i[qi, pos]) - want_v[qi, pos]).abs().max())
        if tie > TOPK_ATOL:
            raise AssertionError(f"{tag}: {int(diff.sum())} indices differ, "
                                 f"not at near-ties ({tie:.3e})")
    return err


def dense_topk(scores, n: int, k: int):
    """Plain top-k over all ``n`` rows, 65,536 at a time: ``scores(start,
    stop)`` gives the (nq, stop - start) plain scores of those rows. The
    oracle of rank_topk_fused and hamming_search_fused."""
    best = None
    for start in range(0, n, 65536):
        s = scores(start, min(start + 65536, n))
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        cand = (v, i + start) if best is None else (
            torch.cat([best[0], v], 1), torch.cat([best[1], i + start], 1))
        v, pos = torch.topk(cand[0], k, dim=1)
        best = (v, torch.gather(cand[1], 1, pos))
    return best


def dense_scores(q, db, scales, qscales):
    """``scores(start, stop)`` for :func:`dense_topk` under the top-k
    kernels' operand rules, scaled as the finish step scales them."""
    from dirjax_torch.ops import topk

    def scores(start, stop):
        s = topk._scores(q, db[start:stop])
        if scales is not None:
            s = s * scales[start:stop]
        return s if qscales is None else s * qscales[:, None]
    return scores


def topk_kernel_phase(device):
    """K2-K4 against their plain versions at the serving shape; returns their
    JSON entries without ``launches``, and the bf16 database."""
    from dirjax_torch.ops import topk

    t0 = time.perf_counter()
    db32 = unit_rows(SERVE_N, SERVE_D, device, seed=1)
    db16 = db32.bfloat16()
    db8, s8 = topk.quantize_db(db16)
    s8 = s8.reshape(-1)
    qf = unit_rows(SERVE_NQ, SERVE_D, device, seed=2)
    q8, qs8 = topk._quantize_block(qf)
    modes = {"fp32": (qf, db32, None), "bf16": (qf.bfloat16(), db16, None),
             "int8": (qf.bfloat16(), db8, s8), "int8x8": (q8, db8, s8)}
    torch.cuda.synchronize()
    print(f"top-k inputs: {SERVE_N} x {SERVE_D} unit rows in fp32, bf16 and "
          f"int8 in {time.perf_counter() - t0:.1f} s")
    cases = [(SERVE_NQ, SERVE_N), (37, SERVE_N - 3), (1, SERVE_N)]
    err = {"fused_topk": 0.0, "finemax": 0.0, "gather_scores": 0.0}

    for mode in ("bf16", "fp32"):
        for nq, n in cases:
            q, db, _ = modes[mode]
            q, db = q[:nq], db[:n]
            got = topk.fused_topk(q, db, 10)
            want = topk.fused_topk_reference(q, db, 10)
            e = check_ranking(f"fused_topk {mode} nq={nq} n={n}", got, want,
                              lambda qi, rows: pair_scores(q, db, None, qi, rows))
            err["fused_topk"] = max(err["fused_topk"], e)
            print(f"kernel fused_topk {mode} nq={nq} n={n} k=10: max_abs_err {e:.3e}")

    for mode in ("bf16", "int8", "int8x8"):
        for nq, n in cases:
            q, db, s = modes[mode]
            q, db, s = q[:nq], db[:n], None if s is None else s[:n]
            tag = f"{mode} nq={nq} n={n}"
            blocks = -(-n // TILE_ROWS) * (TILE_ROWS // 8)
            fmax = topk.finemax(q, db, s, blocks)
            exact = mode == "int8x8"
            e3 = check_scores(f"finemax {tag}", fmax,
                              topk.finemax_reference(q, db, s, blocks), exact)
            bids, _ = topk._hier_select(fmax, 100, TILE_ROWS, n)
            raw = topk.gather_scores(q, db, bids)
            want = topk.gather_scores_reference(q, db, bids)
            if s is not None:   # scores as the finish step scales them
                rows = (bids[:, :, None] * 8 + torch.arange(8, device=device)).reshape(nq, -1)
                raw, want = raw * s[rows], want * s[rows]
            e4 = check_scores(f"gather_scores {tag}", raw, want, exact)
            if not torch.equal(raw.reshape(nq, -1, 8).amax(dim=2),
                               torch.gather(fmax, 1, bids)):
                raise AssertionError(f"{tag}: K4's block maxima are not K3's")
            err["finemax"] = max(err["finemax"], e3)
            err["gather_scores"] = max(err["gather_scores"], e4)
            print(f"kernel finemax {tag}: max_abs_err {e3:.3e}; gather_scores "
                  f"k=100 ({bids.shape[1]} blocks): max_abs_err {e4:.3e}; "
                  f"block maxima bit-identical")

    for mode, k in (("fp32", 10), ("bf16", 10), ("bf16", 100), ("int8", 100),
                    ("int8x8", 100)):
        q, db, s = modes[mode]
        opts = {} if s is None else {"db_scales": s.reshape(1, -1),
                                     "quantize_queries": mode == "int8x8"}
        got = topk.rank_topk_fused(qf, db, k, **opts)
        qs = qs8 if mode == "int8x8" else None
        want = dense_topk(dense_scores(q, db, s, qs), db.shape[0], k)
        kth = want[0][:, -1:]
        inset = (got[1][:, :, None] == want[1][:, None, :]).any(-1)
        qi, pos = (~inset).nonzero(as_tuple=True)
        outside = pair_scores(q, db, s, qi, got[1][qi, pos])
        if qs is not None:
            outside = outside * qs[qi]
        if len(qi) and float((kth[qi, 0] - outside).max()) > TOPK_ATOL:
            raise AssertionError(f"rank_topk_fused {mode} k={k}: a returned row "
                                 "outside the plain top-k is no near-tie")
        e = check_scores(f"rank_topk_fused {mode} k={k}", got[0], want[0], False)
        print(f"rank_topk_fused {mode} nq={SERVE_NQ} k={k} vs dense plain top-k: "
              f"max_abs_err {e:.3e}, {len(qi)} of {got[1].numel()} rows outside "
              "the plain set (near-ties)")

    q, db, _ = modes["bf16"]
    blocks = -(-SERVE_N // TILE_ROWS) * (TILE_ROWS // 8)
    bids, _ = topk._hier_select(topk.finemax(q, db, None, blocks), 100, TILE_ROWS, SERVE_N)
    shape = f"{SERVE_N}x{SERVE_D} bf16 nq={SERVE_NQ}"
    timed = {
        "fused_topk": time_in_turns(
            f"fused_topk {shape} k=10", lambda: topk.fused_topk_reference(q, db, 10),
            lambda: topk.fused_topk(q, db, 10), iters=5),
        "finemax": time_in_turns(
            f"finemax {shape}", lambda: topk.finemax_reference(q, db, None, blocks),
            lambda: topk.finemax(q, db, None, blocks), iters=5),
        "gather_scores": time_in_turns(
            f"gather_scores {shape} k=100", lambda: topk.gather_scores_reference(q, db, bids),
            lambda: topk.gather_scores(q, db, bids), iters=5),
    }
    for mode in ("int8", "int8x8"):
        q, db, s = modes[mode]
        time_in_turns(f"finemax {SERVE_N}x{SERVE_D} {mode} nq={SERVE_NQ}",
                      lambda: topk.finemax_reference(q, db, s, blocks),
                      lambda: topk.finemax(q, db, s, blocks), iters=5)
    replaces = {"fused_topk": "dirjax/ops/topk_pallas.py:56",
                "finemax": "dirjax/ops/topk_pallas.py:166",
                "gather_scores": "dirjax/ops/topk_pallas.py:299"}
    # the library yardstick of K2 and K3: one bf16 matmul of the same
    # operands (it writes the score matrix the kernels never write)
    q, db, _ = modes["bf16"]
    library_ms = _time_ms(lambda: torch.matmul(q, db.T), iters=5)
    nq, n = SERVE_NQ, SERVE_N
    contraction = 2.0 * nq * n * SERVE_D
    kf8 = bids.shape[1] * 8
    bounds = {
        "fused_topk": bound(db.numel() * 2 + q.numel() * 2 + nq * -(-n // 512) * 10 * 12,
                            contraction, "bf16"),
        "finemax": bound(db.numel() * 2 + q.numel() * 2 + nq * blocks * 4,
                         contraction, "bf16"),
        "gather_scores": bound(nq * kf8 * SERVE_D * 2 + q.numel() * 2 + bids.numel() * 8
                               + nq * kf8 * 4, 2.0 * nq * kf8 * SERVE_D, "bf16"),
    }
    library = {"fused_topk": (library_ms, "bf16 torch.matmul of the same operands"),
               "finemax": (library_ms, "bf16 torch.matmul of the same operands"),
               "gather_scores": (None, NO_LIBRARY + " (a gather of 8-row blocks "
                                 "per query, then their dot products)")}
    print(f"library bf16 torch.matmul {shape}: {library_ms:.3f} ms")
    entries = [{"name": name, "route": "cuda", "source": "dirjax_torch/csrc/topk.cu",
                "replaces": replaces[name], "max_abs_err": err[name],
                "ms": timed[name][0], "plain_ms": timed[name][1], **bounds[name],
                "library_ms": library[name][0], "library_note": library[name][1]}
               for name in ("fused_topk", "finemax", "gather_scores")]
    return entries, db16


# --- K5 and the asymmetric rescore: binary codes at the serving shape -------

def binary_kernel_phase(device):
    """K5 (sym and asym) and the rescore against their plain versions on
    2048-bit ITQ codes of the serving rows; returns their JSON entries
    without ``launches``, the fp32 rows and the codec."""
    from dirjax_torch.ops import binary
    from dirjax_torch.ops.topk import _hier_select

    db32 = unit_rows(SERVE_N, SERVE_D, device, seed=1)   # the serving rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codec = binary.fit_itq(db32, BITS, iters=ITQ_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = binary.binarize(db32, codec)
    torch.cuda.synchronize()
    print(f"binary: ITQ fit ({BITS} bits, 131072-row sample, {ITQ_ITERS} "
          f"iterations) {fit_s:.1f} s; {SERVE_N} rows encoded in "
          f"{time.perf_counter() - t0:.2f} s ({codes.numel() / 2**20:.0f} MiB)")
    qb, vq = binary.binarize_and_project(unit_rows(SERVE_NQ, SERVE_D, device, seed=2),
                                         codec)
    ops = {"sym": qb, "asym": vq.bfloat16().contiguous()}
    err = {"sym": 0.0, "asym": 0.0, "bits_gather_scores": 0.0}
    for mode, q_all in ops.items():
        for nq, n in [(SERVE_NQ, SERVE_N), (37, SERVE_N - 3), (1, SERVE_N)]:
            q, db = q_all[:nq], codes[:n]
            blocks = -(-n // TILE_ROWS) * (TILE_ROWS // 8)
            tag = f"{mode} nq={nq} n={n}"
            fmax = binary.bits_finemax(q, db, blocks)
            e5 = check_scores(f"bits_finemax {tag}", fmax,
                              binary.bits_finemax_reference(q, db, blocks),
                              exact=mode == "sym")
            err[mode] = max(err[mode], e5)
            line = f"kernel bits_finemax {tag}: max_abs_err {e5:.3e}"
            if mode == "asym":
                bids, _ = _hier_select(fmax, 100, TILE_ROWS, n)
                raw = binary.bits_gather_scores(q, db, bids)
                er = check_scores(f"bits_gather_scores {tag}", raw,
                                  binary.bits_gather_scores_reference(q, db, bids), False)
                if not torch.equal(raw.reshape(nq, -1, 8).amax(dim=2),
                                   torch.gather(fmax, 1, bids)):
                    raise AssertionError(f"{tag}: the rescore's block maxima are not K5's")
                err["bits_gather_scores"] = max(err["bits_gather_scores"], er)
                line += (f"; bits_gather_scores k=100 ({bids.shape[1]} blocks): "
                         f"max_abs_err {er:.3e}; block maxima bit-identical")
            print(line)

    qf = unit_rows(SERVE_NQ, SERVE_D, device, seed=2)
    for mode in ("sym", "asym"):
        q_op = binary.unpack_pm1(qb) if mode == "sym" else vq.bfloat16().float()
        for k in (10, 100):
            got = binary.hamming_search_fused(qf, codec, codes, k, asym=mode == "asym")
            want = dense_topk(lambda lo, hi: q_op @ binary.unpack_pm1(codes[lo:hi]).T,
                              SERVE_N, k)
            e = check_scores(f"hamming_search_fused {mode} k={k}", got[0], want[0],
                             exact=mode == "sym")
            kth = want[0][:, -1:]
            inset = (got[1][:, :, None] == want[1][:, None, :]).any(-1)
            qi, pos = (~inset).nonzero(as_tuple=True)
            rows = got[1][qi, pos]
            outside = (q_op[qi] * binary.unpack_pm1(codes[rows])).sum(1)
            if len(qi) and float((kth[qi, 0] - outside).max()) > TOPK_ATOL:
                raise AssertionError(f"hamming_search_fused {mode} k={k}: a returned "
                                     "row outside the plain top-k is no near-tie")
            print(f"hamming_search_fused {mode} nq={SERVE_NQ} k={k} vs dense plain "
                  f"top-k: max_abs_err {e:.3e}, {len(qi)} of {got[1].numel()} rows "
                  "outside the plain set (ties)")

    blocks = -(-SERVE_N // TILE_ROWS) * (TILE_ROWS // 8)
    q = ops["asym"]
    bids, _ = _hier_select(binary.bits_finemax(q, codes, blocks), 100, TILE_ROWS, SERVE_N)
    shape = f"{SERVE_N}x{BITS} bits nq={SERVE_NQ}"
    timed = {}
    for mode in ("sym", "asym"):
        timed[mode] = time_in_turns(
            f"bits_finemax {mode} {shape}",
            lambda: binary.bits_finemax_reference(ops[mode], codes, blocks),
            lambda: binary.bits_finemax(ops[mode], codes, blocks), iters=5)
    timed["rescore"] = time_in_turns(
        f"bits_gather_scores {shape} k=100",
        lambda: binary.bits_gather_scores_reference(q, codes, bids),
        lambda: binary.bits_gather_scores(q, codes, bids), iters=5)
    nq, kf8, nb = SERVE_NQ, bids.shape[1] * 8, BITS // 8
    products = float(SERVE_NQ) * SERVE_N * BITS
    out_bytes = SERVE_NQ * blocks * 4
    no_library = (NO_LIBRARY + ": torch has no popcount, and the ±1 contraction "
                  "needs the codes unpacked first")
    src, replaces = "dirjax_torch/csrc/binary.cu", "dirjax/ops/binary.py:357"
    # the main row is the asymmetric mode, which BinaryIndex serves by default
    entries = [
        {"name": "bits_finemax", "mode": "asym", "route": "cuda", "source": src,
         "replaces": replaces, "max_abs_err": err["asym"],
         "ms": timed["asym"][0], "plain_ms": timed["asym"][1],
         **bound(codes.numel() + q.numel() * 2 + out_bytes, 2 * products, "bf16"),
         "library_ms": None, "library_note": no_library,
         "sym_max_abs_err": err["sym"], "sym_ms": timed["sym"][0],
         "sym_plain_ms": timed["sym"][1],
         "sym_bound_ms": bound(codes.numel() + qb.numel() + out_bytes,
                               2 * products, "int8")["bound_ms"]},
        {"name": "bits_gather_scores", "route": "cuda", "source": src,
         "replaces": "dirjax/ops/binary.py:513 (_bits_finish_asym, XLA)",
         "max_abs_err": err["bits_gather_scores"],
         "ms": timed["rescore"][0], "plain_ms": timed["rescore"][1],
         **bound(nq * kf8 * nb + q.numel() * 2 + bids.numel() * 8 + nq * kf8 * 4,
                 2.0 * nq * kf8 * BITS, "bf16"),
         "library_ms": None, "library_note": no_library},
    ]
    del ops, q, bids
    return entries, db32, codec


# --- serving: IndexServer + Clients over the port's RetrievalIndex ----------

CLIENTS_PER_INDEX = 4
REQUESTS_PER_CLIENT = 6
SIGNATURES = {   # (k, options) each index is asked with
    "bf16": [(10, {}), (100, {}), (10, {"aqe": {"k": 10, "alpha": 3.0}})],
    "int8": [(10, {}), (100, {}), (100, {"int8_queries": True}),
             (10, {"aqe": {"k": 10, "alpha": 3.0}})],
    "binary": [(10, {}), (100, {})],
}


def same_answer(tag: str, got, want) -> None:
    """A served answer against the direct search: values within TOPK_ATOL
    (AQE's cuBLAS sums may round differently at another batch size), and a
    differing index only where it is tied within TOPK_ATOL."""
    (gv, gi), (wv, wi) = got, want
    if gv.shape != wv.shape or not np.abs(gv - wv).max() <= TOPK_ATOL:
        raise AssertionError(f"{tag}: scores differ from the direct search")
    for r, c in zip(*np.nonzero(gi != wi)):
        hit = np.nonzero(wi[r] == gi[r, c])[0]
        ref = wv[r, hit[0]] if len(hit) else wv[r, -1]
        if abs(gv[r, c] - ref) > TOPK_ATOL:
            raise AssertionError(f"{tag}: index {gi[r, c]} is no near-tie")


def serving_profile(indexes: dict, out_dir: str, card: str) -> None:
    """Where one direct search's time goes, per serving signature at nq = 1,
    16 and 64: host ms per search (5 searches, the result pull included) and
    the device time of each kernel in a torch.profiler trace of one more."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(6)
    rows = []
    for name, index in indexes.items():
        for k, opts in SIGNATURES[name]:
            for nq in (1, 16, 64):
                q = rng.standard_normal((nq, SERVE_D)).astype(np.float32)
                index.search(q, k=k, **opts)
                t0 = time.perf_counter()
                for _ in range(5):
                    index.search(q, k=k, **opts)
                host_ms = (time.perf_counter() - t0) / 5 * 1e3
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    index.search(q, k=k, **opts)
                trace = os.path.join(out_dir, "trace_search.json")
                prof.export_chrome_trace(trace)
                kernels = defaultdict(float)
                with open(trace) as f:
                    for e in json.load(f)["traceEvents"]:
                        if e.get("ph") == "X" and e.get("cat") in (
                                "kernel", "gpu_memcpy", "gpu_memset"):
                            kname = re.sub(r"^void |\(anonymous namespace\)::", "", e["name"])
                            kernels[kname.split("(")[0][:48]] += e["dur"] / 1e3
                top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:4])
                row = {"index": name, "k": k, "opts": opts, "nq": nq,
                       "host_ms": host_ms, "device_ms": sum(kernels.values()),
                       "top_device_ms": top}
                rows.append(row)
                print("serving profile: " + json.dumps(row))
    os.unlink(os.path.join(out_dir, "trace_search.json"))
    with open(os.path.join(out_dir, "serving_profile.json"), "w") as f:
        json.dump({"card": card, "rows": SERVE_N, "dim": SERVE_D, "searches": rows},
                  f, indent=1)


def serving_phase(device, db16: torch.Tensor, db32: torch.Tensor, codec,
                  profile_dir: str = "", card: str = "") -> dict:
    """The serving main path: concurrent Clients against an IndexServer per
    index; returns the launch counts of K2-K5 and the rescore during the
    traffic. With ``profile_dir``, also :func:`serving_profile`."""
    from dirjax_torch.ops import binary, topk
    from dirjax_torch.server import Client, IndexServer
    from dirjax_torch.serving import BinaryIndex, RetrievalIndex

    t0 = time.perf_counter()
    indexes = {"bf16": RetrievalIndex(db16, dtype=torch.bfloat16, device=device),
               "int8": RetrievalIndex(db16, dtype=torch.int8, device=device),
               "binary": BinaryIndex(db32, _codec=codec, device=device)}
    rng = np.random.default_rng(3)
    plan = {name: [[] for _ in range(CLIENTS_PER_INDEX)] for name in indexes}
    for name, per_client in plan.items():
        for reqs in per_client:
            for _ in range(REQUESTS_PER_CLIENT):
                k, opts = SIGNATURES[name][rng.integers(len(SIGNATURES[name]))]
                q = rng.standard_normal((int(rng.integers(1, 17)), SERVE_D))
                reqs.append(((q / np.linalg.norm(q, axis=1, keepdims=True))
                             .astype(np.float32), k, opts))
    for name, index in indexes.items():   # first calls: cuBLAS and allocator set-up
        for k, opts in SIGNATURES[name]:
            index.search(plan[name][0][0][0], k=k, **opts)
    torch.cuda.synchronize()
    print(f"serving: bf16 and int8 RetrievalIndex and {BITS}-bit asymmetric "
          f"BinaryIndex of {SERVE_N} x {SERVE_D} ready in "
          f"{time.perf_counter() - t0:.1f} s")

    def client_run(address, reqs):
        """This client's answers, and the host clock at the last of them."""
        with Client(address) as client:
            futs = [client.search_async(q, k=k, **opts) for q, k, opts in reqs]
            answers = [f.result(timeout=300) for f in futs]
            return answers, time.perf_counter()

    with tempfile.TemporaryDirectory(prefix="dirjax_torch_sock_") as sock_dir:
        servers = {name: IndexServer(index, os.path.join(sock_dir, f"{name}.sock"),
                                     max_batch=256, max_wait_ms=2.0, pipeline=3)
                   for name, index in indexes.items()}
        threads = [threading.Thread(target=srv.serve_forever, daemon=True)
                   for srv in servers.values()]
        for t in threads:
            t.start()
        try:
            for counts in (topk.launches, binary.launches):
                for key in counts:
                    counts[key] = 0
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(indexes) * CLIENTS_PER_INDEX) as pool:
                jobs = {(name, c): pool.submit(client_run, servers[name].address, reqs)
                        for name, per_client in plan.items()
                        for c, reqs in enumerate(per_client)}
                done = {key: job.result() for key, job in jobs.items()}
            answers = {key: got for key, (got, _) in done.items()}
            wall = max(last for _, last in done.values()) - t0
            launches = {**topk.launches, **binary.launches}
        finally:
            for srv in servers.values():
                with Client(srv.address) as c:
                    c.shutdown_server()
            for t in threads:
                t.join(timeout=60)
        if any(t.is_alive() for t in threads):
            raise AssertionError("an IndexServer did not shut down")

    rows = 0
    for (name, c), got in answers.items():
        for (q, k, opts), ans in zip(plan[name][c], got):
            same_answer(f"{name} k={k} {opts} nq={len(q)}", ans,
                        indexes[name].search(q, k=k, **opts))
            rows += len(q)
    for name, srv in servers.items():
        st, lat = srv.batcher.stats, srv.batcher.latency_stats()
        print(f"serving {name}: {st['requests']} requests, {st['rows']} query "
              f"rows in {st['batches']} batches; latency ms " +
              " ".join(f"{k[:-3]} {v:.2f}" for k, v in lat.items()))
    print(f"serving: {len(answers) * REQUESTS_PER_CLIENT} requests, {rows} query "
          f"rows from {len(answers)} concurrent clients in {wall:.3f} s = "
          f"{rows / wall:.1f} QPS (host clock); launches {launches}; every "
          "answer equals the direct search")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"the serving path launched {missing} no time")
    if profile_dir:
        serving_profile(indexes, profile_dir, card)
    return launches


def cli_phase(device, work: str) -> None:
    """``python -m dirjax_torch.index build --int8`` and ``build --binary
    2048``, each then ``query``, as subprocesses; their JSON must equal the
    in-process search."""
    from dirjax_torch.serving import RetrievalIndex

    descs, queries = (os.path.join(work, f) for f in ("db.npy", "q.npy"))
    np.save(descs, unit_rows(CLI_N, SERVE_D, device, seed=4).cpu().numpy())
    np.save(queries, unit_rows(37, SERVE_D, device, seed=5).cpu().numpy())
    for kind, flags in (("int8", ["--int8"]), ("binary", ["--binary", str(BITS)])):
        index_path = os.path.join(work, f"{kind}.npz")
        hits = os.path.join(work, f"{kind}.json")
        t0 = time.perf_counter()
        for argv in (["build", "--descs", descs, *flags, "--out", index_path],
                     ["query", "--index", index_path, "--descs", queries, "-k", "100",
                      "--out-json", hits]):
            subprocess.run([sys.executable, "-m", "dirjax_torch.index", *argv,
                            "--gpu", "0"], check=True, cwd=REPO, timeout=300)
        with open(hits) as f:
            got = json.load(f)
        vals, idxs = RetrievalIndex.load(index_path, device=device).search(
            np.load(queries), k=100)
        if got["scores"] != vals.tolist() or got["indices"] != idxs.tolist():
            raise AssertionError(f"index CLI answer ({kind}) differs from the "
                                 "in-process search")
        print(f"index CLI: build {' '.join(flags)} and query -k 100 on {CLI_N} x "
              f"{SERVE_D} in {time.perf_counter() - t0:.1f} s; JSON equals the "
              "in-process search")


def random_state_dict(model, seed: int) -> dict:
    """Seeded random weights in the reference's layout: He-normal convs
    (fan = k*k*cout), BN statistics near identity with the last BN of each
    residual branch scaled down (activations stay bounded through deep
    stacks, as in trained ResNets), uniform fc."""
    rng = np.random.default_rng(seed)
    last_bn = "bn2" if model.cfg.backbone.block == "basic" else "bn3"
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("running_mean"):
            v = rng.normal(0.0, 0.05, shape)
        elif name.endswith("running_var"):
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "adpool.p":
            v = np.full(shape, 3.0)
        elif name == "fc.weight":
            bound = shape[1] ** -0.5
            v = rng.uniform(-bound, bound, shape)
        elif name == "fc.bias":
            v = rng.normal(0.0, 0.01, shape)
        elif len(shape) == 4:
            v = rng.normal(0.0, math.sqrt(2.0 / (shape[2] * shape[3] * shape[0])),
                           shape)
        elif name.endswith(".weight"):  # BN scale
            lo, hi = (0.1, 0.3) if name.split(".")[-2] == last_bn else (0.8, 1.2)
            v = rng.uniform(lo, hi, shape)
        else:                             # BN shift
            v = rng.normal(0.0, 0.05, shape)
        sd[name] = v.astype(np.float32)
    return sd


def write_inputs(workdir: str, arch: str, image_size, n_classes: int,
                 per_class: int, n_junk: int, pca_rows: int, seed: int = 0):
    """Synthetic Revisited benchmark + native checkpoint with PCA 'smoke'."""
    from dirjax_torch.datasets import make_synthetic_benchmark
    from dirjax_torch.models import create_model
    from dirjax_torch.ops import fit_pca
    from dirjax_torch.utils.checkpoints import Checkpoint, load_state, save_native

    bench = os.path.join(workdir, "bench")
    make_synthetic_benchmark(os.path.join(bench, "revisited"), n_classes=n_classes,
                             per_class=per_class, n_junk=n_junk,
                             image_size=image_size, seed=seed)
    model = create_model(arch)
    load_state(model, random_state_dict(model, seed))
    vecs = np.random.default_rng(seed + 1).normal(size=(pca_rows, model.cfg.out_dim))
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ckpt = os.path.join(workdir, "model.npz")
    save_native(ckpt, Checkpoint(model=model, preprocess=model.cfg.preprocess,
                                 pca={"smoke": fit_pca(vecs)}))
    return bench, ckpt


def run_test_dir(bench: str, ckpt: str, gpu: int, bf16: bool, feats: str):
    """One test_dir run that saves its descriptors into ``feats``; returns
    (results, database descriptors, images, seconds)."""
    from dirjax_torch import datasets
    from dirjax_torch.cli.test_dir import main

    argv = ["--dataset", f"Synthetic('{bench}')", "--checkpoint", ckpt,
            "--gpu", str(gpu), "--whiten", "smoke",
            "--aqe", "10", "3", "--adba", "10", "3",
            "--save-feats", feats] + (["--bf16"] if bf16 else [])
    db = datasets.create(f"Synthetic('{bench}')")
    n_images = len(db) + len(db.get_query_db())
    if gpu >= 0:
        torch.cuda.synchronize()
    start = time.perf_counter()
    res = main(argv)
    if gpu >= 0:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    for k, v in res.items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"{k} = {v} is not a finite value in [0, 1]")
    if not any(k.startswith("mAP-") for k in res):
        raise AssertionError(f"no Revisited mAP in {res}")
    bdescs = np.load(os.path.join(feats, "feats.bdescs.npy"))
    norms = np.linalg.norm(bdescs, axis=1)
    if (bdescs.shape[0] != len(db) or not np.isfinite(bdescs).all()
            or np.abs(norms - 1).max() > 1e-4):
        raise AssertionError(f"bad database descriptors: shape {bdescs.shape}, "
                             f"norms {norms.min()}..{norms.max()}")
    return res, bdescs, n_images, seconds


def cpu_reference(bench: str, ckpt: str, n: int = N_REF) -> np.ndarray:
    """fp32 descriptors of the first ``n`` database images on the port's CPU
    path (plain PyTorch head), from the decoded images."""
    from dirjax_torch import datasets
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.utils.checkpoints import load_checkpoint

    db = datasets.create(f"Synthetic('{bench}')")
    images = np.stack([np.asarray(db.get_image(i).convert("RGB")) for i in range(n)])
    ck = load_checkpoint(ckpt)
    return FeatureExtractor(ck.model, "cpu", preprocess=ck.preprocess)(images).numpy()


def check_against_cpu(tag: str, got: np.ndarray, want: np.ndarray) -> float:
    """Cosine of the main path's descriptors against the CPU reference."""
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1)
                                        * np.linalg.norm(want, axis=1))
    print(f"main path {tag} vs cpu fp32, descriptors of {len(want)} database "
          f"images: cosine min {cos.min():.7f}, max_abs_err "
          f"{np.abs(got - want).max():.3e} (bound cosine > {COS_BOUND[tag]})")
    if got.shape != want.shape or not cos.min() > COS_BOUND[tag]:
        raise AssertionError(f"{tag} descriptors disagree with the CPU path: "
                             f"shape {got.shape} vs {want.shape}, cosine {cos}")
    return float(cos.min())


_K1_KERNELS = ("gem_pool_kernel", "project_kernel", "l2norm_kernel")
_CONV_OPS = ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution")


def device_breakdown(trace_path: str) -> dict:
    """Device time of a torch.profiler chrome trace, in ms: ``busy`` is the
    union of every kernel, copy and memset interval; the parts sum the
    intervals by kind. A kernel is K1 by name, a convolution when an aten
    convolution op launched it (cuDNN's GEMM, FFT and layout kernels), and
    elementwise when ATen's elementwise templates run it."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    parts = defaultdict(float)
    spans = []
    k1_launches = 0
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        name = e["name"]
        if cat != "kernel":
            kind = "copies"
        elif any(k in name for k in _K1_KERNELS):
            kind = "K1"
            k1_launches += "gem_pool_kernel" in name
        elif ops.get(e.get("args", {}).get("External id")) in _CONV_OPS:
            kind = "convolution"
        elif "elementwise" in name:
            kind = "elementwise"
        else:
            kind = "other"
        parts[kind] += e["dur"] / 1e3
    busy, reach = 0.0, -math.inf
    for lo, hi in sorted(spans):
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    return {"busy_ms": busy / 1e3, "k1_launches": k1_launches,
            **{f"{k}_ms": v for k, v in sorted(parts.items())}}


def profile_phase(bench: str, ckpt: str, device, out_dir: str, card: str):
    """Where a warm database extraction's time goes, fp32 and bf16."""
    from torch.profiler import ProfilerActivity, profile

    from dirjax_torch import datasets
    from dirjax_torch.extraction import FeatureExtractor, extract_image_features
    from dirjax_torch.utils.checkpoints import load_checkpoint

    os.makedirs(out_dir, exist_ok=True)
    db = datasets.create(f"Synthetic('{bench}')")
    batch = np.stack([np.asarray(db.get_image(i).convert("RGB")) for i in range(8)])
    summary = {"card": card, "images": len(db), "batch_size": 8}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        ck = load_checkpoint(ckpt)
        ex = FeatureExtractor(ck.model, device, dtype=dtype, preprocess=ck.preprocess)

        def extract() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            extract_image_features(db, "", ex)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        extract()  # warm-up: cuDNN picks its algorithms, the allocator fills
        walls = [extract(), extract()]
        torch.cuda.reset_peak_memory_stats(device)
        fwd_ms = _time_ms(lambda: ex(batch), iters=10)
        peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_wall = extract()
        trace = os.path.join(out_dir, f"trace_extract_{tag}.json")
        prof.export_chrome_trace(trace)
        b = device_breakdown(trace)
        row = {"wall_ms": walls, "img_per_s": [len(db) * 1e3 / w for w in walls],
               "forward_ms_per_batch": fwd_ms, "forward_img_per_s": 8e3 / fwd_ms,
               "peak_gib": peak_gib, "profiled_wall_ms": prof_wall,
               "idle_share": 1.0 - b["busy_ms"] / prof_wall, **b}
        summary[tag] = row
        print(f"profile {tag}: " + json.dumps(row))
    with open(os.path.join(out_dir, "profile_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", default="", metavar="DIR",
                        help="also profile an extraction; traces go to DIR")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import dirjax_torch  # noqa: F401  (fails outside the repository)
    from dirjax_torch.ops import gem_head

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)

    build_phase()
    entries = [kernel_phase(device)]
    topk_entries, db16 = topk_kernel_phase(device)
    binary_entries, db32, codec = binary_kernel_phase(device)
    serving_launches = serving_phase(device, db16, db32, codec, args.profile, card)
    del db16, db32
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="dirjax_torch_smoke_") as work:
        t0 = time.perf_counter()
        bench, ckpt = write_inputs(work, "resnet101_rmac", (1024, 768),
                                   n_classes=6, per_class=8, n_junk=4,
                                   pca_rows=4096)
        ref = cpu_reference(bench, ckpt)
        print(f"inputs and cpu reference in {time.perf_counter() - t0:.1f} s")
        from dirjax_torch.data import native
        print("host decode: " + ("native (g++ build of dirjax_torch/data/_native/"
                                 "native.cpp)" if native.available() else
                                 "PIL (the native decoder did not build)"))

        runs = {}
        gem_head.launches = 0
        for bf16 in (False, True):
            tag = "bf16" if bf16 else "fp32"
            before = gem_head.launches
            res, bdescs, n_images, sec = run_test_dir(
                bench, ckpt, 0, bf16, os.path.join(work, f"feats_{tag}"))
            if gem_head.launches <= before:
                raise AssertionError(f"{tag} test_dir run launched K1 no time")
            runs[tag] = (res, bdescs)
            print(f"main path {tag}: {json.dumps(res)}; {n_images} images in "
                  f"{sec:.2f} s = {n_images / sec:.1f} img/s (host clock, "
                  f"decode and first-call set-up included); K1 launches "
                  f"{gem_head.launches - before}")
        launches = gem_head.launches
        for tag, (_, bdescs) in runs.items():
            check_against_cpu(tag, bdescs[:N_REF], ref)

        cli_phase(device, work)
        if args.profile:
            profile_phase(bench, ckpt, device, args.profile, card)

    entries[0]["launches"] = launches
    for entry in topk_entries + binary_entries:
        entry["launches"] = serving_launches[entry["name"]]
    print(json.dumps({"kernels": entries + topk_entries + binary_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
