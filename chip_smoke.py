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
   input, within rtol 2e-4 / atol 2e-5, TF32 off; two calls give equal bits;
   timed with CUDA events against the plain version, masked fp32 and bf16,
   and its device time and CUDA launches a call from a torch.profiler trace.
3. fused conv — the bf16 inference convolution with its fused fp32
   epilogue (csrc/conv.cu) at every distinct convolution of
   resnet101_rmac, resnet101_fpn_rmac and resnext101_32x4d_rmac at batch
   8, 1024x768 (seeded random weights; each call recorded from one bf16
   FeatureExtractor forward), of the folded resnet101_rmac (bias-only
   epilogue) at the same size, and of the recall study's extract forward
   (batch 32 of its 224x224 scenes, a ragged last pixel tile): each R101
   forward launches it 104 times; each
   shape against its plain version (an fp32 convolution of the same bf16
   operands, TF32 off, and the same fp32 epilogue): no element further than
   2^-16 of the sum of its products' magnitudes (the order of the fp32 sums
   over K) plus, for a bf16 output, one bf16 ulp, and at most 2e-3 of a
   bf16 output's elements not equal (9.0e-4 measured at K = 4608); the
   largest fp32-output difference over its magnitude is printed, and the
   path each shape took (by the shape: wgmma, wgmma over a grouped conv's
   64-channel spans, the stem kernel, or mma.sync; every grouped and stem
   shape must take its own). Each affine R101 batch-8 shape (and ResNeXt's
   grouped ones) timed (CUDA events): the kernel on packed operands, its
   wrapper as the backbone calls it on its cached operands (in turns with
   the kernel), the plain version, cuDNN's bf16 conv2d of the same shape
   (the convolution alone: no PyTorch call computes it with the fp32
   epilogue), beside its bound, summed by layer class (3x3 256-channel,
   1x1 with the residual, 1x1 reduce, downsample, stem, grouped; the
   grouped class both one shape of each and weighted by its count in a
   ResNeXt forward); then the R101 bf16 backbone, BN-affine and folded,
   against today's route (cuDNN bf16 convolutions and the eager fp32 chain,
   grad_safe) on the same weights, in turns, each backbone's device
   launches (a torch.profiler trace), and the whole bf16 extractor forward.
   ``--conv-only`` runs the build and this phase alone, and ``--tree DIR``
   runs them on the dirjax_torch of DIR (a ``git archive`` of another
   commit): one process a tree, parent / this / this / parent, times two
   trees' kernels in turns on one card.
4. top-k kernels — K2-K4 (csrc/topk.cu) against their plain versions at the
   serving shape: 1,048,576 seeded random unit rows of 2048 (fp32, bf16,
   int8 with per-row scales), nq = 256, 37, 1, 16, 24 and 100 (every query
   width of the tensor-core kernels: 8, 16, 32, 64, 128 and 256), and a
   ragged 1,048,573 rows. K2 at k = 10 on fp32 and bf16; K3 and K4 on fp32,
   bf16, int8 and int8 x int8 queries; fp32 also with self-match queries
   (database rows, nq = 256 and 16). Scores within atol 1e-5 (int8 x int8
   exactly equal), an index may differ only at a near-tie within 1e-5; K4's
   maximum over each fetched block equals K3's bit for bit; rank_topk_fused
   against a dense plain top-k (k = 10 and 100). Each kernel timed against
   its plain version with CUDA events, plain/kernel/kernel/plain, and a
   bf16 torch.matmul of the same operands timed as the library yardstick;
   K2 and K3 also at nq = 16, 1, 64 and 128 (bf16) and in fp32 (the split
   mode) at nq = 256 and 16 beside an fp32 torch.matmul (TF32 off), K3 in
   int8 x bf16 and int8 x int8 at nq = 256 and 16, K2 at k = 1 and 16,
   each beside its bound and each first held against its plain version;
   K4 also in fp32 at k = 100.
   Then rank_topk_fused's two routes at k = 10 (K2 and the merge, against
   K3 + select + K4 + finish) timed at nq = 1, 16 and 256, and the AQE
   chunk's exact top-k (nq x 131,072 scores, k = 10, ties to the lower
   index) by the full stable sort the port runs against torch.topk with a
   tie fill, at nq = 16, 64 and 256.
5. binary kernels — K5 and its asymmetric rescore (csrc/binary.cu, on the
   tensor-core routine of csrc/tc_score.cuh) at the serving shape: the
   same 1,048,576 rows, an ITQ codec fitted on the card (131,072-row
   sample, 30 iterations; the fit time is printed) and 2048-bit codes. K5
   symmetric (exactly equal) and asymmetric (within 1e-5) against their
   plain versions at nq = 256, 37 and 1 and on a ragged 1,048,573 rows; the
   rescore within 1e-5 of its plain version, its block maxima equal to
   K5's bit for bit; hamming_search_fused at k = 10 and 100 against a dense
   plain top-k (values, and no returned row outside the plain set but at a
   near-tie). K5 timed in both modes at nq = 256, 16 and 1, and the
   rescore at k = 100 and nq = 256 and 16, each against its plain version
   with CUDA events, plain/kernel/kernel/plain, each reading first held
   against the plain version.
6. PQ/IVF kernels — K6 and its rescore (csrc/pq.cu) on the same rows:
   m = 32 codebooks at ksub 16 and 256 trained on the card from a
   262,144-row sample, and OPQ once (the fit times are printed); K6 and the
   rescore against their plain versions at nq = 256, 37 and 1, on
   1,048,573 rows too, fp32 and bf16 tables, blocks 64 (ksub 16) and 8
   (ksub 256): both exactly equal in all 12 cases (the number of cases is
   printed), the rescore's block maxima equal to K6's bit for bit; pq_topk
   at k = 10 and 100 against a dense plain ADC top-k; an IVF (nlist 1024)
   whose ivf_topk at nprobe = nvlist, per query and union, is held to the
   dense plain ADC over reconstructions. K6 timed at ksub 16 and 256, fp32
   and bf16 tables, nq = 256 and 16 (each reading first held to exact
   equality with the plain version), and the rescore at PQ phase C (nq =
   256, k = 100: ksub 16, and ksub 256 at block 8 with fp32 and bf16 tables;
   nq = 16, k = 10) and IVF's phase A (16 queries' first 128 probed slabs of
   64 rows), each first held to exact equality, against their plain
   versions with CUDA events, plain/kernel/kernel/plain, and at its device
   time in a torch.profiler trace (at these sizes events around
   back-to-back calls measure the host's launch rate); one
   embedding_bag (the ADC scores of all queries) is K6's library yardstick
   at each ksub and nq. K6's and the rescore's entries also carry their
   lookup floor: their table lookups at 32 a clock on each SM, at the card's
   maximum SM clock.
7. concurrent launches — K6 (resident tables: m 8 and 64 at ksub 16;
   streamed: ksub 256 and 100 at m 32), the ADC rescore (m 64, ksub 256,
   kf 100, nq 1 and 256), K1 (C 1024 and 2048 at the main-path shape) and
   the fused conv (its wgmma and mma.sync paths), each from 8 host threads
   at once, 50 launches a thread alternating the two shapes, whose dynamic
   shared memory differs, on 1,048,576 rows; every launch must succeed and
   every answer equal the plain version (the conv: its own single-thread
   answer, itself within its bounds of the plain version).
8. serving — RetrievalIndex in bf16 and in int8 over the same rows, a
   BinaryIndex (asymmetric) over their 2048-bit codes, a PQIndex (m = 32,
   ksub 16, int8 rerank) and the IVFPQIndex (nprobe 8), each behind the
   port's IndexServer (dirjax_torch.server) on a Unix socket; several
   Clients send concurrent requests of 1-16 queries at k = 10 (K2; binary:
   K5 + rescore) and k = 100 (K3 + K4), int8 with and without int8_queries,
   AQE, and PQ/IVF (K6 + its rescore; IVF probing 8 or 16 cells). The
   launch counters of K2-K6 and the rescores are zeroed just before and
   must have risen just after; every answer must equal the index's own
   direct search (values within 1e-5, an index differing only at a
   near-tie). Requests, batches, latency percentiles and QPS are printed
   as information. Then a DynamicBatcher with upload_bf16 over the bf16
   RetrievalIndex and over a PQIndex of the same codebooks without rerank
   (ADC scores, as dirjax's upload test), with ml_dtypes made unimportable,
   against the fp32-upload batcher on the same burst (8 client threads):
   bf16 indices equal and values within rtol 1e-6, PQ values within 0.02;
   the kernels' counters must rise; each burst's QPS and latency printed.
9. sharded — the mesh paths of dirjax_torch.parallel at world 1 (NCCL in
   this process over a FileStore, make_mesh(1, 1)) on the same rows, codes
   and IVF: sharded_topk on bf16 and int8 rows (nq 256 and 16, k 10 and
   100, int8 with and without quantized queries) and fp32 at nq 16, each
   bit for bit the single-device rank_topk_fused; sharded_hamming_topk
   (symmetric, and a rerank_factor-4 shortlist rescored with the projected
   queries), sharded_pq_topk and sharded_ivf_topk at full probe, bit for bit
   the single-device functions; sharded_scores against one matmul and
   sharded_aqe against expand_queries_chunked / expand_queries_quantized
   (1e-5); RetrievalIndex (bf16, int8), BinaryIndex (symmetric) and PQIndex
   (int8 rerank) with mesh= equal to the index without it after add,
   remove and compact. The launch counters of K2-K6 and the ADC rescore,
   zeroed first, must rise (the single-device references run uncounted).
   ShardedExtractor against FeatureExtractor on resnet101_rmac, 1024x768,
   batch 8 (fp32 within 1e-6, bf16 cosine > 0.999; K1's launches), the
   sharded train step at (1, 1) against the unsharded one (resnet101_rmac
   224x224, SGD, batch 16 and two-pass 64 / 16: loss within 1e-5, weights
   within rtol 2e-4 / atol 2e-5), each pair timed in turns; then the train
   CLI with --mesh 1,1 --ckpt-format orbax under torch.distributed.run for
   2 epochs, and --resume from its directory for a third in this process.
   One "sharded:" JSON line of readings.
10. fit_pca_device — 1,048,576 x 2048 seeded unit rows (8 GiB fp32) in
   131,072-row chunks on the card; its time (host clock), and against an
   fp64 accumulation of the same chunks on the card: the covariance's
   relative error (at most 1e-5), the first 64 components' |cos| (at least
   1 - 1e-6) and their variances' relative error.
11. main path — a synthetic Revisited benchmark at 1024x768 and a
   resnet101_rmac (2048-D) checkpoint with seeded random weights and a fitted
   PCA go through ``dirjax_torch.cli.test_dir.main`` with whitening and
   AQE/ADBA, once in fp32 and once with --bf16. K1's launch counter must rise
   in each run. The database descriptors each run saves (--save-feats) must
   be finite unit vectors, and those of the first 4 images must match the
   port's fp32 CPU path: cosine > 0.9999 for the fp32 run, > 0.999 for the
   bf16 one; the fused conv launches in the bf16 run only, 104 a forward.
   The mAPs are only checked to be finite in [0, 1]: the synthetic
   classes differ by colour, so even random weights rank them perfectly and
   mAP = 1 says nothing about the path. Prints which host decoder ran (the
   native one, or PIL where it cannot build). Then FeatureExtractor's
   pinned upload on a bf16 batch of 8 of these images: three calls (the
   batch, it flipped, a masked batch), each in a fresh page-locked array,
   issued while a sleep kernel holds the stream give descriptors bit for bit
   those of a pageable upload, the ``extraction.staged_*`` counters rise by
   the calls and bytes, and the batch's pinned non-blocking copy is timed
   against the pageable one (CUDA events, in turns, GB/s).
12. main path of the other heads — resnet101_fpn_rmac (FPN, 3072-D) and
   resnext101_32x4d_rmac the same way on a smaller benchmark (16 images),
   each with its own seeded checkpoint: K1 launches above 0 for ResNeXt and
   none for the FPN head (as dirjax gates it), the same cosine bounds, and
   each forward's ms per batch of 8 (CUDA events), fp32 and bf16. Then
   dinov2_vitl14_reg_rmac (DINOv2 ViT-L/14, 4 registers) at its published
   widths: a bf16 FeatureExtractor forward at 1022x770 against the plain
   fp32 forward of tests/plain_vit_gem.py (within 0.03), its 24 attention
   calls on cuDNN's fused kernel (no softmax kernel of the math backend), a
   head the pinned backend refuses raising, and the batch-8 forward's ms;
   its 49 calls (2 * 24 + 1) of the fused LayerScale residual update and
   LayerNorm (csrc/residual_norm.cu; no addcmul or LayerNorm kernel in the
   profile), and that kernel at (8, 4,020, 1,024) with a bf16 branch and
   output against the plain composition (addcmul_, layer_norm, .to: a few
   fp32 ulps on the stream, at most 1e-3 of the bf16 outputs one ulp
   apart), timed with CUDA events in turns with it (`library_ms`) beside
   its 395 MB at 3.35 TB/s (`hbm_pct`).
13. folded BN — resnet101_rmac with every BN folded into its conv
   (fold_batchnorm) against the BN-affine model on 8 database images:
   cosine against the affine fp32 forward (fp32 > 0.9999, bf16 > 0.999),
   K1 launches above 0, forward ms per batch of 8 in fp32 and bf16, timed
   in turns affine/folded/folded/affine.
14. CLI chain — ``extract_features`` -> ``fit_whitening --device-fit``
   (into a .pt) -> ``test_dir --whiten`` on the card; the saved
   descriptors must equal an in-process extraction bit for bit.
15. index CLI — ``python -m dirjax_torch.index build --int8``, ``build
   --binary 2048``, ``build --pq 32`` and ``build --ivf 1024``, each then
   ``query -k 100 --gpu 0``, as subprocesses on 65,536 rows (the four
   chains at once); each JSON answer must equal the in-process search
   exactly.

16. training — resnet101_rmac (2048-D) at 224x224 from seeded random
   weights: the card's AP loss and full gradient (batch 4, two classes)
   against the port's CPU path, fp32 (loss within 1e-5, gradient cosine >
   0.9999) and bf16 (loss within 1e-2, cosine > 0.9: train_bf16_study.py
   puts dirjax's own bf16 gradient near 0.96); the two-pass step (batch 16,
   microbatch 4) against the whole-batch step after one SGD step (loss
   1e-5, weights atol 1e-5 / rtol 1e-4); step ms (CUDA events), img/s,
   peak memory and MFU, fp32 and bf16, whole-batch at batch 16 and
   two-pass at batch 64 / microbatch 16; then ``dirjax_torch.cli.train``
   on a synthetic labeled set (2 epochs x 3 steps with a benchmark
   evaluated each epoch, then --resume for a third): finite losses, BN
   unchanged, K1 launched in the evaluations and never in a train step,
   the resumed run at epoch 2 with the saved optimizer count, and test_dir
   on the last checkpoint.
17. recall study — ``dirjax_torch.recall_study`` in-process on the card:
   ``train`` (resnet101_rmac, 400 steps of batch 16 = 4 classes x 4 views,
   256 classes, 224x224, plain Adam on every tensor, bf16), ``extract`` from
   its checkpoint (16,384 generated scenes and 256 query views, batch 32,
   bf16 forward: K1) and ``evaluate`` of every tier group (whitening with
   dead_floor 1e-7; int8 on K3 + K4, PQ/OPQ and IVF on K6 and the ADC
   rescore, ITQ on K5 and the binary rescore). The stage's own
   src_is_top1 gate must pass, every tier name and key of dirjax's evaluate
   must be there, int8 recall@10 >= 0.95, and the launch counters of K1,
   K3, K4, K5, K6 and the two rescores, zeroed first, must rise. Then on the
   first 4,096 rows of the same file: ``evaluate --tiers "int8|pq_m|ivf"`` on
   the card and with ``--cpu`` (their largest recall difference printed:
   the same seed trains other quantizers on each device, fp32 k-means sums
   in another order), and the card's search against the CPU's on the same
   indexes (int8, PQ ksub 16 with rerank 2/4/8 and ksub 256, OPQ, IVF at
   ksub 16 and 256 over the study's nprobes, ITQ-512 asym and Hamming;
   built on the card, saved, loaded on the CPU): every recall@k within
   0.005. Printed as information: each stage's wall,
   extraction img/s (host clock), the fine-tune's first and last 25-step AP
   loss, the spectrum, every tier's recall, and one ksub-256 IVF search
   (nq 256, k 10, nprobe 4 and 16; CUDA events, ms and QPS).

    python3 chip_smoke.py --profile DIR   # also phase 18

18. profile — where a warm database extraction's time goes, fp32 and bf16:
   unprofiled wall (host clock), forward ms per batch of 8 (CUDA events) and
   peak memory, and a torch.profiler trace whose device intervals are merged
   into busy time and split into convolution, elementwise, copies, K1 and
   other. Writes the traces and ``profile_summary.json`` into DIR. And where
   one direct search's time goes, per serving signature at nq = 1, 16 and
   64: host ms per search and device ms by kernel
   (``serving_profile.json``).

Each phase prints ``chip_smoke: phase <name>`` as it starts; on any
exception the script prints ``chip_smoke: phase <name> failed: <error>``,
the traceback on stderr, and exits 1. No check gates on a time.
Prints the card's name and power limit, then one JSON line with each
kernel's launches on the main paths, error against its plain version, time,
its plain version's time, its bound (the larger of its bytes over 3.35 TB/s
and its operations over the peak rate of their type on an H100 SXM) and the
time of one PyTorch call that computes the same function, where there is
one (launches summed over the paths that ran each kernel, with
``launches_by_path``: K1's extraction paths, the others' serving and
sharded phases, and every kernel's "recall study"); and last a JSON line
with "ok": true. Exits
non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from collections import Counter, defaultdict
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
# the fp32 mode of the top-k kernels: each product as four bf16 products
# (hi.hi + hi.lo + lo.hi + lo.lo of two-part bf16 splits), on the tensor cores
FP32_SPLIT = "4x bf16 split"
FP32_SPLIT_PRODUCTS = 4
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


def card_sms_and_clock():
    """(SM count, maximum SM clock in Hz) of card 0: the clock as nvidia-smi
    reports it (clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60)
    return (torch.cuda.get_device_properties(0).multi_processor_count,
            float(out.stdout.strip().splitlines()[0]) * 1e6)


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
    xb = x.to(torch.bfloat16)
    for tag, xin in (("fp32", x), ("bf16", xb)):   # a sum in a fixed order: equal bits
        if not torch.equal(gem_head.fused_gem_head(xin, p, w, b, mask=mask),
                           gem_head.fused_gem_head(xin, p, w, b, mask=mask)):
            raise AssertionError(f"gem_head {tag}: two calls differ")
    ms, plain_ms = time_in_turns(
        f"gem_head {MAIN_SHAPE}->{MAIN_D} masked fp32",
        lambda: gem_head.gem_head_reference(x, mask, p, w, b),
        lambda: gem_head.fused_gem_head(x, p, w, b, mask=mask))
    # the bf16 reading, first held against the plain version
    torch.testing.assert_close(gem_head.fused_gem_head(xb, p, w, b, mask=mask),
                               gem_head.gem_head_reference(xb.float(), mask, p, w, b),
                               rtol=RTOL, atol=ATOL)
    bf16_ms, bf16_plain_ms = time_in_turns(
        f"gem_head {MAIN_SHAPE}->{MAIN_D} masked bf16",
        lambda: gem_head.gem_head_reference(xb.float(), mask, p, w, b),
        lambda: gem_head.fused_gem_head(xb, p, w, b, mask=mask))
    B, H, W, C = MAIN_SHAPE
    rest = 4 * (w.numel() + b.numel() + B * MAIN_D) + mask.numel()
    ops = 3 * x.numel() + 2 * B * C * MAIN_D   # pow, mean, root; then the FC
    bf16 = bound(2 * x.numel() + rest, ops, "fp32")
    kernels = cuda_kernels_of(lambda: gem_head.fused_gem_head(x, p, w, b, mask=mask))
    print(f"gem_head: CUDA launches a call (torch.profiler): {kernels}")
    dev_ms = {tag: device_ms(lambda: gem_head.fused_gem_head(xin, p, w, b, mask=mask))
              for tag, xin in (("fp32", x), ("bf16", xb))}
    print(f"gem_head device ms a call (torch.profiler): {dev_ms}")
    return {"name": "gem_head", "route": "cuda",
            "source": "dirjax_torch/csrc/gem_head.cu",
            "replaces": "dirjax/ops/gem_head.py:45",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **bound(4 * x.numel() + rest, ops, "fp32"), "library_ms": None,
            "library_note": NO_LIBRARY + " (masked GeM, FC and L2 in one pass)",
            "bf16_ms": bf16_ms, "bf16_plain_ms": bf16_plain_ms,
            "bf16_bound_ms": bf16["bound_ms"], "bf16_bound_by": bf16["bound_by"],
            "device_ms": dev_ms["fp32"], "bf16_device_ms": dev_ms["bf16"],
            "cuda_launches_per_call": None if kernels is None else len(kernels)}


# --- the fused-epilogue convolution of the bf16 inference backbones ----------

CONV_ARCHS = ("resnet101_rmac", "resnet101_fpn_rmac", "resnext101_32x4d_rmac")
CONV_IMAGES = (8, 768, 1024)    # batch 8 of 1024x768 landscape images
R101_CONVS = 104                # stem + 33 bottlenecks x 3 + 4 downsamples
# a bf16 output may differ from the plain version's in this share of its
# elements, each by at most one bf16 ulp (plus the sums' order): an fp32 sum
# taken in another order crosses a bf16 rounding boundary only where it lies
# within its rounding error (~sqrt(K) fp32 ulps) of one; measured 9.0e-4 at
# R101's K = 4608 3x3s, 4.2e-4 at K = 2048, less below (NVIDIA H100, two
# runs); the bound leaves room for cuDNN summing the plain version in
# another order
CONV_BF16_APART = 2e-3
CONV_ARGS = ("x", "weight", "stride", "padding", "groups", "scale", "shift", "residual", "relu",
             "out_dtype")


@contextlib.contextmanager
def recorded_convs(calls: list):
    """Every fused conv the backbones and the FPN merge run inside the block
    (``fused_conv_packed`` on each convolution's packed operands), appended
    to ``calls`` as ``fused_conv``'s arguments (CONV_ARGS) with the packed
    operands under "packed"."""
    import inspect

    from dirjax_torch.models import resnet
    from dirjax_torch.ops import conv

    real, sig = conv.fused_conv_packed, inspect.signature(conv.fused_conv_packed)

    def record(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        a, packed = dict(bound.arguments), bound.arguments["weights"]
        calls.append({"x": a["x"], "weight": packed["weight"], "stride": a["stride"],
                      "padding": a["padding"], "groups": packed["groups"],
                      "scale": packed["scale"], "shift": packed["shift"],
                      "residual": a["residual"], "relu": a["relu"],
                      "out_dtype": a["out_dtype"], "packed": packed})
        return real(*args, **kw)

    resnet.fused_conv_packed = record
    try:
        yield
    finally:
        resnet.fused_conv_packed = real


def check_conv_launches(label: str, launches: int, bf16: bool, per_forward=None) -> None:
    """A bf16 inference run goes through the fused conv (whole forwards of
    ``per_forward`` launches each, where given); an fp32 one never does."""
    if not bf16:
        if launches:
            raise AssertionError(f"{label}: the fp32 run launched the fused conv {launches} "
                                 "times")
        return
    if not launches or (per_forward and launches % per_forward):
        raise AssertionError(f"{label}: the bf16 run launched the fused conv {launches} times"
                             + (f", not a multiple of {per_forward}" if per_forward else ""))


def conv_key(a: dict) -> tuple:
    """A conv call's shape and epilogue."""
    def kind(t):
        return None if t is None else str(t.dtype).replace("torch.", "")

    return (tuple(a["x"].shape), kind(a["x"]), tuple(a["weight"].shape), a["stride"],
            a["padding"], a["groups"], a["scale"] is not None, a["shift"] is not None,
            kind(a["residual"]), a["relu"], str(a["out_dtype"]).replace("torch.", ""))


def conv_bound(a: dict) -> dict:
    """bytes: the input (bf16, or fp32 where the stem path reads it so) and
    the weights, the per-channel vectors and the residual read once, the
    output written once; operations: 2 * M * cout * kh * kw * cin / groups,
    bf16 on the tensor cores."""
    B, cin, H, W = a["x"].shape
    cout, cin_g, kh, kw = a["weight"].shape
    ho = (H + 2 * a["padding"] - kh) // a["stride"] + 1
    wo = (W + 2 * a["padding"] - kw) // a["stride"] + 1
    out_bytes = 2 if a["out_dtype"] == torch.bfloat16 else 4
    x_bytes = 4 if a["x"].dtype == torch.float32 and conv_class(a) == "stem" else 2
    nbytes = (B * H * W * cin * x_bytes + cout * kh * kw * cin_g * 2
              + B * ho * wo * cout * out_bytes
              + 4 * cout * ((a["scale"] is not None) + (a["shift"] is not None)))
    if a["residual"] is not None:
        nbytes += a["residual"].numel() * a["residual"].element_size()
    ops = 2.0 * B * ho * wo * cout * kh * kw * cin_g
    return {"bytes": nbytes, "ops": ops, **bound(nbytes, ops, "bf16")}


def check_conv(a: dict) -> dict:
    """The kernel on a recorded call's operands against conv_reference (TF32
    off): no element beyond the sums' order (SUM_ORDER_RTOL of its
    magnitude; a bf16 output also one ulp), at most CONV_BF16_APART of a
    bf16 output's elements not equal."""
    from dirjax_torch.ops import conv

    args = {k: a[k] for k in CONV_ARGS}
    got = conv.fused_conv(**args)
    want = conv.conv_reference(**args)
    mag = conv.reference_magnitude(a["x"], a["weight"], a["stride"], a["padding"],
                                   a["groups"], a["scale"])
    agree = conv.agreement(got, want, mag)
    if got.shape != want.shape or got.dtype != want.dtype or agree["over"] > 0 or (
            got.dtype == torch.bfloat16 and agree["apart"] > CONV_BF16_APART):
        raise AssertionError(f"fused conv {conv_key(a)} disagrees with its plain version: "
                             f"{agree}")
    return agree


def conv_kernel_path(a: dict) -> str:
    """The path the kernel takes for a recorded call (``kernel_path`` of the
    tree under test; a tree from before the stem and span paths names its
    path by the channels alone)."""
    from dirjax_torch.ops import conv

    cout, cin_g, kh, kw = a["weight"].shape
    cin = cin_g * a["groups"]
    if not hasattr(conv, "conv_path"):
        return conv.kernel_path(cin, cout, a["groups"])
    path = conv.kernel_path(cin, cout, a["groups"], kh, kw, a["stride"])
    if path != conv.conv_path(cin, cout, a["groups"], kh, kw, a["stride"]):
        raise AssertionError(f"fused conv {conv_key(a)}: the library takes {path}, the "
                             "wrapper packs for another path")
    return path


def conv_class(a: dict) -> str:
    """The layer class of a recorded conv, as PERF.md groups them."""
    cout, cin_g, kh, _ = a["weight"].shape
    if a["groups"] > 1:
        return "grouped 3x3"
    if kh == 7:
        return "stem"
    if a["out_dtype"] == torch.float32 and a["residual"] is None and a["relu"] == "none":
        return "downsample"
    if kh == 3:
        return "3x3 256-ch" if (cin_g, cout, a["stride"]) == (256, 256, 1) else "3x3 other"
    if a["residual"] is not None:
        return "1x1 + residual"
    return "1x1 reduce"


def conv_shape_row(key: tuple, entry: dict, totals: dict, classes: dict) -> dict:
    """One recorded shape: checked against the plain version, with the path
    it took; an R101 shape (and ResNeXt's grouped ones, for their class) also
    timed: the kernel on packed operands, its wrapper as the backbone calls
    it (``fused_conv_packed`` on the cached weights, so the input's layout
    and the output's allocation only), the plain version, cuDNN's bf16
    conv2d; an R101 shape's times times its count added to ``totals`` and
    to its class in ``classes``."""
    import torch.nn.functional as F

    from dirjax_torch.ops import conv

    a = entry["args"]
    args = {k: a[k] for k in CONV_ARGS}
    agree = check_conv(a)
    cout, cin_g = a["weight"].shape[:2]
    shape = {"arch": entry["arch"], "x": list(key[0]), "x_dtype": key[1],
             "weight": list(key[2]), "stride": key[3], "padding": key[4],
             "groups": key[5], "epilogue": {"scale": key[6], "shift": key[7],
                                            "residual": key[8], "relu": key[9],
                                            "out": key[10]},
             "class": conv_class(a), "path": conv_kernel_path(a),
             "count": entry["count"], **agree, **conv_bound(a)}
    r101 = entry["arch"] == "resnet101_rmac"
    if r101 or (shape["class"] == "grouped 3x3" and entry["arch"].startswith("resnext")):
        packed = conv.pack(**args)
        xb = a["x"].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wb = a["weight"].detach().to(torch.bfloat16)
        ms, plain_ms = time_in_turns(f"fused conv {key}", lambda: conv.conv_reference(**args),
                                     lambda: conv.run_packed(packed), iters=10)
        # the wrapper in turns with the kernel alone: what it adds per call
        wrapper_ms, _ = time_in_turns(f"fused conv wrapper {key}",
                                      lambda: conv.run_packed(packed),
                                      lambda: conv.fused_conv_packed(
                                          a["x"], a["packed"], a["stride"], a["padding"],
                                          a["residual"], a["relu"], a["out_dtype"]), iters=10)
        shape.update(ms=ms, plain_ms=plain_ms, wrapper_ms=wrapper_ms,
                     library_ms=_time_ms(lambda: F.conv2d(xb, wb, None, a["stride"],
                                                          a["padding"], 1, a["groups"]),
                                         iters=10))
        n = entry["count"] if r101 else 1
        row = classes.setdefault(shape["class"], defaultdict(float))
        row["count"] += n
        row["path"] = shape["path"]
        for k in ("ms", "wrapper_ms", "library_ms", "bound_ms"):
            row[k] += n * shape[k]
            if not r101:   # ResNeXt's grouped shapes: also weighted by their count a forward
                row[f"forward_{k}"] += entry["count"] * shape[k]
        if not r101:
            row["forward_count"] += entry["count"]
        if r101:
            for k in ("ms", "plain_ms", "wrapper_ms", "library_ms", "bytes", "ops"):
                totals[k] += entry["count"] * shape[k]
            totals["bound_sum_ms"] += entry["count"] * shape["bound_ms"]
    return shape


def fused_conv_phase(device) -> dict:
    """The bf16 inference convolutions (csrc/conv.cu) at every distinct
    shape of resnet101_rmac, resnet101_fpn_rmac and resnext101_32x4d_rmac at
    batch 8, 1024x768 (recorded from one FeatureExtractor forward each,
    seeded random weights), of the folded resnet101_rmac (fold_batchnorm:
    the bias-only epilogue) at the same size, and of the recall study's
    extract forward (resnet101_rmac, a batch of 32 of its 224x224 scenes:
    the 7x7 stage's 1,568 pixels leave a ragged 128-pixel tile): each
    against its plain version, with its path, each R101 forward's launches
    (104), each affine R101 batch-8 shape's kernel time (CUDA events, on
    the packed operands; the wrapper on the backbone's cached operands in
    turns with it), its plain version's, cuDNN's bf16 conv2d of the same
    shape (the library yardstick for the convolution alone: no PyTorch call
    computes it with the fp32 epilogue) and its bound, summed by class
    (ResNeXt's grouped shapes timed for theirs); then the bf16 backbone of
    R101, BN-affine and folded, against today's route (grad_safe: cuDNN
    bf16 convolutions and the eager fp32 chain) on the same weights, in
    turns, with its device launches. Returns the kernels-line entry without
    ``launches``."""
    from dirjax_torch import recall_study as RS
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import create_model, fold_batchnorm
    from dirjax_torch.ops import conv
    from dirjax_torch.utils.checkpoints import load_state

    t0 = time.perf_counter()
    images = np.random.default_rng(50).integers(0, 256, size=(*CONV_IMAGES, 3), dtype=np.uint8)
    shapes, row = {}, {"per_arch_launches": {}}
    models = {}

    def record(label: str, forward, convs=None) -> None:
        """The fused_conv calls of one bf16 forward, each distinct shape kept."""
        calls = []
        conv.launches = 0
        with recorded_convs(calls), torch.inference_mode():
            forward()
        torch.cuda.synchronize()
        row["per_arch_launches"][label] = conv.launches
        if conv.launches != len(calls) or (convs and conv.launches != convs):
            raise AssertionError(f"fused conv: {label}'s bf16 forward launched the kernel "
                                 f"{conv.launches} times for {len(calls)} convolutions")
        for a in calls:
            entry = shapes.setdefault(conv_key(a), {"arch": label, "args": a, "count": 0})
            entry["count"] += label == entry["arch"]

    for arch in CONV_ARCHS:
        model = create_model(arch)
        load_state(model, random_state_dict(model, 51))
        ex = FeatureExtractor(model, device, dtype=torch.bfloat16)
        record(arch, lambda: ex(images), R101_CONVS if arch == "resnet101_rmac" else None)
        models[arch] = (model, ex)
    r101 = models["resnet101_rmac"][0]
    folded = fold_batchnorm(r101)
    folded_ex = FeatureExtractor(folded, device, dtype=torch.bfloat16)
    record("resnet101_rmac folded", lambda: folded_ex(images), R101_CONVS)
    # the recall study's extract: model(scenes NCHW, dtype=bf16), batch 32 at 224x224
    scenes = RS.db_scenes(0, 32, 224, 224, device).permute(0, 3, 1, 2)
    record("resnet101_rmac recall study", lambda: r101(scenes, dtype=torch.bfloat16),
           R101_CONVS)
    print(f"fused conv: launches a bf16 forward {json.dumps(row['per_arch_launches'])}; "
          f"{len(shapes)} distinct shapes; recorded in {time.perf_counter() - t0:.1f} s")

    saved, per_shape = conv.launches, []
    totals, classes = defaultdict(float), {}
    worst, worst_rel, worst_apart = 0.0, 0.0, 0.0
    for key, entry in shapes.items():
        with torch.inference_mode():   # the recorded weights are parameters
            shape = conv_shape_row(key, entry, totals, classes)
        worst = max(worst, shape["max_abs_err"])
        worst_rel = max(worst_rel, shape["max_rel"] or 0.0)
        worst_apart = max(worst_apart, shape["apart"] if key[10] == "bfloat16" else 0.0)
        per_shape.append(shape)
        if "ms" in shape:
            print(f"fused conv {shape['x']} x {shape['weight']} stride {shape['stride']} "
                  f"[{shape['path']}, {shape['class']}], {shape['count']} a forward: kernel "
                  f"{shape['ms']:.4f} ms (wrapper {shape['wrapper_ms']:.4f}), plain "
                  f"{shape['plain_ms']:.4f}, cuDNN {shape['library_ms']:.4f}, bound "
                  f"{shape['bound_ms']:.4f} ({shape['bound_by']}); apart {shape['apart']:.2e}")
    conv.launches = saved
    paths = defaultdict(int)
    for shape in per_shape:
        paths[shape["path"]] += 1
    print("fused conv shapes: " + json.dumps(per_shape))
    print(f"fused conv paths: {json.dumps(dict(paths))} of {len(per_shape)} distinct shapes")
    for name, c in sorted(classes.items()):
        print(f"fused conv class {name} ({c['path']}), {int(c['count'])} convs "
              f"{'of one R101 forward' if name != 'grouped 3x3' else 'of ResNeXt (one each)'}: "
              f"kernel {c['ms']:.4f} ms (wrapper {c['wrapper_ms']:.4f}), cuDNN "
              f"{c['library_ms']:.4f}, bounds summed {c['bound_ms']:.4f}")
        if "forward_count" in c:
            print(f"fused conv class {name}, its {int(c['forward_count'])} convs of one "
                  f"ResNeXt forward (each shape times its count): kernel {c['forward_ms']:.4f}"
                  f" ms (wrapper {c['forward_wrapper_ms']:.4f}), cuDNN "
                  f"{c['forward_library_ms']:.4f}, bounds summed {c['forward_bound_ms']:.4f}")
    wrong = sorted({(s["class"], s["path"]) for s in per_shape
                    if (s["class"] == "grouped 3x3") != s["path"].endswith("grouped")
                    or (s["class"] == "stem") != s["path"].startswith("stem")})
    if hasattr(conv, "conv_path") and wrong:
        raise AssertionError(f"fused conv: a grouped or stem shape off its path: {wrong}")
    r101 = bound(totals["bytes"], totals["ops"], "bf16")
    print(f"fused conv, the {R101_CONVS} convolutions of one resnet101_rmac bf16 forward "
          f"(batch 8, 1024x768): kernel {totals['ms']:.3f} ms (wrapper {totals['wrapper_ms']:.3f}),"
          f" plain {totals['plain_ms']:.3f} ms, cuDNN bf16 conv2d alone "
          f"{totals['library_ms']:.3f} ms; bound {r101['bound_ms']:.3f} ms by "
          f"{r101['bound_by']} ({totals['bytes'] / 1e9:.2f} GB, {totals['ops'] / 1e12:.3f} "
          f"TFLOP; per-conv bounds summed {totals['bound_sum_ms']:.3f} ms); every shape within "
          f"its bounds against the plain version, max_abs_err {worst:.3e}; largest fp32-output "
          f"|difference| / magnitude {worst_rel:.3e} (SUM_ORDER_RTOL {conv.SUM_ORDER_RTOL:.3e});"
          f" largest bf16 share apart {worst_apart:.2e} (CONV_BF16_APART {CONV_BF16_APART})")

    # the bf16 backbone, contract route against today's, on the same weights
    model, ex = models["resnet101_rmac"]
    x = torch.from_numpy(images).to(device).float() * ex._scale - ex._offset
    x = x.permute(0, 3, 1, 2)
    forward = {}
    with torch.inference_mode():
        for kind, m in (("affine", model), ("folded", folded)):
            ms, old_ms = time_in_turns(
                f"resnet101_rmac bf16 backbone {kind}",
                lambda: m.features(x, torch.bfloat16, grad_safe=True),
                lambda: m.features(x, torch.bfloat16), iters=10)
            forward[f"{kind}_ms"], forward[f"{kind}_cudnn_chain_ms"] = ms, old_ms
        backbones = {"resnet101_rmac": model, "resnet101_rmac folded": folded,
                     "resnext101_32x4d_rmac": models["resnext101_32x4d_rmac"][0]}
        forward["device_launches"] = {}
        for label, m in backbones.items():
            names = cuda_kernels_of(lambda: m.features(x, torch.bfloat16))
            forward["device_launches"][label] = None if names is None else len(names)
        forward["resnext101_32x4d_rmac_ms"] = _time_ms(
            lambda: backbones["resnext101_32x4d_rmac"].features(x, torch.bfloat16), iters=10)
        forward["extractor_ms"] = _time_ms(lambda: ex(images), iters=10)
    conv.launches = saved
    print(f"fused conv: resnet101_rmac bf16 backbone, batch 8 at 1024x768 (CUDA events, in "
          f"turns): BN-affine {forward['affine_ms']:.2f} ms against today's cuDNN + fp32 "
          f"chain {forward['affine_cudnn_chain_ms']:.2f} ms; folded {forward['folded_ms']:.2f}"
          f" against {forward['folded_cudnn_chain_ms']:.2f} ms; the whole bf16 extractor "
          f"forward (K1 included) {forward['extractor_ms']:.2f} ms; resnext101_32x4d_rmac bf16 "
          f"backbone {forward['resnext101_32x4d_rmac_ms']:.2f} ms; device launches a bf16 "
          f"backbone forward (torch.profiler): " + json.dumps(forward["device_launches"]))
    row.update(forward=forward, shapes=len(shapes), seconds=time.perf_counter() - t0)
    return {"name": "conv_fused", "route": "cuda", "source": "dirjax_torch/csrc/conv.cu",
            "replaces": "dirjax/models/resnet.py:159 (_conv, preferred_element_type=float32, "
                        "and its XLA-fused epilogue; no Pallas kernel)",
            "max_abs_err": worst, "max_rel_fp32": worst_rel, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"],
            **r101, "library_ms": totals["library_ms"],
            "library": "cuDNN bf16 conv2d of the same 104 shapes, the convolution alone (no "
                       "PyTorch call computes it with the fp32 epilogue)",
            "work": f"the {R101_CONVS} convolutions of one resnet101_rmac bf16 forward, "
                    "batch 8, 1024x768",
            "wrapper_ms": totals["wrapper_ms"], "per_conv_bound_sum_ms": totals["bound_sum_ms"],
            "shapes_by_path": dict(paths), "largest_bf16_apart": worst_apart,
            "per_class": {k: dict(v) for k, v in classes.items()},
            **{f"forward_{k}": v for k, v in forward.items()},
            "per_arch_launches": row["per_arch_launches"]}


TRACE_TRIES = 3


def kernel_trace(fn, iters: int = 1, whole=None) -> list:
    """(name, ms) of each device kernel that ``iters`` warm calls of ``fn``
    launch, from a torch.profiler trace; [] when TRACE_TRIES traces in a row
    record no device kernel, or none that ``whole`` (a test of the list)
    takes as whole (on the card's machine a trace sometimes comes back
    without some or all of its device events: a measurement lost, not a
    fault)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="dirjax_torch_trace_") as tmp:
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            with open(trace) as f:
                kernels = [(re.sub(r"^void |\(anonymous namespace\)::", "", e["name"]).split("(")[0],
                            e["dur"] / 1e3) for e in json.load(f)["traceEvents"]
                           if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if kernels and (whole is None or whole(kernels)):
            return kernels
    print(f"torch.profiler recorded no {'whole trace' if whole else 'device kernel'} in "
          f"{TRACE_TRIES} traces: not measured")
    return []


def cuda_kernels_of(fn):
    """Names of the device kernels one warm call of ``fn`` launches (None:
    not measured)."""
    return [name for name, _ in kernel_trace(fn)] or None


def device_ms(fn, iters: int = 20):
    """Device time of one call of ``fn``: the mean over ``iters`` calls of
    the summed durations of the kernels it launches (torch.profiler); None
    when not measured. At small shapes CUDA events around back-to-back
    calls measure the host's launch rate instead."""
    kernels = kernel_trace(fn, iters)
    return sum(ms for _, ms in kernels) / iters if kernels else None


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


def dispatch_timing(topk, operands) -> dict:
    """rank_topk_fused's two routes at k = 10 on a bf16 database, timed
    with CUDA events at nq = 1, 16 and 256: K2 and the merge of its
    candidates (today's route for k <= 16) against K3, the hierarchical
    select, K4 and the finish. Both are what rank_topk_fused runs after its
    checks; their answers agree (checked here)."""
    q_all, db = operands
    rows = {}
    for nq in (1, 16, SERVE_NQ):
        q = q_all[:nq]

        def fused():
            vals, idxs = topk.fused_topk(q, db, 10)
            merged, pos = topk._topk(vals, 10)
            return merged, torch.gather(idxs, 1, pos)

        def hier():
            return topk._hierarchical(q, db, 10, TILE_ROWS)

        a, b = fused(), hier()
        check_scores(f"dispatch k=10 nq={nq}", a[0], b[0], exact=False)
        times = {"k2": [], "hierarchy": []}
        for which in ("k2", "hierarchy", "hierarchy", "k2"):
            times[which].append(_time_ms(fused if which == "k2" else hier, iters=5))
        rows[str(nq)] = {k: float(np.mean(v)) for k, v in times.items()}
        print(f"dispatch k=10 bf16 nq={nq}: K2 route {times['k2']} ms, hierarchy "
              f"(K3 + select + K4 + finish) {times['hierarchy']} ms")
    return rows


def topk_by_threshold(x: torch.Tensor, k: int):
    """The top-k of long rows, ties to the lower index, without sorting the
    rows: torch.topk's k-th value v per row; the entries above v, then the
    lowest-index entries equal to v (a mask and a cumulative sum), picked by
    a second torch.topk on their reversed index; a stable sort of the k.
    The alternative to ops/topk.py's _topk (a full stable sort) that
    aqe_chunk_timing measures; the port does not run it."""
    n = x.shape[-1]
    kth = torch.topk(x, k, dim=-1, sorted=False).values.amin(dim=-1, keepdim=True)
    above, tied = x > kth, x == kth
    room = k - above.sum(dim=-1, keepdim=True, dtype=torch.int32)
    take = above | (tied & (tied.cumsum(dim=-1, dtype=torch.int32) <= room))
    order = torch.arange(n, 0, -1, device=x.device, dtype=torch.float32)
    pos = torch.topk(torch.where(take, order, 0.0), k, dim=-1).indices
    vals, o = torch.sort(torch.gather(x, -1, pos), dim=-1, descending=True, stable=True)
    return vals, torch.gather(pos, -1, o)


def aqe_chunk_timing(topk, qf, db32, k: int = 10) -> dict:
    """The exact top-k (ties to the lower index) of one AQE chunk's scores,
    (nq, 131,072) fp32 with exact ties at k = 10, two ways, timed in turns
    with CUDA events at nq = 16, 64 and 256: the full stable sort that
    ops/qe.py's _chunk_topk runs (topk._topk) against torch.topk's k-th
    value and a tie fill (topk_by_threshold). Their answers must be equal."""
    rows = {}
    for nq in (16, 64, SERVE_NQ):
        sims = qf[:nq] @ db32[:131072].T
        sims[:, 1::7] = sims[:, 0:-1:7]   # exact ties, a seventh of the row
        a, b = topk_by_threshold(sims, k), topk._topk(sims, k)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"AQE chunk top-k nq={nq}: the two ways differ")
        times = {"stable_sort": [], "threshold": []}
        for which in ("stable_sort", "threshold", "threshold", "stable_sort"):
            fn = topk_by_threshold if which == "threshold" else topk._topk
            times[which].append(_time_ms(lambda: fn(sims, k), iters=10))
        rows[str(nq)] = {w: float(np.mean(v)) for w, v in times.items()}
        print(f"AQE chunk top-k nq={nq} x 131072 k={k}: stable sort "
              f"{times['stable_sort']} ms, torch.topk + tie fill {times['threshold']} ms")
    return rows


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
    # self-match queries: database rows, spread over the database
    qself = db32[::SERVE_N // SERVE_NQ + 3][:SERVE_NQ].contiguous()
    modes = {"fp32": (qf, db32, None), "fp32_self": (qself, db32, None),
             "bf16": (qf.bfloat16(), db16, None),
             "int8": (qf.bfloat16(), db8, s8), "int8x8": (q8, db8, s8)}
    torch.cuda.synchronize()
    print(f"top-k inputs: {SERVE_N} x {SERVE_D} unit rows in fp32, bf16 and "
          f"int8 in {time.perf_counter() - t0:.1f} s")
    # nq 1, 16, 24, 37, 100 and 256 take every query width the kernels have
    # (8, 16, 32, 64, 128, 256), with partial groups and ragged rows
    cases = [(SERVE_NQ, SERVE_N), (37, SERVE_N - 3), (1, SERVE_N), (16, SERVE_N),
             (24, SERVE_N - 3), (100, SERVE_N)]
    err = {"fused_topk": 0.0, "finemax": 0.0, "gather_scores": 0.0}

    self_cases = [(SERVE_NQ, SERVE_N), (16, SERVE_N - 3)]
    for mode, mode_cases in (("bf16", cases), ("fp32", cases), ("fp32_self", self_cases)):
        for nq, n in mode_cases:
            q, db, _ = modes[mode]
            q, db = q[:nq], db[:n]
            got = topk.fused_topk(q, db, 10)
            want = topk.fused_topk_reference(q, db, 10)
            e = check_ranking(f"fused_topk {mode} nq={nq} n={n}", got, want,
                              lambda qi, rows: pair_scores(q, db, None, qi, rows))
            err["fused_topk"] = max(err["fused_topk"], e)
            print(f"kernel fused_topk {mode} nq={nq} n={n} k=10: max_abs_err {e:.3e}")

    for mode, mode_cases in (("fp32", cases), ("fp32_self", self_cases), ("bf16", cases),
                             ("int8", cases), ("int8x8", cases)):
        for nq, n in mode_cases:
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

    blocks = -(-SERVE_N // TILE_ROWS) * (TILE_ROWS // 8)
    n = SERVE_N

    def contraction(nq):
        return 2.0 * nq * n * SERVE_D

    # products: tensor-core products per multiply-add (the fp32 mode's split
    # does each as FP32_SPLIT_PRODUCTS bf16 ones)
    def k2_bound(q, db, _scales, kind, k=10, products=1):
        nq = q.shape[0]
        return bound(db.numel() * db.element_size() + q.numel() * q.element_size()
                     + nq * -(-n // 512) * k * 12, products * contraction(nq), kind)

    def k3_bound(q, db, s, kind, products=1):
        nq = q.shape[0]
        return bound(db.numel() * db.element_size() + q.numel() * q.element_size()
                     + (0 if s is None else s.numel() * 4) + nq * blocks * 4,
                     products * contraction(nq), kind)

    # each timed reading is first held against its plain version
    def timed_k2(mode, nq, iters=5, k=10):
        q, db, _ = modes[mode]
        q = q[:nq]
        tag = f"fused_topk {n}x{SERVE_D} {mode} nq={nq} k={k}"
        err["fused_topk"] = max(err["fused_topk"], check_ranking(
            tag, topk.fused_topk(q, db, k), topk.fused_topk_reference(q, db, k),
            lambda qi, rows: pair_scores(q, db, None, qi, rows)))
        return time_in_turns(tag, lambda: topk.fused_topk_reference(q, db, k),
                             lambda: topk.fused_topk(q, db, k), iters=iters)

    def timed_k3(mode, nq, iters=5):
        q, db, s = modes[mode]
        q = q[:nq].contiguous()
        tag = f"finemax {n}x{SERVE_D} {mode} nq={nq}"
        err["finemax"] = max(err["finemax"], check_scores(
            tag, topk.finemax(q, db, s, blocks), topk.finemax_reference(q, db, s, blocks),
            exact=mode == "int8x8"))
        return time_in_turns(tag, lambda: topk.finemax_reference(q, db, s, blocks),
                             lambda: topk.finemax(q, db, s, blocks), iters=iters)

    q, db, _ = modes["bf16"]
    bids, _ = topk._hier_select(topk.finemax(q, db, None, blocks), 100, TILE_ROWS, n)
    shape = f"{n}x{SERVE_D} bf16 nq={SERVE_NQ}"
    timed = {
        "fused_topk": timed_k2("bf16", SERVE_NQ),
        "finemax": timed_k3("bf16", SERVE_NQ),
        "gather_scores": time_in_turns(
            f"gather_scores {shape} k=100", lambda: topk.gather_scores_reference(q, db, bids),
            lambda: topk.gather_scores(q, db, bids), iters=5),
    }
    # the library yardstick of K2 and K3: one bf16 matmul of the same
    # operands (it writes the score matrix the kernels never write)
    library_ms = _time_ms(lambda: torch.matmul(q, db.T), iters=5)
    print(f"library bf16 torch.matmul {shape}: {library_ms:.3f} ms")
    kf8 = bids.shape[1] * 8
    bounds = {
        "fused_topk": k2_bound(q, db, None, "bf16"),
        "finemax": k3_bound(q, db, None, "bf16"),
        "gather_scores": bound(SERVE_NQ * kf8 * SERVE_D * 2 + q.numel() * 2 + bids.numel() * 8
                               + SERVE_NQ * kf8 * 4, 2.0 * SERVE_NQ * kf8 * SERVE_D, "bf16"),
    }
    # the fp32 library yardstick: one fp32 matmul (TF32 off) of the same
    # operands, at nq = 256 and 16
    assert not torch.backends.cuda.matmul.allow_tf32
    fp32_library_ms = {}
    for nq in (SERVE_NQ, 16):
        q32 = modes["fp32"][0][:nq].contiguous()
        fp32_library_ms[nq] = _time_ms(lambda: torch.matmul(q32, db32.T), iters=5)
        print(f"library fp32 torch.matmul (TF32 off) {n}x{SERVE_D} nq={nq}: "
              f"{fp32_library_ms[nq]:.3f} ms")
    # more readings of K2 and K3 as extra fields of their rows: bf16 at
    # nq = 16 and 1, and at 64 and 128 (how the time grows with the query
    # width), K3's int8 modes at nq = 256 and 16, and the fp32 mode at
    # nq = 256 and 16, each beside its bound; fp32 also beside its library
    # time and the bound of the same work on the CUDA cores
    extra = {"fused_topk": {}, "finemax": {}}
    for name, timer, bounder in (("fused_topk", timed_k2, k2_bound),
                                 ("finemax", timed_k3, k3_bound)):
        readings = [("bf16", 16), ("bf16", 1), ("bf16", 64), ("bf16", 128),
                    ("fp32", SERVE_NQ), ("fp32", 16)]
        if name == "finemax":
            readings += [("int8", SERVE_NQ), ("int8", 16), ("int8x8", SERVE_NQ),
                         ("int8x8", 16)]
        for mode, nq in readings:
            ms, plain_ms = timer(mode, nq)
            q, db, s = modes[mode]
            key = (f"{mode}_" if mode != "bf16" else "") + f"nq{nq}"
            if mode == "fp32":
                b = bounder(q[:nq], db, s, "bf16", products=FP32_SPLIT_PRODUCTS)
                if b["bound_by"] == "operations":
                    b["bound_by"] = f"operations ({FP32_SPLIT})"
                extra[name].update({
                    f"{key}_library_ms": fp32_library_ms[nq],
                    f"{key}_cuda_core_bound_ms": bounder(q[:nq], db, s, "fp32")["bound_ms"]})
            else:
                kind = {"bf16": "bf16", "int8": "bf16", "int8x8": "int8"}[mode]
                b = bounder(q[:nq], db, s, kind)
            extra[name].update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                                f"{key}_bound_ms": b["bound_ms"],
                                f"{key}_bound_by": b["bound_by"]})
    # K2 at nq = 256 with k = 1 and 16 beside k = 10: the selection's share
    for k in (1, 16):
        ms, plain_ms = timed_k2("bf16", SERVE_NQ, k=k)
        b = k2_bound(modes["bf16"][0], modes["bf16"][1], None, "bf16", k=k)
        extra["fused_topk"].update({f"k{k}_ms": ms, f"k{k}_plain_ms": plain_ms,
                                    f"k{k}_bound_ms": b["bound_ms"],
                                    f"k{k}_bound_by": b["bound_by"]})
    # K4 in fp32 (the split mode) at k = 100, beside its bound
    q32, _, _ = modes["fp32"]
    bids32, _ = topk._hier_select(topk.finemax(q32, db32, None, blocks), 100, TILE_ROWS, n)
    ms, plain_ms = time_in_turns(
        f"gather_scores {n}x{SERVE_D} fp32 nq={SERVE_NQ} k=100",
        lambda: topk.gather_scores_reference(q32, db32, bids32),
        lambda: topk.gather_scores(q32, db32, bids32), iters=5)
    kf8 = bids32.shape[1] * 8
    b = bound(SERVE_NQ * kf8 * SERVE_D * 4 + q32.numel() * 4 + bids32.numel() * 8
              + SERVE_NQ * kf8 * 4, FP32_SPLIT_PRODUCTS * 2.0 * SERVE_NQ * kf8 * SERVE_D, "bf16")
    extra["gather_scores"] = {"fp32_k100_ms": ms, "fp32_k100_plain_ms": plain_ms,
                              "fp32_k100_bound_ms": b["bound_ms"],
                              "fp32_k100_bound_by": b["bound_by"]}
    extra["fused_topk"]["dispatch_k10_ms"] = dispatch_timing(topk, modes["bf16"][:2])
    extra["fused_topk"]["aqe_chunk_topk_ms"] = aqe_chunk_timing(topk, qf, db32)
    library = {"fused_topk": (library_ms, "bf16 torch.matmul of the same operands"),
               "finemax": (library_ms, "bf16 torch.matmul of the same operands"),
               "gather_scores": (None, NO_LIBRARY + " (a gather of 8-row blocks "
                                 "per query, then their dot products)")}
    replaces = {"fused_topk": "dirjax/ops/topk_pallas.py:56",
                "finemax": "dirjax/ops/topk_pallas.py:166",
                "gather_scores": "dirjax/ops/topk_pallas.py:299"}
    entries = [{"name": name, "route": "cuda", "source": "dirjax_torch/csrc/topk.cu",
                "replaces": replaces[name], "max_abs_err": err[name],
                "ms": timed[name][0], "plain_ms": timed[name][1], **bounds[name],
                "library_ms": library[name][0], "library_note": library[name][1],
                **extra.get(name, {})}
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

    def k5_bound(mode, nq):
        # the packed (sym) or bf16 (asym) queries the wrapper takes
        q_bytes = nq * BITS // 8 if mode == "sym" else nq * BITS * 2
        return bound(codes.numel() + q_bytes + nq * blocks * 4, 2.0 * nq * SERVE_N * BITS,
                     "int8" if mode == "sym" else "bf16")

    # each timed reading is first held against its plain version
    readings = {}
    for mode in ("asym", "sym"):
        for nq in (SERVE_NQ, 16, 1):
            q = ops[mode][:nq].contiguous()
            tag = f"bits_finemax {mode} {SERVE_N}x{BITS} bits nq={nq}"
            err[mode] = max(err[mode], check_scores(
                tag, binary.bits_finemax(q, codes, blocks),
                binary.bits_finemax_reference(q, codes, blocks), exact=mode == "sym"))
            readings[(mode, nq)] = time_in_turns(
                tag, lambda: binary.bits_finemax_reference(q, codes, blocks),
                lambda: binary.bits_finemax(q, codes, blocks), iters=5)
    rescore = {}
    for nq in (SERVE_NQ, 16):
        q = ops["asym"][:nq].contiguous()
        fmax = binary.bits_finemax(q, codes, blocks)
        bids, _ = _hier_select(fmax, 100, TILE_ROWS, SERVE_N)
        raw = binary.bits_gather_scores(q, codes, bids)
        if not torch.equal(raw.reshape(nq, -1, 8).amax(dim=2), torch.gather(fmax, 1, bids)):
            raise AssertionError(f"nq={nq}: the rescore's block maxima are not K5's")
        ms, plain_ms = time_in_turns(
            f"bits_gather_scores {SERVE_N}x{BITS} bits nq={nq} k=100",
            lambda: binary.bits_gather_scores_reference(q, codes, bids),
            lambda: binary.bits_gather_scores(q, codes, bids), iters=5)
        kf8 = bids.shape[1] * 8
        rescore[nq] = {"ms": ms, "plain_ms": plain_ms, **bound(
            nq * kf8 * BITS // 8 + q.numel() * 2 + bids.numel() * 8 + nq * kf8 * 4,
            2.0 * nq * kf8 * BITS, "bf16")}
    no_library = (NO_LIBRARY + ": torch has no popcount, and the ±1 contraction "
                  "needs the codes unpacked first")
    src, replaces = "dirjax_torch/csrc/binary.cu", "dirjax/ops/binary.py:357"
    extra = {}
    for (mode, nq), (ms, plain_ms) in readings.items():
        if (mode, nq) == ("asym", SERVE_NQ):
            continue   # the row's own reading
        key = ("sym_" if mode == "sym" else "") + ("" if nq == SERVE_NQ else f"nq{nq}_")
        b = k5_bound(mode, nq)
        extra.update({f"{key}ms": ms, f"{key}plain_ms": plain_ms,
                      f"{key}bound_ms": b["bound_ms"], f"{key}bound_by": b["bound_by"]})
    # the main row is the asymmetric mode, which BinaryIndex serves by default
    entries = [
        {"name": "bits_finemax", "mode": "asym", "route": "cuda", "source": src,
         "replaces": replaces, "max_abs_err": err["asym"],
         "ms": readings[("asym", SERVE_NQ)][0], "plain_ms": readings[("asym", SERVE_NQ)][1],
         **k5_bound("asym", SERVE_NQ), "library_ms": None, "library_note": no_library,
         "sym_max_abs_err": err["sym"], **extra},
        {"name": "bits_gather_scores", "route": "cuda", "source": src,
         "replaces": "dirjax/ops/binary.py:513 (_bits_finish_asym, XLA)",
         "max_abs_err": err["bits_gather_scores"], **rescore[SERVE_NQ],
         **{f"nq16_{k}": v for k, v in rescore[16].items()},
         "library_ms": None, "library_note": no_library},
    ]
    del ops, q, bids, fmax, raw
    return entries, db32, codec


# --- K6 and the ADC rescore: PQ and IVF codes of the serving rows ----------

PQ_M = 32
IVF_NLIST = 1024
IVF_NPROBE = 8


def adc_dense_topk(luts, codes, k: int, bias=None):
    """Plain dense ADC top-k over all rows (K6's plain version at block 1,
    plus ``bias[:, cell]`` of each row's ``cell`` for IVF), and the plain
    score of (query, row) pairs for :func:`check_ranking`. ``bias`` is
    ``(cs, cell)``."""
    from dirjax_torch.ops import pq

    def scores(lo, hi):
        s = pq.adc_finemax_reference(luts, codes[lo:hi], 1)
        return s if bias is None else bias[0][:, bias[1][lo:hi]] + s

    def pair(qi, rows):
        lf, c = luts.float(), codes[rows].long()
        s = torch.zeros(len(qi), device=luts.device)
        for j in range(lf.shape[1]):
            s += lf[qi, j, c[:, j]]
        return s if bias is None else bias[0][qi, bias[1][rows]] + s
    return dense_topk(scores, codes.shape[0], k), pair


def pq_kernel_phase(device, db32):
    """K6 and the rescore against their plain versions on m = 32 PQ codes
    (ksub 16 and 256) of the serving rows; pq_topk and ivf_topk (nlist 1024,
    full probe, per query and union) against dense plain ADC top-k. Returns
    the JSON entries without ``launches``, the ks16 codebooks and the
    IVFPQIndex the serving phase reuses."""
    from dirjax_torch.ops import ivf, pq
    from dirjax_torch.serving import IVFPQIndex

    fit = {}
    books = {}
    for ksub in (16, 256):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        books[ksub] = pq.train_pq(db32, PQ_M, ksub)
        torch.cuda.synchronize()
        fit[ksub] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rot, _ = pq.train_opq(db32, PQ_M, 16)
    torch.cuda.synchronize()
    fit["opq"] = time.perf_counter() - t0
    err_rot = float((rot @ rot.T - torch.eye(SERVE_D, device=device)).abs().max())
    if err_rot > 1e-4:
        raise AssertionError(f"the OPQ rotation is {err_rot:.1e} from orthogonal")
    t0 = time.perf_counter()
    codes = {ksub: pq.encode_pq(db32, books[ksub]) for ksub in books}
    torch.cuda.synchronize()
    print(f"pq: m={PQ_M} codebooks from a 262144-row sample, 25 iterations: ksub 16 in "
          f"{fit[16]:.1f} s, ksub 256 in {fit[256]:.1f} s; OPQ (ksub 16, 131072-row "
          f"sample, 10 rounds) in {fit['opq']:.1f} s, |R R^T - I| {err_rot:.1e}; "
          f"{SERVE_N} rows encoded at both in {time.perf_counter() - t0:.2f} s")
    qf = unit_rows(SERVE_NQ, SERVE_D, device, seed=2)
    luts = {ksub: pq.pq_lookup(qf, books[ksub]) for ksub in books}
    err = {"adc_finemax": 0.0, "adc_gather_scores": 0.0}
    cases = 0
    for ksub, block in ((16, 64), (256, 8)):
        for dt in (torch.float32, torch.bfloat16):
            for nq, n in [(SERVE_NQ, SERVE_N), (37, SERVE_N - 3), (1, SERVE_N)]:
                lut, db = luts[ksub][:nq].to(dt).contiguous(), codes[ksub][:n]
                tag = f"ksub={ksub} block={block} {str(dt)[6:]} nq={nq} n={n}"
                fmax = pq.adc_finemax(lut, db, block)
                want = pq.adc_finemax_reference(lut, db, block)
                e6 = check_scores(f"adc_finemax {tag}", fmax, want, exact=True)
                bids, _ = pq._descend_maxima(fmax, 100)
                bids = bids.contiguous()
                raw = pq.adc_gather_scores(lut, db, bids, block)
                er = check_scores(f"adc_gather_scores {tag}", raw,
                                  pq.adc_gather_scores_reference(lut, db, bids, block), True)
                if not torch.equal(raw.reshape(nq, -1, block).amax(dim=2),
                                   torch.gather(fmax, 1, bids)):
                    raise AssertionError(f"{tag}: the rescore's block maxima are not K6's")
                cases += 1
                err["adc_finemax"] = max(err["adc_finemax"], e6)
                err["adc_gather_scores"] = max(err["adc_gather_scores"], er)
                print(f"kernel adc_finemax {tag}: max_abs_err {e6:.3e}; adc_gather_scores "
                      f"k=100 ({bids.shape[1]} blocks): max_abs_err {er:.3e}; block maxima "
                      "bit-identical")
    print(f"K6 and the rescore equal their plain versions exactly in {cases} of {cases} cases")

    for ksub, dt in ((16, None), (256, torch.bfloat16)):
        lut = pq._round_luts(luts[ksub], dt)
        for k in (10, 100):
            got = pq.pq_topk(luts[ksub], codes[ksub], k, compute_dtype=dt)
            tag = f"pq_topk ksub={ksub} {'bf16' if dt else 'fp32'} nq={SERVE_NQ} k={k}"
            e = check_ranking(tag, got, *adc_dense_topk(lut, codes[ksub], k))
            print(f"{tag} vs dense plain ADC top-k: max_abs_err {e:.3e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = IVFPQIndex(db32, nlist=IVF_NLIST, m=PQ_M, ksub=16, nprobe=IVF_NPROBE, device=device)
    torch.cuda.synchronize()
    arrays = index._ivf
    print(f"ivf: nlist={IVF_NLIST} (nvlist {arrays.nvlist}, cap {arrays.vlist_tab.shape[1]}, "
          f"{arrays.codes.shape[0]} slabs of {arrays.slab}) over {SERVE_N} rows built in "
          f"{time.perf_counter() - t0:.1f} s")
    assign, rcodes = ivf.unbin_ivf(arrays, SERVE_N)
    assign = torch.from_numpy(assign).to(device).long()
    rcodes = torch.from_numpy(rcodes).to(device)
    ilut = pq.pq_lookup(qf, index.codebooks)
    cs = (qf.double() @ index._centroids.double().T).float()
    for union in (False, True):
        t0 = time.perf_counter()
        got = ivf.ivf_topk(ilut, qf, arrays, 100, nprobe=arrays.nvlist, union=union)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        tag = (f"ivf_topk {'union' if union else 'per-query'} nprobe=nvlist nq={SERVE_NQ} "
               "k=100")
        e = check_ranking(tag, got, *adc_dense_topk(ilut, rcodes, 100, bias=(cs, assign)))
        print(f"{tag} ({sec:.2f} s) vs dense plain ADC over reconstructions: max_abs_err "
              f"{e:.3e}")

    # the rescore at the shapes its callers give it, each reading first held
    # to exact equality with the plain version: PQ phase C (nq 256, k = 100,
    # ksub 16 and, block 8, ksub 256 in fp32 and bf16; nq 16, k = 10) and
    # IVF's phase A (16 queries' first 128 probed slabs of 64 rows)
    sm_clock = card_sms_and_clock()
    pid = ivf._probe(qf[:16], arrays, IVF_NPROBE)[1]
    slab_ids = arrays.vlist_tab[pid].reshape(16, -1)[:, :128].long().clamp_min(0).contiguous()
    rescore = {}
    for key, lut, db, block, nq, k in [   # k None: IVF's slab ids
            ("", luts[16], codes[16], 64, SERVE_NQ, 100),
            ("nq16_k10_", luts[16], codes[16], 64, 16, 10),
            ("ksub256_", luts[256], codes[256], 8, SERVE_NQ, 100),
            ("ksub256_bf16_", luts[256].to(torch.bfloat16), codes[256], 8, SERVE_NQ, 100),
            ("ivf_a_nq16_", ilut, arrays.codes.reshape(-1, PQ_M), arrays.slab, 16, None)]:
        lut = lut[:nq].contiguous()
        bids = slab_ids if k is None else \
            pq._descend_maxima(pq.adc_finemax(lut, db, block), k)[0].contiguous()
        kf = bids.shape[1]
        tag = (f"adc_gather_scores {key or 'pq_'}{db.shape[0]}x{PQ_M} ksub={lut.shape[2]} "
               f"{str(lut.dtype)[6:]} nq={nq} kf={kf} block={block}")
        check_scores(tag, pq.adc_gather_scores(lut, db, bids, block),
                     pq.adc_gather_scores_reference(lut, db, bids, block), exact=True)
        ms, plain_ms = time_in_turns(
            tag, lambda: pq.adc_gather_scores_reference(lut, db, bids, block),
            lambda: pq.adc_gather_scores(lut, db, bids, block), iters=5)
        dev = device_ms(lambda: pq.adc_gather_scores(lut, db, bids, block))
        print(f"{tag}: device ms a call (torch.profiler) {dev}")
        lookups = float(nq) * kf * block * PQ_M
        rescore[key] = {
            "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev,
            **bound(lookups + lut.numel() * lut.element_size() + bids.numel() * 8
                    + nq * kf * block * 4, lookups, "fp32"),
            "lookup_floor_ms": lookups / (32.0 * sm_clock[0] * sm_clock[1]) * 1e3}
    del slab_ids
    # K6 at both ksub, fp32 and bf16 tables, nq = 256 and 16, each reading
    # first held to exact equality with the plain version; one embedding_bag
    # (every ADC score of the queries: the sum of m table rows, written as
    # the score matrix) at each ksub and nq is the library yardstick
    readings, library, extra = {}, {}, {}
    for ksub, block in ((16, 64), (256, 8)):
        nb = -(-SERVE_N // block)
        for nq in (SERVE_NQ, 16):
            for dt in (torch.float32, torch.bfloat16):
                l2 = luts[ksub][:nq].to(dt).contiguous()
                tag = (f"adc_finemax {SERVE_N}x{PQ_M} ksub={ksub} block={block} "
                       f"{str(dt)[6:]} nq={nq}")
                check_scores(tag, pq.adc_finemax(l2, codes[ksub], block),
                             pq.adc_finemax_reference(l2, codes[ksub], block), exact=True)
                ms, plain_ms = time_in_turns(
                    tag, lambda: pq.adc_finemax_reference(l2, codes[ksub], block),
                    lambda: pq.adc_finemax(l2, codes[ksub], block), iters=5)
                lookups = float(nq) * SERVE_N * PQ_M
                key = ("ksub256_" if ksub == 256 else "") + (
                    "bf16_" if dt == torch.bfloat16 else "") + ("nq16_" if nq == 16 else "")
                readings[key] = {
                    "ms": ms, "plain_ms": plain_ms,
                    **bound(codes[ksub].numel() + l2.numel() * l2.element_size() + nq * nb * 4,
                            lookups, "fp32"),
                    "lookup_floor_ms": lookups / (32.0 * sm_clock[0] * sm_clock[1]) * 1e3}
            flat = (codes[ksub].long() + torch.arange(PQ_M, device=device) * ksub).contiguous()
            table = luts[ksub][:nq].reshape(nq, -1).T.contiguous()
            key = ("ksub256_" if ksub == 256 else "") + ("nq16_" if nq == 16 else "")
            library[key] = _time_ms(
                lambda: torch.nn.functional.embedding_bag(flat, table, mode="sum"), iters=5)
            print(f"library embedding_bag (sum) {SERVE_N}x{PQ_M} ksub={ksub} fp32 nq={nq}: "
                  f"{library[key]:.3f} ms")
            del flat, table
    for key, r in readings.items():
        if key:   # the main row's reading is ksub 16, fp32, nq = 256
            extra.update({f"{key}{k}": v for k, v in r.items()})
    for key, ms in library.items():
        if key:
            extra[f"{key}library_ms"] = ms
    onehot = bound(0, 2.0 * SERVE_NQ * SERVE_N * PQ_M * 16, "bf16")["bound_ms"]
    entries = [
        {"name": "adc_finemax", "route": "cuda", "source": "dirjax_torch/csrc/pq.cu",
         "replaces": "dirjax/ops/pq.py:441", "max_abs_err": err["adc_finemax"],
         **readings[""], "library_ms": library[""],
         "library_note": "torch.nn.functional.embedding_bag(mode='sum') of the same "
                         "codes and tables (writes the score matrix)",
         "lookup_floor_note": f"table lookups / (32 a clock x {sm_clock[0]} SMs x "
                              f"{sm_clock[1] / 1e6:.0f} MHz, the card's maximum SM clock)",
         "onehot_bound_ms": onehot, **extra},
        {"name": "adc_gather_scores", "route": "cuda", "source": "dirjax_torch/csrc/pq.cu",
         "replaces": "dirjax/ops/pq.py:393-421 (_pq_topk_hier phase C, XLA)",
         "max_abs_err": err["adc_gather_scores"], **rescore[""],
         "library_ms": None,
         "library_note": NO_LIBRARY + " (per query, table sums over its own candidate "
                         "blocks)",
         "lookup_floor_note": "table lookups / (32 a clock x SMs x the maximum SM clock)",
         **{f"{key}{k}": v for key, r in rescore.items() if key for k, v in r.items()}},
    ]
    del codes, luts, rcodes
    return entries, books[16], index


# --- serving: IndexServer + Clients over the port's RetrievalIndex ----------

CLIENTS_PER_INDEX = 4
REQUESTS_PER_CLIENT = 6
SIGNATURES = {   # (k, options) each index is asked with
    "bf16": [(10, {}), (100, {}), (10, {"aqe": {"k": 10, "alpha": 3.0}})],
    "int8": [(10, {}), (100, {}), (100, {"int8_queries": True}),
             (10, {"aqe": {"k": 10, "alpha": 3.0}})],
    "binary": [(10, {}), (100, {})],
    "pq": [(10, {}), (100, {}), (10, {"aqe": {"k": 10, "alpha": 3.0}})],
    "ivf": [(10, {}), (100, {}), (10, {"nprobe": 16})],
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
    the device time of each kernel in a torch.profiler trace of one more
    (the four largest, and the ADC rescore's sum)."""
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
                       "top_device_ms": top,
                       "rescore_ms": sum(v for kn, v in kernels.items() if "adc_rescore" in kn)}
                rows.append(row)
                print("serving profile: " + json.dumps(row))
    os.unlink(os.path.join(out_dir, "trace_search.json"))
    with open(os.path.join(out_dir, "serving_profile.json"), "w") as f:
        json.dump({"card": card, "rows": SERVE_N, "dim": SERVE_D, "searches": rows},
                  f, indent=1)


def serving_phase(device, db16: torch.Tensor, db32: torch.Tensor, codec, pq_books,
                  ivf_index, profile_dir: str = "", card: str = "") -> dict:
    """The serving main path: concurrent Clients against an IndexServer per
    index; returns the launch counts of K2-K6 and the rescores during the
    traffic. With ``profile_dir``, also :func:`serving_profile`."""
    from dirjax_torch.ops import binary, pq, topk
    from dirjax_torch.serve import latency_ms
    from dirjax_torch.server import Client, IndexServer
    from dirjax_torch.serving import BinaryIndex, PQIndex, RetrievalIndex
    from dirjax_torch.utils import timer

    t0 = time.perf_counter()
    indexes = {"bf16": RetrievalIndex(db16, dtype=torch.bfloat16, device=device),
               "int8": RetrievalIndex(db16, dtype=torch.int8, device=device),
               "binary": BinaryIndex(db32, _codec=codec, device=device),
               "pq": PQIndex(db32, rerank=True, device=device, _trained=(None, pq_books)),
               "ivf": ivf_index}
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
    print(f"serving: bf16 and int8 RetrievalIndex, {BITS}-bit asymmetric "
          f"BinaryIndex, PQIndex (m={PQ_M}, ksub 16, int8 rerank) and IVFPQIndex "
          f"(nlist {IVF_NLIST}, nprobe {IVF_NPROBE}) of {SERVE_N} x {SERVE_D} ready in "
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
            for counts in (topk.launches, binary.launches, pq.launches):
                for key in counts:
                    counts[key] = 0
            timer.clear()
            timer.enable()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(indexes) * CLIENTS_PER_INDEX) as pool:
                jobs = {(name, c): pool.submit(client_run, servers[name].address, reqs)
                        for name, per_client in plan.items()
                        for c, reqs in enumerate(per_client)}
                done = {key: job.result() for key, job in jobs.items()}
            answers = {key: got for key, (got, _) in done.items()}
            wall = max(last for _, last in done.values()) - t0
            launches = {**topk.launches, **binary.launches, **pq.launches}
        finally:
            timer.disable()
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
        st = srv.batcher.stats
        print(f"serving {name}: {st['requests']} requests, {st['rows']} query "
              f"rows in {st['batches']} batches")
    print("serving: latency ms, from a frame's arrival to its reply's send, every "
          "server: " + " ".join(f"{k} {v:.2f}" for k, v in
                                latency_ms(timer.spans("server.request")).items()))
    print(f"serving: {len(answers) * REQUESTS_PER_CLIENT} requests, {rows} query "
          f"rows from {len(answers)} concurrent clients in {wall:.3f} s = "
          f"{rows / wall:.1f} QPS (host clock); launches {launches}; every "
          "answer equals the direct search")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"the serving path launched {missing} no time")
    # PQ as dirjax's upload test has it, without the int8 rerank: on random
    # rows a rerank shortlist that gains or loses one row shifts every
    # exact score after it, which says nothing about the upload
    upload_bf16_check({"bf16": indexes["bf16"],
                       "pq": PQIndex(db32, device=device, _trained=(None, pq_books))})
    if profile_dir:
        serving_profile(indexes, profile_dir, card)
    return launches


UPLOAD_REQUESTS, UPLOAD_CLIENTS = 24, 8   # per client, on each batcher


def upload_bf16_check(indexes: dict) -> None:
    """DynamicBatcher(upload_bf16=True) against the fp32-upload batcher over
    the bf16 RetrievalIndex and a PQIndex (ADC scores), with ``ml_dtypes`` made
    unimportable: the same burst (8 client threads, 1-16 queries a request,
    k = 10 and 100) through each; bf16 indices equal and values within rtol
    1e-6, PQ values within 0.02 (dirjax's test_upload_bf16_pq_close_to_f32).
    The kernels' counters must rise in the bf16-upload bursts. QPS and the
    percentiles of each burst's queue wait (the ``batcher.wait`` spans, from
    submit to dispatch) are printed as information."""
    from dirjax_torch.ops import pq, topk
    from dirjax_torch.serve import latency_ms
    from dirjax_torch.server import DynamicBatcher
    from dirjax_torch.utils import timer

    saved = sys.modules.get("ml_dtypes")
    sys.modules["ml_dtypes"] = None   # the port must not need it
    try:
        rng = np.random.default_rng(8)
        plan = []
        for _ in range(UPLOAD_CLIENTS):
            reqs = []
            for _ in range(UPLOAD_REQUESTS):
                q = rng.standard_normal((int(rng.integers(1, 17)), SERVE_D))
                reqs.append(((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32),
                             int(rng.choice([10, 100]))))
            plan.append(reqs)
        rows = sum(len(q) for reqs in plan for q, _ in reqs)

        def burst(batcher):
            def client(reqs):
                return [batcher.submit(q, k=k).result(timeout=300) for q, k in reqs]

            timer.clear()
            timer.enable()
            t0 = time.perf_counter()
            try:
                with ThreadPoolExecutor(UPLOAD_CLIENTS) as pool:
                    answers = list(pool.map(client, plan))
            finally:
                timer.disable()
            return (answers, time.perf_counter() - t0,
                    latency_ms(timer.spans("batcher.wait")))

        for name, index in indexes.items():
            results = {}
            for upload in (False, True):
                batcher = DynamicBatcher(index, max_batch=256, max_wait_ms=2.0, pipeline=3,
                                         upload_bf16=upload)
                try:
                    burst(batcher)       # warm the first calls
                    for counts in (topk.launches, pq.launches):
                        for key in counts:
                            counts[key] = 0
                    results[upload] = burst(batcher)
                    launches = {k: v for k, v in {**topk.launches, **pq.launches}.items() if v}
                finally:
                    batcher.close()
                if upload and not launches:
                    raise AssertionError(f"upload_bf16 {name}: no kernel launched")
                answers, wall, lat = results[upload]
                print(f"serving upload_bf16={upload} {name}: {rows} query rows from "
                      f"{UPLOAD_CLIENTS} client threads in {wall:.3f} s = {rows / wall:.1f} QPS "
                      "(host clock); queue wait ms " +
                      " ".join(f"{k} {v:.2f}" for k, v in lat.items()) +
                      f"; launches {launches}")
            worst = 0.0
            for reqs, want_c, got_c in zip(plan, results[False][0], results[True][0]):
                for (q, k), (wv, wi), (gv, gi) in zip(reqs, want_c, got_c):
                    if name == "pq":
                        np.testing.assert_allclose(gv, wv, rtol=0.02, atol=0.02)
                    else:
                        np.testing.assert_array_equal(gi, wi)
                        np.testing.assert_allclose(gv, wv, rtol=1e-6)
                    worst = max(worst, float(np.abs(gv - wv).max()))
            print(f"serving upload_bf16 {name}: answers equal the fp32 upload's "
                  f"(max |diff| {worst:.3e}; ml_dtypes not importable)")
    finally:
        if saved is None:
            del sys.modules["ml_dtypes"]
        else:
            sys.modules["ml_dtypes"] = saved


# --- sharded: the mesh paths at world 1 over NCCL ---------------------------

SHARDED_KERNELS = ("fused_topk", "finemax", "gather_scores", "bits_finemax", "adc_finemax",
                   "adc_gather_scores")
SHARDED_TRAIN_BOUND = {"loss": 1e-5, "rtol": 2e-4, "atol": 2e-5}   # dirjax's mesh bounds


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (the single-device references) leave every
    kernel counter as it was."""
    from dirjax_torch.ops import binary, conv, gem_head, pq, topk

    saved = [dict(topk.launches), dict(binary.launches), dict(pq.launches), gem_head.launches,
             conv.launches]
    try:
        yield
    finally:
        for counts, old in zip((topk.launches, binary.launches, pq.launches), saved):
            counts.update(old)
        gem_head.launches, conv.launches = saved[3], saved[4]


def same_bits(tag: str, got, want) -> None:
    for g, w in zip(got, want):
        g, w = (torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x.cpu()
                for x in (g, w))
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{tag}: the sharded answer differs from one device's")


def sharded_phase(device, db16, db32, codec, pq_books, ivf_index, card: str):
    """The mesh paths of ``dirjax_torch.parallel`` at world 1 (NCCL over a
    FileStore, ``make_mesh(1, 1)``), each held against the port's
    single-device function on the same data. Returns the readings and the
    launches of K2-K6 and the rescores while the sharded calls ran (the
    single-device references run uncounted), and K1's in ShardedExtractor."""
    import torch.distributed as dist

    from dirjax_torch import parallel as par
    from dirjax_torch.ops import binary, gem_head, pq, topk
    from dirjax_torch.ops import expand_queries_chunked, expand_queries_quantized
    from dirjax_torch.ops.ivf import ivf_topk
    from dirjax_torch.serving import BinaryIndex, PQIndex, RetrievalIndex

    t_phase = time.perf_counter()
    mesh = par.make_mesh(1, 1)
    readings, done = {"card": card}, []
    try:
        for counts in (topk.launches, binary.launches, pq.launches):
            for key in counts:
                counts[key] = 0
        rng = np.random.default_rng(12)
        q32 = torch.from_numpy(rng.standard_normal((SERVE_NQ, SERVE_D)).astype(np.float32))
        q32 = torch.nn.functional.normalize(q32, dim=1).to(device)
        q16 = q32.to(torch.bfloat16)

        # dense: bit for bit the single-device kernels plus a trivial merge
        sh16, n = par.shard_database(db16, mesh)
        sh32, _ = par.shard_database(db32, mesh)
        d8, s8, _ = par.shard_database_quantized(db16, mesh)
        cases = [(f"bf16 nq={nq} k={k}", q16[:nq], sh16, {}) for nq in (256, 16)
                 for k in (10, 100)]
        cases += [(f"int8 nq={nq} k={k} qq={qq}", q32[:nq], d8,
                   {"db_scales": s8, "quantize_queries": qq}) for nq in (256, 16)
                  for k in (10, 100) for qq in (False, True)]
        cases += [(f"fp32 nq=16 k={k}", q32[:16], sh32, {}) for k in (10, 100)]
        for tag, q, db, kw in cases:
            k = int(tag.split("k=")[1].split()[0])
            got = par.sharded_topk(q, db, k, mesh, n, **kw)
            with uncounted():
                want = topk.rank_topk_fused(q, db, k, **kw)
            same_bits(f"sharded_topk {tag}", got, want)
        done.append(f"sharded_topk bit-identical to rank_topk_fused in {len(cases)} cases")
        got = par.sharded_scores(q32[:16], sh32, mesh, n)
        with uncounted():
            want = q32[:16] @ db32.T
        err = float((got - want).abs().max())
        if err > TOPK_ATOL:
            raise AssertionError(f"sharded_scores: max |diff| {err} against one matmul")
        readings["scores_max_abs_err"] = err
        for tag, db, kw, ref in (("bf16", sh16, {}, lambda: expand_queries_chunked(
                q16[:16], db16, k=10).float()),
                ("int8", d8, {"db_scales": s8}, lambda: expand_queries_quantized(
                    q32[:16], d8, s8, k=10))):
            got = par.sharded_aqe(q16[:16] if tag == "bf16" else q32[:16], db, mesh, n, k=10,
                                  **kw)
            with uncounted():
                want = ref()
            err = float((got - want).abs().max())
            if err > TOPK_ATOL:
                raise AssertionError(f"sharded_aqe {tag}: max |diff| {err}")
            readings[f"aqe_{tag}_max_abs_err"] = err
        done.append("sharded_scores and sharded_aqe (bf16, int8) within 1e-5")

        # binary (2048-bit codes), PQ (m = 32) and IVF (nlist 1024, full probe)
        codes = binary.binarize(db32, codec)
        qb, vq = binary.binarize_and_project(q32, codec)
        bsh, _ = par.shard_codes_binary(codes, mesh)
        for nq, k in ((256, 10), (16, 100)):
            got = par.sharded_hamming_topk(qb[:nq], bsh, k, mesh, n)
            with uncounted():
                want = binary.hamming_topk_mxu(qb[:nq], codes, k)
            same_bits(f"sharded_hamming_topk sym nq={nq} k={k}", got, want)
            got = par.sharded_hamming_topk(qb[:nq], bsh, k, mesh, n, vq=vq[:nq],
                                           rerank_factor=4)
            with uncounted():
                short = binary.hamming_topk_mxu(qb[:nq], codes, 4 * k)[1]
                want = binary.asym_rescore(vq[:nq], codes, short, k)
            same_bits(f"sharded_hamming_topk vq rf=4 nq={nq} k={k}", got, want)
        pq_codes = pq.encode_pq(db32, pq_books)
        csh, _ = par.shard_codes(pq_codes, mesh)
        ivf = ivf_index._ivf
        ivf_sh = par.shard_ivf(ivf, mesh)
        for nq, k in ((256, 100), (16, 10)):
            luts = pq.pq_lookup(q32[:nq], pq_books)
            got = par.sharded_pq_topk(luts, csh, k, mesh, n)
            with uncounted():
                want = pq.pq_topk(luts, pq_codes, k)
            same_bits(f"sharded_pq_topk nq={nq} k={k}", got, want)
            rl = pq.pq_lookup(q32[:nq], ivf_index.codebooks)
            got = par.sharded_ivf_topk(rl, q32[:nq], ivf_sh, k, mesh, nprobe=ivf.nvlist)
            with uncounted():
                want = ivf_topk(rl, q32[:nq], ivf, k, nprobe=ivf.nvlist)
            same_bits(f"sharded_ivf_topk full probe nq={nq} k={k}", got, want)
        done.append("sharded_hamming_topk (sym, and vq at rerank_factor 4), sharded_pq_topk "
                    "and sharded_ivf_topk bit-identical to one device's")

        # indexes: mesh= against one device, after add + remove + compact
        extra = db32[:1000] * 0.5 + db32[1000:2000] * 0.5
        removed = np.arange(0, SERVE_N, SERVE_N // 50)
        specs = {"bf16": (RetrievalIndex, (db16,), {"dtype": torch.bfloat16}),
                 "int8": (RetrievalIndex, (db16,), {"dtype": torch.int8}),
                 "binary sym": (BinaryIndex, (db32,), {"_codec": codec, "asym": False}),
                 "pq rerank": (PQIndex, (db32,), {"rerank": True,
                                                  "_trained": (None, pq_books)})}
        for name, (cls, args, kw) in specs.items():
            index = cls(*args, mesh=mesh, **kw)
            index.add(extra)
            index.remove(indices=removed)
            index.compact()
            got = [index.search(q32[:16].cpu().numpy(), k=k) for k in (10, 100)]
            del index
            with uncounted():
                ref = cls(*args, device=device, **kw)
                ref.add(extra)
                ref.remove(indices=removed)
                ref.compact()
                want = [ref.search(q32[:16].cpu().numpy(), k=k) for k in (10, 100)]
                del ref
            for g, w in zip(got, want):
                same_bits(f"{name} index with mesh=", g, w)
            torch.cuda.empty_cache()
        done.append("RetrievalIndex (bf16, int8), BinaryIndex (symmetric) and PQIndex "
                    "(int8 rerank) with mesh= answer exactly as without it after add, "
                    "remove and compact")
        launches = {**topk.launches, **binary.launches, **pq.launches}
        missing = [name for name in SHARDED_KERNELS if not launches[name]]
        if missing:
            raise AssertionError(f"the sharded paths launched {missing} no time")
        del d8, s8, codes, pq_codes, ivf_sh, csh, bsh
        torch.cuda.empty_cache()

        # timings: the sharded call against the single-device one, in turns
        for tag, sharded, single in (
                ("topk_bf16_nq256_k10", lambda: par.sharded_topk(q16, sh16, 10, mesh, n),
                 lambda: topk.rank_topk_fused(q16, db16, 10)),
                ("topk_bf16_nq256_k100", lambda: par.sharded_topk(q16, sh16, 100, mesh, n),
                 lambda: topk.rank_topk_fused(q16, db16, 100))):
            with uncounted():
                ms, single_ms = time_in_turns(tag, single, sharded, iters=5)
            readings[f"{tag}_ms"], readings[f"{tag}_single_ms"] = ms, single_ms

        readings.update(sharded_extraction(device, mesh))
        readings.update(sharded_training(device, mesh))
        launches["gem_head"] = readings.pop("k1_launches")
        launches["conv_fused"] = readings.pop("conv_launches")
    finally:
        dist.destroy_process_group()
    readings["cli"] = sharded_cli()
    readings["seconds"] = time.perf_counter() - t_phase
    for line in done:
        print("sharded: " + line)
    print("sharded: " + json.dumps(readings))
    return readings, launches


def sharded_extraction(device, mesh) -> dict:
    """ShardedExtractor against FeatureExtractor on resnet101_rmac, 1024x768,
    batch 8: fp32 within 1e-6, bf16 cosine > 0.999; K1's launches in the
    sharded calls; forward ms a batch of each (CUDA events, in turns)."""
    from dirjax_torch import parallel as par
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import create_model
    from dirjax_torch.ops import conv, gem_head
    from dirjax_torch.utils.checkpoints import load_state

    model = create_model("resnet101_rmac")
    load_state(model, random_state_dict(model, 40))
    images = np.random.default_rng(41).integers(
        0, 256, size=(8, MAIN_SHAPE[1] * 32, MAIN_SHAPE[2] * 32, 3), dtype=np.uint8)
    row, before, conv_before = {}, gem_head.launches, conv.launches
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        sharded = par.ShardedExtractor(model, mesh, dtype=dt)
        got = sharded(images)
        with uncounted():
            single = FeatureExtractor(model, device, dtype=dt)
            want = single(images)
            ms, single_ms = time_in_turns(f"extraction {tag}", lambda: single(images),
                                          lambda: sharded(images), iters=5)
        if tag == "fp32":
            err = float((got - want).abs().max())
            if err > 1e-6:
                raise AssertionError(f"ShardedExtractor fp32: max |diff| {err}")
            row["extract_fp32_max_abs_err"] = err
        else:
            cos = float(torch.nn.functional.cosine_similarity(got, want, dim=1).min())
            if cos <= COS_BOUND["bf16"]:
                raise AssertionError(f"ShardedExtractor bf16: cosine {cos}")
            row["extract_bf16_min_cosine"] = cos
        row[f"extract_{tag}_ms"], row[f"extract_{tag}_single_ms"] = ms, single_ms
    row["k1_launches"] = gem_head.launches - before
    if not row["k1_launches"]:
        raise AssertionError("ShardedExtractor launched K1 no time")
    row["conv_launches"] = conv.launches - conv_before
    check_conv_launches("ShardedExtractor", row["conv_launches"], True, R101_CONVS)
    return row


def sharded_training(device, mesh) -> dict:
    """make_sharded_train_step at (1, 1) against the unsharded step on
    resnet101_rmac at 224x224, SGD: batch 16 whole-batch and 64 /
    microbatch 16 two-pass, loss within 1e-5 and every tensor within dirjax's
    mesh bounds (rtol 2e-4, atol 2e-5) after one step; then both step times
    (CUDA events, in turns)."""
    from dataclasses import replace

    from dirjax_torch import train as TT

    row = {}
    rng = np.random.default_rng(42)
    for tag, batch, micro in (("whole_b16", 16, 0), ("two_pass_b64_mb16", 64, 16)):
        cfg = TT.TrainConfig(batch_size=batch, microbatch=micro, optimizer="sgd",
                             learning_rate=1e-3)
        x = torch.from_numpy(rng.standard_normal((batch, TRAIN_SIZE, TRAIN_SIZE, 3))
                             .astype(np.float32)).to(device)
        y = torch.arange(batch, device=device) % 4
        sharded, single = train_model(34, device), train_model(34, device)
        opt_s, opt_1 = TT.make_optimizer(cfg, sharded), TT.make_optimizer(cfg, single)
        TT.shard_fc(sharded, opt_s, mesh)
        step_s = TT.make_sharded_train_step(sharded, cfg, opt_s, mesh)
        make = TT.make_two_pass_train_step if micro else TT.make_train_step
        step_1 = make(single, replace(cfg), opt_1)
        l_s, l_1 = float(step_s(x, y)), float(step_1(x, y))
        TT.unshard_fc(sharded, opt_s, mesh)
        worst = 0.0
        for (name, a), b in zip(single.state_dict().items(), sharded.state_dict().values()):
            torch.testing.assert_close(b, a, rtol=SHARDED_TRAIN_BOUND["rtol"],
                                       atol=SHARDED_TRAIN_BOUND["atol"],
                                       msg=lambda m: f"sharded step {tag} {name}: {m}")
            worst = max(worst, float((a - b).abs().max()))
        if abs(l_s - l_1) > SHARDED_TRAIN_BOUND["loss"]:
            raise AssertionError(f"sharded step {tag}: loss {l_s} != {l_1}")
        TT.shard_fc(sharded, opt_s, mesh)
        ms, single_ms = time_in_turns(f"train step {tag}", lambda: step_1(x, y),
                                      lambda: step_s(x, y), iters=2)
        row.update({f"train_{tag}_loss_diff": abs(l_s - l_1),
                    f"train_{tag}_weight_max_diff": worst,
                    f"train_{tag}_ms": ms, f"train_{tag}_single_ms": single_ms})
        print(f"sharded train step {tag} ({TRAIN_ARCH}, {TRAIN_SIZE}x{TRAIN_SIZE}, SGD, mesh "
              f"(1, 1)): loss {l_s:.7f} vs {l_1:.7f}, weights max |diff| {worst:.2e}; "
              f"{ms:.2f} ms against {single_ms:.2f} ms unsharded (CUDA events)")
        del sharded, single, opt_s, opt_1, step_s, step_1, x
        torch.cuda.empty_cache()
    return row


def sharded_cli(gpu: int = 0) -> dict:
    """The train CLI on a mesh: ``python -m torch.distributed.run --standalone
    --nproc-per-node 1 -m dirjax_torch.train --mesh 1,1 --ckpt-format orbax
    --gpu 0`` (``gpu``) for 2 epochs x 2 steps of resnet101_rmac at 224 on
    SyntheticLabels, then ``--resume`` from its checkpoint directory for a
    third, in this process without torchrun (a world of 1). Checks the
    epochs each run reports and the steps the directory keeps."""
    from dirjax_torch.cli import train as cli_train
    from dirjax_torch.datasets import make_synthetic_benchmark
    from dirjax_torch.utils.dist_ckpt import TrainCheckpointer

    with tempfile.TemporaryDirectory(prefix="dirjax_torch_mesh_cli_") as work:
        bench, out = os.path.join(work, "bench"), os.path.join(work, "run")
        make_synthetic_benchmark(os.path.join(bench, "revisited"), n_classes=4, per_class=8,
                                 n_junk=0, image_size=(288, 256), seed=5)
        argv = ["--dataset", f"SyntheticLabels('{bench}')", "--arch", TRAIN_ARCH,
                "--batch-size", "8", "--steps-per-epoch", "2", "--threads", "4",
                "--out-dir", out, "--mesh", "1,1", "--ckpt-format", "orbax", "--gpu", str(gpu)]
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc-per-node", "1", "-m", "dirjax_torch.train", *argv,
                              "--epochs", "2"], capture_output=True, text=True, cwd=REPO,
                             timeout=300)
        if res.returncode:
            raise AssertionError(f"mesh train CLI exited {res.returncode}: "
                                 f"{res.stdout[-2000:]}{res.stderr[-3000:]}")
        epochs = [[int(e) for e in re.findall(r"^epoch (\d+): loss", res.stdout, re.M)]]
        resumed = cli_train.main(argv + ["--epochs", "3", "--resume", os.path.join(out, "orbax")])
        epochs.append([h["epoch"] for h in resumed])
        with TrainCheckpointer(os.path.join(out, "orbax"), async_save=False) as ck:
            steps = ck.all_steps()
        seconds = time.perf_counter() - t0
    if epochs != [[0, 1], [2]] or steps != [1, 2] or not np.isfinite(resumed[0]["loss"]):
        raise AssertionError(f"mesh train CLI: epochs {epochs}, checkpoint steps {steps}")
    print(f"sharded: train CLI --mesh 1,1 --ckpt-format orbax, under torchrun then resumed "
          f"in-process: epochs {epochs}, steps kept {steps}, in {seconds:.1f} s")
    return {"epochs": epochs, "steps": steps, "seconds": seconds}


def cli_phase(device, work: str) -> None:
    """``python -m dirjax_torch.index build --int8``, ``--binary 2048``,
    ``--pq 32`` and ``--ivf 1024``, each then ``query``, as subprocesses (the
    four build-then-query chains run at once); their JSON must equal the
    in-process search."""
    from dirjax_torch.serving import RetrievalIndex

    descs, queries = (os.path.join(work, f) for f in ("db.npy", "q.npy"))
    np.save(descs, unit_rows(CLI_N, SERVE_D, device, seed=4).cpu().numpy())
    np.save(queries, unit_rows(37, SERVE_D, device, seed=5).cpu().numpy())
    kinds = {"int8": ["--int8"], "binary": ["--binary", str(BITS)],
             "pq": ["--pq", str(PQ_M)], "ivf": ["--ivf", str(IVF_NLIST)]}

    def chain(kind):
        t0 = time.perf_counter()
        index_path = os.path.join(work, f"{kind}.npz")
        for argv in (["build", "--descs", descs, *kinds[kind], "--out", index_path],
                     ["query", "--index", index_path, "--descs", queries, "-k", "100",
                      "--out-json", os.path.join(work, f"{kind}.json")]):
            subprocess.run([sys.executable, "-m", "dirjax_torch.index", *argv,
                            "--gpu", "0"], check=True, cwd=REPO, timeout=300)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(kinds)) as pool:
        seconds = dict(zip(kinds, pool.map(chain, kinds)))
    for kind, flags in kinds.items():
        with open(os.path.join(work, f"{kind}.json")) as f:
            got = json.load(f)
        vals, idxs = RetrievalIndex.load(os.path.join(work, f"{kind}.npz"),
                                         device=device).search(np.load(queries), k=100)
        if got["scores"] != vals.tolist() or got["indices"] != idxs.tolist():
            raise AssertionError(f"index CLI answer ({kind}) differs from the "
                                 "in-process search")
        print(f"index CLI: build {' '.join(flags)} and query -k 100 on {CLI_N} x "
              f"{SERVE_D} in {seconds[kind]:.1f} s (the four chains at once); JSON "
              "equals the in-process search")


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
        elif name.endswith(".p"):        # GeM powers: adpool, adpoolx5, adpoolc4
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


def check_against_cpu(tag: str, got: np.ndarray, want: np.ndarray,
                      label: str = "main path", against: str = "cpu fp32") -> float:
    """Cosine of a path's descriptors against a reference (the CPU path's
    by default), held to ``COS_BOUND[tag]``."""
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1)
                                        * np.linalg.norm(want, axis=1))
    print(f"{label} {tag} vs {against}, descriptors of {len(want)} database "
          f"images: cosine min {cos.min():.7f}, max_abs_err "
          f"{np.abs(got - want).max():.3e} (bound cosine > {COS_BOUND[tag]})")
    if got.shape != want.shape or not cos.min() > COS_BOUND[tag]:
        raise AssertionError(f"{label} {tag} descriptors disagree with {against}: "
                             f"shape {got.shape} vs {want.shape}, cosine {cos}")
    return float(cos.min())


_K1_KERNELS = ("gem_pool_kernel", "project_kernel")
_CONV_OPS = ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution")


def device_breakdown(trace_path: str) -> dict:
    """Device time of a torch.profiler chrome trace, in ms: ``busy`` is the
    union of every kernel, copy and memset interval; the parts sum the
    intervals by kind. A kernel is K1 by name, a convolution when an aten
    convolution op launched it (cuDNN's GEMM, FFT and layout kernels), the
    fused conv (csrc/conv.cu) by name otherwise, and elementwise when
    ATen's elementwise templates run it."""
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
        elif re.search(r"namespace\)::(wg::conv_wgmma_kernel|conv_kernel)<", name):   # csrc/conv.cu
            kind = "fused_conv"
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


# --- concurrent launches: the launchers' shared-memory opt-in under threads --

RACE_THREADS, RACE_LAUNCHES = 8, 50
RACE_NQ, RACE_KF = 32, 100    # K6's queries a launch (one group on the lanes); rescore blocks


def concurrent_phase(device) -> None:
    """Each shape-dependent case of ``dirjax_torch.kernels.concurrency`` at
    serving size (SERVE_N rows; K1 at MAIN_SHAPE's batch and map; the conv
    at the harness's own shapes) from RACE_THREADS host threads at once,
    RACE_LAUNCHES launches a thread alternating the two shapes: every launch
    must succeed and every answer equal its plain version (K6 and the
    rescore exactly, K1 within rtol 2e-4 / atol 2e-5, the conv bit for bit
    its own single-thread answer)."""
    from dirjax_torch.kernels import concurrency

    t0 = time.perf_counter()
    for case in ("k6_resident", "k6_streamed", "rescore", "k1_project", "conv"):
        launches = concurrency.alternation(case, device, n=SERVE_N, nq=RACE_NQ,
                                           rescore_nq=SERVE_NQ, kf=RACE_KF,
                                           head=MAIN_SHAPE[:3], d=MAIN_D, seed=6)
        try:
            worst = concurrency.race(launches, RACE_THREADS, RACE_LAUNCHES)
        except AssertionError as e:
            raise AssertionError(f"concurrent launches {case}: {e}") from e
        print(f"concurrent launches {case}: {RACE_THREADS} threads x {RACE_LAUNCHES} "
              f"launches alternating {launches[0].label} / {launches[1].label} at {SERVE_N} "
              f"rows (K1: {MAIN_SHAPE[:3]}): all launched, every answer equals the plain "
              f"version (max_abs_err {worst:.3e})")
        del launches
    print(f"concurrent launches in {time.perf_counter() - t0:.1f} s")


# --- the rest of the extraction side: FPN, ResNeXt, folded BN, PCA, CLIs ----

NEW_ARCHS = {"resnet101_fpn_rmac": False, "resnext101_32x4d_rmac": True}   # arch: runs K1


def forward_ms(ex, batch) -> float:
    """Mean ms of one forward of ``batch`` (host uint8 images), CUDA events."""
    return _time_ms(lambda: ex(batch), iters=10)


def first_images(bench: str, n: int) -> np.ndarray:
    from dirjax_torch import datasets

    db = datasets.create(f"Synthetic('{bench}')")
    return np.stack([np.asarray(db.get_image(i).convert("RGB")) for i in range(n)])


def arch_phase(work: str, device, arch: str) -> dict:
    """``arch`` through ``dirjax_torch.cli.test_dir.main`` at 1024x768 in fp32
    and bf16 from a seeded random checkpoint: K1's launches counted in each
    run (above 0 for a plain head, 0 for an FPN head, as dirjax gates it),
    the first N_REF database descriptors against the fp32 CPU path, and the
    forward's ms per batch of 8 (CUDA events)."""
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.ops import conv, gem_head
    from dirjax_torch.utils.checkpoints import load_checkpoint

    t0 = time.perf_counter()
    workdir = os.path.join(work, arch)
    bench, ckpt = write_inputs(workdir, arch, (1024, 768), n_classes=3, per_class=4,
                               n_junk=1, pca_rows=1024)
    ref = cpu_reference(bench, ckpt)
    print(f"{arch}: checkpoint and cpu reference in {time.perf_counter() - t0:.1f} s")
    row = {"arch": arch}
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "fp32"
        gem_head.launches = conv.launches = 0
        res, bdescs, n_images, sec = run_test_dir(
            bench, ckpt, 0, bf16, os.path.join(workdir, f"feats_{tag}"))
        launches = gem_head.launches
        if (launches > 0) != NEW_ARCHS[arch]:
            raise AssertionError(f"{arch} {tag}: K1 launched {launches} times; dirjax "
                                 f"{'runs' if NEW_ARCHS[arch] else 'never runs'} it there")
        check_conv_launches(f"{arch} {tag}", conv.launches, bf16)
        row[f"{tag}_conv_launches"] = conv.launches
        print(f"{arch} {tag}: {json.dumps(res)}; {n_images} images in {sec:.2f} s = "
              f"{n_images / sec:.1f} img/s (host clock, decode and first-call set-up "
              f"included); K1 launches {launches}, fused conv launches {conv.launches}")
        row[f"{tag}_cosine"] = check_against_cpu(tag, bdescs[:N_REF], ref, label=arch)
        row[f"{tag}_k1_launches"] = launches
        row[f"{tag}_img_per_s"] = n_images / sec
    batch = first_images(bench, 8)
    ck = load_checkpoint(ckpt)
    for dt in (torch.float32, torch.bfloat16):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        ex = FeatureExtractor(ck.model, device, dtype=dt, preprocess=ck.preprocess)
        row[f"{tag}_forward_ms"] = forward_ms(ex, batch)
    print(f"{arch} forward, batch 8 at 1024x768 (CUDA events): fp32 "
          f"{row['fp32_forward_ms']:.2f} ms, bf16 {row['bf16_forward_ms']:.2f} ms")
    return row


VIT_STREAM = (8, 4020, 1024)     # cell 6's residual stream: batch 8 at 1022x770


def vit_phase(device):
    """DINOv2 ViT-L/14 with registers (``dinov2_vitl14_reg_rmac``) at its
    published widths, seeded random weights (LayerScale 0.1-0.5, so every
    block counts): a bf16 FeatureExtractor forward of 2 images of 1022 x 770
    (4,020 tokens) against the plain fp32 forward of
    ``tests/plain_vit_gem.py`` (TF32 off), within 0.03 of a unit descriptor;
    the pinned attention backend ran each block's attention (24 calls, the
    profiler sees cuDNN's fused kernel and no softmax of the math backend);
    the fused residual and norm kernel launched 2 * 24 + 1 times (the
    wrapper's launch counter, which ``vit.residual_norm_calls`` and a whole
    trace agree with), and no addcmul or LayerNorm kernel, nor a copy
    kernel once a block (a bf16 cast of the stream), did; a head 320 wide, beyond that backend, raises; and
    the batch-8 forward's ms (CUDA events). Returns the architecture's row
    and the fused kernel's JSON entry (:func:`residual_norm_timing`)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import plain_vit_gem

    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import create_model, vit
    from dirjax_torch.ops import residual_norm as rn

    model = create_model("dinov2_vitl14_reg_rmac")
    sd = plain_vit_gem.draw({k: v.shape for k, v in model.state_dict().items()}, 21)
    model.load_state_dict(sd)
    ex = FeatureExtractor(model, device, dtype=torch.bfloat16)
    batch = np.random.default_rng(21).integers(0, 256, (8, 770, 1022, 3), dtype=np.uint8)
    ex(batch[:2])     # the first call casts the weights to bf16 once: count a warm one
    calls, fused_calls, rn.launches = vit.attention_calls, vit.residual_norm_calls, 0
    got = ex(batch[:2])
    torch.cuda.synchronize()
    if vit.attention_calls - calls != 24:
        raise AssertionError(f"ViT-L forward made {vit.attention_calls - calls} attention calls")
    fused_calls, launches = vit.residual_norm_calls - fused_calls, rn.launches
    if launches != 2 * 24 + 1 or fused_calls != launches:
        raise AssertionError(f"ViT-L forward launched the fused residual/norm kernel {launches} "
                             f"times in {fused_calls} calls, not 49")
    # the checks below read a trace only if it holds every launch counted
    kernels = kernel_trace(lambda: ex(batch[:2]), whole=lambda ks: launches == sum(
        "residual_norm_kernel" in name for name, _ in ks))
    if not kernels:
        raise AssertionError("no whole trace of a ViT-L forward: its kernels went unchecked")
    names = Counter(name for name, _ in kernels)
    if not any("fort_native_sdpa" in n for n in names) or any("softmax" in n.lower()
                                                              for n in names):
        raise AssertionError(f"ViT-L attention did not run on cuDNN's fused kernel: {names}")
    unfused = [n for n in names if "addcmul_cuda_kernel" in n or "layer_norm_kernel" in n]
    # a bf16 cast of the stream would be a copy kernel launched once a block or more
    copies = {n[:120]: c for n, c in names.items() if "copy" in n.lower()}
    print(f"ViT-L forward's copy kernels (launches): {copies}")
    if unfused or any(c >= 24 for c in copies.values()):
        raise AssertionError(f"ViT-L pointwise passes: unfused kernels {unfused}, copies {copies}")
    x = torch.from_numpy(batch[:2]).to(device).permute(0, 3, 1, 2).float() \
        * ex._scale[:, None, None] - ex._offset[:, None, None]
    widths = {"patch_size": 14, "num_heads": 16, "ln_eps": 1e-6, "depth": 24,
              "num_registers": 4}
    want = plain_vit_gem.forward({k: v.to(device) for k, v in sd.items()}, widths, x)
    dist = (got.double() - want.double()).norm(dim=1).max().item()
    if not dist < 0.03:
        raise AssertionError(f"ViT-L bf16 forward {dist!r} from the plain fp32 forward")
    q = torch.randn(1, 2, 64, 320, device=device, dtype=torch.bfloat16)
    try:
        vit.attention(q, q, q)
    except RuntimeError:
        pass
    else:
        raise AssertionError("the pinned attention backend ran a head 320 wide")
    row = {"arch": "dinov2_vitl14_reg_rmac", "bf16_desc_dist": dist,
           "bf16_forward_ms": forward_ms(ex, batch), "residual_norm_launches": launches}
    print(f"dinov2_vitl14_reg_rmac bf16: {dist!r} from the plain fp32 forward at 1022x770; "
          f"24 attention calls on cuDNN's fused kernel; {launches} fused residual/norm "
          f"launches (as many in the trace), no addcmul or LayerNorm kernel; "
          f"batch 8 forward {row['bf16_forward_ms']:.2f} ms (CUDA events)")
    return row, residual_norm_timing(device)


def residual_norm_timing(device) -> dict:
    """The fused residual update and LayerNorm (csrc/residual_norm.cu) at
    cell 6's stream with a bf16 branch and output, as 47 of a forward's 49
    launches take it: held to the plain composition on the card, then timed
    in turns with it (CUDA events); its JSON entry."""
    from dirjax_torch.ops import residual_norm as rn

    g = torch.Generator(device=device).manual_seed(22)
    B, N, D = VIT_STREAM
    z0 = torch.randn(VIT_STREAM, generator=g, device=device) * 2 + 0.5
    y = torch.randn(VIT_STREAM, generator=g, device=device).to(torch.bfloat16)
    gamma = torch.rand(D, generator=g, device=device) * 0.4 + 0.1
    w = torch.rand(D, generator=g, device=device) * 0.4 + 0.8
    b = torch.randn(D, generator=g, device=device) * 0.05
    args = (y, gamma, w, b, 1e-6, torch.bfloat16)
    z, z_want = z0.clone(), z0.clone()
    got, want = rn.fused_residual_norm(z, *args), rn.residual_norm_reference(z_want, *args)
    torch.cuda.synchronize()
    summands = z0.abs() + (gamma * y.float()).abs()
    stream_ulps = ((z - z_want).abs() / summands).max().item() * 2 ** 23
    apart = (got != want).float().mean().item()
    one_ulp = ((got.float() - want.float()).abs() <= want.float().abs() * 2 ** -7 + 1e-5).all()
    print(f"residual_norm {VIT_STREAM} bf16: stream within {stream_ulps:.2f} fp32 ulps of its "
          f"summands, bf16 outputs apart {apart:.2e}")
    if stream_ulps > 2 or apart > 1e-3 or not one_ulp:
        raise AssertionError("residual_norm strays from the plain composition")
    del z_want, want, got
    ms, library_ms = time_in_turns(f"residual_norm {VIT_STREAM} bf16",
                                   lambda: rn.residual_norm_reference(z, *args),
                                   lambda: rn.fused_residual_norm(z, *args))
    nbytes = B * N * D * (4 + 2 + 4 + 2)   # z and y read, z and the bf16 rows written
    entry = {"name": "residual_norm", "route": "cuda",
             "source": "dirjax_torch/csrc/residual_norm.cu",
             "replaces": "no TPU kernel: models/vit.py's addcmul_, layer_norm and bf16 cast",
             "stream_max_ulps": stream_ulps, "bf16_apart": apart, "ms": ms,
             "plain_ms": library_ms, **bound(nbytes, 10 * B * N * D, "fp32"),
             "library_ms": library_ms,
             "library_note": "the plain composition: addcmul_, F.layer_norm, .to (ATen)"}
    entry["hbm_pct"] = 100 * entry["bound_ms"] / ms
    print(f"residual_norm {VIT_STREAM}: {ms:.4f} ms (CUDA events), "
          f"composition {library_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({nbytes / 1e6:.0f} MB): {entry['hbm_pct']:.1f}% of 3.35 TB/s")
    return entry


def folded_phase(bench: str, ckpt: str, device) -> dict:
    """resnet101_rmac with every BN folded into its conv (fold_batchnorm)
    against the BN-affine model on the first 8 database images: descriptor
    cosine against the affine fp32 forward (fp32 > 0.9999, bf16 > 0.999),
    K1's launches in the folded forwards, and forward ms per batch of 8 in
    fp32 and bf16, timed in turns affine/folded/folded/affine."""
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import fold_batchnorm
    from dirjax_torch.ops import conv, gem_head
    from dirjax_torch.utils.checkpoints import load_checkpoint

    batch = first_images(bench, 8)
    ck = load_checkpoint(ckpt)
    models = {"affine": ck.model, "folded": fold_batchnorm(ck.model)}
    ex = {(kind, tag): FeatureExtractor(m, device, dtype=dt, preprocess=ck.preprocess)
          for kind, m in models.items()
          for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    want = ex["affine", "fp32"](batch).cpu().numpy()
    gem_head.launches = 0
    row = {}
    for tag in ("fp32", "bf16"):
        conv.launches = 0
        got = ex["folded", tag](batch).cpu().numpy()
        check_conv_launches(f"folded BN {tag}", conv.launches, tag == "bf16", R101_CONVS)
        row["conv_launches"] = conv.launches
        row[f"{tag}_cosine"] = check_against_cpu(tag, got, want, label="folded BN",
                                                 against="BN-affine fp32 on the card")
    row["k1_launches"] = gem_head.launches
    if row["k1_launches"] == 0:
        raise AssertionError("the folded resnet101_rmac launched K1 no time")
    for tag in ("fp32", "bf16"):
        times = {"affine": [], "folded": []}
        for kind in ("affine", "folded", "folded", "affine"):
            times[kind].append(forward_ms(ex[kind, tag], batch))
        row[f"{tag}_affine_ms"] = float(np.mean(times["affine"]))
        row[f"{tag}_folded_ms"] = float(np.mean(times["folded"]))
        print(f"folded BN resnet101_rmac {tag}, batch 8 at 1024x768 (CUDA events, in "
              f"turns): BN-affine {times['affine']} ms, folded {times['folded']} ms")
    return row


def staged_upload_check(bench: str, ckpt: str, device) -> dict:
    """FeatureExtractor's pinned upload on a bf16 resnet101_rmac and batches
    of 8 of the first database images at 1024x768: three calls in a row (the
    batch, it flipped, and it with a bucket mask), each batch written into a
    fresh ``extraction.pinned_empty`` array after the previous one was
    released, all issued while a sleep kernel holds the stream; each
    descriptor bit for bit that of a pageable ``torch.from_numpy(...).to()``
    upload of the same pixels. ``extraction.staged_uploads`` must rise by 3
    and ``staged_bytes`` by the arrays' bytes. Then the batch's copy from
    pinned memory (non-blocking) against the pageable copy, CUDA events, in
    turns, in GB/s."""
    from dirjax_torch import extraction
    from dirjax_torch.utils.checkpoints import load_checkpoint

    batch = first_images(bench, 8)
    ck = load_checkpoint(ckpt)
    ex = extraction.FeatureExtractor(ck.model, device, dtype=torch.bfloat16,
                                     preprocess=ck.preprocess)
    b, h, w, _ = batch.shape
    mask = np.zeros((b, h, w), bool)
    mask[:, : h - 40, : w - 72] = True
    masked = np.where(mask[..., None], batch, 0).astype(np.uint8)
    calls = [(batch, None), (np.ascontiguousarray(batch[:, :, ::-1]), None), (masked, mask)]

    def pinned(a):
        if a is None:
            return None
        p = extraction.pinned_empty(a.shape, a.dtype)
        p[...] = a
        return p

    @torch.inference_mode()
    def pageable(images, m):
        x = torch.from_numpy(images).to(device)
        x = (x.float() * ex._scale - ex._offset).permute(0, 3, 1, 2)
        m = None if m is None else torch.from_numpy(m).to(device)
        return ex.model(x, mask=m, dtype=ex.dtype)

    for images, m in calls:   # warm: every shape, and the host cache
        ex(pinned(images), pinned(m))
    torch.cuda.synchronize()
    uploads, nbytes = extraction.staged_uploads, extraction.staged_bytes
    torch.cuda._sleep(4_000_000_000)   # ~2 s: every copy below waits behind it
    got = [ex(pinned(images), pinned(m)) for images, m in calls]
    if torch.cuda.current_stream().query():
        raise AssertionError("pinned upload: the stream drained before the last call")
    torch.cuda.synchronize()
    for i, (images, m) in enumerate(calls):
        if not torch.equal(got[i], pageable(images, m)):
            raise AssertionError(f"pinned upload: call {i}'s descriptors differ from "
                                 f"the pageable upload's")
    want_bytes = sum(images.nbytes + (0 if m is None else m.nbytes) for images, m in calls)
    if (extraction.staged_uploads - uploads, extraction.staged_bytes - nbytes) != \
            (3, want_bytes):
        raise AssertionError(f"pinned upload counters rose by "
                             f"{extraction.staged_uploads - uploads} calls, "
                             f"{extraction.staged_bytes - nbytes} B; want 3, {want_bytes}")
    src = pinned(batch)
    staged_ms, pageable_ms = time_in_turns(
        f"host-to-device copy of {batch.nbytes} B (kernel: pinned, non-blocking; "
        f"plain: pageable)", lambda: torch.from_numpy(batch).to(device),
        lambda: src.base.to(device, non_blocking=True), iters=10)
    row = {"pageable_h2d_gb_per_s": batch.nbytes / pageable_ms / 1e6,
           "staged_h2d_gb_per_s": batch.nbytes / staged_ms / 1e6}
    print(f"pinned upload: 3 calls on a busy stream bit-identical to pageable uploads; "
          f"counters +3 calls, +{want_bytes} B; the batch's copy "
          f"{row['staged_h2d_gb_per_s']:.2f} GB/s pinned, "
          f"{row['pageable_h2d_gb_per_s']:.2f} pageable")
    return row


PCA_ROWS, PCA_CHUNK, PCA_TOP = 1_048_576, 131_072, 64


def fit_pca_phase(device) -> dict:
    """fit_pca_device on 1,048,576 x 2048 seeded unit rows (8 GiB of fp32)
    in 131,072-row chunks on the card, held against an fp64 accumulation
    of the same chunks on the card: the covariance's relative error (fp32
    sums against fp64, Frobenius), and against the fp64 covariance's own
    eigendecomposition the |cos| of the first 64 components and their
    variances' relative error. The rows have 64 leading directions whose
    variances fall from 1 to 0.09 above a flat tail, and a common mean, so
    the components compared are well separated."""
    from dirjax_torch.ops import whitening

    scale = torch.full((SERVE_D,), 0.05, device=device)
    scale[:PCA_TOP] = torch.logspace(0.0, math.log10(0.3), PCA_TOP, device=device)
    chunks = []
    for i in range(PCA_ROWS // PCA_CHUNK):
        g = torch.Generator(device=device).manual_seed(100 + i)
        x = torch.randn((PCA_CHUNK, SERVE_D), generator=g, device=device) * scale + 0.01
        chunks.append(x / x.norm(dim=1, keepdim=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pca = whitening.fit_pca_device(chunks, device=device)
    fit_s = time.perf_counter() - t0
    n, s1, s2 = whitening._device_moments(chunks, device)
    d1 = torch.zeros((SERVE_D,), dtype=torch.float64, device=device)
    d2 = torch.zeros((SERVE_D, SERVE_D), dtype=torch.float64, device=device)
    for c in chunks:
        c = c.double()
        d1 += c.sum(dim=0)
        d2 += c.T @ c
    del chunks

    def cov(a, b):
        mean = a.double() / n
        return (b.double() - n * torch.outer(mean, mean)) / (n - 1)

    c64 = cov(d1, d2)
    cov_err = ((cov(s1, s2) - c64).norm() / c64.norm()).item()
    w, v = torch.linalg.eigh(c64)
    w, v = w.flip(0)[:PCA_TOP], v.flip(1)[:, :PCA_TOP].T
    comps = torch.from_numpy(np.asarray(pca.components[:PCA_TOP], np.float64)).to(device)
    cos = (comps * v).sum(dim=1).abs()
    var = torch.from_numpy(np.asarray(pca.variance[:PCA_TOP], np.float64)).to(device)
    var_err = ((var - w).abs() / w).max().item()
    row = {"fit_s": fit_s, "cov_rel_err": cov_err, "min_abs_cos": cos.min().item(),
           "var_rel_err": var_err}
    print(f"fit_pca_device {PCA_ROWS} x {SERVE_D} in {PCA_ROWS // PCA_CHUNK} chunks of "
          f"{PCA_CHUNK}: {fit_s:.3f} s (host clock, eigh included); against fp64 "
          f"accumulation on the card: covariance relative error {cov_err:.3e} (bound 1e-5), "
          f"first {PCA_TOP} components |cos| min {row['min_abs_cos']:.9f} (bound 1 - 1e-6), "
          f"variance relative error max {var_err:.3e}")
    if not cov_err <= 1e-5 or not row["min_abs_cos"] >= 1 - 1e-6:
        raise AssertionError(f"fit_pca_device disagrees with fp64: {row}")
    return row


def cli_chain_phase(bench: str, ckpt: str, device, work: str) -> None:
    """``extract_features`` -> ``fit_whitening --device-fit`` -> ``test_dir
    --whiten`` on the card through their ``main``: the saved descriptors
    equal an in-process extraction of the same checkpoint, the whitening
    lands in a ``.pt`` checkpoint, and test_dir whitens with it."""
    from dirjax_torch import datasets, ops
    from dirjax_torch.cli import extract_features, fit_whitening, test_dir
    from dirjax_torch.extraction import FeatureExtractor, extract_image_features
    from dirjax_torch.utils.checkpoints import load_checkpoint

    t0 = time.perf_counter()
    out = os.path.join(work, "cli", "feats.npy")
    extract_features.main(["--dataset", f"Synthetic('{bench}')", "--checkpoint", ckpt,
                           "--output", out, "--gpu", "0"])
    ck = load_checkpoint(ckpt)
    ex = FeatureExtractor(ck.model, device, preprocess=ck.preprocess)
    db = datasets.create(f"Synthetic('{bench}')")
    for part, d in (("dbdescs", db), ("qdescs", db.get_query_db())):
        want = ops.pool_descriptors([torch.from_numpy(extract_image_features(d, "", ex))
                                     .to(device)], "gem", 3).cpu().numpy()
        got = np.load(os.path.join(work, "cli", f"feats.{part}.npy"))
        if not np.array_equal(got, want):
            raise AssertionError(f"extract_features {part} differ from the in-process "
                                 f"run: max_abs_err {np.abs(got - want).max():.3e}")
    whitened = os.path.join(work, "cli", "whitened.pt")
    fit_whitening.main(["--dataset", f"SyntheticLabels('{bench}')", "--checkpoint", ckpt,
                        "--name", "cli", "--out", whitened, "--device-fit", "--gpu", "0"])
    pca = load_checkpoint(whitened).pca["cli"]
    res = test_dir.main(["--dataset", f"Synthetic('{bench}')", "--checkpoint", whitened,
                         "--whiten", "cli", "--gpu", "0"])
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()):
        raise AssertionError(f"test_dir --whiten cli: {res}")
    print(f"CLI chain: extract_features ({len(db)} + {len(db.get_query_db())} images; the "
          f"saved descriptors equal the in-process run bit for bit) -> fit_whitening "
          f"--device-fit ({pca.components.shape[0]} components into a .pt) -> test_dir "
          f"--whiten: {json.dumps(res)}; in {time.perf_counter() - t0:.1f} s")


TRAIN_ARCH, TRAIN_SIZE = "resnet101_rmac", 224
# (loss diff, gradient cosine) against the fp32 CPU path. The bf16 gradient
# of a random-weight resnet101_rmac sits near cosine 0.95 to the fp32 one in
# dirjax too (train_bf16_study.py: 0.960 at 96x96 on the CPU): 23 blocks of
# bf16 conv outputs and ReLU kinks, not a fault; 0.9 still catches a lost or
# misrouted gradient, and the loss is held to 1e-2
TRAIN_BOUND = {"fp32": (1e-5, 0.9999), "bf16": (1e-2, 0.9)}
# step timings: (tag, batch, microbatch); the two-pass step runs the forward twice
TRAIN_TIMINGS = (("whole_b16", 16, 0), ("two_pass_b64_mb16", 64, 16))


def train_model(seed: int, device):
    """resnet101_rmac (2048-D) with seeded random weights, on ``device``."""
    from dirjax_torch.models import create_model
    from dirjax_torch.utils.checkpoints import load_state

    model = create_model(TRAIN_ARCH)
    load_state(model, random_state_dict(model, seed))
    return model.to(device).train()


def loss_and_gradient(model, cfg, images, labels, dtype):
    """The train step's loss and the gradient of every trained tensor,
    flattened into one fp64 host vector (no optimizer step)."""
    from dirjax_torch import train as TT

    params = TT._trained_parameters(model, cfg.freeze_bn)
    x, y = TT._device_batch(model, images, labels)
    loss = TT.make_batch_objective(cfg)(model(x, dtype=dtype, train=True), y)
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), torch.cat([g.reshape(-1).double().cpu() for g in grads])


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(a @ b / (a.norm() * b.norm()))


def train_step_checks(device) -> dict:
    """The card's loss and gradient against the port's CPU path (one batch
    of 4, two classes, AP loss, fp32 and bf16 against fp32 on the CPU), and
    the two-pass step against the whole-batch step on the card (batch 16,
    microbatch 4, SGD without momentum: dirjax's bounds, loss 1e-5, weights
    atol 1e-5 / rtol 1e-4). Neither may launch K1 or the fused conv (the
    training route is grad_safe)."""
    from dataclasses import replace

    from dirjax_torch import train as TT
    from dirjax_torch.ops import conv, gem_head

    row, before, conv_before = {}, gem_head.launches, conv.launches
    rng = np.random.default_rng(21)
    images = rng.standard_normal((4, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(np.float32)
    labels = np.array([0, 0, 1, 1])
    cfg = TT.TrainConfig()
    t0 = time.perf_counter()
    want_loss, want = loss_and_gradient(train_model(30, "cpu"), cfg, images, labels,
                                        torch.float32)
    cpu_s = time.perf_counter() - t0
    card = train_model(30, device)
    fc = card.fc.weight.numel()   # the last trained tensors: fc.weight, fc.bias
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        loss, got = loss_and_gradient(card, cfg, images, labels, dt)
        cos = _cosine(got, want)
        fc_cos = _cosine(got[-fc - MAIN_D:-MAIN_D], want[-fc - MAIN_D:-MAIN_D])
        loss_tol, cos_bound = TRAIN_BOUND[tag]
        print(f"training {tag} card vs cpu fp32 (batch 4, {TRAIN_SIZE}x{TRAIN_SIZE}, AP loss): "
              f"loss {loss:.7f} vs {want_loss:.7f} (|diff| {abs(loss - want_loss):.2e}, bound "
              f"{loss_tol}); gradient cosine {cos:.7f} over {got.numel()} values (bound > "
              f"{cos_bound}), fc.weight's {fc_cos:.7f}")
        row[f"{tag}_fc_grad_cosine"] = fc_cos
        if not (abs(loss - want_loss) <= loss_tol and cos > cos_bound):
            raise AssertionError(f"training {tag}: the card's loss or gradient disagrees "
                                 "with the CPU path")
        row[f"{tag}_loss_diff"], row[f"{tag}_grad_cosine"] = abs(loss - want_loss), cos
    row["cpu_loss_and_grad_s"] = cpu_s
    del card

    cfg = TT.TrainConfig(batch_size=16, microbatch=4, optimizer="sgd", momentum=0.0,
                         weight_decay=0.0, learning_rate=1e-3)
    images = rng.standard_normal((16, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(np.float32)
    labels = np.arange(16) % 4
    whole, two = train_model(31, device), train_model(31, device)
    whole_cfg = replace(cfg, microbatch=0)
    l1 = float(TT.make_train_step(whole, whole_cfg, TT.make_optimizer(whole_cfg, whole))(
        images, labels))
    l2 = float(TT.make_two_pass_train_step(two, cfg, TT.make_optimizer(cfg, two))(
        images, labels))
    worst = 0.0
    for (name, a), b in zip(whole.state_dict().items(), two.state_dict().values()):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-4, msg=lambda m: f"{name}: {m}")
        worst = max(worst, float((a - b).abs().max()))
    if abs(l1 - l2) > 1e-5:
        raise AssertionError(f"two-pass loss {l2} != whole-batch loss {l1}")
    print(f"training two-pass (batch 16, microbatch 4) vs whole-batch on the card, one SGD "
          f"step: loss {l2:.7f} vs {l1:.7f}; weights max |diff| {worst:.2e} (bounds: loss "
          "1e-5, weights atol 1e-5 / rtol 1e-4)")
    row["two_pass_loss_diff"], row["two_pass_weight_max_diff"] = abs(l1 - l2), worst
    if gem_head.launches != before or conv.launches != conv_before:
        raise AssertionError("a train step launched K1 or the fused conv (they have no "
                             "backward)")
    return row


def forward_flops(model, device, dtype) -> float:
    """FLOPs of one image's descriptor forward at TRAIN_SIZE, counted from
    the convolutions' and the FC's shapes (torch's FlopCounterMode)."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros(1, 3, TRAIN_SIZE, TRAIN_SIZE, device=device)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, dtype=dtype, train=True)
    return float(counter.get_total_flops())


_CONV_GEMM = ("xmma", "conv", "dgrad", "wgrad", "gemm", "nvjet", "cutlass")


def step_breakdown(kernels: list, steps: int):
    """A step's device time from a trace of ``steps`` steps: the summed
    kernel ms a step, split into convolutions and GEMMs, copies and layout
    conversions, and the rest (elementwise, reductions, the optimizer),
    with the kernel count a step; None when the trace held no kernel."""
    if not kernels:
        return None
    split = {"conv_gemm_ms": 0.0, "copy_ms": 0.0, "other_ms": 0.0}
    for name, ms in kernels:
        low = name.lower()
        kind = ("copy_ms" if "copy" in low or "nhwcto" in low or "nchwto" in low else
                "conv_gemm_ms" if any(k in low for k in _CONV_GEMM) else "other_ms")
        split[kind] += ms / steps
    split["device_ms"] = sum(ms for _, ms in kernels) / steps
    split["kernels"] = len(kernels) // steps
    return split


def train_timing(device) -> dict:
    """Step ms (CUDA events over 10 steps after 3 warm-up steps, batches
    already on the card), img/s, peak memory and MFU of the whole-batch step
    at batch 16 and the two-pass step at batch 64 (microbatch 16), fp32 (TF32
    off) and bf16, AdamW. MFU: the step's FLOPs (3x the forward, 4x for the
    two-pass step, whose forward runs twice) over the H100 SXM's peak for
    the dtype (fp32 67, bf16 989 TFLOP/s). For the whole-batch step also its
    device time (torch.profiler, :func:`step_breakdown`) and busy share
    (device ms over step ms)."""
    from dirjax_torch import train as TT

    row = {}
    model = train_model(32, device)
    flops = {tag: forward_flops(model, device, dt) for tag, dt in
             (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    row["forward_gflop_per_image"] = flops["fp32"] / 1e9
    for name, batch, micro in TRAIN_TIMINGS:
        for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            model = train_model(32, device)
            cfg = TT.TrainConfig(batch_size=batch, microbatch=micro)
            make = TT.make_two_pass_train_step if micro else TT.make_train_step
            step = make(model, cfg, TT.make_optimizer(cfg, model), dtype=dt)
            x = torch.randn(batch, TRAIN_SIZE, TRAIN_SIZE, 3, device=device)
            y = torch.arange(batch, device=device) % (batch // 4)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = _time_ms(lambda: step(x, y), iters=10)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            step_flops = flops[tag] * batch * (4 if micro else 3)
            mfu = step_flops / (ms / 1e3) / PEAK_OPS_PER_S[tag]
            key = f"{name}_{tag}"
            row.update({f"{key}_step_ms": ms, f"{key}_img_per_s": batch / ms * 1e3,
                        f"{key}_peak_gib": peak, f"{key}_mfu": mfu})
            busy = ""
            if not micro:   # where the whole-batch step's device time goes
                split = step_breakdown(kernel_trace(lambda: step(x, y), iters=3), 3)
                if split:
                    row[f"{key}_device"] = split
                    busy = (f"; device {split['device_ms']:.2f} ms a step (busy share "
                            f"{split['device_ms'] / ms:.3f}) in {split['kernels']} kernels: "
                            f"conv/gemm {split['conv_gemm_ms']:.2f}, copies "
                            f"{split['copy_ms']:.2f}, other {split['other_ms']:.2f} ms")
            print(f"training step {name} {tag} ({TRAIN_ARCH}, {TRAIN_SIZE}x{TRAIN_SIZE}, "
                  f"AdamW; CUDA events): {ms:.2f} ms = {batch / ms * 1e3:.1f} img/s, peak "
                  f"{peak:.2f} GiB, MFU {mfu:.3f} of {PEAK_OPS_PER_S[tag] / 1e12:.0f} TFLOP/s "
                  f"({step_flops / 1e12:.3f} TFLOP a step){busy}")
            del model, step, x
            torch.cuda.empty_cache()
    return row


def train_cli_check(work: str, gpu: int = 0) -> dict:
    """``dirjax_torch.cli.train.main`` on the card: SyntheticLabels (6
    classes of 320x256 images, 224 random crops, batch 16) from a seeded
    resnet101_rmac checkpoint, 2 epochs x 3 steps with a Synthetic benchmark
    evaluated each epoch, then ``--resume`` for a third. Checks: finite
    losses; BN tensors bitwise unchanged (frozen by default); K1 launched in
    the evaluations and never in a train step; the resumed run starts at
    epoch 2 with the saved optimizer step count (6); the last checkpoint goes
    through ``test_dir`` on the card with finite mAPs."""
    from dirjax_torch import train as TT
    from dirjax_torch.cli import test_dir
    from dirjax_torch.cli import train as cli_train
    from dirjax_torch.datasets import make_synthetic_benchmark
    from dirjax_torch.models import create_model
    from dirjax_torch.ops import conv, gem_head
    from dirjax_torch.utils.checkpoints import (Checkpoint, load_native, load_state,
                                                save_native)

    root = os.path.join(work, "train")
    bench, out = os.path.join(root, "bench"), os.path.join(root, "run")
    make_synthetic_benchmark(os.path.join(bench, "revisited"), n_classes=6, per_class=12,
                             n_junk=2, image_size=(320, 256), seed=3)
    start = os.path.join(root, "start.npz")
    model = create_model(TRAIN_ARCH)
    load_state(model, random_state_dict(model, 33))
    save_native(start, Checkpoint(model=model, preprocess=model.cfg.preprocess))

    counts = {"step_k1": 0, "steps": 0, "eval_k1": 0, "eval_conv": 0, "start_count": []}
    make_step, evaluate = TT.make_train_step, TT.evaluate_retrieval

    def counted_make(model, cfg, optimizer, dtype=torch.float32):
        step = make_step(model, cfg, optimizer, dtype)
        counts["start_count"].append(TT._step_count(optimizer))

        def counted(images, labels):
            before = gem_head.launches + conv.launches
            out = step(images, labels)
            counts["step_k1"] += gem_head.launches + conv.launches - before
            counts["steps"] += 1
            return out
        return counted

    def counted_eval(*args, **kw):
        before, conv_before = gem_head.launches, conv.launches
        res = evaluate(*args, **kw)
        counts["eval_k1"] += gem_head.launches - before
        counts["eval_conv"] += conv.launches - conv_before
        return res

    def opt_steps():
        with np.load(os.path.join(out, "checkpoint.npz.opt")) as f:
            return json.loads(bytes(f["__meta__"]).decode())["step_count"]

    argv = ["--dataset", f"SyntheticLabels('{bench}')", "--arch", TRAIN_ARCH,
            "--steps-per-epoch", "3", "--eval-dataset", f"Synthetic('{bench}')",
            "--out-dir", out, "--gpu", str(gpu)]
    TT.make_train_step, TT.evaluate_retrieval = counted_make, counted_eval
    t0 = time.perf_counter()
    try:
        first = cli_train.main(argv + ["--epochs", "2", "--checkpoint", start])
        saved = opt_steps()
        resumed = cli_train.main(argv + ["--epochs", "3", "--resume",
                                         os.path.join(out, "checkpoint.npz")])
    finally:
        TT.make_train_step, TT.evaluate_retrieval = make_step, evaluate
    seconds = time.perf_counter() - t0
    losses = [h["loss"] for h in first + resumed]
    if not (len(first) == 2 and np.isfinite(losses).all()):
        raise AssertionError(f"train CLI: history {first} {resumed}")
    if [h["epoch"] for h in resumed] != [2] or counts["start_count"] != [0, saved] \
            or saved != 6 or opt_steps() != 9:
        raise AssertionError(f"resume: epochs {[h['epoch'] for h in resumed]}, optimizer "
                             f"counts at start {counts['start_count']}, saved {saved}")
    if counts["step_k1"] or not counts["eval_k1"]:
        raise AssertionError(f"K1 and fused conv launches: {counts['step_k1']} in train "
                             f"steps; K1 {counts['eval_k1']} in the evaluations")
    before = load_native(start).model.state_dict()
    after = load_native(os.path.join(out, "checkpoint.npz")).model.state_dict()
    bn = [k for k in before if "bn" in k or "downsample.1" in k]
    if not all(torch.equal(before[k], after[k]) for k in bn) or \
            torch.equal(before["fc.weight"], after["fc.weight"]):
        raise AssertionError("frozen BN tensors moved, or the FC did not")
    res = test_dir.main(["--dataset", f"Synthetic('{bench}')", "--checkpoint",
                         os.path.join(out, "checkpoint.npz"), "--whiten", "", "--gpu", str(gpu)])
    if not (res and all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())):
        raise AssertionError(f"test_dir on the trained checkpoint: {res}")
    print(f"train CLI: epochs {[h['epoch'] for h in first + resumed]}, losses {losses}, "
          f"mAP-medium {[h.get('mAP-medium') for h in first + resumed]}; {counts['steps']} "
          f"steps (K1 launches 0), evaluations launched K1 {counts['eval_k1']} times; resumed "
          f"at epoch 2 from optimizer step {saved}; {len(bn)} BN tensors unchanged; test_dir "
          f"on the last checkpoint: {json.dumps(res)}; in {seconds:.1f} s")
    return {"eval_k1_launches": counts["eval_k1"], "eval_conv_launches": counts["eval_conv"],
            "cli_seconds": seconds,
            "losses": losses}


# 400 steps, the study's default: after 50 and 100 the descriptor space is
# between the random and the trained one and retrieves a query's source
# image less often than the stage's own gate allows (src_is_top1 0.4219 and
# 0.4766 against 0.5; 0.5977 after 400; NVIDIA H100 80GB HBM3, 700 W)
RECALL_TRAIN = ["--steps", "400", "--batch", "16", "--views", "4", "--n-classes", "256",
                "--size", "224"]
RECALL_EXTRACT = ["--n-db", "16384", "--n-q", "256", "--batch", "32", "--size", "224"]
# the tiers each device trains for itself, on the first 4,096 rows
RECALL_CHECK_ROWS, RECALL_CHECK_TIERS = 4096, "pq_m|ivf|itq512"
# card-trained against CPU-trained quantizers, each device fitting its own
# whitening and quantizers: no farther apart than quantizer seeds 0-4 on the
# card are on the same cut, the largest spread of any tier at each k,
# rounded up (0.1367, 0.0445, 0.0356; recall_spread_study.py, NVIDIA H100
# 80GB HBM3, 700 W)
RECALL_TRAINED_TOL = {"recall@1": 0.14, "recall@10": 0.045, "recall@100": 0.036}
# the card's search against the CPU's on the same index: one near-tie swap
# among 256 queries moves recall@1 by 1/256 = 0.0039, so at most 0.005 of
# the (query, rank) places may hold another row or a score more than
# RECALL_SCORE_TOL from the CPU's
RECALL_CARD_CPU_TOL, RECALL_SCORE_TOL = 0.005, 1e-4
# one Lloyd iteration from the same rows on both devices: codebooks equal to
# fp32 rounding, but for the centroids a near-tie assignment moved (at most
# 1 in 100); the same share bounds the codes that a near-tie encodes apart
LLOYD_TOL, LLOYD_MOVED = 1e-5, 0.01
RECALL_INT8_R10 = 0.95
RECALL_KERNELS = ("gem_head", "conv_fused", "finemax", "gather_scores", "bits_finemax",
                  "bits_gather_scores", "adc_finemax", "adc_gather_scores")


def recall_tier_names(n: int) -> set:
    """Every tier dirjax's ``recall_study.py evaluate`` grades on n rows."""
    nlist = max(16, int(np.sqrt(n)))
    return {"int8", "int8_w8q", "pq_m32k16", "pq_m16k256", "opq_m32k16",
            "pq_m32k16_rerank2", "pq_m32k16_rerank4", "pq_m32k16_rerank8",
            "pca256_exact", "pca256_pq_m32k256", "pca256_pq_m32k256_rerank4",
            "pca256_itq256_asym_rf4", "pq_m32k256_full", "pq_m32k256_full_rerank4",
            "itq512_hamming", "itq512_asym_rf4", "itq2048_hamming", "itq2048_asym_rf4",
            *(f"ivf_nlist{nlist}_nprobe{p}" for p in (1, 4, 16, nlist)),
            *(f"ivf256_nlist{nlist}_nprobe{p}" for p in (4, 16))}


def check_recall_layout(res: dict) -> None:
    """dirjax's evaluate JSON: every key, tier and tuner field."""
    if set(res) != {"n_db", "dim", "n_q", "src_is_top1", "spectrum", "tiers", "tuner",
                    "tuner_pca256"}:
        raise AssertionError(f"recall study: keys {sorted(res)}")
    spectrum = {f"top{k}_variance_share" for k in (16, 64, 256, 1024)} | {"rank_for_99pct"}
    if set(res["spectrum"]) != spectrum:
        raise AssertionError(f"recall study: spectrum keys {sorted(res['spectrum'])}")
    names = recall_tier_names(res["n_db"])
    if set(res["tiers"]) != names:
        raise AssertionError(f"recall study: tiers missing {sorted(names - set(res['tiers']))}"
                             f", unexpected {sorted(set(res['tiers']) - names)}")
    for name, row in res["tiers"].items():
        if not {"recall@1", "recall@10", "recall@100"} <= set(row) <= \
                {"recall@1", "recall@10", "recall@100", "note"}:
            raise AssertionError(f"recall study: {name} has keys {sorted(row)}")
    for t in ("tuner", "tuner_pca256"):
        if set(res[t]) != {"index", "target", "params", "tune_recall", "met",
                           "heldout_recall"}:
            raise AssertionError(f"recall study: {t} has keys {sorted(res[t])}")


def study_k1_check(ckpt: str, device) -> float:
    """K1 at the shape the study's extract gives it: the trained model's bf16
    (32, 7, 7, 2048) map of the first database batch, no mask, against
    gem_head_reference (RTOL, ATOL). Returns the largest |difference|."""
    from dirjax_torch import recall_study as RS
    from dirjax_torch.ops import gem_head
    from dirjax_torch.utils.checkpoints import load_native

    model = load_native(ckpt).model.to(device).eval()
    with torch.inference_mode():
        imgs = RS.db_scenes(0, 32, 224, 224, device).permute(0, 3, 1, 2)
        x = model.features(imgs, torch.bfloat16).permute(0, 2, 3, 1)
        head = (model.adpool.p, model.fc.weight.T, model.fc.bias)
        got = gem_head.fused_gem_head(x, *head)
        want = gem_head.gem_head_reference(x.float(), None, *head)
    if tuple(x.shape) != (32, 7, 7, 2048) or x.dtype != torch.bfloat16:
        raise AssertionError(f"recall study: K1 got {tuple(x.shape)} {x.dtype}")
    err = (got - want).abs().max().item()
    print(f"recall study: K1 on the trained (32, 7, 7, 2048) bf16 map: max_abs_err {err:.3e}")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    return err


def same_index_check(graded: dict, root: str) -> dict:
    """Every index the full study graded, saved and loaded again on the CPU,
    searched with the same knobs at k = 1, 10, 100: the card's kernels
    against their plain versions at the study's size. Per (tier, k) the
    share of (query, rank) places whose row differs, and the share whose
    sorted score lies more than RECALL_SCORE_TOL from the CPU's; each at most
    RECALL_CARD_CPU_TOL. Returns the worst of each and the largest score
    difference."""
    worst = {"rows_differ": (0.0, None), "scores_differ": (0.0, None),
             "max_score_diff": (0.0, None)}
    cases = 0
    for name, (index, queries, knobs) in graded.items():
        if not hasattr(index, "save"):
            continue   # pca256_exact: a host argsort
        path = os.path.join(root, f"{name}.npz")
        index.save(path)
        cpu = type(index).load(path, device="cpu")
        for k in (1, 10, 100):
            sc, ic = index.search(queries, k=k, **knobs)
            sp, ip = cpu.search(queries.cpu(), k=k, **knobs)
            sc, sp = np.asarray(sc), np.asarray(sp)
            with np.errstate(invalid="ignore"):   # -inf padding on both sides is equal
                diff = np.where(sc == sp, 0.0, np.abs(sc - sp))
            reading = {"rows_differ": float(np.mean(np.asarray(ic) != np.asarray(ip))),
                       "scores_differ": float(np.mean(diff > RECALL_SCORE_TOL)),
                       "max_score_diff": float(diff.max())}
            for key, v in reading.items():
                if v >= worst[key][0]:
                    worst[key] = (v, f"{name} k={k}")
            cases += 1
        os.remove(path)
    print(f"recall study: the card's search vs the CPU's on the same {cases} (index, k) "
          f"cases at full size: {json.dumps(worst)}")
    for key in ("rows_differ", "scores_differ"):
        if worst[key][0] > RECALL_CARD_CPU_TOL:
            raise AssertionError(f"recall study: card vs CPU on the same index: {key} "
                                 f"{worst[key]}")
    return {key: v for key, (v, _) in worst.items()}


def quantizer_check(db: torch.Tensor) -> dict:
    """The study's quantizers trained from one seed on the card and on the
    CPU, and their codes: PQ (m 32, ksub 16 and 256) and IVF's coarse
    k-means (nlist 64) after one Lloyd iteration from the same rows agree to
    LLOYD_TOL but for at most LLOYD_MOVED of the centroids (after the
    study's 10, the distance is printed); the card's codebooks, cells and
    512-bit ITQ codec encode the rows alike on both devices but for at most
    LLOYD_MOVED of the codes. Returns {quantizer: [largest |difference|
    after 1, after 10, share of centroids past LLOYD_TOL after 1, share of
    codes apart]}."""
    from dirjax_torch.ops.binary import binarize, fit_itq, unpack_pm1
    from dirjax_torch.ops.ivf import ivf_assign, train_ivf
    from dirjax_torch.ops.pq import encode_pq, train_pq

    def to_cpu(t):
        return t if isinstance(t, np.ndarray) else t.cpu().numpy()

    trainers = {"pq_m32k16": (lambda x, it: train_pq(x, 32, 16, iters=it, seed=0), encode_pq),
                "pq_m32k256": (lambda x, it: train_pq(x, 32, 256, iters=it, seed=0),
                               encode_pq),
                "ivf_nlist64": (lambda x, it: train_ivf(x, 64, iters=it, seed=0), ivf_assign)}
    out = {}
    for name, (train, encode) in trainers.items():
        books = [(train(db, it), train(db.cpu(), it)) for it in (1, 10)]
        gaps = [(card.cpu() - cpu).abs() for card, cpu in books]
        codes = [to_cpu(encode(x, books[1][0].to(x.device))) for x in (db, db.cpu())]
        out[name] = [gaps[0].max().item(), gaps[1].max().item(),
                     float((gaps[0].amax(-1) > LLOYD_TOL).float().mean()),
                     float(np.mean(codes[0] != codes[1]))]
    codec = fit_itq(db, 512, seed=0)
    bits = [unpack_pm1(binarize(x, codec._replace(mean=codec.mean.to(x.device),
                                                  proj=codec.proj.to(x.device)))).cpu()
            for x in (db, db.cpu())]
    out["itq512"] = [None, None, None, float((bits[0] != bits[1]).float().mean())]
    print(f"recall study: card vs CPU quantizers from one seed, [largest |difference| after "
          f"1 iteration, after 10, share of centroids past {LLOYD_TOL} after 1, share of "
          f"codes apart]: {json.dumps(out)}")
    bad = {n: r for n, r in out.items()
           if (r[2] is not None and r[2] > LLOYD_MOVED) or r[3] > LLOYD_MOVED}
    if bad:
        raise AssertionError(f"recall study: the card's quantizers differ from the CPU's: {bad}")
    return out


def ivf256_search_ms(graded: dict) -> dict:
    """The study's own ksub-256 IVF (nlist sqrt(n), m = 32): a search of its
    256 queries at k = 10, nprobe 4 and 16, in CUDA events (mean of 10 after
    2 warm-ups)."""
    out = {}
    for name, (ivf, q, knobs) in graded.items():
        if not name.startswith("ivf256_"):
            continue
        for _ in range(2):
            ivf.search(q, k=10, **knobs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            ivf.search(q, k=10, **knobs)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 10
        out[f"nprobe{knobs['nprobe']}"] = {"ms": ms, "qps": len(q) / (ms / 1e3)}
    return out


def recall_phase(work: str, device) -> dict:
    """``dirjax_torch.recall_study`` in-process on the card: ``train`` (400
    steps, batch 16 of 4 views, 256 classes, 224x224), ``extract`` from that
    checkpoint (16,384 scenes and 256 query views, batch 32) and
    ``evaluate`` of every tier group. Checks: the stage's own src_is_top1
    gate; dirjax's keys and tier names; int8 recall@10 >= 0.95; the launches
    of K1, K3, K4, K5, K6 and the two rescores rose; the TF32 flags as they
    were. Then, uncounted: K1 at the study's shape (:func:`study_k1_check`);
    every index of the study searched on the card and on the CPU
    (:func:`same_index_check`); the quantizers trained and applied on both
    devices (:func:`quantizer_check`); on the first 4,096 rows, the card's ``evaluate
    --tiers "pq_m|ivf|itq512"`` against the port's ``--cpu`` one, each
    device fitting its own whitening and quantizers, within
    RECALL_TRAINED_TOL at each k; the ksub-256 IVF search timed. Returns
    the readings and the launches of each kernel in the three stages."""
    from dirjax_torch import recall_study as RS
    from dirjax_torch.ops import binary, conv, gem_head, pq, topk

    root = os.path.join(work, "recall")
    os.makedirs(root)
    ckpt, descs, out = (os.path.join(root, f)
                        for f in ("ckpt.npz", "descs.npz", "recall.json"))
    for counts in (topk.launches, binary.launches, pq.launches):
        for key in counts:
            counts[key] = 0
    gem_head.launches = conv.launches = 0
    walls, graded = {}, {}
    # each stage runs with TF32 off and leaves the caller's flags as they
    # were: here on, read after the stages
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        trained = RS.main(["train", *RECALL_TRAIN, "--out", ckpt])
        walls["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        extracted = RS.main(["extract", "--checkpoint", ckpt, *RECALL_EXTRACT, "--out", descs])
        walls["extract"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = RS.main(["evaluate", "--descs", descs, "--out", out], graded=graded)
        walls["evaluate"] = time.perf_counter() - t0
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    launches = {"gem_head": gem_head.launches, "conv_fused": conv.launches, **topk.launches,
                **binary.launches, **pq.launches}
    check_recall_layout(res)
    if res["tiers"]["int8"]["recall@10"] < RECALL_INT8_R10:
        raise AssertionError(f"recall study: int8 recall@10 {res['tiers']['int8']}")
    idle = [k for k in RECALL_KERNELS if not launches[k]]
    if idle:
        raise AssertionError(f"recall study: {idle} launched no time ({launches})")
    if flags != (True, True):
        raise AssertionError(f"recall study: the stages left TF32 at {flags}")

    data = np.load(descs)
    small = os.path.join(root, "first.npz")
    np.savez(small, db=data["db"][:RECALL_CHECK_ROWS], q=data["q"], src=data["src"])
    with uncounted():
        t0 = time.perf_counter()
        k1_err = study_k1_check(ckpt, device)
        same = same_index_check(graded, root)
        walls["check_same_index"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cut = torch.from_numpy(data["db"][:RECALL_CHECK_ROWS]).to(device)
        quantizers = quantizer_check(RS.study_whitening(cut)[1](cut))
        walls["check_quantizers"] = time.perf_counter() - t0
        graded_by = {}
        for tag, extra in (("card", []), ("cpu", ["--cpu"])):
            t0 = time.perf_counter()
            graded_by[tag] = RS.main(["evaluate", *extra, "--descs", small, "--out",
                                      os.path.join(root, f"{tag}.json"), "--tiers",
                                      RECALL_CHECK_TIERS])
            walls[f"check_{tag}"] = time.perf_counter() - t0
        ivf_ms = ivf256_search_ms(graded)
    card, cpu = graded_by["card"]["tiers"], graded_by["cpu"]["tiers"]
    if set(card) != set(cpu) or not card:
        raise AssertionError(f"card/CPU tiers differ: {sorted(card)} vs {sorted(cpu)}")
    trained_apart = {(name, k): abs(card[name][k] - cpu[name][k])
                     for name in card for k in card[name] if k.startswith("recall@")}
    apart = max(trained_apart, key=trained_apart.get)
    print(f"recall study: evaluate on the card vs --cpu on the first {RECALL_CHECK_ROWS} "
          f"rows (each fits its own whitening and quantizers), {len(card)} tiers: largest "
          f"|difference| "
          f"{trained_apart[apart]:.4f} at {apart}; tuner {graded_by['card']['tuner']['params']} "
          f"vs {graded_by['cpu']['tuner']['params']}")
    over = {key: v for key, v in trained_apart.items() if v > RECALL_TRAINED_TOL[key[1]]}
    if over:
        raise AssertionError(f"recall study: card-trained and CPU-trained tiers differ past "
                             f"the seed spread: {over}")
    row = {"walls_s": walls, "extract_img_per_s": extracted["n_images"] / extracted["seconds"],
           "loss_first25": trained["loss_first25"], "loss_last25": trained["loss_last25"],
           "spectrum": res["spectrum"], "src_is_top1": res["src_is_top1"],
           "tiers": {n: {k: v for k, v in r.items() if k != "note"}
                     for n, r in res["tiers"].items()},
           "tuner": res["tuner"], "tuner_pca256": res["tuner_pca256"],
           "k1_study_shape_max_abs_err": k1_err,
           "card_vs_cpu_same_index": same,
           "card_vs_cpu_quantizers": quantizers,
           "card_vs_cpu_trained_max_diff": trained_apart[apart],
           "ivf256_search_nq256_k10": ivf_ms,
           "launches": launches}
    print(f"recall study: train {walls['train']:.1f} s (AP loss {trained['loss_first25']} -> "
          f"{trained['loss_last25']}), extract {walls['extract']:.1f} s "
          f"({row['extract_img_per_s']:.1f} img/s, host clock), evaluate "
          f"{walls['evaluate']:.1f} s; spectrum {json.dumps(res['spectrum'])}; ivf256 "
          f"{json.dumps(ivf_ms)}; launches {json.dumps(launches)}")
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", default="", metavar="DIR",
                        help="also profile an extraction; traces go to DIR")
    parser.add_argument("--conv-only", action="store_true",
                        help="build and run the fused conv phase alone (no result lines)")
    parser.add_argument("--tree", default="", metavar="DIR",
                        help="import dirjax_torch from DIR (e.g. a git archive of another "
                             "commit) instead of this checkout")
    args = parser.parse_args(argv)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    phase, started = "setup", time.perf_counter()
    phase_t0, seconds = started, {}

    def enter(name):
        nonlocal phase, phase_t0
        now = time.perf_counter()
        seconds[phase] = round(now - phase_t0, 1)
        phase, phase_t0 = name, now
        print(f"chip_smoke: phase {name}")

    try:
        import dirjax_torch  # (fails outside the repository)
        from dirjax_torch.ops import conv, gem_head

        print(f"dirjax_torch from {os.path.dirname(os.path.abspath(dirjax_torch.__file__))}")

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device("cuda", 0)
        card = card_line()
        print(card)
        enter("build")
        build_phase()
        enter("K1 kernel")
        entries = [kernel_phase(device)]
        enter("fused conv")
        conv_entry = fused_conv_phase(device)
        if args.conv_only:
            enter("report")
            print("fused conv entry: " + json.dumps(conv_entry))
            print("phase seconds: " + json.dumps(seconds))
            return 0
        enter("top-k kernels")
        topk_entries, db16 = topk_kernel_phase(device)
        enter("binary kernels")
        binary_entries, db32, codec = binary_kernel_phase(device)
        enter("PQ/IVF kernels")
        pq_entries, pq_books, ivf_index = pq_kernel_phase(device, db32)
        enter("concurrent launches")
        concurrent_phase(device)
        enter("serving")
        serving_launches = serving_phase(device, db16, db32, codec, pq_books, ivf_index,
                                         args.profile, card)
        enter("sharded")
        sharded_row, sharded_launches = sharded_phase(device, db16, db32, codec, pq_books,
                                                      ivf_index, card)
        del db16, db32, ivf_index
        torch.cuda.empty_cache()
        enter("fit_pca_device")
        pca_row = fit_pca_phase(device)
        torch.cuda.empty_cache()

        k1_by_path = {"sharded": sharded_launches["gem_head"]}
        conv_by_path = {"sharded": sharded_launches["conv_fused"]}
        with tempfile.TemporaryDirectory(prefix="dirjax_torch_smoke_") as work:
            enter("main path resnet101_rmac")
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
            gem_head.launches = conv.launches = 0
            for bf16 in (False, True):
                tag = "bf16" if bf16 else "fp32"
                before, conv_before = gem_head.launches, conv.launches
                res, bdescs, n_images, sec = run_test_dir(
                    bench, ckpt, 0, bf16, os.path.join(work, f"feats_{tag}"))
                if gem_head.launches <= before:
                    raise AssertionError(f"{tag} test_dir run launched K1 no time")
                check_conv_launches(f"main path {tag}", conv.launches - conv_before, bf16,
                                    R101_CONVS)
                runs[tag] = (res, bdescs)
                print(f"main path {tag}: {json.dumps(res)}; {n_images} images in "
                      f"{sec:.2f} s = {n_images / sec:.1f} img/s (host clock, "
                      f"decode and first-call set-up included); K1 launches "
                      f"{gem_head.launches - before}, fused conv launches "
                      f"{conv.launches - conv_before}")
            k1_by_path["resnet101_rmac"] = gem_head.launches
            conv_by_path["resnet101_rmac"] = conv.launches
            for tag, (_, bdescs) in runs.items():
                check_against_cpu(tag, bdescs[:N_REF], ref)
            upload_row = staged_upload_check(bench, ckpt, device)

            arch_rows = {}
            for arch in NEW_ARCHS:
                enter(f"main path {arch}")
                arch_rows[arch] = arch_phase(work, device, arch)
                k1_by_path[arch] = arch_rows[arch]["fp32_k1_launches"] + \
                    arch_rows[arch]["bf16_k1_launches"]
                conv_by_path[arch] = arch_rows[arch]["bf16_conv_launches"]
            enter("main path dinov2_vitl14_reg_rmac")
            arch_rows["dinov2_vitl14_reg_rmac"], fused_norm_entry = vit_phase(device)
            enter("folded BN")
            folded_row = folded_phase(bench, ckpt, device)
            k1_by_path["resnet101_rmac folded"] = folded_row["k1_launches"]
            conv_by_path["resnet101_rmac folded"] = folded_row["conv_launches"]
            enter("CLI chain")
            cli_chain_phase(bench, ckpt, device, work)
            enter("index CLI")
            cli_phase(device, work)
            enter("training")
            train_row = {**train_step_checks(device), **train_timing(device),
                         **train_cli_check(work)}
            k1_by_path["train eval"] = train_row["eval_k1_launches"]
            conv_by_path["train eval"] = train_row["eval_conv_launches"]
            enter("recall study")
            recall_row = recall_phase(work, device)
            k1_by_path["recall study"] = recall_row["launches"]["gem_head"]
            conv_by_path["recall study"] = recall_row["launches"]["conv_fused"]
            if args.profile:
                enter("profile")
                profile_phase(bench, ckpt, device, args.profile, card)
        enter("report")
        print("extraction side: " + json.dumps({"architectures": arch_rows, "folded_bn": folded_row,
                                                "fit_pca_device": pca_row,
                                                "staged_upload": upload_row}))
        print("training: " + json.dumps(train_row))
        print("sharded: " + json.dumps(sharded_row))
        print("recall study: " + json.dumps(recall_row))
        print("phase seconds: " + json.dumps(seconds) +
              f"; total {time.perf_counter() - started:.1f} s")

        entries[0]["launches"] = sum(k1_by_path.values())
        entries[0]["launches_by_path"] = k1_by_path
        conv_entry["launches"] = sum(conv_by_path.values())
        conv_entry["launches_by_path"] = conv_by_path
        entries.append(conv_entry)
        fused_norm_entry["launches"] = arch_rows["dinov2_vitl14_reg_rmac"][
            "residual_norm_launches"]
        fused_norm_entry["launches_by_path"] = {"dinov2_vitl14_reg_rmac": fused_norm_entry[
            "launches"]}
        entries.append(fused_norm_entry)
        for entry in topk_entries + binary_entries + pq_entries:
            by_path = {"serving": serving_launches[entry["name"]],
                       "sharded": sharded_launches[entry["name"]],
                       "recall study": recall_row["launches"][entry["name"]]}
            entry["launches"], entry["launches_by_path"] = sum(by_path.values()), by_path
        print(json.dumps({"kernels": entries + topk_entries + binary_entries + pq_entries}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception as e:   # the boundary: say which phase failed, then exit 1
        print(f"chip_smoke: phase {phase} failed: {e!r}", flush=True)
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
