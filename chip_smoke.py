#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dirjax_torch) once through its main path on
one NVIDIA GPU, and check what comes out.

    python3 chip_smoke.py      # from the repository root; needs one CUDA card

Phases, each of which raises on failure:

1. build  — nvcc builds dirjax_torch/csrc/*.cu for sm_90a.
2. kernel — K1, the fused GeM -> FC -> L2 head (csrc/gem_head.cu), against
   its plain PyTorch version on the card at the main-path shape
   (8, 32, 24, 2048) -> 2048: unmasked, bucket-masked, a ragged D and bf16
   input, within rtol 2e-4 / atol 2e-5, TF32 off; both timed with CUDA events.
3. main path — a synthetic Revisited benchmark at 1024x768 and a
   resnet101_rmac (2048-D) checkpoint with seeded random weights and a fitted
   PCA go through ``dirjax_torch.cli.test_dir.main`` with whitening and
   AQE/ADBA, once in fp32 and once with --bf16. K1's launch counter must rise
   in each run. The database descriptors each run saves (--save-feats) must
   be finite unit vectors, and those of the first 4 images must match the
   port's fp32 CPU path: cosine > 0.9999 for the fp32 run, > 0.999 for the
   bf16 one. The mAPs are only checked to be finite in [0, 1]: the synthetic
   classes differ by colour, so even random weights rank them perfectly and
   mAP = 1 says nothing about the path.

    python3 chip_smoke.py --profile DIR   # also phase 4

4. profile — where a warm database extraction's time goes, fp32 and bf16:
   unprofiled wall (host clock), forward ms per batch of 8 (CUDA events) and
   peak memory, and a torch.profiler trace whose device intervals are merged
   into busy time and split into convolution, elementwise, copies, K1 and
   other. Writes the traces and ``profile_summary.json`` into DIR.

Prints the card's name and power limit, then one JSON line with each
kernel's launches, error and times, and last a JSON line with "ok": true.
Exits non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

RTOL, ATOL = 2e-4, 2e-5
MAIN_SHAPE = (8, 32, 24, 2048)   # R101 C5 at 1024x768, batch 8
MAIN_D = 2048
N_REF = 4                        # database images held against the CPU path
COS_BOUND = {"fp32": 0.9999, "bf16": 0.999}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_phase():
    from dirjax_torch.kernels.build import build, load_library

    res = build()
    load_library()
    if res.command:
        print("nvcc:", " ".join(res.command))
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

    def plain():
        return gem_head.gem_head_reference(x, mask, p, w, b)

    def kernel():
        return gem_head.fused_gem_head(x, p, w, b, mask=mask)

    # plain, kernel, kernel, plain: one card, in turns
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(_time_ms(plain if which == "plain" else kernel))
    ms, plain_ms = float(np.mean(times["kernel"])), float(np.mean(times["plain"]))
    print(f"kernel gem_head timing {MAIN_SHAPE}->{MAIN_D} masked fp32: kernel "
          f"{times['kernel']} ms, plain {times['plain']} ms")
    return {"name": "gem_head", "route": "cuda",
            "source": "dirjax_torch/csrc/gem_head.cu",
            "replaces": "dirjax/ops/gem_head.py:45",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    entry = kernel_phase(device)

    with tempfile.TemporaryDirectory(prefix="dirjax_torch_smoke_") as work:
        t0 = time.perf_counter()
        bench, ckpt = write_inputs(work, "resnet101_rmac", (1024, 768),
                                   n_classes=6, per_class=8, n_junk=4,
                                   pca_rows=4096)
        ref = cpu_reference(bench, ckpt)
        print(f"inputs and cpu reference in {time.perf_counter() - t0:.1f} s")

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

        if args.profile:
            profile_phase(bench, ckpt, device, args.profile, card)

    entry["launches"] = launches
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
