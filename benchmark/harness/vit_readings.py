"""Arithmetic of the vision transformer cells' per-layer readers
(``benchmark/metrics/extract.vit.*``).

Each function takes a ``runner.Reading`` and returns a number, or None where
the traced slice holds nothing to read. Bounds come from the configuration's
widths (``harness/vit_shapes.py``); kernels are found by the names a trace
of the program's bf16 ViT-L/14 forward on an H100 (torch 2.11, CUDA 12.8)
gave them:

- attention: cuDNN's fused attention,
  ``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_cga1x1x1_kernel0_0``,
  the backend the program pins for bf16; flash attention's
  ``pytorch_flash::flash_fwd_kernel`` is matched too;
- linear layers: cuBLAS's ``nvjet_tst_...`` (qkv, proj, fc1, fc2) and a
  CUTLASS ``..._tensorop_bf16_s16816gemm_...`` (the patch embedding);
- pointwise passes: ``vectorized_layer_norm_kernel`` (LayerNorm),
  ``GeluCUDAKernelImpl`` (GELU), ``addcmul_cuda_kernel`` (the LayerScale
  residual update);
- K1: ``gem_pool_kernel`` and ``project_kernel`` (csrc/gem_head.cu).
"""

from __future__ import annotations

from typing import Optional

from . import peaks, vit_shapes

ATTENTION = r"fort_native_sdpa|flash_fwd|fmha"
LINEAR = r"nvjet|gemm"
POINTWISE = {"layer_norm": r"layer_norm_kernel", "gelu": r"GeluCUDAKernelImpl",
             "residual": r"addcmul_cuda_kernel"}
K1_POOL, K1_PROJECT = r"gem_pool_kernel", r"project_kernel"


def _sizes(r):
    batch = int(r.config["inference"]["batch_size"])
    return [(batch, int(h), int(w)) for w, h in r.mix["sizes"]]


def _mean(fn, r) -> float:
    """``fn(model, batch, height, width)`` averaged over the mix's sizes."""
    sizes = _sizes(r)
    return sum(fn(r.config["model"], b, h, w) for b, h, w in sizes) / len(sizes)


def _images(r) -> int:
    return sum(s[2] for s in r.spans_in_slice("extractor"))


def attention_roofline(r) -> Optional[float]:
    """Each attention launch (one a block a batch) against 4 N^2 D
    operations a layer an image at the bf16 peak."""
    if r.trace is None:
        return None
    launches = r.trace.kernels(ATTENTION)
    bound = len(launches) * _mean(vit_shapes.attention_bound_s, r)
    return peaks.roofline_pct(bound, r.trace.seconds(launches))


def linear_roofline(r) -> Optional[float]:
    """The linear layers' launches (qkv, proj, fc1, fc2 and the patch
    embedding), each bounded by the mean bound of a forward's GEMMs, over
    their device time."""
    if r.trace is None:
        return None
    attention = {id(e) for e in r.trace.kernels(ATTENTION)}
    launches = [e for e in r.trace.kernels(LINEAR) if id(e) not in attention]

    def per_launch(model, b, h, w):
        gemms = vit_shapes.gemms(model, b, h, w)
        return sum(g.bound_s for g in gemms) / len(gemms)

    return peaks.roofline_pct(len(launches) * _mean(per_launch, r),
                              r.trace.seconds(launches))


def pointwise_roofline(r) -> Optional[float]:
    """LayerNorm, GELU and the LayerScale residual updates, each launch
    against its bytes at the memory rate, over their device time."""
    if r.trace is None:
        return None
    bound, seconds = 0.0, 0.0
    for kind, pattern in POINTWISE.items():
        launches = r.trace.kernels(pattern)
        bound += len(launches) * _mean(
            lambda model, b, h, w: vit_shapes.pointwise_bounds(model, b, h, w)[kind], r)
        seconds += r.trace.seconds(launches)
    return peaks.roofline_pct(bound, seconds)


def gem_head_roofline(r) -> Optional[float]:
    """K1's pool and projection launches on the patch map, each against its
    own bound."""
    if r.trace is None:
        return None
    pools, projects = r.trace.kernels(K1_POOL), r.trace.kernels(K1_PROJECT)
    pool_b = _mean(lambda *a: vit_shapes.gem_head_launches(*a)[0], r)
    proj_b = _mean(lambda *a: vit_shapes.gem_head_launches(*a)[1], r)
    return peaks.roofline_pct(len(pools) * pool_b + len(projects) * proj_b,
                              r.trace.seconds(pools + projects))


def device_mfu(r) -> Optional[float]:
    """The forward's operations for every image handed to the extractor in
    the slice, over the device's busy time in it, against the bf16 peak."""
    images = _images(r)
    if r.trace is None or not images or r.trace.busy_s <= 0:
        return None
    per_image = _mean(lambda model, b, h, w: vit_shapes.forward_flops(model, 1, h, w), r)
    return peaks.mfu_pct(images * per_image, r.trace.busy_s)
