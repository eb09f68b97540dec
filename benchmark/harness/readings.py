"""Arithmetic the per-layer metric readers share (``benchmark/metrics/``).

Each function takes a ``runner.Reading`` and returns a number, or None where
the traced slice holds nothing to read. Kernels are found by the names the
program's CUDA sources give them; shapes come from the configuration.
"""

from __future__ import annotations

from typing import Optional

from . import peaks, shapes

# the program's kernels, by name: csrc/conv.cu (the dense and grouped wgmma
# kernel, the stem kernel, the mma.sync kernel), csrc/gem_head.cu (K1's two
# launches), csrc/tc_score.cuh's work types for K3 and K4
CONV = r"conv_wgmma_kernel|conv_kernel|stem_kernel"
K1_POOL, K1_PROJECT = r"gem_pool_kernel", r"project_kernel"
K3 = r"FinemaxWork"


def idle_share(r) -> Optional[float]:
    """Wall time of the slice that no kernel, copy or memset covered, in %."""
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * max(0.0, t.window_s - t.busy_s) / t.window_s


def _images(r) -> int:
    return sum(s[2] for s in r.spans_in_slice("extractor"))


def _sizes(r):
    batch = int(r.config["inference"]["batch_size"])
    return [(batch, int(h), int(w)) for w, h in r.mix["sizes"]]


def h2d_ms_per_img(r) -> Optional[float]:
    images = _images(r)
    copies = r.trace.memcpys("HtoD") if r.trace is not None else []
    if not images or not copies:
        return None
    return r.trace.seconds(copies) * 1e3 / images


def conv_roofline(r) -> Optional[float]:
    """Every fused-conv launch's bound (its shape at the batch's image size,
    averaged over the launches of a forward and the mix's sizes) over the
    device time of those launches."""
    if r.trace is None:
        return None
    launches = r.trace.kernels(CONV)
    model = r.config["model"]
    per_launch = [sum(c.bound_s for c in convs) / len(convs)
                  for convs in (shapes.backbone_convs(model, b, h, w) for b, h, w in _sizes(r))]
    bound = len(launches) * sum(per_launch) / len(per_launch)
    return peaks.roofline_pct(bound, r.trace.seconds(launches))


def gem_head_roofline(r) -> Optional[float]:
    """K1's pool and projection launches, each against its own bound."""
    if r.trace is None:
        return None
    pools, projects = r.trace.kernels(K1_POOL), r.trace.kernels(K1_PROJECT)
    model = r.config["model"]
    bounds = [shapes.gem_head_launches(model, b, h, w) for b, h, w in _sizes(r)]
    pool_b = sum(b[0] for b in bounds) / len(bounds)
    proj_b = sum(b[1] for b in bounds) / len(bounds)
    return peaks.roofline_pct(len(pools) * pool_b + len(projects) * proj_b,
                              r.trace.seconds(pools + projects))


def extract_mfu(r) -> Optional[float]:
    """The forward's operations for every image handed to the extractor in
    the slice, over the slice, against the bf16 peak."""
    images = _images(r)
    if r.trace is None or not images:
        return None
    return peaks.mfu_pct(images * _flops_per_image(r), r.trace.window_s)


def extract_img_per_s(r) -> Optional[float]:
    """Images whose descriptors came back over the whole window (host
    clock), the traced slice included."""
    w = r.spans.get("window", [])
    return sum(x[2] for x in w) / sum(x[1] - x[0] for x in w) if w else None


def extract_device_mfu(r) -> Optional[float]:
    """The forward's operations for every image handed to the extractor in
    the slice, over the device's busy time in it, against the bf16 peak."""
    images = _images(r)
    if r.trace is None or not images or r.trace.busy_s <= 0:
        return None
    return peaks.mfu_pct(images * _flops_per_image(r), r.trace.busy_s)


def _flops_per_image(r) -> float:
    model = r.config["model"]
    return sum(shapes.forward_flops(model, 1, h, w) for _, h, w in _sizes(r)) / len(_sizes(r))


def _searches(r):
    return r.spans_in_slice("search")


def rows_per_batch(r) -> Optional[float]:
    """Mean query rows a dispatch of the batcher carried, over the window
    outside the traced slice."""
    s = r.spans_outside_slice("search")
    return sum(x[2] for x in s) / len(s) if s else None


def index_ms(r) -> Optional[float]:
    """Mean host ms of a dispatched search, its results on the host, over
    the window outside the traced slice."""
    s = r.spans_outside_slice("search")
    return sum(x[1] - x[0] for x in s) * 1e3 / len(s) if s else None


def _index_rows(r) -> int:
    ix = r.config["index"]
    return int(ix["landmark_rows"]) + int(ix["distractor_rows"])


def finemax_roofline(r) -> Optional[float]:
    """K3's launches, each bounded at the mean query rows of the slice's
    dispatches (a dispatch launches K3 once), over their device time."""
    s = _searches(r)
    if r.trace is None or not s:
        return None
    launches = r.trace.kernels(K3)
    dim = int(r.config["index"]["dim"])
    mean_bound = sum(shapes.finemax_bound_s(_index_rows(r), dim, x[2]) for x in s) / len(s)
    return peaks.roofline_pct(len(launches) * mean_bound, r.trace.seconds(launches))


def search_mfu(r) -> Optional[float]:
    """2 * rows answered * N * D operations over the slice, against the bf16
    peak."""
    s = _searches(r)
    if r.trace is None or not s:
        return None
    flops = shapes.search_flops(_index_rows(r), int(r.config["index"]["dim"]),
                                sum(x[2] for x in s))
    return peaks.mfu_pct(flops, r.trace.window_s)
