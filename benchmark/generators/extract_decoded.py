"""Extraction from decoded batches: the program's ``FeatureExtractor`` alone,
without the loader.

Set-up builds the program's model (``dirjax_torch.models.create_model``)
with the configuration's weights from the seed, its ``FeatureExtractor`` in
the configuration's dtype, and a pool of ``pool_batches`` decoded uint8
(batch, H, W, 3) batches drawn from the seed: the mix's smooth-noise content
(``harness/images.py``), the sizes alternating batch by batch, in page-locked
memory from ``dirjax_torch.extraction.pinned_empty`` on the card, as the
loader makes them there. It warms every size. The window calls the
extractor closed-loop over the pool, one batch in flight, as
``extract_image_features`` does: it launches the next batch, then pulls the
previous one's descriptors. The rate is the images whose descriptors came
back over the window; a cell whose end-to-end metrics hold
``extract_device_ms_per_img`` profiles the device over the whole window and
reports its busy time over those images instead. The check compares a
sample of the returned descriptors, drawn from the seed, with the
configuration's fp32 reference on their pool pixels, on the card in blocks.

The configuration's ``model.block`` picks the weights and the reference:
``bottleneck``, ``harness/weights.py`` and ``reference/resnet_gem.py``;
``vit``, ``harness/vit_weights.py`` and ``reference/vit_gem.py``.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from harness import images, trace, vit_weights, weights
from harness.runner import Check, Window
from reference import resnet_gem, vit_gem

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
IN_CALL = "in the extractor call (upload, normalize, forward launches)"
BETWEEN_CALLS = "between extractor calls (the previous batch's pull)"
DEVICE_MS = "extract_device_ms_per_img"
FAMILIES = {"bottleneck": (weights, resnet_gem), "vit": (vit_weights, vit_gem)}


@dataclass
class State:
    sd: dict
    pool: List[np.ndarray]
    extractor: object
    model: object = None
    returned: List[tuple] = field(default_factory=list)   # (pool slot, descriptors)


def _family(ctx):
    block = ctx.config["model"]["block"]
    if block not in FAMILIES:
        raise ValueError(f"no weights or reference for model block {block!r}")
    return FAMILIES[block]


def _pool(ctx) -> List[np.ndarray]:
    """``pool_batches`` uint8 batches, sizes alternating, from the seed."""
    mix = ctx.mix
    batch = int(ctx.config["inference"]["batch_size"])
    sizes = [tuple(s) for s in mix["sizes"]]
    if ctx.device == "cuda":
        from dirjax_torch.extraction import pinned_empty
    else:
        pinned_empty = np.empty
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    pool = []
    for i in range(int(mix["pool_batches"])):
        w, h = sizes[i % len(sizes)]
        out = pinned_empty((batch, h, w, 3), np.uint8)
        out[...] = images.render(g, batch, w, h, mix["content"], ctx.device).cpu().numpy()
        pool.append(out)
    return pool


def setup(ctx) -> State:
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import create_model

    model_cfg = ctx.config["model"]
    make_weights, ref = _family(ctx)
    with torch.device("meta"):
        model = create_model(model_cfg["arch"])
    sd = make_weights.state_dict(model_cfg, ctx.seed, ctx.device)
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(sd)
    program = FeatureExtractor(model, ctx.device, dtype=DTYPES[ctx.config["inference"]["dtype"]])
    extractor = ctx.hook("extractor", program, sd=sd, config=ctx.config)
    if isinstance(extractor, resnet_gem.Extractor) and ref is not resnet_gem:
        # the control of harness/controls.py is the ResNet reference's: stand
        # the configuration's own reference in, at the same precision. This
        # goes once controls.control picks its reference by model.block.
        extractor = ref.Extractor(ctx.config, sd, extractor.device,
                                  extractor.forward.precision)
    pool = _pool(ctx)
    n_sizes = len(ctx.mix["sizes"])
    for i in range(int(ctx.mix["warm_batches"]) * n_sizes):
        extractor(pool[i % len(pool)]).cpu()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return State(sd=sd, pool=pool, extractor=extractor, model=model)


def window(ctx, st: State) -> Window:
    whole = (not ctx.trace and ctx.device == "cuda"
             and any(m["name"] == DEVICE_MS for m in ctx.cell.end_to_end))
    if whole:   # the profiler runs from before the first call to the window's end
        tracer = trace.Slice(True, float("-inf"), float("inf"))
        tracer.tick()
    start = time.perf_counter()
    if not whole:
        lo = start + float(ctx.mix["trace_from"]) * ctx.seconds
        tracer = trace.Slice(ctx.trace, lo, min(float(ctx.mix["trace_seconds"]),
                                                0.5 * ctx.seconds))
    spans, pending, done, i = [], None, 0, 0
    while True:
        slot = i % len(st.pool)
        tracer.tick()
        t0 = time.perf_counter()
        dev = st.extractor(st.pool[slot])
        spans.append((t0, time.perf_counter(), len(st.pool[slot])))
        if pending is not None:     # the previous batch's pull, behind this launch
            st.returned.append((pending[0], pending[1].cpu().numpy()))
            done += len(st.returned[-1][1])
        pending, i = (slot, dev), i + 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    st.returned.append((pending[0], pending[1].cpu().numpy()))
    done += len(st.returned[-1][1])
    end = time.perf_counter()
    tracer.end([(a, b, IN_CALL) for a, b, _ in spans], BETWEEN_CALLS)
    elapsed = end - start
    per_call = sum(b - a for a, b, _ in spans) * 1e3 / len(spans)
    notes = [f"extract_decoded: {done} images in {elapsed:.6f} s, {i} calls over a pool of "
             f"{len(st.pool)} batches; {per_call:.3f} ms in the extractor call a batch"]
    values = {"extract_img_per_s": done / elapsed}
    if whole:
        values[DEVICE_MS] = tracer.trace.busy_s * 1e3 / done
        notes.append(f"extract_decoded: device busy {tracer.trace.busy_s!r} s of "
                     f"{tracer.trace.window_s!r} s traced, {len(tracer.trace.events)} device "
                     f"events; {values[DEVICE_MS]!r} device ms an image")
    return Window(values=values, attempted=done, failed=0, trace=tracer.trace,
                  spans={"extractor": spans, "window": [(start, end, done)]}, notes=notes)


@torch.no_grad()
def check(ctx, st: State, win: Window) -> List[Check]:
    """The sampled descriptors against the fp32 reference on their pool
    pixels: ``desc_dist``, the widest L2 distance between a returned unit
    descriptor and the reference's."""
    rows = [(slot, r) for slot, descs in st.returned for r in range(len(descs))]
    got_all = np.concatenate([descs for _, descs in st.returned])
    st.extractor = st.model = st.returned = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([ctx.seed, 1])
    sample = np.sort(rng.choice(len(rows), min(len(rows), int(ctx.mix["sample_images"])),
                                replace=False))
    _, ref = _family(ctx)
    forward = ref.Forward(ctx.config["model"], ctx.config["preprocess"], st.sd)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    want = np.zeros((len(sample), got_all.shape[1]), np.float32)
    try:
        by_slot = {}
        for j, i in enumerate(sample):
            by_slot.setdefault(rows[i][0], []).append((j, rows[i][1]))
        for slot, picks in by_slot.items():
            x = torch.from_numpy(st.pool[slot][[r for _, r in picks]]).to(ctx.device)
            want[[j for j, _ in picks]] = forward(x).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    dist = np.linalg.norm(got_all[sample].astype(np.float64) - want, axis=1)
    worst = float(np.nanmax(dist)) if np.all(np.isfinite(dist)) else float("nan")
    print(f"extract_decoded: {len(sample)} sampled descriptors, L2 distance to the reference "
          f"median {float(np.median(dist))!r} max {worst!r}", file=sys.stderr)
    return [Check("desc_dist", worst, float(ctx.cell.limits.get("desc_dist", float("nan"))))]
