"""Database extraction from JPEG files, as ``test_dir`` and
``extract_features`` run it.

Set-up draws the configuration's weights and the mix's JPEG files from the
seed, builds the program's model (``dirjax_torch.models.create_model``) with
those weights and its ``FeatureExtractor`` in the configuration's dtype, and
warms it on each image size of the mix. The window calls
``dirjax_torch.extraction.extract_image_features`` again and again, each
call over a chunk of an ``ImageList`` whose entries cycle through the files,
so the loader decodes plain image files on its normal path. The rate is the
images whose descriptors came back over the whole window, the last chunk's
overrun included. A cell whose end-to-end metrics hold
``extract_device_ms_per_img`` profiles the device over the whole window and
reports its busy time over the images instead, for a cell where the host's
speed swings too widely for the rate to be held to a bound. The check compares a sample of the returned descriptors,
drawn from the seed, with the plain fp32 reference on the same files.
"""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from harness import images, trace, weights
from harness.runner import Check, Window
from reference import resnet_gem

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# what the host was doing during an idle gap of the device
IN_CALL = "in the extractor call (upload, normalize, forward launches)"
BETWEEN_CALLS = "between extractor calls (loader: decode, batching; the last batch's pull)"
# the end-to-end metric read from a device trace of the whole window
DEVICE_MS = "extract_device_ms_per_img"


class TimedExtractor:
    """The program's extractor as ``extract_image_features`` sees it, with
    each call timed and counted (span "extractor": start, end, images), and
    the traced slice started and stopped between calls."""

    def __init__(self, inner, tracer: trace.Slice):
        self.inner, self.tracer = inner, tracer
        self.spans: List[tuple] = []
        self.preprocess = inner.preprocess               # read by the loader
        self.model = getattr(inner, "model", None)       # read when a chunk is empty

    def __call__(self, images_, mask=None):
        self.tracer.tick()
        t0 = time.perf_counter()
        out = self.inner(images_, mask)
        self.spans.append((t0, time.perf_counter(), len(images_)))
        return out


@dataclass
class State:
    sd: dict
    files: List[tuple]
    tmp: str
    extractor: object
    model: object = None
    returned: List[np.ndarray] = field(default_factory=list)


def _dataset(files, count: int, offset: int = 0):
    from dirjax_torch.datasets.generic import ImageList

    return ImageList(imgs=[files[(offset + i) % len(files)][0] for i in range(count)])


def _extract(ctx, extractor, dataset) -> np.ndarray:
    from dirjax_torch.extraction import extract_image_features

    inf = ctx.config["inference"]
    return extract_image_features(dataset, inf["transforms"], extractor,
                                  batching=inf["batching"], batch_size=inf["batch_size"],
                                  threads=inf["threads"])


def setup(ctx) -> State:
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import create_model

    model_cfg, mix = ctx.config["model"], ctx.mix
    sd = weights.state_dict(model_cfg, ctx.seed, ctx.device)
    tmp = tempfile.mkdtemp(prefix="bench_jpeg_")
    files = images.write_jpegs(mix, ctx.seed, tmp, ctx.device)
    with torch.device("meta"):
        model = create_model(model_cfg["arch"])
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(sd)
    program = FeatureExtractor(model, ctx.device, dtype=DTYPES[ctx.config["inference"]["dtype"]])
    extractor = ctx.hook("extractor", program, sd=sd, config=ctx.config)
    # warm-up: every image size of the mix, in whole batches of each
    from dirjax_torch.datasets.generic import ImageList

    per_size = ctx.config["inference"]["batch_size"] * int(mix["warm_batches"])
    warm = [path for w, h in mix["sizes"]
            for path in [f[0] for f in files if (f[1], f[2]) == (w, h)][:per_size]]
    _extract(ctx, extractor, ImageList(imgs=warm))
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return State(sd=sd, files=files, tmp=tmp, extractor=extractor, model=model)


def window(ctx, st: State) -> Window:
    chunk = int(ctx.mix["chunk_images"])
    whole = (not ctx.trace and ctx.device == "cuda"
             and any(m["name"] == DEVICE_MS for m in ctx.cell.end_to_end))
    if whole:   # the profiler runs from before the first call to the window's end
        tracer = trace.Slice(True, float("-inf"), float("inf"))
        tracer.tick()
    start = time.perf_counter()
    if not whole:
        tracer = trace.Slice(ctx.trace, *_slice_times(start, ctx.seconds, ctx.mix))
    timed = TimedExtractor(st.extractor, tracer)
    done, ends = 0, []
    while True:
        st.returned.append(_extract(ctx, timed, _dataset(st.files, chunk, done)))
        done += chunk
        ends.append(time.perf_counter())
        if ends[-1] - start >= ctx.seconds:
            break
    elapsed = ends[-1] - start
    tracer.end([(a, b, IN_CALL) for a, b, _ in timed.spans], BETWEEN_CALLS)
    rates = [chunk / (b - a) for a, b in zip([start] + ends[:-1], ends)]
    calls = [sum(e - s for s, e, _ in timed.spans if a <= s < b) * 1e3 * 8 / chunk
             for a, b in zip([start] + ends[:-1], ends)]
    notes = [f"extract: {done} images in {elapsed:.6f} s, chunks of {chunk}, "
             f"{len(st.files)} files; img/s by chunk {[round(r, 1) for r in rates]}; "
             f"ms in the extractor call a batch of 8, by chunk {[round(c, 2) for c in calls]}"]
    values = {"extract_img_per_s": done / elapsed}
    if whole:
        values[DEVICE_MS] = tracer.trace.busy_s * 1e3 / done
        notes.append(f"extract: device busy {tracer.trace.busy_s!r} s of "
                     f"{tracer.trace.window_s!r} s traced, {len(tracer.trace.events)} device "
                     f"events; {values[DEVICE_MS]!r} device ms an image")
    return Window(values=values, attempted=done, failed=0, trace=tracer.trace,
                  spans={"extractor": timed.spans, "window": [(start, ends[-1], done)]},
                  notes=notes)


def _slice_times(start: float, seconds: float, mix: dict):
    lo = start + float(mix["trace_from"]) * seconds
    return lo, min(float(mix["trace_seconds"]), 0.5 * seconds)


def check(ctx, st: State, win: Window) -> List[Check]:
    """The sampled descriptors against the fp32 reference on their files:
    ``desc_dist``, the widest L2 distance between a returned unit descriptor
    and the reference's."""
    returned = np.concatenate(st.returned)
    st.extractor = st.model = st.returned = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([ctx.seed, 1])
    sample = np.sort(rng.choice(len(returned), min(len(returned),
                                                   int(ctx.mix["sample_images"])),
                                replace=False))
    paths = [st.files[i % len(st.files)][0] for i in sample]
    try:
        want = resnet_gem.descriptors(ctx.config["model"], ctx.config["preprocess"], st.sd,
                                      paths, ctx.device)
    finally:
        shutil.rmtree(st.tmp, ignore_errors=True)
    got = returned[sample]
    dist = np.linalg.norm(got.astype(np.float64) - want, axis=1)
    worst = float(np.nanmax(dist)) if np.all(np.isfinite(dist)) else float("nan")
    print(f"extract: {len(sample)} sampled descriptors, L2 distance to the reference "
          f"median {float(np.median(dist))!r} max {worst!r}", file=sys.stderr)
    return [Check("desc_dist", worst, float(ctx.cell.limits.get("desc_dist", float("nan"))))]
