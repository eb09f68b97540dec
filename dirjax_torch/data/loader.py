"""Host-side data loading: threaded decode/transform + TPU-friendly batching.

The port's own copy of ``dirjax/data/loader.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Replaces the reference's torch DataLoader stack
(``dirtorch/utils/pytorch_loader.py``) with a thread-pool pipeline producing
NHWC numpy batches ready for device upload. Two batching strategies address
XLA's static-shape model (the reference instead falls back to batch=1 for
variable sizes, test_dir.py:52-55):

* ``group``  — batch only identically-shaped images together (benchmark
  datasets concentrate on a handful of shapes, so this costs few compiles
  and is bit-exact), and
* ``bucket`` — pad every image up to shape buckets (H, W rounded up to a
  multiple) and emit a validity mask for masked pooling: one compile per
  bucket, maximal MXU occupancy.

Also provides :class:`BalancedSampler` (log-interpolated per-class targets,
reference pytorch_loader.py:184-249) and the small loader helpers.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ..utils import timer
from . import transforms as T

__all__ = [
    "SampleLoader", "get_loader", "iterate_batches", "BalancedSampler",
    "Batch", "load_one_img", "array2img", "test_loader_speed",
]


def _try_to_get(func, *args, **kwargs):
    try:
        return func(*args, **kwargs)
    except NotImplementedError:
        return None


class SampleLoader:
    """index -> transformed sample fields.

    ``output`` names the fields returned per sample: 'img' (HWC float array
    after the chain's ToArray/Normalize), 'label', 'bbox', 'img_key',
    'img_filename', 'imsize', plus anything a transform added to the sample
    dict (e.g. BBoxToPixelLabel's 'pix_label').

    Iterating a SampleLoader yields :class:`Batch` objects following the
    batching settings stored by :func:`get_loader` (batch_size / shuffle /
    balanced / threads ...), making it a drop-in for the reference's torch
    DataLoader loop. Index explicitly (``loader[i]``) for single samples, or
    call :func:`iterate_batches` with your own order/settings."""

    # batch-iteration settings, overridden by get_loader(...)
    batch_size: int = 8
    threads: int = 8
    processes: int = 0
    shuffle: bool = False
    balanced: float = 0.0
    use_all: bool = False
    batching: str = "group"
    seed = None
    #: use the native C decode+resize pipeline when the transform chain and
    #: dataset allow it (bit-exact with the PIL path; see dirjax.data.native)
    native_decode: bool = True
    #: 'raise' (default) propagates decode/transform errors; 'skip' drops
    #: the failing sample from the batch stream with a warning — corrupt
    #: files in a crawl must not kill a long training run. Extraction keeps
    #: its strict every-image contract and refuses silently-short results.
    on_error: str = "raise"

    def __init__(self, dataset, transform=None, output=("img", "label")):
        self.dataset = dataset
        self.transform = transform
        self.output = tuple(output)
        self._native_load = None  # resolved lazily: False = disabled

    def __getstate__(self):
        # the resolved fast path is a closure (unpicklable); worker processes
        # re-resolve it locally
        state = self.__dict__.copy()
        state["_native_load"] = None
        return state

    _NATIVE_FIELDS = {"img", "label", "img_key", "img_filename", "imsize"}

    def _native_fast_path(self):
        """filename -> img-array loader, or None. Enabled only when (a) the
        native lib built, (b) the transform chain is exactly reproducible
        natively, (c) the dataset serves plain image files (no crop/ROI
        override of get_image), and (d) no output field needs PIL-side
        bookkeeping. Bit-exactness with the PIL path is tested
        (tests/test_native.py)."""
        if self._native_load is None:
            from ..datasets.base import Dataset as _Base
            from . import native

            plan = None
            if (self.native_decode and native.available()
                    and set(self.output) <= self._NATIVE_FIELDS
                    and type(self.dataset).get_image is _Base.get_image):
                plan = native.plan_fast_path(self.transform)
            self._native_load = plan if plan is not None else False
        return self._native_load or None

    def __len__(self):
        return len(self.dataset)

    def default_order(self):
        """Index order per the stored settings: a fresh BalancedSampler draw
        when ``balanced`` > 0, else a (possibly shuffled) range."""
        if self.balanced > 0:
            sampler = BalancedSampler(
                self.dataset, balanced=self.balanced, use_all=self.use_all,
                rng=np.random.default_rng(self.seed))
            return list(iter(sampler))
        order = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        return order

    def __iter__(self) -> "Iterator[Batch]":
        return iterate_batches(self, self.default_order(),
                               batch_size=self.batch_size,
                               threads=self.threads,
                               processes=self.processes,
                               batching=self.batching)

    def __getitem__(self, index):
        fast = self._native_fast_path()
        if fast is not None:
            from .native import Unsupported

            filename = self.dataset.get_filename(index)
            try:
                img = fast(filename)
            except (Unsupported, ValueError, OSError):
                img = None  # CMYK/16-bit/exotic input: PIL path below
            if img is not None:
                sample = {
                    "img_filename": filename,
                    "img_key": self.dataset.get_key(index),
                    "img": img,
                    "label": _try_to_get(self.dataset.get_label, index,
                                         toint=True),
                    "imsize": tuple(img.shape[:2]),
                }
                # same contract as the PIL path below: requesting a field
                # the dataset can't provide must raise in BOTH paths, not
                # silently yield None only when the native lib is built
                for o in self.output:
                    assert sample.get(o) is not None, \
                        f"Missing field {o} for img {sample['img_filename']}"
                return {o: sample[o] for o in self.output}
        sample = {
            "img_filename": self.dataset.get_filename(index),
            "img_key": self.dataset.get_key(index),
            "img": self.dataset.get_image(index),
            "label": _try_to_get(self.dataset.get_label, index, toint=True),
        }
        if "bbox" in self.output and hasattr(self.dataset, "get_bbox"):
            bbox = _try_to_get(self.dataset.get_bbox, index)
            if bbox:
                sample["bbox"] = bbox
        if self.transform is not None:
            sample = self.transform(sample)
        sample["imsize"] = tuple(sample["img"].shape[:2]) \
            if isinstance(sample["img"], np.ndarray) else sample["img"].size[::-1]
        for o in self.output:
            assert sample.get(o) is not None, \
                f"Missing field {o} for img {sample['img_filename']}"
        return {o: sample[o] for o in self.output}


@dataclass
class Batch:
    """One device-ready batch."""

    images: np.ndarray                    # (B, H, W, C) float32
    mask: Optional[np.ndarray]            # (B, H, W) bool, None if exact
    indices: np.ndarray                   # dataset indices of the rows
    fields: dict = field(default_factory=dict)  # other requested outputs


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_WORKER_LOADER: Optional[SampleLoader] = None


def _worker_init(loader: SampleLoader) -> None:
    global _WORKER_LOADER
    _WORKER_LOADER = loader


def _worker_get(i: int):
    if getattr(_WORKER_LOADER, "on_error", "raise") == "skip":
        try:
            return i, _WORKER_LOADER[i]
        except Exception as e:
            import warnings

            warnings.warn(f"skipping sample {i}: {e}")
            return i, None
    return i, _WORKER_LOADER[i]


def iterate_batches(loader: SampleLoader, order: Sequence[int],
                    batch_size: int = 8, threads: int = 8,
                    batching: str = "group", bucket_multiple: int = 64,
                    max_pixels: Optional[int] = None,
                    processes: int = 0,
                    alloc: Optional[Callable] = None) -> Iterator[Batch]:
    """Decode+transform in a thread pool (or worker processes), then batch.

    ``batching='group'``: exact shapes, same-shape rows batched together.
    ``batching='bucket'``: shapes padded up to ``bucket_multiple`` buckets
    with validity masks.
    ``batching='single'``: one image per batch (reference behavior).
    ``processes>0``: decode in that many worker processes instead of threads
    — PIL resize/convert holds the GIL, so threads alone cannot saturate a
    multi-core host (the analog of torch DataLoader's num_workers,
    reference pytorch_loader.py:67-73). Pair with the uint8
    ``device_normalize`` loader so each sample pickles ~1 MB, not ~17 MB.

    On the thread path each sample's decode and transform is a
    ``loader.decode`` span (:mod:`dirjax_torch.utils.timer`). With
    ``processes > 0`` the decode runs in the worker processes, and this
    process records no such span.

    ``alloc(shape, dtype)`` gives the uninitialised array each batch's images,
    and its mask, are written into (default ``np.empty``): the extractor's
    page-locked host memory, so the batch goes to the device as it is.
    """
    alloc = alloc or np.empty
    order = list(order)
    skip_errors = getattr(loader, "on_error", "raise") == "skip"

    def get_one(ldr, i):
        with timer.span("loader.decode"):
            if not skip_errors:
                return i, ldr[i]
            try:
                return i, ldr[i]
            except Exception as e:  # corrupt file: drop it, keep the run alive
                import warnings

                warnings.warn(f"skipping sample {i} "
                              f"({ldr.dataset.get_filename(i)}): {e}")
                return i, None

    if processes > 0:
        from concurrent.futures import ProcessPoolExecutor

        pool = ProcessPoolExecutor(max_workers=processes,
                                   initializer=_worker_init,
                                   initargs=(loader,))
        samples = pool.map(_worker_get, order)
    else:
        pool = ThreadPoolExecutor(max_workers=max(1, threads))
        samples = pool.map(lambda i: get_one(loader, i), order)
    if skip_errors:
        samples = (s for s in samples if s[1] is not None)

    def emit(group) -> Batch:
        idxs, items = zip(*group)
        imgs = [it["img"] for it in items]
        shapes = {im.shape for im in imgs}
        fields = {k: [it[k] for it in items]
                  for k in items[0] if k != "img"}
        if len(shapes) == 1 and batching != "bucket":
            dtype = np.result_type(*{im.dtype for im in imgs})
            images = np.stack(imgs, out=alloc((len(imgs),) + imgs[0].shape, dtype))
            return Batch(images=images, mask=None,
                         indices=np.asarray(idxs), fields=fields)
        hmax = max(im.shape[0] for im in imgs)
        wmax = max(im.shape[1] for im in imgs)
        hmax = _round_up(hmax, bucket_multiple)
        wmax = _round_up(wmax, bucket_multiple)
        canvas = alloc((len(imgs), hmax, wmax, imgs[0].shape[2]), imgs[0].dtype)
        mask = alloc((len(imgs), hmax, wmax), bool)
        for r, im in enumerate(imgs):  # every element written once
            h, w = im.shape[:2]
            canvas[r, :h, :w] = im
            canvas[r, :h, w:] = 0
            canvas[r, h:] = 0
            mask[r, :h, :w] = True
            mask[r, :h, w:] = False
            mask[r, h:] = False
        return Batch(images=canvas, mask=mask, indices=np.asarray(idxs),
                     fields=fields)

    try:
        if batching == "single":
            for i, item in samples:
                yield emit([(i, item)])
        elif batching == "group":
            pending: dict = {}
            for i, item in samples:
                key = item["img"].shape
                pending.setdefault(key, []).append((i, item))
                if len(pending[key]) == batch_size:
                    yield emit(pending.pop(key))
            for group in pending.values():
                yield emit(group)
        elif batching == "bucket":
            pending = {}
            for i, item in samples:
                h, w = item["img"].shape[:2]
                key = (_round_up(h, bucket_multiple), _round_up(w, bucket_multiple))
                if max_pixels and key[0] * key[1] > max_pixels:
                    # oversize images go alone
                    yield emit([(i, item)])
                    continue
                pending.setdefault(key, []).append((i, item))
                if len(pending[key]) == batch_size:
                    yield emit(pending.pop(key))
            for group in pending.values():
                yield emit(group)
        else:
            raise ValueError(f"unknown batching mode: {batching}")
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def get_loader(dataset, trf_chain: str = "", iscuda=None, preprocess=None,
               output=("img",), batch_size: int = 8, threads: int = 8,
               shuffle: bool = False, balanced: float = 0,
               use_all: bool = False, totensor: bool = True,
               device_normalize: bool = False, batching: str = "group",
               processes: int = 0, seed=None,
               native_decode: bool = True,
               on_error: str = "raise") -> SampleLoader:
    """Reference-signature convenience (pytorch_loader.py:11-73): build the
    transform chain from preprocess vars and return a :class:`SampleLoader`.

    ``batch_size`` / ``threads`` / ``processes`` / ``shuffle`` / ``balanced``
    / ``use_all`` / ``batching`` configure the loader's own batch iteration
    (``for batch in loader``); :func:`iterate_batches` remains the explicit
    API when the caller controls the order. ``iscuda`` is accepted for
    signature parity and ignored — device placement is JAX's job.

    ``device_normalize=True`` emits uint8 HWC arrays and leaves /255 +
    mean/std to the device (the extractor): ~100x less host CPU per image
    and 4x fewer host->device bytes."""
    preprocess = dict(preprocess or {})
    preprocess.setdefault("mean", [0.485, 0.456, 0.406])
    preprocess.setdefault("std", [0.229, 0.224, 0.225])
    if device_normalize and totensor:
        chain = T.create(trf_chain, to_array=False, **preprocess)
        chain = T.Compose(chain.transforms + [T.ToArray(dtype="uint8")])
    else:
        chain = T.create(trf_chain, to_array=totensor, **preprocess)
    loader = SampleLoader(dataset, transform=chain, output=output)
    loader.batch_size = batch_size
    loader.threads = threads
    loader.processes = processes
    loader.shuffle = shuffle
    loader.balanced = balanced
    loader.use_all = use_all
    loader.batching = batching
    loader.seed = seed
    loader.native_decode = native_decode
    assert on_error in ("raise", "skip"), on_error
    loader.on_error = on_error
    return loader


class BalancedSampler:
    """Yields dataset indices such that classes are (approximately) equally
    represented; ``balanced`` in [0,1] interpolates log-target sizes between
    the true class size and the percentile target
    (reference pytorch_loader.py:184-249)."""

    def __init__(self, dataset, size: float = 1.0, balanced: float = 1.0,
                 use_all: bool = False, rng=None):
        assert 0 <= size <= 2
        assert 0 <= balanced <= 1
        self.cls_imgs = [[] for _ in range(dataset.nclass)]
        for i in range(len(dataset)):
            self.cls_imgs[dataset.get_label(i, toint=True)].append(i)
        self.npc = np.percentile([len(imgs) for imgs in self.cls_imgs],
                                 max(0, min(50 * size, 100)))
        self.balanced = balanced
        self.use_all = use_all
        self.rng = rng or np.random.default_rng()
        self.nelem = int(0.5 + self.npc * dataset.nclass)

    def __iter__(self):
        indices = []
        b = self.balanced
        for imgs in self.cls_imgs:
            imgs = list(imgs)
            self.rng.shuffle(imgs)
            if imgs:
                target = 2 ** (b * np.log2(self.npc) + (1 - b) * np.log2(len(imgs)))
                target = int(0.5 + target)
            else:
                target = 0
            if self.use_all:
                target = max(target, len(imgs))
            repeated: list = []
            while len(repeated) < target:
                repeated += imgs
            indices += repeated[:target]
        self.rng.shuffle(indices)
        self.nelem = len(indices)
        return iter(indices)

    def __len__(self):
        return self.nelem


def load_one_img(loader: SampleLoader, order=None):
    """Yield samples one by one (helper, reference pytorch_loader.py:256-267)."""
    for i in order if order is not None else range(len(loader)):
        yield loader[i]


def array2img(arr, preprocess):
    """Undo ToArray+Normalize: HWC float array -> PIL image
    (reference tensor2img, pytorch_loader.py:270-284)."""
    from PIL import Image

    mean = np.asarray(preprocess["mean"])
    std = np.asarray(preprocess["std"])
    res = np.uint8(np.clip(255 * (arr * std + mean), 0, 255))
    return Image.fromarray(res)


def test_loader_speed(loader: SampleLoader, order=None) -> float:
    """Images/second through decode+transform (reference :287-294)."""
    import time

    n = 0
    start = time.perf_counter()
    for _ in load_one_img(loader, order):
        n += 1
    return n / (time.perf_counter() - start)
