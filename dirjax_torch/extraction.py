"""Descriptor extraction and benchmark evaluation (counterpart of
``dirjax/extraction.py``).

The host decodes and batches images through the port's copy of dirjax's
host loader (:mod:`dirjax_torch.data`) as uint8; for a model on a CUDA
device the loader builds each batch in page-locked memory, which goes up by a
non-blocking copy. The device normalizes them with the checkpoint's
mean/std, runs the descriptor forward, pools the transform chains, whitens,
expands (AQE/ADBA) and scores. mAP stays on the host.
"""

from __future__ import annotations

import os
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from . import ops
from .data.loader import get_loader, iterate_batches
from .models import RMACDescriptor
from .utils import evaluation as ev
from .utils import timer

__all__ = ["extract_image_features", "eval_model", "FeatureExtractor",
           "adaptive_call", "pinned_empty", "staged_uploads", "staged_bytes"]

#: ``FeatureExtractor`` calls whose batch or mask went up from page-locked
#: host memory by a non-blocking copy, and the bytes so sent, in this process
#: (reset them to count a run)
staged_uploads = 0
staged_bytes = 0


def pinned_empty(shape, dtype) -> np.ndarray:
    """An uninitialised host array in page-locked memory from PyTorch's
    caching host allocator: the numpy view of a pinned tensor, which
    :class:`FeatureExtractor` sends to its CUDA device as it is, without a
    host copy and without blocking. Needs CUDA."""
    a = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                    pin_memory=True).numpy()
    _PINNED[id(a.base)] = a.base
    return a


#: the pinned tensors that :func:`pinned_empty`'s live arrays view (each
#: array's ``base``), by id: such an array goes up without a host copy
_PINNED: "weakref.WeakValueDictionary[int, torch.Tensor]" = weakref.WeakValueDictionary()


def _batch_alloc(extractor):
    """The loader's allocator for ``extractor``'s batches: :func:`pinned_empty`
    when its model is on a CUDA device, else None (numpy's)."""
    model = getattr(extractor, "model", None)
    param = None if model is None else next(model.parameters(), None)
    return pinned_empty if param is not None and param.is_cuda else None


def _to_numpy(descs) -> np.ndarray:
    return descs.cpu().numpy() if torch.is_tensor(descs) else np.asarray(descs)


def adaptive_call(call, images: np.ndarray,
                  mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Run ``call(images, mask)``, halving the batch recursively (down to
    single images) on ``torch.cuda.OutOfMemoryError``, on the same device.
    Returns a host array."""
    try:
        return _to_numpy(call(images, mask))
    except torch.cuda.OutOfMemoryError:
        if len(images) <= 1:
            raise
    half = len(images) // 2
    return np.concatenate([
        adaptive_call(call, images[:half], None if mask is None else mask[:half]),
        adaptive_call(call, images[half:], None if mask is None else mask[half:]),
    ])


class FeatureExtractor:
    """Descriptor forward of ``model`` on ``device``.

    ``dtype`` is the backbone's compute dtype (fp32, or bf16 for speed).
    ``preprocess`` is the checkpoint's mean/std dict; it defaults to the
    architecture's ImageNet constants.
    """

    def __init__(self, model: RMACDescriptor, device, dtype=torch.float32,
                 preprocess: Optional[dict] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.dtype = dtype
        self.preprocess = dict(model.cfg.preprocess)
        if preprocess:
            self.preprocess.update(preprocess)
        std = torch.tensor(self.preprocess["std"], dtype=torch.float32)
        mean = torch.tensor(self.preprocess["mean"], dtype=torch.float32)
        self._scale = (1.0 / (255.0 * std)).to(self.device)
        self._offset = (mean / std).to(self.device)

    @torch.inference_mode()
    def __call__(self, images: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> torch.Tensor:
        """(B, H, W, 3) uint8 or normalized float images -> (B, D) fp32
        descriptors on the device (not synchronised). The upload with its
        normalize is the span ``extract.upload``, the forward's launches
        ``extract.forward``."""
        global staged_uploads, staged_bytes
        with timer.span("extract.upload", len(images)):
            x, pinned = self._upload(images)
            if x.dtype == torch.uint8:
                # normalize on the device: the host ships raw pixels
                x = x.float() * self._scale - self._offset
            x = x.permute(0, 3, 1, 2)  # NHWC storage = NCHW channels_last
            m = None
            if mask is not None:
                m, mask_pinned = self._upload(mask)
                pinned += mask_pinned
            if pinned:
                staged_uploads += 1
                staged_bytes += pinned
        with timer.span("extract.forward", len(images)):
            return self.model(x, mask=m, dtype=self.dtype)

    def _upload(self, a: np.ndarray):
        """``a`` on the device, and the bytes sent from page-locked memory.
        An array of :func:`pinned_empty` (the loader's batches for a CUDA
        device) goes up by a non-blocking copy on the current stream, a DMA
        at the link's rate. The copy is launched from the pinned tensor
        itself, so the caching host allocator records its event on the block
        and hands the block out again only after the copy has read it. Any
        other array, a view of one included, takes the plain copy, which
        the host waits for."""
        t = getattr(a, "base", None)
        if t is not None and _PINNED.get(id(t)) is t and self.device.type == "cuda":
            return t.to(self.device, non_blocking=True), a.nbytes
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device), 0

    def call_adaptive(self, images: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> np.ndarray:
        """OOM-surviving ``__call__``; see :func:`adaptive_call`."""
        return adaptive_call(self, images, mask)


def extract_image_features(dataset, transforms: str, extractor: FeatureExtractor,
                           *, flip: Optional[Sequence[int]] = None,
                           batching: str = "group", batch_size: int = 8,
                           threads: int = 8, processes: int = 0,
                           bucket_multiple: int = 64,
                           ret_imgs: bool = False,
                           desc: str = "extract",
                           progress: bool = False):
    """(N, D) descriptors of every image of ``dataset``. ``flip``: optional
    per-image 0/1 list; 1 mirrors the image before the forward.
    ``ret_imgs``: also return the transformed input images (host arrays, cut
    back to each image's extent), ordered by dataset index (the reference's
    debug path, test_dir.py:63,76-77); the return becomes ``(images,
    descriptors)``."""
    loader = get_loader(dataset, trf_chain=transforms,
                        preprocess=extractor.preprocess, output=("img",),
                        totensor=True, device_normalize=True)
    n = len(dataset)
    out: Optional[np.ndarray] = None
    imgs_out: list = [None] * n if ret_imgs else []
    done = 0
    batches = iterate_batches(loader, range(n), batch_size=batch_size,
                              threads=threads, processes=processes,
                              batching=batching, bucket_multiple=bucket_multiple,
                              alloc=_batch_alloc(extractor))
    if progress:
        import tqdm

        batches = tqdm.tqdm(batches, desc=desc)
    pending = None  # (indices, device descriptors) of the batch in flight

    def flush(pending_):
        nonlocal out
        idxs, descs = pending_
        descs = _to_numpy(descs)
        if out is None:
            out = np.zeros((n, descs.shape[1]), np.float32)
        out[idxs] = descs

    batches = iter(batches)
    while True:
        # the wait for the loader's next batch: its decodes, then the batching
        wait = timer.begin()
        batch = next(batches, None)
        if batch is None:
            break
        timer.end(wait, "extract.wait", len(batch.indices))
        images = batch.images
        if flip is not None:
            for r, idx in enumerate(batch.indices):
                if flip[idx]:
                    if batch.mask is None:
                        images[r] = images[r, :, ::-1]
                    else:  # flip the valid region only, to stay on the mask
                        w = int(batch.mask[r][0].sum())
                        images[r, :, :w] = images[r, :, w - 1::-1]
        # one batch in flight: the device runs batch i while the host
        # decodes batch i+1; an OOM at dispatch retries the batch in halves
        try:
            dev = extractor(images, batch.mask)
        except torch.cuda.OutOfMemoryError:
            dev = adaptive_call(extractor, images, batch.mask)
        if pending is not None:
            flush(pending)
        pending = (batch.indices, dev)
        if ret_imgs:
            for r, idx in enumerate(batch.indices):
                # copies: a view would hold the whole (page-locked) batch
                if batch.mask is None:
                    imgs_out[idx] = images[r].copy()
                else:  # un-pad back to the image's real extent
                    h = int(batch.mask[r, :, 0].sum())
                    w = int(batch.mask[r, 0, :].sum())
                    imgs_out[idx] = images[r, :h, :w].copy()
        done += len(batch.indices)
    if pending is not None:
        flush(pending)
    if done != n:
        raise RuntimeError(f"extracted {done}/{n} images")
    if out is None:
        out = np.zeros((0, extractor.model.cfg.out_dim), np.float32)
    if ret_imgs:
        return imgs_out, out
    return out


def eval_model(db, extractor: FeatureExtractor, trfs="", *, pooling="mean",
               gemp=3, detailed=False, whiten=None, aqe=None, adba=None,
               tta=None, threads=8, processes=0, batch_size=8,
               batching="group", save_feats=None, load_feats=None,
               score_chunk=None, progress=False) -> dict:
    """Benchmark evaluation: extract database and query descriptors over
    one or more transform chains, pool them, whiten, expand, score, and
    compute mAP / top-k under the dataset's protocol. Arguments as in
    ``dirjax.extraction.eval_model``; the device stages run on
    ``extractor.device``."""
    if tta not in (None, "", "flip"):
        raise ValueError(f"unknown tta mode: {tta!r}")
    query_db = db.get_query_db()
    device = extractor.device

    if load_feats:
        bdescs = np.load(os.path.join(load_feats, "feats.bdescs.npy"))
        qdescs = (np.load(os.path.join(load_feats, "feats.qdescs.npy"))
                  if query_db is not db else bdescs)
    else:
        trfs_list = [trfs] if isinstance(trfs, str) else list(trfs)
        kw = dict(batch_size=batch_size, threads=threads, processes=processes,
                  progress=progress, batching=batching)
        bl, ql = [], []
        for chain in trfs_list:
            bl.append(extract_image_features(db, chain, extractor, desc="DB", **kw))
            ql.append(bl[-1] if db is query_db else extract_image_features(
                query_db, chain, extractor, desc="query", **kw))
            if tta == "flip":
                bl.append(extract_image_features(
                    db, chain, extractor, desc="DB/flip", flip=[1] * len(db), **kw))
                ql.append(bl[-1] if db is query_db else extract_image_features(
                    query_db, chain, extractor, desc="query/flip",
                    flip=[1] * len(query_db), **kw))
        bdescs = _to_numpy(ops.pool_descriptors(
            [torch.from_numpy(d).to(device) for d in bl], pooling, gemp))
        qdescs = _to_numpy(ops.pool_descriptors(
            [torch.from_numpy(d).to(device) for d in ql], pooling, gemp))

    if save_feats:
        os.makedirs(save_feats, exist_ok=True)
        np.save(os.path.join(save_feats, "feats.bdescs.npy"), bdescs)
        if query_db is not db:
            np.save(os.path.join(save_feats, "feats.qdescs.npy"), qdescs)

    bdev = torch.from_numpy(np.ascontiguousarray(bdescs, np.float32)).to(device)
    qdev = torch.from_numpy(np.ascontiguousarray(qdescs, np.float32)).to(device)
    if whiten is not None:
        wkw = {k: v for k, v in whiten.items() if k != "pca"}
        bdev = ops.apply_whitening(bdev, whiten["pca"], **wkw)
        qdev = ops.apply_whitening(qdev, whiten["pca"], **wkw)
    if adba is not None:
        bdev = ops.expand_database(bdev, **adba)
    if aqe is not None:
        qdev = ops.expand_queries(qdev, bdev, **aqe)

    if score_chunk is None and bdev.numel() > 2 ** 28:
        # auto: chunk so one block streams ~1 GB of fp32 database rows
        score_chunk = max(4096, 2 ** 28 // max(1, bdev.shape[1]))
    if score_chunk:
        scores = ops.compute_scores_chunked(qdev, bdev, chunk=int(score_chunk))
    else:
        scores = _to_numpy(ops.compute_scores(qdev, bdev))

    res: dict = {}
    try:
        aps = [db.eval_query_AP(q, scores[q]) for q in range(len(scores))]
        if not aps:
            pass
        elif not isinstance(aps[0], dict):
            aps = [float(a) for a in aps]
            if detailed:
                res["APs"] = aps
            res["mAP"] = ev.mean_excluding_invalid(aps)
        else:
            for mode in aps[0]:
                vals = [float(a[mode]) for a in aps]
                if detailed:
                    res["APs-" + mode] = vals
                res["mAP-" + mode] = ev.mean_excluding_invalid(vals)
    except NotImplementedError:
        pass

    try:
        tops = [db.eval_query_top(q, scores[q]) for q in range(len(scores))]
        if tops:
            if detailed:
                res["tops"] = tops
            for k in tops[0]:
                res[f"top{k}"] = float(np.mean([t[k] for t in tops]))
    except NotImplementedError:
        pass
    return res
