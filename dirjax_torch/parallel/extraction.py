"""Batch-sharded descriptor extraction over the mesh's "data" axis
(counterpart of ``dirjax/parallel/extraction.py``).

Every rank is given the whole batch: it pads the batch to a multiple of the
"data" size, runs its contiguous slice through
:class:`~dirjax_torch.extraction.FeatureExtractor` on its device (K1 on the
card), all-gathers the descriptors over "data" and returns the first ``n``.
Global pooling is per image, so no rank needs another's activations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..extraction import FeatureExtractor, adaptive_call
from ..models import RMACDescriptor
from .mesh import axis_rank, axis_size, mesh_device
from .ranking import gather_shards

__all__ = ["ShardedExtractor"]


class ShardedExtractor:
    """Like :class:`~dirjax_torch.extraction.FeatureExtractor` (the same
    call signature, ``device`` and ``preprocess``), but each rank extracts
    its slice of the batch and every rank returns all the descriptors, so
    :func:`~dirjax_torch.extraction.eval_model` runs on it unchanged."""

    def __init__(self, model: RMACDescriptor, mesh: DeviceMesh, dtype=torch.float32,
                 axis: str = "data", preprocess: Optional[dict] = None):
        self.mesh, self.axis = mesh, axis
        self.n_shards = axis_size(mesh, axis)
        self._inner = FeatureExtractor(model, mesh_device(mesh), dtype=dtype,
                                       preprocess=preprocess)
        self.model, self.device = self._inner.model, self._inner.device
        self.dtype, self.preprocess = dtype, self._inner.preprocess

    @staticmethod
    def _pad(a: np.ndarray, pad: int) -> np.ndarray:
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a

    def __call__(self, images: np.ndarray, mask: Optional[np.ndarray] = None) -> torch.Tensor:
        """(B, H, W, 3) uint8 or normalized float images, the same on every
        rank -> (B, D) fp32 descriptors on this rank's device. Pad images
        (zeros, masked out) fill the batch to a multiple of the shards."""
        n = images.shape[0]
        pad = (-n) % self.n_shards
        images = self._pad(np.asarray(images), pad)
        if mask is not None:
            mask = self._pad(np.asarray(mask), pad)
        per = images.shape[0] // self.n_shards
        start = axis_rank(self.mesh, self.axis) * per
        local = self._inner(images[start:start + per],
                            None if mask is None else mask[start:start + per])
        return gather_shards(local.float(), self.mesh, self.axis)[:n]

    def call_adaptive(self, images: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
        """``__call__`` halving the batch on an out-of-memory error
        (:func:`~dirjax_torch.extraction.adaptive_call`); each half is padded
        to the shard count again. Every rank halves alike only if every rank
        runs out of memory alike, as ranks of equal cards on equal slices do."""
        return adaptive_call(self, images, mask)
