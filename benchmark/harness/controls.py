"""What can stand in the program's place in a run: the control (the
reference one precision step below the configuration's) and the planted
faults the tests drive a run with. Each is a ``program_hook`` for
``runner.Ctx``: ``hook(kind, program, extras)`` returns the object the
window drives, for kind "extractor" (a ``FeatureExtractor``) or "index" (a
``RetrievalIndex``).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import resnet_gem, topk

from . import rows


def control(kind: str, program, extras: dict):
    """fp8 operands for the extractor (bf16 configured); int8 rows and
    queries for the index (bf16 configured)."""
    if kind == "extractor":
        return resnet_gem.Extractor(extras["config"], extras["sd"], program.device, "fp8")
    db = extras["rows"]
    return topk.Int8Control(db.rows, db.n, db.dim, db.device, rows.BLOCK)


class _Faulty:
    """``inner`` with its answers broken as ``fault`` says; every other
    attribute is the inner object's."""

    def __init__(self, inner, fault: str):
        self.inner, self.fault = inner, fault

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, images, mask=None):
        if self.fault == "half_batch":      # the second half never computed
            half = max(1, len(images) // 2)
            out = self.inner(images[:half], None if mask is None else mask[:half])
            return torch.cat([out, out])[:len(images)]
        out = self.inner(images, mask).clone()
        out[:, 0] += 0.5                    # every descriptor altered
        return out / out.norm(dim=1, keepdim=True)

    def search(self, queries, k: int = 10, **opts):
        q = np.asarray(queries)
        if self.fault == "half_batch":      # the second half never searched
            half = max(1, len(q) // 2)
            vals, ids = self.inner.search(q[:half], k=k, **opts)
            reps = -(-len(q) // half)
            return np.tile(vals, (reps, 1))[:len(q)], np.tile(ids, (reps, 1))[:len(q)]
        vals, ids = self.inner.search(q, k=k, **opts)
        ids = np.array(ids, copy=True)
        ids[:, -1] = (ids[:, -1] + 1) % getattr(self.inner, "n", 1 << 20)  # one id altered
        return vals, ids


def fault(name: str):
    """A hook planting ``name`` ("half_batch" or "altered") in the program."""
    def hook(kind: str, program, extras: dict):
        return _Faulty(program, name)
    return hook
