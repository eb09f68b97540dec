"""Similarity scoring and top-k ranking (counterpart of
``dirjax/ops/ranking.py``). fp32 matmuls: bf16 or TF32 rounding could
reorder near-tied scores and shift mAP, so callers keep TF32 off."""

from __future__ import annotations

import numpy as np
import torch

from .topk import _topk

__all__ = ["compute_scores", "compute_scores_chunked", "rank_topk"]


def compute_scores(qdescs: torch.Tensor, db_descs: torch.Tensor) -> torch.Tensor:
    """(Nq, D) x (Nd, D) -> (Nq, Nd) dot-product similarity in fp32."""
    return qdescs.float() @ db_descs.float().T


def compute_scores_chunked(qdescs: torch.Tensor, db_descs,
                           chunk: int = 262144) -> np.ndarray:
    """Score against a database streamed in ``chunk``-row blocks onto the
    queries' device; full score rows are assembled on the host (junk-aware
    mAP needs complete rows)."""
    out = []
    for start in range(0, db_descs.shape[0], chunk):
        block = torch.as_tensor(db_descs[start:start + chunk]).to(qdescs.device)
        out.append(compute_scores(qdescs, block).cpu().numpy())
    return np.concatenate(out, axis=1)


def rank_topk(qdescs: torch.Tensor, db_descs: torch.Tensor, k: int):
    """Score + top-k: (values, indices) of the k best database rows, ties
    to the lower index (``lax.top_k``)."""
    return _topk(compute_scores(qdescs, db_descs), k)
