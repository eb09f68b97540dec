"""Alpha query expansion (AQE) and database augmentation (ADBA), dense form
(counterpart of ``dirjax/ops/qe.py:34-96``):

    q' = normalize( (q + sum_{j in topk(q)} sim(q, d_j)^alpha * d_j) / (k+1) )

ADBA expands the database against itself with the self-similarity zeroed
first, so a zeroed self can still fill a top-k slot (weight 0^alpha) when
fewer than k neighbours score positive.
"""

from __future__ import annotations

import torch

from .normalize import l2_normalize

__all__ = ["expand_queries", "expand_database"]


def _weights(top_sims: torch.Tensor, alpha: float) -> torch.Tensor:
    """sim^alpha as numpy computes it for an integer alpha: a negative sim
    keeps sign^alpha where a plain float power would give NaN."""
    if float(alpha).is_integer():
        return torch.sign(top_sims) ** int(alpha) * top_sims.abs().pow(alpha)
    return top_sims.pow(alpha)


def _expand_from_sims(descs, db_descs, sims, alpha: float, k: int):
    k = min(int(k), db_descs.shape[0])
    top_sims, top_idx = torch.topk(sims, k, dim=1)
    neighbors = db_descs[top_idx]                           # (N, k, D)
    weighted = torch.einsum("nk,nkd->nd", _weights(top_sims, alpha), neighbors)
    return l2_normalize((descs + weighted) / (k + 1.0))


def expand_queries(qdescs: torch.Tensor, db_descs: torch.Tensor,
                   alpha: float = 3.0, k: int = 10) -> torch.Tensor:
    """AQE: expand each query with its top-k database neighbours."""
    qdescs, db_descs = qdescs.float(), db_descs.float()
    return _expand_from_sims(qdescs, db_descs, qdescs @ db_descs.T, alpha, k)


def expand_database(db_descs: torch.Tensor, alpha: float = 3.0,
                    k: int = 10) -> torch.Tensor:
    """ADBA: expand every database row against the database, self excluded
    by zeroing the diagonal."""
    db_descs = db_descs.float()
    sims = db_descs @ db_descs.T
    sims.fill_diagonal_(0.0)
    return _expand_from_sims(db_descs, db_descs, sims, alpha, k)
