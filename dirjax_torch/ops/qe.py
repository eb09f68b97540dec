"""Alpha query expansion (AQE) and database augmentation (ADBA)
(counterpart of ``dirjax/ops/qe.py``):

    q' = normalize( (q + sum_{j in topk(q)} sim(q, d_j)^alpha * d_j) / (k+1) )

ADBA expands the database against itself with the self-similarity zeroed
first, so a zeroed self can still fill a top-k slot (weight 0^alpha) when
fewer than k neighbours score positive.

The dense forms build the (N, Nd) similarity matrix. The ``*_chunked`` forms
stream the database in ``db_chunk``-row tiles into a running top-k, and
gather only the k neighbour rows per query, so the matrix never exists;
:func:`expand_queries_quantized` takes its top-k from the int8 kernels of
:mod:`.topk`. ``exclude_mask`` drops rows (tombstones) from the neighbour
set exactly, by over-fetching ``exclude_pad`` extra candidates. Every
top-k ranks ties lower index first, as dirjax's ``lax.top_k`` does.
"""

from __future__ import annotations

import torch

from .normalize import l2_normalize
from .topk import _topk, rank_topk_fused

__all__ = ["expand_descriptors", "expand_queries", "expand_database",
           "expand_queries_chunked", "expand_database_chunked",
           "expand_queries_quantized"]


def _weights(top_sims: torch.Tensor, alpha: float) -> torch.Tensor:
    """sim^alpha as numpy computes it for an integer alpha: a negative sim
    keeps sign^alpha where a plain float power would give NaN."""
    if float(alpha).is_integer():
        return torch.sign(top_sims) ** int(alpha) * top_sims.abs().pow(alpha)
    return top_sims.pow(alpha)


def _expand_from_topk(descs, db_descs, top_sims, top_idx, alpha: float, k: int):
    # gather BEFORE widening: only the (N, k) neighbour rows go to fp32.
    # Slots of -1 (filtered by _drop_excluded) weigh 0.
    neighbors = db_descs[top_idx.clamp_min(0)].float()        # (N, k, D)
    w = torch.where(top_idx >= 0, _weights(top_sims, alpha), 0.0)
    weighted = torch.einsum("nk,nkd->nd", w, neighbors)
    return l2_normalize((descs + weighted) / (k + 1.0))


def _drop_excluded(vals, idxs, exclude_mask, k: int):
    """Exact top-``k`` of the rows not excluded, from a top-``(k + pad)``
    candidate list with ``pad >=`` the excluded count. Excluded and empty
    slots come back as ``(0.0, -1)``."""
    bad = (idxs < 0) | exclude_mask[idxs.clamp_min(0)]
    vals, pos = _topk(vals.masked_fill(bad, float("-inf")), min(k, vals.shape[1]))
    idxs = torch.gather(idxs, 1, pos)
    live = vals > float("-inf")
    return torch.where(live, vals, 0.0), torch.where(live, idxs, -1)


def _expand_from_sims(descs, db_descs, sims, alpha: float, k: int):
    k = min(int(k), db_descs.shape[0])
    top_sims, top_idx = _topk(sims, k)
    return _expand_from_topk(descs, db_descs, top_sims, top_idx, alpha, k)


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


# --------------------------------------------------------------------------
# chunked forms: bounded memory at 1M-row scale
# --------------------------------------------------------------------------

def _chunk_topk(q, chunk, start: int, row0, k: int):
    """Top-k of q @ chunk.T (fp32 after an exact widening) with global
    column offset ``start``; with ``row0`` the (row == column)
    self-similarities are zeroed first (ADBA)."""
    sims = q.float() @ chunk.float().T
    if row0 is not None:
        col = start + torch.arange(chunk.shape[0], device=q.device)
        row = row0 + torch.arange(q.shape[0], device=q.device)
        sims = torch.where(col[None, :] == row[:, None], 0.0, sims)
    vals, idx = _topk(sims, k)
    return vals, idx + start


def _merge_topk(v1, i1, v2, i2, k: int):
    """Top-k of the running (v1, i1) and a chunk's (v2, i2): the running
    entries come first, so an earlier chunk's row wins a tie."""
    best, pos = _topk(torch.cat([v1, v2], dim=1), k)
    return best, torch.gather(torch.cat([i1, i2], dim=1), 1, pos)


def _streaming_topk(q, db, k: int, db_chunk: int, row0=None):
    """(values, indices) of the top-k per query over ``db_chunk``-row tiles
    of the database: peak memory O(len(q) * db_chunk)."""
    if db_chunk < k:
        raise ValueError(f"db_chunk={db_chunk} must be >= k={k}")
    best = None
    for start in range(0, db.shape[0], db_chunk):
        chunk = db[start:start + db_chunk]
        v, i = _chunk_topk(q, chunk, start, row0, min(k, chunk.shape[0]))
        best = (v, i) if best is None else _merge_topk(*best, v, i, k)
    return best


def expand_queries_chunked(qdescs, db_descs, alpha: float = 3.0, k: int = 10,
                           *, db_chunk: int = 131072, exclude_mask=None,
                           exclude_pad: int = 0) -> torch.Tensor:
    """AQE over a database too large for an (Nq, Nd) similarity matrix; the
    same top-k and weighting as :func:`expand_queries`. The queries are
    cast to the database's dtype for the top-k (a bf16 database stays
    bf16). ``exclude_mask`` (bool (Nd,), True = excluded, on the database's
    device) with ``exclude_pad >=`` its count gives the expansion of a
    database without those rows."""
    qdescs = qdescs.float()
    k = min(int(k), db_descs.shape[0])
    kk = min(k + int(exclude_pad), db_descs.shape[0]) \
        if exclude_mask is not None else k
    vals, idxs = _streaming_topk(qdescs.to(db_descs.dtype), db_descs, kk, db_chunk)
    if exclude_mask is not None:
        vals, idxs = _drop_excluded(vals, idxs, exclude_mask, k)
    return _expand_from_topk(qdescs, db_descs, vals, idxs, alpha, k)


def expand_database_chunked(db_descs, alpha: float = 3.0, k: int = 10, *,
                            row_block: int = 4096,
                            db_chunk: int = 131072) -> torch.Tensor:
    """ADBA at scale: the database's rows stream in ``row_block`` blocks
    against ``db_chunk`` tiles, and each expanded block goes to the host as
    it completes, so device memory holds the database plus
    O(row_block * db_chunk) similarities. Returns a CPU fp32 tensor, equal
    to :func:`expand_database`'s result."""
    n, d = db_descs.shape
    k = min(int(k), n)
    out = torch.empty((n, d), dtype=torch.float32)
    for row0 in range(0, n, row_block):
        rows = db_descs[row0:row0 + row_block]
        vals, idxs = _streaming_topk(rows, db_descs, k, db_chunk, row0=row0)
        out[row0:row0 + len(rows)] = _expand_from_topk(
            rows.float(), db_descs, vals, idxs, alpha, k).cpu()
    return out


def expand_queries_quantized(qdescs, db_i8, db_scales, alpha: float = 3.0,
                             k: int = 10, *, exclude_mask=None,
                             exclude_pad: int = 0) -> torch.Tensor:
    """AQE against an int8 database from :func:`.topk.quantize_db`: the
    top-k runs through the int8 kernels (:func:`.topk.rank_topk_fused`) and
    only the k neighbour rows per query are dequantized. Same semantics as
    :func:`expand_queries`; ``exclude_mask``/``exclude_pad`` as in
    :func:`expand_queries_chunked`."""
    qdescs = qdescs.float()
    k = min(int(k), db_i8.shape[0])
    kk = min(k + int(exclude_pad), db_i8.shape[0]) \
        if exclude_mask is not None else k
    vals, idxs = rank_topk_fused(qdescs, db_i8, kk, db_scales=db_scales)
    if exclude_mask is not None:
        vals, idxs = _drop_excluded(vals, idxs, exclude_mask, k)
    safe = idxs.clamp_min(0)
    nb = db_i8[safe].float() * db_scales.reshape(-1)[safe][:, :, None]
    w = torch.where(idxs >= 0, _weights(vals, alpha), 0.0)
    weighted = torch.einsum("nk,nkd->nd", w, nb)
    return l2_normalize((qdescs + weighted) / (k + 1.0))


def expand_descriptors(descs, db=None, alpha: float = 0, k: int = 0):
    """The reference's signature (``test_dir.py:24-44``): ``db=None`` means
    ADBA-style self-expansion, ``k=0`` returns ``descs`` unchanged."""
    if k < 0 or alpha < 0:
        raise ValueError("k and alpha must be non-negative")
    if k == 0:
        return descs
    if db is None:
        return expand_database(descs, alpha=alpha, k=k)
    return expand_queries(descs, db, alpha=alpha, k=k)
