"""Database-sharded ranking over the mesh's "db" axis (counterpart of
``dirjax/parallel/ranking.py``).

Each rank holds a contiguous row slice of the database, padded so that every
slice has ``rows = ceil(n / size)`` rows; the queries are replicated. A rank
searches its valid rows, ``clip(n_valid - offset, 0, rows)`` of them, with
the port's single-chip search, whose kernels run on the card:

* dense fp32 / bf16 / int8 rows: :func:`~dirjax_torch.ops.topk.rank_topk_fused`
  (K2-K4);
* PQ codes: :func:`~dirjax_torch.ops.pq.pq_topk` (K6 and its rescore);
* an inverted file: :func:`~dirjax_torch.ops.ivf.ivf_topk` over the rank's
  cells, probing ``ceil(nprobe / size)`` of them;
* binary codes: :func:`~dirjax_torch.ops.binary.hamming_topk_mxu` (K5) for a
  symmetric shortlist, then :func:`~dirjax_torch.ops.binary.asym_rescore`
  when projected queries are given (dirjax's mesh semantics; the exact
  asymmetric search stays single-chip).

Every rank emits exactly ``kk = min(k, rows)`` candidates, padded with
-inf / -1 when it holds fewer valid rows (none, on a rank past the end).
The candidates, fp32 values and int64 global ids, are all-gathered over
"db" in rank order and merged by a stable top-k, so ties go to the lower
global id as ``lax.top_k`` gives them to dirjax; a -inf value gets id -1.
Every rank returns the merged global result (the SPMD contract of
:mod:`dirjax_torch.parallel`).

Not carried over: dirjax's ``stream``, ``chunk`` (PQ), ``block`` and
``chunk_rows`` options, which size its XLA programs (the port's kernels
never build a score matrix). Invalid binary slots carry -inf, as the port's
single-chip binary search returns them (dirjax writes -2**30).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.binary import _as_tensor, _to_bytes, asym_rescore, hamming_topk_mxu
from ..ops.ivf import IVFArrays, ivf_topk
from ..ops.normalize import l2_normalize
from ..ops.pq import pq_topk
from ..ops.qe import _drop_excluded, _weights
from ..ops.topk import _topk, quantize_db, rank_topk_fused
from .mesh import axis_rank, axis_size, mesh_device

__all__ = ["shard_database", "shard_database_quantized", "sharded_topk",
           "sharded_scores", "sharded_aqe", "shard_codes", "sharded_pq_topk",
           "shard_ivf", "sharded_ivf_topk", "shard_codes_binary",
           "sharded_hamming_topk", "gather_rows", "gather_shards"]

_NEG = float("-inf")
_CHUNK = 65536      # rows per step of sharded_scores' widening (bounds memory)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

def _slice_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str, multiple: int = 1
                ) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s rows after padding them with
    zeros to a multiple of ``size * multiple``, on the rank's device."""
    size = axis_size(mesh, axis)
    rows = -(-x.shape[0] // (size * multiple)) * multiple
    start = axis_rank(mesh, axis) * rows
    local = x[start:start + rows].to(mesh_device(mesh))
    short = rows - local.shape[0]
    if short:
        local = torch.cat([local, local.new_zeros((short,) + tuple(local.shape[1:]))])
    return local.contiguous()


def shard_database(db, mesh: DeviceMesh, axis: str = "db") -> Tuple[torch.Tensor, int]:
    """This rank's row slice of the full (Nd, D) matrix (its dtype kept),
    zero-padded to ``ceil(Nd / size)`` rows, on the rank's device; returns
    ``(slice, Nd)``. Pad rows are masked by ``n_valid`` at query time."""
    db = _as_tensor(db)
    return _slice_rows(db, mesh, axis), int(db.shape[0])


def shard_database_quantized(db, mesh: DeviceMesh, axis: str = "db"):
    """int8-quantize this rank's rows (:func:`~dirjax_torch.ops.topk.quantize_db`,
    per row, so the slice of the quantization is the quantization of the
    slice): ``(rows_i8, scales (1, rows), Nd)``; pad rows carry scale 0."""
    local, n = shard_database(db, mesh, axis)
    q8, s8 = quantize_db(local)
    return q8, s8, n


def shard_codes(codes, mesh: DeviceMesh, axis: str = "db") -> Tuple[torch.Tensor, int]:
    """This rank's slice of an (N, m) uint8 PQ code matrix; pad rows are
    masked by ``n_valid`` at query time."""
    codes = _as_tensor(codes)
    return _slice_rows(codes, mesh, axis), int(codes.shape[0])


def shard_codes_binary(codes, mesh: DeviceMesh, axis: str = "db") -> Tuple[torch.Tensor, int]:
    """This rank's slice of packed sign codes (uint8 bytes, or dirjax's
    uint32 words), N padded to a multiple of ``size * 128`` as dirjax pads
    it; returns ``(uint8 slice, N)``."""
    b = _to_bytes(codes)
    return _slice_rows(b, mesh, axis, multiple=128), int(b.shape[0])


def _local_valid(n_valid: int, mesh: DeviceMesh, axis: str, rows: int):
    """(offset, valid rows) of this rank's slice."""
    offset = axis_rank(mesh, axis) * rows
    return offset, int(np.clip(n_valid - offset, 0, rows))


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def gather_shards(local: torch.Tensor, mesh: DeviceMesh, axis: str = "db",
                  dim: int = 0) -> torch.Tensor:
    """Every rank's ``local`` (equal shapes) concatenated along ``dim`` in
    the order of ``axis``."""
    parts = [torch.empty_like(local) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, local.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def _merge(vals: torch.Tensor, ids: torch.Tensor, k: int, mesh: DeviceMesh, axis: str):
    """The O(size * kk) candidate merge: all-gather, stable top-k, -1 ids
    where the value is -inf."""
    vals = gather_shards(vals, mesh, axis, dim=1)
    ids = gather_shards(ids, mesh, axis, dim=1)
    merged, pos = _topk(vals, min(k, vals.shape[1]))
    idx = torch.gather(ids, 1, pos)
    return merged, torch.where(merged > _NEG, idx, -1)


def gather_rows(local: torch.Tensor, idxs: torch.Tensor, mesh: DeviceMesh, n_valid: int,
                axis: str = "db", transform=None) -> torch.Tensor:
    """The rows of the sharded matrix at global ids ``idxs`` (any shape,
    the same on every rank), zeros where an id is -1: each rank fills the
    rows it owns, ``transform(rows, local_ids)`` of them (default: widened
    to fp32), and an ``all_reduce(SUM)`` over ``axis`` completes the
    result. The sum is exact: one rank contributes each row."""
    offset, lv = _local_valid(n_valid, mesh, axis, local.shape[0])
    own = (idxs >= offset) & (idxs < offset + lv)
    li = idxs[own] - offset
    rows = local[li]
    rows = transform(rows, li) if transform is not None else rows.float()
    out = torch.zeros(tuple(idxs.shape) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=local.device)
    out[own] = rows
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out


def _padded(nq: int, kk: int, device):
    return (torch.full((nq, kk), _NEG, device=device),
            torch.full((nq, kk), -1, dtype=torch.int64, device=device))


# --------------------------------------------------------------------------
# dense tiers
# --------------------------------------------------------------------------

def sharded_topk(q, db_sharded: torch.Tensor, k: int, mesh: DeviceMesh, n_valid: int,
                 axis: str = "db", db_scales=None, quantize_queries: bool = False):
    """(values, int64 global indices) of the top-k per query over the
    sharded rows: each rank's :func:`rank_topk_fused` over its valid rows,
    then the candidate merge. ``min(k, size * kk)`` columns come back; -1
    marks a -inf column (k past the valid rows).

    An int8 ``db_sharded`` takes its ``db_scales`` from
    :func:`shard_database_quantized`; ``quantize_queries`` quantizes the
    queries per row for the int8 x int8 contraction, and each query's scale
    multiplies its values once (a positive per-query constant commutes with
    the merge)."""
    quantized = db_sharded.dtype == torch.int8
    if quantize_queries and not quantized:
        raise ValueError("quantize_queries requires an int8 sharded database "
                         "(shard_database_quantized)")
    if quantized and db_scales is None:
        raise ValueError("int8 sharded database requires db_scales")
    dev = db_sharded.device
    q = _as_tensor(q).to(dev)
    rows = db_sharded.shape[0]
    offset, lv = _local_valid(n_valid, mesh, axis, rows)
    kk = min(k, rows)
    vals, ids = _padded(q.shape[0], kk, dev)
    if lv and q.shape[0]:
        kl = min(kk, lv)
        scales = db_scales.reshape(1, -1)[:, :lv] if quantized else None
        v, i = rank_topk_fused(q, db_sharded[:lv], kl, db_scales=scales,
                               quantize_queries=quantize_queries)
        vals[:, :kl], ids[:, :kl] = v, i + offset
    return _merge(vals, ids, k, mesh, axis)


def sharded_scores(q, db_sharded: torch.Tensor, mesh: DeviceMesh, n_valid: int,
                   axis: str = "db") -> torch.Tensor:
    """The full (nq, n_valid) fp32 score matrix on every rank: one product
    of the queries with the rank's rows (widened to fp32 a chunk at a time,
    fp32 accumulation), all-gathered over ``axis``."""
    dev = db_sharded.device
    q = _as_tensor(q).to(dev, torch.float32)
    local = torch.cat([q @ db_sharded[s:s + _CHUNK].float().T
                       for s in range(0, db_sharded.shape[0], _CHUNK)], dim=1)
    return gather_shards(local, mesh, axis, dim=1)[:, :n_valid]


def sharded_aqe(q, db_sharded: torch.Tensor, mesh: DeviceMesh, n_valid: int,
                alpha: float = 3.0, k: int = 10, axis: str = "db", db_scales=None,
                exclude_mask=None, exclude_pad: int = 0) -> torch.Tensor:
    """Alpha query expansion against the sharded database: the top-k by
    :func:`sharded_topk`, the neighbour rows by :func:`gather_rows`
    (dequantized by their rank for an int8 database), weighted and
    renormalized as :mod:`dirjax_torch.ops.qe` does. ``exclude_mask``
    (bool (n_valid,), True = excluded) with ``exclude_pad >=`` its count
    drops those rows from the neighbourhood exactly (``_drop_excluded``)."""
    dev = db_sharded.device
    q = _as_tensor(q).to(dev, torch.float32)
    kk = min(k + int(exclude_pad), n_valid) if exclude_mask is not None else k
    vals, idxs = sharded_topk(q, db_sharded, kk, mesh, n_valid, axis, db_scales=db_scales)
    if exclude_mask is not None:
        vals, idxs = _drop_excluded(vals, idxs, _as_tensor(exclude_mask).to(dev), k)
    transform = None
    if db_sharded.dtype == torch.int8:
        scales = db_scales.reshape(-1)

        def transform(rows, li):
            return rows.float() * scales[li][:, None]
    nb = gather_rows(db_sharded, idxs, mesh, n_valid, axis, transform)
    w = torch.where(idxs >= 0, _weights(vals, alpha), 0.0)
    return l2_normalize((q + torch.einsum("nk,nkd->nd", w, nb)) / (k + 1.0))


# --------------------------------------------------------------------------
# compressed tiers
# --------------------------------------------------------------------------

def sharded_pq_topk(luts, codes_sharded: torch.Tensor, k: int, mesh: DeviceMesh,
                    n_valid: int, axis: str = "db", compute_dtype=None):
    """Global ADC top-k over row-sharded PQ codes: each rank's
    :func:`pq_topk` over its valid rows (the replicated tables), then the
    candidate merge."""
    dev = codes_sharded.device
    luts = _as_tensor(luts).to(dev, torch.float32)
    rows = codes_sharded.shape[0]
    offset, lv = _local_valid(n_valid, mesh, axis, rows)
    kk = min(k, rows)
    vals, ids = _padded(luts.shape[0], kk, dev)
    if lv and luts.shape[0]:
        v, i = pq_topk(luts, codes_sharded[:lv], kk, compute_dtype=compute_dtype)
        vals, ids = v, torch.where(i >= 0, i + offset, -1)
    return _merge(vals, ids, k, mesh, axis)


def shard_ivf(ivf: IVFArrays, mesh: DeviceMesh, axis: str = "db") -> IVFArrays:
    """This rank's part of an inverted file, cell-wise: the greedy
    largest-first grouping of the virtual cells by slab count (dirjax's,
    computed in numpy, identically on every rank), slabs re-indexed locally
    with ``slab_rows`` keeping GLOBAL row ids. Groups pad to a common shape:
    sentinel cells carry ``probe_adjust = -3e38`` and no slabs."""
    size, d = axis_size(mesh, axis), axis_rank(mesh, axis)
    tab = ivf.vlist_tab.cpu().numpy()
    cv = ivf.centroids_v.cpu().numpy()
    adj = ivf.probe_adjust.cpu().numpy()
    cell = ivf.cell_of_v.cpu().numpy()
    codes = ivf.codes.cpu().numpy()
    rows = ivf.slab_rows.cpu().numpy()
    sizes = (tab >= 0).sum(1)
    loads = np.zeros(size, np.int64)
    groups = [[] for _ in range(size)]
    for v in np.argsort(-sizes, kind="stable"):   # greedy largest-first
        g = int(np.argmin(loads))
        groups[g].append(int(v))
        loads[g] += sizes[v]
    nvl = max(1, max(len(g) for g in groups))
    nsl = max(1, int(loads.max()))
    s_cv = np.zeros((nvl, cv.shape[1]), np.float32)
    s_adj = np.full((nvl,), np.float32(-3.0e38))
    s_tab = np.full((nvl, tab.shape[1]), -1, np.int32)
    s_codes = np.zeros((nsl,) + codes.shape[1:], codes.dtype)
    s_rows = np.full((nsl,) + rows.shape[1:], -1, np.int32)
    s_cell = np.full((nvl,), -1, np.int32)
    si = 0
    for j, v in enumerate(groups[d]):
        sl = tab[v][tab[v] >= 0]
        s_cv[j], s_adj[j], s_cell[j] = cv[v], adj[v], cell[v]
        s_tab[j, :len(sl)] = np.arange(si, si + len(sl))
        s_codes[si:si + len(sl)] = codes[sl]
        s_rows[si:si + len(sl)] = rows[sl]
        si += len(sl)
    return IVFArrays(*(torch.from_numpy(a) for a in
                       (s_cv, s_adj, s_tab, s_codes, s_rows, s_cell))).to(mesh_device(mesh))


def sharded_ivf_topk(luts, q, ivf_sharded: IVFArrays, k: int, mesh: DeviceMesh, *,
                     nprobe: int = 8, axis: str = "db", compute_dtype=None,
                     chunk: int = 128):
    """Global IVF-ADC top-k over a cell-sharded inverted file: each rank
    probes its ``ceil(nprobe / size)`` nearest LOCAL cells with
    :func:`ivf_topk`, then the candidate merge (dirjax's distributed-IVF
    approximation: the union of the local probes, never fewer cells a rank)."""
    dev = ivf_sharded.codes.device
    luts = _as_tensor(luts).to(dev, torch.float32)
    nprobe_local = max(1, -(-nprobe // axis_size(mesh, axis)))
    vals, ids = ivf_topk(luts, _as_tensor(q).to(dev), ivf_sharded, k, nprobe=nprobe_local,
                         compute_dtype=compute_dtype, chunk=chunk)
    return _merge(vals, ids, k, mesh, axis)


def sharded_hamming_topk(q_packed, codes_sharded: torch.Tensor, k: int, mesh: DeviceMesh,
                         n_valid: int, axis: str = "db", *, vq=None,
                         rerank_factor: int = 4):
    """Global Hamming top-k over row-sharded packed codes: each rank's exact
    symmetric top-k (:func:`hamming_topk_mxu`, values ``n_bits - 2*dist``)
    over its valid rows, then the candidate merge.

    With ``vq`` (fp32 projected queries, :func:`~dirjax_torch.ops.binary.project_queries`)
    each rank takes a symmetric shortlist of ``rerank_factor * k`` rows and
    rescores it asymmetrically (:func:`asym_rescore`) before the merge:
    dirjax's mesh semantics, which can miss a row the exact asymmetric
    search would rank."""
    dev = codes_sharded.device
    qb = _to_bytes(q_packed).to(dev).contiguous()
    rows = codes_sharded.shape[0]
    offset, lv = _local_valid(n_valid, mesh, axis, rows)
    kk = min(k, rows)
    kf = min(max(k * rerank_factor, k), rows) if vq is not None else kk
    vals, ids = _padded(qb.shape[0], kk, dev)
    if lv and qb.shape[0]:
        v, i = hamming_topk_mxu(qb, codes_sharded[:lv], min(kf, lv))
        if vq is not None:
            v, i = asym_rescore(vq, codes_sharded, i, kk)
        w = v.shape[1]
        vals[:, :w], ids[:, :w] = v, torch.where(i >= 0, i + offset, -1)
    return _merge(vals, ids, k, mesh, axis)
