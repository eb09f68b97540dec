"""IVF-ADC: an inverted file over residual PQ codes (counterpart of
``dirjax/ops/ivf.py``), scored through the kernels of ``csrc/pq.cu``.

A coarse k-means splits the rows into ``nlist`` cells; each query probes its
``nprobe`` nearest cells and scores only their rows. Rows are stored sorted
by cell in fixed ``slab``-row slabs of residual PQ codes; cells larger than
``cap`` slabs split into sibling *virtual* cells sharing one centroid, so the
(nvlist, cap) probe table stays tightly padded. Ranking is by inner product,
``q . (c + r) = q . c + q . r``, so the ADC tables depend only on the query
and each probed cell adds the scalar bias ``q . c``.

:func:`ivf_topk` per query (dirjax's default): the probe (an fp32 product
accumulated in fp64, then a top-k over ``cs + probe_adjust``); phase A, the
per-slab maxima of ``bias + ADC`` over the ``nprobe * cap`` candidate slabs,
``chunk`` slabs at a time; phase B, the top-k slabs; phase C, their rows
rescored. Phases A and C score rows through the rescore kernel
:func:`~.pq.adc_gather_scores` with ``block = slab`` on the codes viewed as
(nslabs * slab, m); the bias is added in torch. ``union=True`` scores the
union of the batch's probed cells against every query with **K6**
(:func:`~.pq.adc_finemax`, ``block = slab``), then descends the maxima
(:func:`~.pq._descend_maxima`) and rescores the winning slabs. With
``nprobe >= nvlist`` both equal dense ADC over reconstructions,
``q . centroid[cell(i)] + luts[codes[i]]``.

Binning (:func:`bin_ivf`, :func:`unbin_ivf`) is host numpy, copied from
dirjax: a slab's tail padding repeats its first row's codes and carries
``slab_rows = -1``, so the blind per-slab maxima of the union path never
exceed the slab's true best. Arrays are torch tensors (int32 tables, as
dirjax's files hold them). Training samples come from a ``torch.Generator``
(it cannot reproduce ``jax.random``'s draws). The union path gathers only
the distinct probed cells (dirjax gathers every probe and masks repeats, a
static-shape rule); the surviving slabs keep dirjax's order, so ties break
alike. An inverted file is sharded over a mesh by
:func:`dirjax_torch.parallel.ranking.shard_ivf`. Not carried over: the 12-bit
row-id split of the one-hot select, and the union's Pallas geometry fallback.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .pq import (_as_tensor, _assign, _descend_maxima, _kmeans, _pad_k, _round_luts,
                 _sample_rows, adc_finemax, adc_gather_scores, encode_pq, train_pq)
from .topk import _topk

__all__ = ["IVFArrays", "train_ivf", "ivf_assign", "build_ivf", "bin_ivf",
           "unbin_ivf", "ivf_topk"]

_SLAB = 64


class IVFArrays(NamedTuple):
    """Arrays of a built inverted file (dirjax's fields).

    ``centroids_v``/``probe_adjust`` are per virtual cell (siblings repeat
    their centroid); ``vlist_tab[v]`` lists the slab ids of virtual cell
    ``v`` (-1 past its end); ``codes[s]`` holds slab ``s``'s residual codes,
    ``slab_rows[s]`` the original row ids (-1 on tail padding), and
    ``cell_of_v`` the cell behind each virtual cell."""

    centroids_v: torch.Tensor   # (nvlist, D) fp32
    probe_adjust: torch.Tensor  # (nvlist,) fp32: -||c||^2 / 2
    vlist_tab: torch.Tensor     # (nvlist, cap) int32
    codes: torch.Tensor         # (nslabs, slab, m) uint8
    slab_rows: torch.Tensor     # (nslabs, slab) int32
    cell_of_v: torch.Tensor     # (nvlist,) int32

    @property
    def nvlist(self) -> int:
        return self.centroids_v.shape[0]

    @property
    def slab(self) -> int:
        return self.codes.shape[1]

    def to(self, device) -> "IVFArrays":
        return IVFArrays(*(t.to(device) for t in self))

    @classmethod
    def from_numpy(cls, centroids, vlist_tab, codes, slab_rows, cell_of_v) -> "IVFArrays":
        """Host tensors from numpy arrays (a file's, or dirjax's); the
        per-virtual-cell centroids and probe adjustments are derived."""
        centroids = np.asarray(centroids, np.float32)
        cell_of_v = np.asarray(cell_of_v).astype(np.int32)
        cv = centroids[cell_of_v]
        return cls(torch.from_numpy(cv),
                   torch.from_numpy(-0.5 * np.sum(np.square(cv), axis=1, dtype=np.float32)),
                   torch.from_numpy(np.asarray(vlist_tab).astype(np.int32)),
                   torch.from_numpy(np.asarray(codes).astype(np.uint8)),
                   torch.from_numpy(np.asarray(slab_rows).astype(np.int32)),
                   torch.from_numpy(cell_of_v))


def train_ivf(x, nlist: int, *, iters: int = 20, seed: int = 0,
              sample: Optional[int] = 262144, chunk: int = 8192) -> torch.Tensor:
    """Coarse k-means: (nlist, D) fp32 centroids, by the PQ trainer's Lloyd
    step with one subspace spanning the full dimension."""
    x = _as_tensor(x).float()
    n = x.shape[0]
    if n < nlist:
        raise ValueError(f"need at least nlist={nlist} training rows, got {n}")
    g = torch.Generator(device=x.device).manual_seed(seed)
    if sample is not None and n > sample:
        x = x[_sample_rows(x, sample, g)]
        n = sample
    init = x[_sample_rows(x, nlist, g)][None]
    chunk = max(256, min(chunk, n, (1 << 25) // max(1, nlist)))
    return _kmeans(x[None].contiguous(), init, iters, chunk)[0]


def ivf_assign(x, centroids, *, chunk: int = 16384) -> np.ndarray:
    """Nearest-centroid (L2) cell id per row, as host int32; for unit rows
    the same rule as the probe's ``x . c - ||c||^2 / 2``."""
    centroids = _as_tensor(centroids).float()
    x = _as_tensor(x)
    n = x.shape[0]
    chunk = max(256, min(chunk, max(n, 1), (1 << 26) // max(1, centroids.shape[0])))
    out = [_assign(x[s:s + chunk].to(centroids.device, torch.float32)[None],
                   centroids[None])[0].to(torch.int32).cpu().numpy()
           for s in range(0, n, chunk)]
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


def bin_ivf(assign, codes, centroids, *, slab: int = _SLAB,
            cap: Optional[int] = None) -> IVFArrays:
    """Host binning (dirjax's, in numpy): rows sorted by cell -> slabs ->
    the virtual-cell table. ``assign`` (N,) cell per row, ``codes`` (N, m)
    residual codes, ``centroids`` (nlist, D). Returns host tensors."""
    assign = np.asarray(assign)
    codes = np.asarray(codes)
    centroids = np.asarray(centroids, np.float32)
    n, m = codes.shape
    nlist = centroids.shape[0]
    if assign.shape != (n,):
        raise ValueError(f"assign must be ({n},), got {assign.shape}")
    order = np.argsort(assign, kind="stable").astype(np.int64)
    counts = np.bincount(assign, minlength=nlist)
    slabs_per_list = -(-counts // slab)
    if cap is None:
        nonempty = max(1, int((counts > 0).sum()))
        cap = max(1, math.ceil(1.5 * slabs_per_list.sum() / nonempty))
    nslabs = max(1, int(slabs_per_list.sum()))
    nv_per_list = -(-slabs_per_list // cap)
    nvlist = max(1, int(nv_per_list.sum()))
    row_starts = np.concatenate([[0], np.cumsum(counts)])
    slab_starts = np.concatenate([[0], np.cumsum(slabs_per_list)])
    within = np.arange(n, dtype=np.int64) - np.repeat(row_starts[:-1], counts)
    padded_pos = np.repeat(slab_starts[:-1] * slab, counts) + within
    rows_flat = np.full(nslabs * slab, -1, np.int64)
    rows_flat[padded_pos] = order
    slab_rows = rows_flat.reshape(nslabs, slab).astype(np.int32)
    codes_flat = np.zeros((nslabs * slab, m), np.uint8)
    codes_flat[padded_pos] = codes[order]
    codes_slabbed = codes_flat.reshape(nslabs, slab, m)
    # tail padding repeats the slab's first row's codes (slab_rows stays -1):
    # a pad row scores like a real row, so blind per-slab maxima never
    # exceed the slab's true best
    pad_mask = slab_rows < 0
    if pad_mask.any():
        codes_slabbed = np.where(pad_mask[:, :, None], codes_slabbed[:, :1, :], codes_slabbed)
    v_starts = np.concatenate([[0], np.cumsum(nv_per_list)])
    li_of_slab = np.repeat(np.arange(nlist), slabs_per_list)
    rel = np.arange(slab_starts[-1], dtype=np.int64) - np.repeat(slab_starts[:-1],
                                                                 slabs_per_list)
    vlist_tab = np.full((nvlist, cap), -1, np.int32)
    vlist_tab[v_starts[li_of_slab] + rel // cap, rel % cap] = np.arange(slab_starts[-1])
    cent_of_v = np.repeat(np.arange(nlist), nv_per_list)
    if len(cent_of_v) == 0:                      # empty corpus guard
        cent_of_v = np.zeros(1, np.int64)
    return IVFArrays.from_numpy(centroids, vlist_tab, codes_slabbed, slab_rows, cent_of_v)


def build_ivf(x, nlist: int, m: int = 32, ksub: int = 16, *, slab: int = _SLAB,
              cap: Optional[int] = None, coarse_iters: int = 20, pq_iters: int = 25,
              seed: int = 0, sample: Optional[int] = 262144, codebooks=None,
              centroids=None, chunk: int = 16384
              ) -> Tuple[IVFArrays, torch.Tensor, torch.Tensor]:
    """Train, assign, residual-encode and bin, on the rows' device. Returns
    ``(ivf, centroids, codebooks)``, the arrays on that device; queries need
    the codebooks for their :func:`~.pq.pq_lookup` tables."""
    x = _as_tensor(x).float()
    n = x.shape[0]
    if centroids is None:
        centroids = train_ivf(x, nlist, iters=coarse_iters, seed=seed, sample=sample)
    centroids = _as_tensor(centroids).to(x.device, torch.float32)
    assign = ivf_assign(x, centroids, chunk=chunk)
    if codebooks is None:
        ns = n if sample is None else min(n, sample)
        g = torch.Generator(device=x.device).manual_seed(seed + 2)
        idx = _sample_rows(x, ns, g) if ns < n else torch.arange(n, device=x.device)
        a = torch.from_numpy(assign).to(x.device)
        codebooks = train_pq(x[idx] - centroids[a[idx]], m, ksub, iters=pq_iters,
                             seed=seed, sample=None)
    codebooks = _as_tensor(codebooks).to(x.device, torch.float32)
    codes = []
    for start in range(0, n, chunk):
        a = torch.from_numpy(assign[start:start + chunk]).to(x.device).long()
        codes.append(encode_pq(x[start:start + chunk] - centroids[a], codebooks).cpu().numpy())
    codes = np.concatenate(codes) if codes else np.zeros((0, m), np.uint8)
    ivf = bin_ivf(assign, codes, centroids.cpu().numpy(), slab=slab, cap=cap)
    return ivf.to(x.device), centroids, codebooks


def unbin_ivf(ivf: IVFArrays, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Invert :func:`bin_ivf`: per-row ``(assign, codes)`` in original row
    order, as host numpy."""
    rows = ivf.slab_rows.cpu().numpy()
    codes = ivf.codes.cpu().numpy()
    tab = ivf.vlist_tab.cpu().numpy()
    cv = ivf.cell_of_v.cpu().numpy()
    slab_cell = np.full(rows.shape[0], -1, np.int32)
    mask = tab >= 0
    slab_cell[tab[mask]] = np.repeat(cv, tab.shape[1]).reshape(tab.shape)[mask]
    assign = np.full(n, -1, np.int32)
    out_codes = np.zeros((n, codes.shape[2]), np.uint8)
    valid = rows >= 0
    assign[rows[valid]] = np.broadcast_to(slab_cell[:, None], rows.shape)[valid]
    out_codes[rows[valid]] = codes[valid]
    if not (assign >= 0).all():
        raise ValueError("slab_rows do not cover all n rows")
    return assign, out_codes


# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------

def _probe(q: torch.Tensor, ivf: IVFArrays, nprobe: int):
    """(cs (nq, nvlist), pid (nq, p)): centroid scores, accumulated in fp64
    and rounded once (a query probes alike in any batch), and the ``p``
    nearest virtual cells by the build's L2 rule."""
    cs = (q.double() @ ivf.centroids_v.double().T).float()
    _, pid = _topk(cs + ivf.probe_adjust[None, :], min(nprobe, ivf.nvlist))
    return cs, pid


def _rescore_slabs(luts, codes_flat, slab_rows, win, win_ok, win_bias, k: int, slab: int):
    """Rescore the (nq, kf) winning slab ids (-1: none) -> final (vals,
    idxs): the rescore kernel over their rows plus each slab's bias, pad
    rows and losers masked, top-k."""
    nq, kf = win.shape
    wsafe = win.clamp_min(0)
    raw = adc_gather_scores(luts, codes_flat, wsafe.contiguous(), slab).reshape(nq, kf, slab)
    rows = slab_rows[wsafe].long()                               # (nq, kf, slab)
    ok = (rows >= 0) & win_ok[:, :, None]
    s3 = torch.where(ok, win_bias[:, :, None] + raw, float("-inf")).reshape(nq, kf * slab)
    vals, pos = _topk(s3, min(k, kf * slab))
    idxs = torch.gather(rows.reshape(nq, -1).clamp_min(0), 1, pos)
    return _pad_k(vals, torch.where(vals > float("-inf"), idxs, -1), k)


def _ivf_topk(luts, q, ivf: IVFArrays, k: int, nprobe: int, chunk: int):
    """Per query: probe -> per-slab maxima over the probed slabs (the
    rescore kernel, ``chunk`` slabs at a time) -> top-k slabs -> rescore."""
    nq = q.shape[0]
    cap = ivf.vlist_tab.shape[1]
    nslabs, slab, m = ivf.codes.shape
    codes_flat = ivf.codes.reshape(nslabs * slab, m)
    cs, pid = _probe(q, ivf, nprobe)
    bias = torch.gather(cs, 1, pid)
    cand = ivf.vlist_tab[pid].reshape(nq, -1).long()             # (nq, S), -1 padded
    bias_s = bias.repeat_interleave(cap, dim=1)
    fmax = torch.empty(cand.shape, device=q.device)
    for s0 in range(0, cand.shape[1], chunk):
        ids = cand[:, s0:s0 + chunk]
        c = ids.shape[1]
        raw = adc_gather_scores(luts, codes_flat, ids.clamp_min(0).contiguous(), slab)
        rows = ivf.slab_rows[ids.clamp_min(0)]
        ok = (rows >= 0) & (ids >= 0)[:, :, None]
        s = torch.where(ok, bias_s[:, s0:s0 + c, None] + raw.reshape(nq, c, slab),
                        float("-inf"))
        fmax[:, s0:s0 + c] = s.amax(dim=2)
    fv, sel = _topk(fmax, min(k, fmax.shape[1]))
    win = torch.gather(cand, 1, sel)
    win_bias = torch.gather(bias_s, 1, sel)
    return _rescore_slabs(luts, codes_flat, ivf.slab_rows, win,
                          (win >= 0) & (fv > float("-inf")), win_bias, k, slab)


def _ivf_topk_union(luts, q, ivf: IVFArrays, k: int, nprobe: int):
    """Batch-union probing: K6 scores the slabs of every cell any query of
    the batch probes against all queries; each query adds its own cell
    biases and selects over the whole union (recall >= per-query probing)."""
    nq = q.shape[0]
    nslabs, slab, m = ivf.codes.shape
    cs, pid = _probe(q, ivf, nprobe)
    occ = pid.reshape(-1)
    # distinct probed cells in first-occurrence order (dirjax keeps the
    # first occurrence of each and masks the rest)
    srt, perm = torch.sort(occ, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    cells = occ[torch.sort(perm[first]).values]
    sid = ivf.vlist_tab[cells].reshape(-1).long()
    voc = cells.repeat_interleave(ivf.vlist_tab.shape[1])
    real = sid >= 0
    sid, voc = sid[real], voc[real]
    rows_mat = ivf.codes[sid].reshape(-1, m)                      # the union's rows
    fmax = adc_finemax(luts, rows_mat, slab)                      # (nq, S_u)
    bias_u = cs[:, voc]
    top, tvalid = _descend_maxima(fmax + bias_u, k)
    win = torch.where(tvalid, sid[top], -1)
    win_bias = torch.gather(bias_u, 1, top)
    return _rescore_slabs(luts, ivf.codes.reshape(nslabs * slab, m), ivf.slab_rows, win,
                          (win >= 0) & tvalid, win_bias, k, slab)


def ivf_topk(luts, q, ivf: IVFArrays, k: int, *, nprobe: int = 8, compute_dtype=None,
             chunk: int = 128, union: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fp32 values, int64 indices) of the best ``k`` rows over the probed
    cells, on the arrays' device; -inf/-1 pad past what the probe reaches.

    ``luts`` are :func:`~.pq.pq_lookup` tables of the queries against the
    RESIDUAL codebooks; ``q`` the same queries for the probe and the bias.
    ``compute_dtype=torch.bfloat16`` rounds the tables to bf16. ``chunk``
    is the slabs per phase-A step (memory: nq * chunk * slab fp32 scores).
    ``union=True`` switches to batch-union probing."""
    luts = _round_luts(_as_tensor(luts), compute_dtype)
    q = _as_tensor(q).to(luts.device, torch.float32)
    if union:
        return _ivf_topk_union(luts, q, ivf, k, nprobe)
    chunk = max(8, min(chunk, min(nprobe, ivf.nvlist) * ivf.vlist_tab.shape[1]))
    return _ivf_topk(luts, q, ivf, k, nprobe, chunk)
