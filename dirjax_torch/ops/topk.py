"""Exact top-k without the score matrix (counterpart of
``dirjax/ops/topk_pallas.py``), on the kernels of ``csrc/topk.cu``.

:func:`rank_topk_fused` keeps dirjax's dispatch rule:

* an unquantized database and ``k <= 16``: **K2** :func:`fused_topk` scores
  each 512-row slab against the queries and keeps its top-k; a top-k over
  the (nq, slabs*k) candidates merges them;
* ``k > 16`` or an int8 database: the hierarchy. **K3** :func:`finemax`
  streams the database once and writes only the maximum score of each 8
  consecutive rows (a fine block); :func:`_hier_select` descends
  tile -> 16-block chunk -> fine block to the kf winning blocks per query;
  **K4** :func:`gather_scores` rescores their rows; :func:`_finish_from_raw`
  applies the int8 scales, scores the ragged tail (< 8 rows) densely and
  takes the final top-k;
* an int8 database with fewer rows than one tile: a dense plain top-k.

Exactness: an element of the true top-k scores >= the k-th best, so the max
of any group that holds it does too; at most k disjoint groups clear that
bar, so the top-k groups by max contain the whole answer, at every level.
K3 and K4 score a (row, query) pair through one device routine, so K4
reproduces K3's maxima bit for bit.

Each kernel wrapper runs its plain PyTorch version (``*_reference``, the
kernel's oracle, same signature and output layout) for a CPU tensor, and
launches the kernel or raises for a CUDA tensor. Operand rules, as
``_score_dot`` fixes them: fp32 x fp32, bf16 x bf16, int8 rows x bf16
queries (fp32 accumulation), int8 x int8 (exact int32). The plain versions
contract in fp32 after an exact widening (fp64 for int8 x int8, exact up to
2**53), so they differ from the kernels only in summation order, and in
fp32 by the kernels' split of each operand into two bf16 parts (hi.hi +
hi.lo + lo.hi + lo.lo on the tensor cores: within 1e-6 for unit rows at
D = 2048; :func:`_split`).

Ties rank the lower index first, as ``lax.top_k`` does (:func:`_topk`).
Indices come back int64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rank_topk_fused", "quantize_db", "fused_topk", "finemax",
           "gather_scores", "fused_topk_reference", "finemax_reference",
           "gather_scores_reference", "launches"]

#: launches of each CUDA kernel in this process (reset them to count a run;
#: plain ints, so a race between serving threads may lose an increment)
launches = {"fused_topk": 0, "finemax": 0, "gather_scores": 0}

_RPB = 8            # rows per fine block
_SLAB = 512         # K2 rows per slab (csrc/topk.cu kSlab)
_CHUNK = 65536      # rows per plain-version step (bounds its memory)
_NEG = float("-inf")

# (database dtype, query dtype) -> csrc/topk.cu operand mode
_MODES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
          (torch.int8, torch.bfloat16): 2, (torch.int8, torch.int8): 3}


def _topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def _scores(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain (nq, len(rows)) fp32 scores under the kernels' operand rules."""
    if rows.dtype == torch.int8 and q.dtype == torch.int8:
        return (q.double() @ rows.double().T).float()
    return q.float() @ rows.float().T


# --------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracles
# --------------------------------------------------------------------------

def fused_topk_reference(q: torch.Tensor, db: torch.Tensor, k: int):
    """K2's plain version: per 512-row slab the top-k (values, int64 row
    ids), rows >= n masked; (nq, slabs*k) each, -inf/-1 where a slab has
    fewer than k live rows."""
    nq, n = q.shape[0], db.shape[0]
    slabs = -(-n // _SLAB)
    vals = torch.full((nq, slabs, k), _NEG, device=q.device)
    idxs = torch.full((nq, slabs, k), -1, dtype=torch.int64, device=q.device)
    kk = min(k, _SLAB)
    for start in range(0, n, _CHUNK):
        s = _scores(q, db[start:start + _CHUNK])
        pad = -s.shape[1] % _SLAB
        s = torch.nn.functional.pad(s, (0, pad), value=_NEG).reshape(nq, -1, _SLAB)
        v, i = _topk(s, kk)
        first = start // _SLAB
        rows = i + (first + torch.arange(s.shape[1], device=q.device))[None, :, None] * _SLAB
        vals[:, first:first + s.shape[1], :kk] = v
        idxs[:, first:first + s.shape[1], :kk] = torch.where(v > _NEG, rows, -1)
    return vals.reshape(nq, slabs * k), idxs.reshape(nq, slabs * k)


def finemax_reference(q: torch.Tensor, db: torch.Tensor,
                      scales: Optional[torch.Tensor] = None,
                      blocks: Optional[int] = None) -> torch.Tensor:
    """K3's plain version: (nq, blocks) maxima over rows [8b, 8b+8) of the
    optionally row-scaled scores; rows >= n score -inf."""
    nq, n = q.shape[0], db.shape[0]
    blocks = -(-n // _RPB) if blocks is None else blocks
    out = torch.full((nq, blocks), _NEG, device=q.device)
    for start in range(0, n, _CHUNK):
        s = _scores(q, db[start:start + _CHUNK])
        if scales is not None:
            s = s * scales.reshape(-1)[start:start + _CHUNK]
        pad = -s.shape[1] % _RPB
        s = torch.nn.functional.pad(s, (0, pad), value=_NEG).reshape(nq, -1, _RPB)
        out[:, start // _RPB:start // _RPB + s.shape[1]] = s.amax(dim=2)
    return out


def gather_scores_reference(q: torch.Tensor, db: torch.Tensor,
                            bids: torch.Tensor) -> torch.Tensor:
    """K4's plain version: raw (nq, kf*8) scores of the 8 rows of each fine
    block ``bids`` names; NaN for a block not wholly inside the database."""
    nq, kf = bids.shape
    n, d = db.shape
    ok = (bids >= 0) & (bids * _RPB + _RPB <= n)
    rows = (bids.clamp(0, max(n // _RPB - 1, 0))[:, :, None] * _RPB
            + torch.arange(_RPB, device=db.device)).reshape(nq, -1).clamp(max=n - 1)
    both_int = db.dtype == torch.int8 and q.dtype == torch.int8
    wide = torch.float64 if both_int else torch.float32
    out = torch.empty((nq, kf * _RPB), device=q.device)
    step = max(1, _CHUNK // max(kf * _RPB, 1))
    for i in range(0, nq, step):
        cand = db[rows[i:i + step]].to(wide)              # (b, kf*8, D)
        raw = torch.bmm(cand, q[i:i + step].to(wide)[:, :, None])[:, :, 0]
        out[i:i + step] = raw.float()
    return out.masked_fill(~ok.repeat_interleave(_RPB, dim=1), float("nan"))


# --------------------------------------------------------------------------
# kernel wrappers: plain version for a CPU tensor, the kernel for CUDA
# --------------------------------------------------------------------------

def _check(name: str, q: torch.Tensor, db: torch.Tensor, modes) -> int:
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"{name}: q (nq, D) and db (n, D) must share D, got "
                         f"{tuple(q.shape)} and {tuple(db.shape)}")
    mode = _MODES.get((db.dtype, q.dtype))
    if mode not in modes:
        raise ValueError(f"{name}: no kernel for db {db.dtype} x q {q.dtype}")
    if q.device != db.device or not (q.is_contiguous() and db.is_contiguous()):
        raise ValueError(f"{name}: q and db must be contiguous on one device")
    if db.shape[0] == 0 or db.shape[1] == 0:
        raise ValueError(f"{name}: empty database")
    return mode


def _device(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type


# the fp32 mode's order of each query's 16 d: a kernel thread takes 4
# consecutive d of a row as the wgmma fragment's k 2t, 2t+1, 2t+8, 2t+9
_F32_ORDER = [4 * (k % 8 // 2) + 2 * (k // 8) + k % 2 for k in range(16)]


def _split(q: torch.Tensor) -> torch.Tensor:
    """fp32 queries as the fp32 mode of csrc/topk.cu takes them: (nq, D32 /
    32, 2, 32) bf16 with D32 = D rounded up to 32 (zeros past D); for each
    32 d the hi parts bf16(q), then the lo parts bf16(q - hi), both rounded
    to nearest even (q - hi is exact in fp32), each 16 d in ``_F32_ORDER``.
    The kernel splits its rows alike and sums hi.hi + hi.lo + lo.hi + lo.lo
    on the tensor cores."""
    nq, d = q.shape
    q = torch.nn.functional.pad(q, (0, -d % 32)).reshape(nq, -1, 1, 2, 16)[..., _F32_ORDER]
    hi = q.to(torch.bfloat16)
    lo = (q - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=2).contiguous()


def _run(name: str, device: torch.device, *args, counts: dict = launches) -> None:
    """Launch ``dirjax_<name>`` on the current stream of ``device`` and count
    it in ``counts[name]``."""
    from ..kernels.build import load_library

    with torch.cuda.device(device):
        err = getattr(load_library(), f"dirjax_{name}")(
            *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    counts[name] += 1


def fused_topk(q: torch.Tensor, db: torch.Tensor, k: int):
    """K2: per-slab top-k candidates (see :func:`fused_topk_reference`)."""
    if _device("fused_topk", q) == "cpu":
        return fused_topk_reference(q, db, k)
    mode = _check("fused_topk", q, db, (0, 1))
    if k < 1:
        raise ValueError(f"fused_topk: k must be positive, got {k}")
    nq, n = q.shape[0], db.shape[0]
    slabs = -(-n // _SLAB)
    vals = torch.empty((nq, slabs * k), device=q.device)
    idxs = torch.empty((nq, slabs * k), dtype=torch.int64, device=q.device)
    if nq:
        q = _split(q) if mode == 0 else q
        _run("fused_topk", q.device, q.data_ptr(), db.data_ptr(), mode, nq, n,
             db.shape[1], k, vals.data_ptr(), idxs.data_ptr())
    return vals, idxs


def finemax(q: torch.Tensor, db: torch.Tensor,
            scales: Optional[torch.Tensor] = None,
            blocks: Optional[int] = None) -> torch.Tensor:
    """K3: (nq, blocks) fine-block maxima (see :func:`finemax_reference`)."""
    nq, n = q.shape[0], db.shape[0]
    blocks = -(-n // _RPB) if blocks is None else blocks
    if blocks * _RPB < n:
        raise ValueError(f"finemax: {blocks} blocks cannot cover {n} rows")
    if _device("finemax", q) == "cpu":
        return finemax_reference(q, db, scales, blocks)
    mode = _check("finemax", q, db, (0, 1, 2, 3))
    if scales is not None:
        scales = scales.reshape(-1)
        if (scales.shape[0] != n or scales.dtype != torch.float32
                or scales.device != q.device or not scales.is_contiguous()):
            raise ValueError(f"finemax: scales must be {n} contiguous fp32 "
                             f"values on {q.device}")
    out = torch.empty((nq, blocks), device=q.device)
    if nq:
        q = _split(q) if mode == 0 else q
        _run("finemax", q.device, q.data_ptr(), db.data_ptr(),
             None if scales is None else scales.data_ptr(), mode, nq, n,
             db.shape[1], blocks, out.data_ptr())
    return out


def gather_scores(q: torch.Tensor, db: torch.Tensor,
                  bids: torch.Tensor) -> torch.Tensor:
    """K4: raw (nq, kf*8) candidate scores (see
    :func:`gather_scores_reference`)."""
    if _device("gather_scores", q) == "cpu":
        return gather_scores_reference(q, db, bids)
    mode = _check("gather_scores", q, db, (0, 1, 2, 3))
    if (bids.dim() != 2 or bids.shape[0] != q.shape[0] or bids.dtype != torch.int64
            or bids.device != q.device or not bids.is_contiguous()):
        raise ValueError(f"gather_scores: bids must be contiguous int64 "
                         f"({q.shape[0]}, kf) on {q.device}")
    nq, kf = bids.shape
    out = torch.empty((nq, kf * _RPB), device=q.device)
    if nq and kf:
        q = _split(q) if mode == 0 else q
        _run("gather_scores", q.device, q.data_ptr(), db.data_ptr(),
             bids.data_ptr(), mode, nq, db.shape[0], db.shape[1], kf,
             out.data_ptr())
    return out


# --------------------------------------------------------------------------
# the hierarchy (torch ops, as dirjax leaves them to XLA)
# --------------------------------------------------------------------------

def _kf_pad(kf: int) -> int:
    """Pad the fine-block candidate count to a multiple of 16 (one K4 block
    of 16 fine blocks = 128 rows)."""
    return ((kf + 15) // 16) * 16


def _hier_select(fmax: torch.Tensor, k: int, tile_rows: int, n_valid: int,
                 row_order: bool = False):
    """Descend the query-major maxima (nq, tiles*tile_rows/8) to the winning
    fine-block ids: tiles -> 16-block chunks of the k winning tiles -> fine
    blocks of the k winning chunks. Returns ``bids (nq, kf_pad)`` int64,
    zero-padded past kf, and ``vmask (nq, kf_pad)`` marking genuine
    candidates; every id is gather-safe. Each level lists its winners by
    score, as dirjax's hierarchy does, or with ``row_order`` by row, so that
    a tie between groups goes to the lower rows at every level and the
    answer is the dense ``lax.top_k``'s, ties included."""
    fpt = tile_rows // _RPB
    nq = fmax.shape[0]
    tiles = fmax.shape[1] // fpt
    nb_main = n_valid // _RPB     # fine blocks wholly inside the database
    F = fmax.reshape(nq, tiles, fpt)
    # the block straddling the ragged tail is scored densely by the finish
    bid = torch.arange(tiles * fpt, device=fmax.device).reshape(1, tiles, fpt)
    F = torch.where(bid < nb_main, F, _NEG)

    def winners(maxima, kk):
        pos = _topk(maxima, kk)[1]
        return pos.sort(dim=1).values if row_order else pos

    # level 0: whole tiles
    kc = min(k, tiles)
    c_idx = winners(F.amax(dim=2), kc)                           # (nq, kc)
    G = torch.gather(F, 1, c_idx[:, :, None].expand(-1, -1, fpt))
    # level 1: 16-fine-block chunks within the winning tiles
    G16 = G.reshape(nq, kc * (fpt // 16), 16)
    ks = min(k, kc * (fpt // 16))
    s_idx = winners(G16.amax(dim=2), ks)
    H = torch.gather(G16, 1, s_idx[:, :, None].expand(-1, -1, 16))
    # level 2: fine blocks within the winning chunks
    kf = min(k, ks * 16)
    h_val, h_sel = _topk(H.reshape(nq, ks * 16), kf)
    if row_order:
        h_sel, order = h_sel.sort(dim=1)
        h_val = torch.gather(h_val, 1, order)
    sc = torch.gather(s_idx, 1, h_sel // 16)                     # chunk id
    f = (sc % (fpt // 16)) * 16 + h_sel % 16                     # fine-in-tile
    t_sel = torch.gather(c_idx, 1, sc // (fpt // 16))
    bids = t_sel * fpt + f                                       # global blocks
    # a -inf selection means k exceeded the finite blocks (tiny database):
    # its id is arbitrary, so clip it for the gather and mask it out
    vmask = h_val > _NEG
    bids = bids.clamp(0, max(nb_main - 1, 0))
    pad = _kf_pad(kf) - kf
    if pad:
        bids = torch.cat([bids, bids.new_zeros((nq, pad))], dim=1)
        vmask = torch.cat([vmask, vmask.new_zeros((nq, pad))], dim=1)
    return bids, vmask


def _finish_from_raw(q, db, bids, vmask, raw, k: int, n_valid: int,
                     scales=None, qscales=None):
    """Mask non-candidates, rescale int8, score the ragged tail densely,
    final top-k (candidates in row order, from ``_hier_select(...,
    row_order=True)``, rank ties lower row first). ``qscales`` (full-int8)
    scale the returned values only: a positive per-query constant changes
    no ranking."""
    nq, kf_pad = bids.shape
    nb_main = n_valid // _RPB
    rows = (bids[:, :, None] * _RPB
            + torch.arange(_RPB, device=bids.device)).reshape(nq, kf_pad * _RPB)
    if scales is not None:
        s = scales.reshape(-1)
        s8 = torch.nn.functional.pad(s, (0, -s.shape[0] % _RPB)).reshape(-1, _RPB)
        raw = raw * s8[bids.clamp(0, s8.shape[0] - 1)].reshape(nq, kf_pad * _RPB)
    valid = vmask.repeat_interleave(_RPB, dim=1)
    scores = torch.where(valid, raw, _NEG)
    tail = n_valid - nb_main * _RPB
    if tail:
        trows = db[nb_main * _RPB:n_valid].float()
        if scales is not None:
            trows = trows * scales.reshape(-1)[nb_main * _RPB:n_valid, None]
        scores = torch.cat([scores, q.float() @ trows.T], dim=1)
        rows = torch.cat([rows, torch.arange(nb_main * _RPB, n_valid,
                                             device=rows.device).expand(nq, -1)], dim=1)
    vals, pos = _topk(scores, k)
    idxs = torch.gather(rows, 1, pos)
    if qscales is not None:
        vals = vals * qscales.reshape(-1, 1)
    return vals, idxs


def _hierarchical(q, db, k: int, tile_rows: int, scales=None, qscales=None):
    """Exact top-k: K3 fine maxima -> hierarchical select -> K4 rescore ->
    finish."""
    n = db.shape[0]
    tiles = -(-n // tile_rows)
    fmax = finemax(q, db, scales, blocks=tiles * (tile_rows // _RPB))
    bids, vmask = _hier_select(fmax, k, tile_rows, n, row_order=True)
    raw = gather_scores(q, db, bids)
    return _finish_from_raw(q, db, bids, vmask, raw, k, n, scales, qscales)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def _quantize_block(block: torch.Tensor):
    b32 = block.float()
    m = b32.abs().amax(dim=1, keepdim=True)
    # XLA folds dirjax's `/ 127.0` into a multiply by the fp32 reciprocal;
    # the same product keeps the scales bit-identical to dirjax's
    scale = m.clamp_min(1e-12) * (1.0 / 127.0)
    q = torch.round(b32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def quantize_db(db_descs, *, block_rows: int = 65536
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: ``(db_i8 (N, D) int8, scales
    (1, N) fp32)`` with ``db ~ db_i8 * scales.T``, on the input's device
    (a numpy array goes to the CPU). ``block_rows`` rows at a time bounds
    the fp32 temporaries. Rounds half to even, as ``jnp.round`` does, so
    the codes equal dirjax's bit for bit."""
    db = torch.as_tensor(db_descs)
    qs, ss = [], []
    for start in range(0, db.shape[0], block_rows):
        q, s = _quantize_block(db[start:start + block_rows])
        qs.append(q)
        ss.append(s)
    if not qs:
        return (torch.empty((0, db.shape[1]), dtype=torch.int8, device=db.device),
                torch.empty((1, 0), device=db.device))
    return torch.cat(qs), torch.cat(ss).reshape(1, -1)


def rank_topk_fused(qdescs: torch.Tensor, db_descs: torch.Tensor, k: int, *,
                    tile_rows: int = 1024, db_scales=None,
                    quantize_queries: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (fp32 values, int64 db indices) per query without the score
    matrix, on the queries' device (cpu or cuda).

    ``db_descs`` is fp32 or bf16 (queries are cast to its dtype), or int8
    from :func:`quantize_db` with ``db_scales`` its (1, N) scales: queries
    then go bf16, or int8 per row with ``quantize_queries=True`` (exact
    int32 contraction; values rescaled by the query scales). ``tile_rows``
    is the rows per level-0 group of the hierarchy: a multiple of 128, at
    most 128*128."""
    q, db = qdescs, db_descs
    _device("rank_topk_fused", q)
    if db.device != q.device:
        raise ValueError(f"queries on {q.device}, database on {db.device}")
    quantized = db.dtype == torch.int8
    if quantized and db_scales is None:
        raise ValueError("int8 database requires db_scales from quantize_db")
    if quantize_queries and not quantized:
        raise ValueError("quantize_queries requires an int8 database "
                         "(build one with quantize_db)")
    if k > db.shape[0]:
        raise ValueError(f"k={k} exceeds the {db.shape[0]} database rows")
    if tile_rows % 128 or not 0 < tile_rows <= 128 * 128:
        raise ValueError(f"tile_rows={tile_rows} must be a multiple of 128 "
                         "in [128, 16384]")
    qscales = scales = None
    if quantized:
        scales = torch.as_tensor(db_scales, device=db.device).float().reshape(1, -1)
        if quantize_queries:
            q, qs = _quantize_block(q)
            qscales = qs.reshape(1, -1)
        else:
            q = q.to(torch.bfloat16)
    elif q.dtype != db.dtype:
        q = q.to(db.dtype)
    q = q.contiguous()
    if quantized and db.shape[0] < tile_rows:
        # a small quantized database: the stream has nothing to stream
        if qscales is not None:
            raw = (q.double() @ db.double().T).float()
            scores = raw * scales * qscales.reshape(-1, 1)
        else:
            scores = q.float() @ (db.float() * scales.T).T
        return _topk(scores, k)
    tile_rows = min(tile_rows, max(256, db.shape[0] // 256 * 256))
    if db.shape[0] >= tile_rows and (k > 16 or quantized):
        return _hierarchical(q, db, k, tile_rows, scales, qscales)
    vals, idxs = fused_topk(q, db, k)
    merged, pos = _topk(vals, k)
    return merged, torch.gather(idxs, 1, pos)
