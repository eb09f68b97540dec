"""Binary hashing: ITQ sign codes and exact top-k over packed codes
(counterpart of ``dirjax/ops/binary.py``), on the kernels of
``csrc/binary.cu``.

Descriptors become ``n_bits`` sign bits of a learned projection, packed
LSB-first into bytes: byte ``j`` of a row holds projected dims ``8j .. 8j+7``,
bit ``i`` dim ``8j + i``. That is the memory of dirjax's uint32 words on a
little-endian host, so ``codes.numpy().view(np.uint32)`` gives dirjax's
words and :func:`_to_bytes` takes them back. 2048 bits are 256 B per row.

Two scores, both sorting descending like every other index tier:

* symmetric: the ±1 dot product of two codes, ``n_bits - 2 * hamming``,
  an exact integer;
* asymmetric: the continuous projected query, rounded to bf16, against the
  ±1 code, accumulated in fp32 (dirjax's bf16-input/fp32-accumulate rule).

:func:`hamming_search_fused` ranks exactly through the dense path's
hierarchy: **K5** :func:`bits_finemax` streams the codes once and writes only
the maximum score of each 8 consecutive rows; ``topk._hier_select`` descends
to the winning 8-row blocks; the finish rescores them (symmetric: a popcount
through a byte table; asymmetric: the rescore kernel
:func:`bits_gather_scores`, which shares K5's arithmetic, so its block maxima
equal K5's bit for bit) and scores the ragged tail densely. Both kernels run
on the dense top-k's tensor-core routine (``csrc/tc_score.cuh``): they unpack
the codes to ±1 in registers and contract them with the bf16 queries
(asymmetric), or with the queries unpacked to int8 ±1 by the wrapper
(symmetric, exact int32 sums).

Each kernel wrapper runs its plain PyTorch version (``*_reference``, same
signature and output layout, the kernel's oracle) for a CPU tensor, and
launches the kernel or raises for a CUDA tensor. The plain versions contract
unpacked ±1 codes in fp32: exact for the symmetric score (integers below
2**24), the kernels' products in another summation order for the asymmetric
one. Ties rank the lower position first, as ``lax.top_k`` does. The ITQ fit
runs fp32 matmuls (keep TF32 off, PyTorch's default for matmuls, for
dirjax's ``precision=HIGHEST``); the encoding projection accumulates in fp64
(:func:`project_queries`).

Not carried over (TPU workarounds): padding queries to 8 rows, the iota-eye
unpack, ``use_mxu``/``interpret`` and the 32768-row code padding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .topk import _RPB, _device, _hier_select, _run, _topk

__all__ = ["BinaryCodec", "fit_itq", "binarize", "project_queries",
           "binarize_and_project", "unpack_pm1", "bytes_for_search",
           "hamming_topk", "hamming_topk_mxu", "hamming_search_fused", "asym_rescore",
           "bits_finemax", "bits_gather_scores", "bits_finemax_reference",
           "bits_gather_scores_reference", "launches"]

#: launches of each CUDA kernel in this process (reset them to count a run;
#: plain ints, so a race between serving threads may lose an increment)
launches = {"bits_finemax": 0, "bits_gather_scores": 0}

_BITS_TILE = 1024   # rows per level-0 group of the hierarchy (dirjax's tile)
_CHUNK = 65536      # rows per plain-version / encoding step (bounds memory)
_NEG = float("-inf")
_POPC8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.uint8)


class BinaryCodec(NamedTuple):
    """Learned hash: ``bits = sign((x - mean) @ proj)``, fp32 tensors.

    ``proj`` is (D, n_bits) with orthonormal columns (PCA basis times the
    ITQ rotation). Asymmetric scores rank by the centred dot product
    ``(q - mean) . (x - mean)`` up to the projection."""

    mean: torch.Tensor   # (D,)
    proj: torch.Tensor   # (D, n_bits)

    @property
    def n_bits(self) -> int:
        return int(self.proj.shape[1])


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# codec fitting and encoding
# --------------------------------------------------------------------------

def fit_itq(descriptors, n_bits: Optional[int] = None, *, iters: int = 30,
            seed: int = 0, sample: Optional[int] = 131072) -> BinaryCodec:
    """Learn an ITQ binary codec from (a sample of) the corpus, on the
    descriptors' device (a numpy array computes on the CPU).

    ``n_bits`` defaults to the descriptor dim rounded down to a multiple of
    32. ``iters=0`` skips the rotation: plain PCA sign hashing. The sample
    rows are dirjax's (the same numpy generator). The initial rotation is the
    Q of a Gaussian matrix from a ``torch.Generator`` seeded with ``seed``:
    it cannot reproduce ``jax.random``'s bits, so the two packages learn
    different rotations of equal quality from the same seed."""
    x = _as_tensor(descriptors)
    n, d = x.shape
    if n_bits is None:
        n_bits = (d // 32) * 32
    if not (32 <= n_bits <= d and n_bits % 32 == 0):
        raise ValueError(f"n_bits={n_bits} must be a multiple of 32 in [32, {d}]")
    if sample is not None and n > sample:
        rows = np.random.default_rng(seed).choice(n, sample, replace=False)
        rows.sort()
        x = x[torch.from_numpy(rows).to(x.device)]
    x = x.float()
    mean = x.mean(dim=0)
    xc = x - mean
    # PCA basis: the top-n_bits eigenvectors of the covariance
    _, vecs = torch.linalg.eigh(xc.T @ xc)        # ascending eigenvalues
    w_pca = vecs.flip(1)[:, :n_bits].contiguous()
    if iters == 0:
        return BinaryCodec(mean=mean, proj=w_pca)
    v = xc @ w_pca
    g = torch.Generator(device=x.device).manual_seed(seed)
    r, _ = torch.linalg.qr(torch.randn((n_bits, n_bits), generator=g,
                                       device=x.device))
    for _ in range(iters):
        b = torch.where(v @ r >= 0, 1.0, -1.0)
        # Procrustes: max tr(R^T V^T B) -> R = U Vh from svd(V^T B)
        u, _, vh = torch.linalg.svd(v.T @ b, full_matrices=False)
        r = u @ vh
    return BinaryCodec(mean=mean, proj=w_pca @ r)


def _pack(v: torch.Tensor) -> torch.Tensor:
    """(N, n_bits) projections -> (N, n_bits/8) uint8 sign bits, LSB first."""
    bits = (v >= 0).reshape(v.shape[0], -1, 8)
    out = bits[..., 0].to(torch.uint8)
    for i in range(1, 8):
        out |= bits[..., i].to(torch.uint8) << i
    return out


def binarize(descriptors, codec: BinaryCodec, chunk: int = _CHUNK) -> torch.Tensor:
    """(N, D) descriptors -> (N, n_bits/8) uint8 packed sign codes on the
    codec's device, ``chunk`` rows at a time (the fp32 projection of the
    whole corpus never exists)."""
    x = _as_tensor(descriptors)
    dev = codec.proj.device
    out = [_pack(project_queries(x[s:s + chunk].to(dev), codec))
           for s in range(0, x.shape[0], chunk)]
    return torch.cat(out) if out else torch.empty(
        (0, codec.n_bits // 8), dtype=torch.uint8, device=dev)


def project_queries(queries, codec: BinaryCodec) -> torch.Tensor:
    """Centred fp32 projection of float queries: the asymmetric-scoring
    counterpart of :func:`binarize` (only the database side is quantized).

    The product accumulates in fp64 and rounds once to fp32, so a row's
    projection, and with it its sign bits and bf16 query values, does not
    depend on how many rows share the call: cuBLAS picks its fp32 summation
    order by shape, and a served query must rank as it does alone."""
    q = _as_tensor(queries).to(codec.proj.device, torch.float32)
    return ((q - codec.mean).double() @ codec.proj.double()).float()


def binarize_and_project(queries, codec: BinaryCodec
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed codes, continuous projection) from one shared matmul."""
    v = project_queries(queries, codec)
    return _pack(v), v


# --------------------------------------------------------------------------
# layout helpers
# --------------------------------------------------------------------------

def _to_bytes(codes) -> torch.Tensor:
    """Packed codes -> (N, bytes) uint8 tensor: uint8 passes through, and
    dirjax's (N, W) uint32 words (numpy, or a 4-byte torch dtype) are viewed
    as their little-endian bytes, which is the LSB-first byte layout."""
    if not torch.is_tensor(codes):
        c = np.ascontiguousarray(codes)
        if c.dtype != np.uint8:
            if c.dtype.itemsize != 4:
                raise ValueError(f"packed codes are uint8 or uint32, got {c.dtype}")
            c = c.astype(c.dtype.newbyteorder("<"), copy=False).view(np.uint8)
        return torch.from_numpy(c)
    if codes.dtype == torch.uint8:
        return codes
    if codes.element_size() != 4:
        raise ValueError(f"packed codes are uint8 or 32-bit words, got {codes.dtype}")
    return codes.contiguous().view(torch.uint8)


def unpack_pm1(codes) -> torch.Tensor:
    """(..., bytes) packed codes -> (..., bytes*8) fp32 in {-1, +1}."""
    c = _to_bytes(codes)
    shifts = torch.arange(8, dtype=torch.uint8, device=c.device)
    bits = (c[..., None] >> shifts) & 1
    return bits.reshape(*c.shape[:-1], c.shape[-1] * 8).float() * 2.0 - 1.0


def bytes_for_search(codes, tile_rows: int = _BITS_TILE) -> torch.Tensor:
    """Packed codes -> (Npad, bytes) uint8, zero rows padding N to a
    ``tile_rows`` multiple: dirjax's resident search layout. The search
    here takes any row count, so the padding is optional."""
    b = _to_bytes(codes)
    pad = -b.shape[0] % tile_rows
    if pad:
        b = torch.cat([b, b.new_zeros((pad, b.shape[1]))])
    return b


# --------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracles
# --------------------------------------------------------------------------

def _query_operand(q: torch.Tensor) -> torch.Tensor:
    """The fp32 query side of a contraction: unpacked ±1 for packed uint8
    queries (symmetric), the bf16 values widened exactly (asymmetric)."""
    return unpack_pm1(q) if q.dtype == torch.uint8 else q.float()


def bits_finemax_reference(q: torch.Tensor, db: torch.Tensor,
                           blocks: Optional[int] = None) -> torch.Tensor:
    """K5's plain version: (nq, blocks) maxima over rows [8b, 8b+8) of the
    scores of ``q`` against the (n, bytes) uint8 codes ``db``; rows >= n
    score -inf. ``q`` is (nq, bytes) uint8 packed codes (symmetric) or
    (nq, bytes*8) bf16 projected queries (asymmetric)."""
    nq, n = q.shape[0], db.shape[0]
    blocks = -(-n // _RPB) if blocks is None else blocks
    qf = _query_operand(q)
    out = torch.full((nq, blocks), _NEG, device=q.device)
    for start in range(0, n, _CHUNK):
        s = qf @ unpack_pm1(db[start:start + _CHUNK]).T
        pad = -s.shape[1] % _RPB
        s = torch.nn.functional.pad(s, (0, pad), value=_NEG).reshape(nq, -1, _RPB)
        out[:, start // _RPB:start // _RPB + s.shape[1]] = s.amax(dim=2)
    return out


def bits_gather_scores_reference(q: torch.Tensor, db: torch.Tensor,
                                 bids: torch.Tensor) -> torch.Tensor:
    """The asymmetric rescore's plain version: raw (nq, kf*8) scores of the
    bf16 queries against the 8 rows of each fine block ``bids`` names; NaN
    for a block not wholly inside the codes."""
    nq, kf = bids.shape
    n = db.shape[0]
    ok = (bids >= 0) & (bids * _RPB + _RPB <= n)
    rows = (bids.clamp(0, max(n // _RPB - 1, 0))[:, :, None] * _RPB
            + torch.arange(_RPB, device=db.device)).reshape(nq, -1).clamp(max=n - 1)
    out = torch.empty((nq, kf * _RPB), device=q.device)
    step = max(1, _CHUNK // max(kf * _RPB, 1))
    for i in range(0, nq, step):
        cand = unpack_pm1(db[rows[i:i + step]])            # (b, kf*8, bits)
        out[i:i + step] = torch.bmm(cand, q[i:i + step].float()[:, :, None])[:, :, 0]
    return out.masked_fill(~ok.repeat_interleave(_RPB, dim=1), float("nan"))


# --------------------------------------------------------------------------
# kernel wrappers: plain version for a CPU tensor, the kernel for CUDA
# --------------------------------------------------------------------------

def _check(name: str, q: torch.Tensor, db: torch.Tensor) -> int:
    """Validate the operands; returns 1 for asymmetric (bf16) queries, 0 for
    symmetric (packed uint8) ones."""
    if db.dim() != 2 or db.dtype != torch.uint8 or db.shape[1] % 4 or not db.shape[0]:
        raise ValueError(f"{name}: db must be non-empty (n, bytes) uint8 codes with "
                         f"bytes a multiple of 4, got {tuple(db.shape)} {db.dtype}")
    nb = db.shape[1]
    if q.dim() == 2 and q.dtype == torch.uint8 and q.shape[1] == nb:
        asym = 0
    elif q.dim() == 2 and q.dtype == torch.bfloat16 and q.shape[1] == nb * 8:
        asym = 1
    else:
        raise ValueError(f"{name}: queries must be ({nb} bytes) uint8 codes or "
                         f"({nb * 8} bits) bf16, got {tuple(q.shape)} {q.dtype}")
    if q.device != db.device or not (q.is_contiguous() and db.is_contiguous()):
        raise ValueError(f"{name}: q and db must be contiguous on one device")
    if db.data_ptr() % 4 or q.data_ptr() % 4:
        raise ValueError(f"{name}: q and db must be 4-byte aligned (code words)")
    return asym


def bits_finemax(q: torch.Tensor, db: torch.Tensor,
                 blocks: Optional[int] = None) -> torch.Tensor:
    """K5: (nq, blocks) fine-block maxima (see :func:`bits_finemax_reference`)."""
    nq, n = q.shape[0], db.shape[0]
    blocks = -(-n // _RPB) if blocks is None else blocks
    if blocks * _RPB < n:
        raise ValueError(f"bits_finemax: {blocks} blocks cannot cover {n} rows")
    if _device("bits_finemax", q) == "cpu":
        return bits_finemax_reference(q, db, blocks)
    asym = _check("bits_finemax", q, db)
    out = torch.empty((nq, blocks), device=q.device)
    if nq:
        q = q if asym else unpack_pm1(q).to(torch.int8)   # K5's int8 ±1 queries
        _run("bits_finemax", q.device, q.data_ptr(), db.data_ptr(), asym, nq, n,
             db.shape[1] // 4, blocks, out.data_ptr(), counts=launches)
    return out


def bits_gather_scores(q: torch.Tensor, db: torch.Tensor,
                       bids: torch.Tensor) -> torch.Tensor:
    """The asymmetric rescore: raw (nq, kf*8) scores (see
    :func:`bits_gather_scores_reference`)."""
    if _device("bits_gather_scores", q) == "cpu":
        return bits_gather_scores_reference(q, db, bids)
    if not _check("bits_gather_scores", q, db):
        raise ValueError("bits_gather_scores rescores bf16 (asymmetric) queries")
    if (bids.dim() != 2 or bids.shape[0] != q.shape[0] or bids.dtype != torch.int64
            or bids.device != q.device or not bids.is_contiguous()):
        raise ValueError(f"bits_gather_scores: bids must be contiguous int64 "
                         f"({q.shape[0]}, kf) on {q.device}")
    nq, kf = bids.shape
    out = torch.empty((nq, kf * _RPB), device=q.device)
    if nq and kf:
        _run("bits_gather_scores", q.device, q.data_ptr(), db.data_ptr(),
             bids.data_ptr(), nq, db.shape[0], db.shape[1] // 4, kf,
             out.data_ptr(), counts=launches)
    return out


# --------------------------------------------------------------------------
# finishes (torch ops, as dirjax leaves them to XLA)
# --------------------------------------------------------------------------

def _hamming(qb: torch.Tensor, db: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(nq, m) int32 Hamming distances of each query's packed code to the
    rows ``rows[qi]`` of ``db``, through a byte popcount table."""
    table = _POPC8.to(qb.device)
    nq, m = rows.shape
    out = torch.empty((nq, m), dtype=torch.int32, device=qb.device)
    step = max(1, (1 << 24) // max(m * db.shape[1], 1))
    for i in range(0, nq, step):
        x = db[rows[i:i + step]] ^ qb[i:i + step, None, :]
        out[i:i + step] = table[x.int()].sum(dim=-1, dtype=torch.int32)
    return out


def _finish(scores: torch.Tensor, rows: torch.Tensor, k: int):
    vals, pos = _topk(scores, k)
    idxs = torch.gather(rows, 1, pos)
    return vals, torch.where(vals > _NEG, idxs, -1)


def _candidates(bids: torch.Tensor, vmask: torch.Tensor, n_valid: int):
    """Row ids of the candidate blocks (clipped into the codes) and the
    mask of genuine candidates, both (nq, kf_pad*8)."""
    nq, kf_pad = bids.shape
    rows = (bids[:, :, None] * _RPB
            + torch.arange(_RPB, device=bids.device)).reshape(nq, kf_pad * _RPB)
    return rows.clamp(max=n_valid - 1), vmask.repeat_interleave(_RPB, dim=1)


def _tail_rows(nq: int, n_valid: int, device) -> torch.Tensor:
    """The ragged tail (< 8 rows past the last whole fine block), per query."""
    start = n_valid // _RPB * _RPB
    return torch.arange(start, n_valid, device=device).expand(nq, -1)


def _bits_finish(qb, db, bids, vmask, k: int, n_valid: int):
    """Symmetric finish: exact popcount rescore of the candidate blocks and
    of the ragged tail, final top-k."""
    n_bits = db.shape[1] * 8
    rows, valid = _candidates(bids, vmask, n_valid)
    rows = torch.cat([rows, _tail_rows(len(qb), n_valid, db.device)], dim=1)
    valid = torch.cat([valid, valid.new_ones((len(qb), rows.shape[1] - valid.shape[1]))],
                      dim=1)
    sims = (n_bits - 2 * _hamming(qb, db, rows)).float()
    return _finish(torch.where(valid, sims, _NEG), rows, k)


def _bits_finish_asym(vqb, db, bids, vmask, k: int, n_valid: int):
    """Asymmetric finish: the rescore kernel over the candidate blocks (its
    block maxima are K5's), the ragged tail scored densely, final top-k."""
    rows, valid = _candidates(bids, vmask, n_valid)
    scores = torch.where(valid, bits_gather_scores(vqb, db, bids), _NEG)
    tail = _tail_rows(len(vqb), n_valid, db.device)
    if tail.shape[1]:
        tscores = vqb.float() @ unpack_pm1(db[tail[0]]).T
        scores = torch.cat([scores, tscores], dim=1)
        rows = torch.cat([rows, tail], dim=1)
    return _finish(scores, rows, k)


# --------------------------------------------------------------------------
# public search API
# --------------------------------------------------------------------------

def _plan(db_bytes, k: int, n_valid: Optional[int], tile_rows: int):
    db = _to_bytes(db_bytes)
    n = db.shape[0] if n_valid is None else int(n_valid)
    if not 0 < n <= db.shape[0]:
        raise ValueError(f"n_valid={n} must be in [1, {db.shape[0]}]")
    if not 0 < k <= n:
        raise ValueError(f"k={k} exceeds the {n} database rows")
    if tile_rows % 128 or not 0 < tile_rows <= 128 * 128:
        raise ValueError(f"tile_rows={tile_rows} must be a multiple of 128 "
                         "in [128, 16384]")
    blocks = -(-n // tile_rows) * (tile_rows // _RPB)
    return db[:n], n, blocks


def hamming_topk(q_packed, db_packed, k: int, *, n_valid: Optional[int] = None):
    """Exact top-k by Hamming distance, plain: the ±1 dot of every row,
    chunk by chunk. Returns fp32 values ``n_bits - 2*dist`` (descending) and
    int64 indices; rows >= ``n_valid`` are never returned. Ties rank the
    lower index first."""
    db = _to_bytes(db_packed)
    qf = unpack_pm1(_to_bytes(q_packed).to(db.device))
    n = db.shape[0] if n_valid is None else int(n_valid)
    if not 0 < k <= n:
        raise ValueError(f"k={k} exceeds the {n} database rows")
    best = None
    for start in range(0, n, _CHUNK):
        s = qf @ unpack_pm1(db[start:min(start + _CHUNK, n)]).T
        v, i = _topk(s, min(k, s.shape[1]))
        cand = (v, i + start) if best is None else (
            torch.cat([best[0], v], 1), torch.cat([best[1], i + start], 1))
        v, pos = _topk(cand[0], k)
        best = (v, torch.gather(cand[1], 1, pos))
    return best


def asym_rescore(vq, codes, idxs, k: int):
    """Asymmetric rescore of a Hamming shortlist (dirjax's ``asym_rescore``):
    the continuous fp32 projected queries ``vq`` (:func:`project_queries`,
    not rounded to bf16) against the ±1 unpacked codes of each query's
    candidate rows ``idxs`` (nq, c), an fp32 product over the shortlist.
    Slots of -1 are ignored. Returns the top ``min(k, c)`` (values, int64
    indices) of the shortlist, -inf/-1 where fewer candidates are real."""
    codes = _to_bytes(codes)
    vq = _as_tensor(vq).to(codes.device, torch.float32)
    idxs = _as_tensor(idxs).to(codes.device, torch.int64)
    nq, c = idxs.shape
    scores = torch.empty((nq, c), device=codes.device)
    step = max(1, (1 << 24) // max(c * codes.shape[1] * 8, 1))
    for i in range(0, nq, step):
        cand = unpack_pm1(codes[idxs[i:i + step].clamp_min(0)])   # (b, c, bits)
        scores[i:i + step] = torch.bmm(cand, vq[i:i + step, :, None])[:, :, 0]
    scores = torch.where(idxs >= 0, scores, _NEG)
    vals, pos = _topk(scores, min(k, c))
    sel = torch.gather(idxs, 1, pos)
    return vals, torch.where(torch.isfinite(vals), sel, -1)


def hamming_topk_mxu(q_packed, db_bytes, k: int, *, n_valid: Optional[int] = None,
                     tile_rows: int = _BITS_TILE):
    """Exact symmetric top-k through the hierarchy: K5 fine maxima ->
    ``_hier_select`` -> popcount finish. The same return contract as
    :func:`hamming_topk`, on the codes' device."""
    db, n, blocks = _plan(db_bytes, k, n_valid, tile_rows)
    qb = _to_bytes(q_packed).to(db.device).contiguous()
    fmax = bits_finemax(qb, db, blocks)
    bids, vmask = _hier_select(fmax, k, tile_rows, n)
    return _bits_finish(qb, db, bids, vmask, k, n)


def hamming_search_fused(queries, codec: BinaryCodec, db_bytes, k: int, *,
                         n_valid: Optional[int] = None,
                         tile_rows: int = _BITS_TILE, asym: bool = True):
    """The whole binary search: float queries -> centred projection (packed
    codes and the continuous projection from one matmul) -> exact top-k on
    the codes' device. Returns (fp32 values, int64 indices).

    ``asym=False`` ranks by the symmetric ±1 dot (``n_bits - 2*hamming``,
    exact integers). ``asym=True`` ranks by the exact asymmetric score: K5
    writes fine maxima of the final score, so the hierarchy selects its top-k
    directly, with no symmetric shortlist."""
    db, n, blocks = _plan(db_bytes, k, n_valid, tile_rows)
    q = _as_tensor(queries)
    qb, vq = binarize_and_project(q[None] if q.dim() == 1 else q, codec)
    if not asym:
        return hamming_topk_mxu(qb, db, k, n_valid=n, tile_rows=tile_rows)
    vqb = vq.to(torch.bfloat16).contiguous()
    fmax = bits_finemax(vqb, db, blocks)
    bids, vmask = _hier_select(fmax, k, tile_rows, n)
    return _bits_finish_asym(vqb, db, bids, vmask, k, n)
