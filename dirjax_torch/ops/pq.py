"""Product quantization (PQ/OPQ) and ADC top-k (counterpart of
``dirjax/ops/pq.py``), on the kernels of ``csrc/pq.cu``.

A row is stored as ``m`` uint8 codebook ids (32 B at m = 32) and scored
against a query by asymmetric distance computation (ADC): the query's lookup
tables ``luts[q, j, c] = q_j . codebooks[j, c]`` (:func:`pq_lookup`) summed
over the row's codes, which equals ``q . reconstruct_pq(codes)`` up to fp32
rounding.

:func:`pq_topk` keeps dirjax's rules: the fine block is 64 rows, or 8 when
``m * ksub > 1024``; a corpus of at most ``max(4096, 2 * k * block)`` rows is
scored densely (**K6** at block 1, whose maxima are the scores); a larger
one goes through the hierarchy: **K6** :func:`adc_finemax` writes only each
block's maximum score, :func:`_descend_maxima` (dirjax's x16 max-pyramid,
with gathers where dirjax contracts one-hots) picks the k winning blocks,
and the rescore :func:`adc_gather_scores` scores their rows for the final
top-k. The rescore adds the same fp32 table values in the same order as K6,
so its block maxima equal K6's bit for bit, which the containment argument
of ``ops/topk.py`` needs. ``compute_dtype=torch.bfloat16`` rounds the tables
to bf16 before any scoring; sums accumulate in fp32 either way.

Each kernel wrapper runs its plain PyTorch version (``*_reference``, same
signature and output layout, the kernel's oracle) for a CPU tensor, and
launches the kernel or raises for a CUDA tensor. The plain versions add
``luts[:, j, codes[:, j]]`` for j = 0 .. m-1 in fp32, as the kernels do, so
they agree with them exactly. Ties rank the lower index first, as
``lax.top_k`` does. Indices come back int64.

Training runs k-means batched over the subspaces with fp32 ``bmm`` (keep
TF32 off, PyTorch's default for matmuls, for dirjax's ``precision=HIGHEST``)
and dirjax's argmin rule ``||c||^2 - 2 x.c``; empty clusters keep their
centroid. Samples and initial centroids come from a ``torch.Generator``
seeded with ``seed``: it cannot reproduce ``jax.random``'s draws, so the two
packages train different codebooks of equal quality from the same seed; with
an explicit ``init`` the Lloyd iterations are deterministic and match.
:func:`pq_lookup` accumulates in fp64 and rounds once, so a query's tables do
not depend on the batch it rides in.

Not carried over (TPU workarounds): the one-hot ``_select_exact`` dots, the
``N / block < 2**24`` assertion, ``_pallas_geometry`` and its slices, the
XLA scan and its ``chunk``, and ``use_pallas``. :func:`pq_pad_codes` is kept
as API; the search takes codes of any row count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .topk import _device, _run, _topk

__all__ = ["train_pq", "encode_pq", "pq_lookup", "pq_scores", "pq_topk",
           "pq_pad_codes", "reconstruct_pq", "train_opq", "adc_finemax",
           "adc_gather_scores", "adc_finemax_reference",
           "adc_gather_scores_reference", "launches"]

#: launches of each CUDA kernel in this process (reset them to count a run;
#: plain ints, so a race between serving threads may lose an increment)
launches = {"adc_finemax": 0, "adc_gather_scores": 0}

_BLOCK = 64         # fine-block rows of the hierarchy (dirjax's)
_CHUNK = 65536      # rows per plain-version step (bounds its memory)
#: finite -inf stand-in inside the selection pyramid, dirjax's value
_NEG = float(np.float32(-3.0e38))


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _as_subvectors(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) -> (m, N, dsub) with D = m * dsub."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} is not divisible by m={m}")
    return x.reshape(n, m, d // m).transpose(0, 1).contiguous()


def _assign(chunk: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids (m, C) of a (m, C, dsub) chunk against
    (m, ksub, dsub) centroids: argmin of ``||c||^2 - 2 x.c`` (the ``||x||^2``
    term is constant per row), the first minimum on ties."""
    xc = torch.bmm(chunk, centroids.transpose(1, 2))
    c2 = centroids.square().sum(-1)
    return torch.argmin(c2[:, None, :] - 2.0 * xc, dim=-1)


def _kmeans(x_sub: torch.Tensor, init: torch.Tensor, iters: int, chunk: int) -> torch.Tensor:
    """Lloyd iterations batched over subspaces: ``x_sub`` (m, N, dsub), init
    (m, ksub, dsub). Sums accumulate chunk by chunk as a one-hot ``bmm``
    (deterministic, as dirjax's einsum); empty clusters keep their centroid."""
    m, n, _ = x_sub.shape
    ksub = init.shape[1]
    c = init
    for _ in range(iters):
        sums = torch.zeros_like(c)
        counts = torch.zeros((m, ksub), device=c.device)
        for start in range(0, n, chunk):
            blk = x_sub[:, start:start + chunk]
            ids = _assign(blk, c)
            oh = torch.zeros((m, blk.shape[1], ksub), device=c.device)
            oh.scatter_(2, ids[:, :, None], 1.0)
            sums += torch.bmm(oh.transpose(1, 2), blk)
            counts += oh.sum(dim=1)
        c = torch.where(counts[..., None] > 0, sums / counts.clamp_min(1.0)[..., None], c)
    return c


def _sample_rows(x: torch.Tensor, count: int, g: torch.Generator) -> torch.Tensor:
    """``count`` distinct row ids of ``x`` drawn from ``g``."""
    return torch.randperm(x.shape[0], generator=g, device=g.device)[:count].to(x.device)


def train_pq(x, m: int = 16, ksub: int = 256, *, iters: int = 25, seed: int = 0,
             sample: Optional[int] = 262144, chunk: int = 8192,
             init=None) -> torch.Tensor:
    """Learn PQ codebooks (m, ksub, dsub) fp32 by per-subspace k-means, on
    the rows' device (a numpy array trains on the CPU).

    ``sample`` caps the training rows; ``init`` (m, ksub, dsub) warm-starts
    the centroids (:func:`train_opq` uses it), else ``ksub`` rows drawn from
    the seeded generator start them (each subspace its own subvectors)."""
    x = _as_tensor(x).float()
    n = x.shape[0]
    if not 0 < ksub <= 256:
        raise ValueError(f"codes are uint8: ksub must be in [1, 256], got {ksub}")
    if n < ksub:
        raise ValueError(f"need at least ksub={ksub} training rows, got {n}")
    g = torch.Generator(device=x.device).manual_seed(seed)
    if sample is not None and n > sample:
        x = x[_sample_rows(x, sample, g)]
        n = sample
    x_sub = _as_subvectors(x, m)
    if init is None:
        init = x_sub[:, _sample_rows(x, ksub, g)]
    init = _as_tensor(init).to(x.device, torch.float32)
    return _kmeans(x_sub, init, iters, min(chunk, max(256, n)))


def encode_pq(x, codebooks: torch.Tensor, *, chunk: int = 65536) -> torch.Tensor:
    """Quantize (N, D) rows to (N, m) uint8 codes on the codebooks' device,
    ``chunk`` rows at a time."""
    x = _as_tensor(x)
    m = codebooks.shape[0]
    out = [_assign(_as_subvectors(x[s:s + chunk].to(codebooks.device, torch.float32), m),
                   codebooks).T.to(torch.uint8)
           for s in range(0, x.shape[0], chunk)]
    return torch.cat(out) if out else torch.zeros((0, m), dtype=torch.uint8,
                                                  device=codebooks.device)


def pq_lookup(q, codebooks: torch.Tensor) -> torch.Tensor:
    """ADC lookup tables (nq, m, ksub) fp32: each query subvector against
    every centroid of its subspace, accumulated in fp64 and rounded once."""
    q = _as_tensor(q).to(codebooks.device)
    nq, d = q.shape
    m = codebooks.shape[0]
    return torch.einsum("qmd,mkd->qmk", q.double().reshape(nq, m, d // m),
                        codebooks.double()).float().contiguous()


def _round_luts(luts: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Tables in the ADC compute dtype: fp32 (None) or bf16 (rounded once,
    before any scoring)."""
    if compute_dtype in (None, torch.float32):
        return luts.float().contiguous()
    if compute_dtype == torch.bfloat16:
        return luts.to(torch.bfloat16).contiguous()
    raise ValueError(f"compute_dtype must be None, torch.float32 or torch.bfloat16, "
                     f"got {compute_dtype}")


def reconstruct_pq(codes, codebooks: torch.Tensor) -> torch.Tensor:
    """Decode (N, m) codes back to (N, D) concatenated centroids."""
    codes = _as_tensor(codes).to(codebooks.device).long()
    m = codebooks.shape[0]
    rec = codebooks[torch.arange(m, device=codes.device)[None, :], codes]   # (N, m, dsub)
    return rec.reshape(codes.shape[0], -1)


def train_opq(x, m: int = 16, ksub: int = 256, *, iters: int = 25, opq_iters: int = 10,
              seed: int = 0, sample: Optional[int] = 131072,
              chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPQ (Ge et al., CVPR'13): a rotation R (D, D) and codebooks minimizing
    the quantization error of ``x @ R``, by alternating k-means and orthogonal
    Procrustes (``torch.linalg.svd``). Encode ``x @ R``; build query tables
    from ``q @ R``. Returns ``(R, codebooks)``."""
    x = _as_tensor(x).float()
    n, d = x.shape
    if sample is not None and n > sample:
        g = torch.Generator(device=x.device).manual_seed(seed)
        x = x[_sample_rows(x, sample, g)]
    r = torch.eye(d, device=x.device)
    codebooks = None
    for _ in range(opq_iters):
        xr = x @ r
        codebooks = train_pq(xr, m, ksub, iters=max(4, iters // 4), seed=seed, sample=None,
                             chunk=chunk, init=codebooks)
        rec = reconstruct_pq(encode_pq(xr, codebooks), codebooks)
        # in fp64: an fp32 SVD on the card left R ~1e-3 from orthogonal at
        # D = 2048
        u, _, vt = torch.linalg.svd((x.T @ rec).double(), full_matrices=False)
        r = (u @ vt).float()
    codebooks = train_pq(x @ r, m, ksub, iters=iters, seed=seed, sample=None, chunk=chunk,
                         init=codebooks)
    return r, codebooks


def pq_pad_codes(codes, *, chunk: int = 131072) -> Tuple[torch.Tensor, int]:
    """Pad (N, m) codes with zero rows to dirjax's resident geometry (a
    ``chunk`` multiple past 32768 rows, else 256); returns ``(codes_padded,
    n_valid)`` for ``pq_topk(..., n_valid=)``. The port's search takes any
    row count, so the padding is optional."""
    codes = _as_tensor(codes)
    n = codes.shape[0]
    pad = -n % (chunk if n > 32768 else 256)
    if pad:
        codes = torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])
    return codes, n


# --------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracles
# --------------------------------------------------------------------------

def _adc_rows(lf: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(nq, C) ADC scores of the C rows ``codes`` (int64) under fp32 tables
    ``lf``: fp32 adds for j = 0 .. m-1, the kernels' order."""
    s = torch.zeros((lf.shape[0], codes.shape[0]), device=lf.device)
    for j in range(lf.shape[1]):
        s += lf[:, j, codes[:, j]]
    return s


def adc_finemax_reference(luts: torch.Tensor, codes: torch.Tensor, block: int) -> torch.Tensor:
    """K6's plain version: (nq, ceil(n / block)) maxima over rows [block*b,
    block*b + block) of the ADC scores of ``luts`` (nq, m, ksub) fp32 or bf16
    against the (n, m) uint8 ``codes``; rows >= n score -inf."""
    nq, n = luts.shape[0], codes.shape[0]
    blocks = -(-n // block)
    lf = luts.float()
    out = torch.full((nq, blocks), float("-inf"), device=luts.device)
    step = max(block, _CHUNK // block * block)
    for start in range(0, n, step):
        s = _adc_rows(lf, codes[start:start + step].long())
        s = torch.nn.functional.pad(s, (0, -s.shape[1] % block), value=float("-inf"))
        s = s.reshape(nq, -1, block).amax(dim=2)
        out[:, start // block:start // block + s.shape[1]] = s
    return out


def adc_gather_scores_reference(luts: torch.Tensor, codes: torch.Tensor,
                                bids: torch.Tensor, block: int) -> torch.Tensor:
    """The rescore's plain version: raw (nq, kf*block) ADC scores of the rows
    of each block ``bids`` (nq, kf) names; NaN for a block id outside
    [0, ceil(n / block)), -inf for a row >= n inside a valid block."""
    nq, kf = bids.shape
    n = codes.shape[0]
    nb = -(-n // block)
    valid = (bids >= 0) & (bids < nb)
    rows = (bids.clamp(0, nb - 1)[:, :, None] * block
            + torch.arange(block, device=bids.device)).reshape(nq, kf * block)
    inside = rows < n
    rows = rows.clamp(max=n - 1)
    lf = luts.float()
    out = torch.empty((nq, kf * block), device=luts.device)
    step = max(1, _CHUNK // max(kf * block, 1))
    for i in range(0, nq, step):
        c = codes[rows[i:i + step]].long()                      # (b, R, m)
        s = torch.zeros(c.shape[:2], device=luts.device)
        for j in range(lf.shape[1]):
            s += torch.gather(lf[i:i + step, j], 1, c[:, :, j])
        out[i:i + step] = s
    out = torch.where(inside, out, float("-inf"))
    return out.masked_fill(~valid.repeat_interleave(block, dim=1), float("nan"))


# --------------------------------------------------------------------------
# kernel wrappers: plain version for a CPU tensor, the kernel for CUDA
# --------------------------------------------------------------------------

def _check(name: str, luts: torch.Tensor, codes: torch.Tensor, block: int) -> None:
    if luts.dim() != 3 or luts.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: luts must be (nq, m, ksub) fp32 or bf16, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    if not 0 < luts.shape[2] <= 256:
        raise ValueError(f"{name}: ksub must be in [1, 256], got {luts.shape[2]}")
    if (codes.dim() != 2 or codes.dtype != torch.uint8 or codes.shape[1] != luts.shape[1]
            or not codes.shape[0]):
        raise ValueError(f"{name}: codes must be non-empty (n, {luts.shape[1]}) uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if luts.device != codes.device or not (luts.is_contiguous() and codes.is_contiguous()):
        raise ValueError(f"{name}: luts and codes must be contiguous on one device")
    if block < 1:
        raise ValueError(f"{name}: block must be positive, got {block}")


def adc_finemax(luts: torch.Tensor, codes: torch.Tensor, block: int) -> torch.Tensor:
    """K6: (nq, ceil(n / block)) fine-block ADC maxima (see
    :func:`adc_finemax_reference`)."""
    if _device("adc_finemax", luts) == "cpu":
        return adc_finemax_reference(luts, codes, block)
    _check("adc_finemax", luts, codes, block)
    nq, n = luts.shape[0], codes.shape[0]
    out = torch.empty((nq, -(-n // block)), device=luts.device)
    if nq:
        _run("adc_finemax", luts.device, luts.data_ptr(), int(luts.dtype == torch.bfloat16),
             codes.data_ptr(), nq, n, codes.shape[1], luts.shape[2], block,
             out.data_ptr(), counts=launches)
    return out


def adc_gather_scores(luts: torch.Tensor, codes: torch.Tensor, bids: torch.Tensor,
                      block: int) -> torch.Tensor:
    """The rescore: raw (nq, kf*block) scores of the candidate blocks (see
    :func:`adc_gather_scores_reference`)."""
    if _device("adc_gather_scores", luts) == "cpu":
        return adc_gather_scores_reference(luts, codes, bids, block)
    _check("adc_gather_scores", luts, codes, block)
    if (bids.dim() != 2 or bids.shape[0] != luts.shape[0] or bids.dtype != torch.int64
            or bids.device != luts.device or not bids.is_contiguous()):
        raise ValueError(f"adc_gather_scores: bids must be contiguous int64 "
                         f"({luts.shape[0]}, kf) on {luts.device}")
    nq, kf = bids.shape
    out = torch.empty((nq, kf * block), device=luts.device)
    if nq and kf:
        _run("adc_gather_scores", luts.device, luts.data_ptr(),
             int(luts.dtype == torch.bfloat16), codes.data_ptr(), bids.data_ptr(), nq,
             codes.shape[0], codes.shape[1], luts.shape[2], block, kf, out.data_ptr(),
             counts=launches)
    return out


# --------------------------------------------------------------------------
# selection (torch ops, as dirjax leaves them to XLA)
# --------------------------------------------------------------------------

def _descend_maxima(fmax: torch.Tensor, k: int):
    """Hierarchical selection over per-block maxima (nq, nb): a x16
    max-pyramid until the coarsest width is <= 4096, a top-k there, then at
    each level the surviving groups expand to their 16 children and a top-k
    keeps k. Each level's top-k by group maximum contains every true top-k
    block. Returns ``(ids (nq, kf) int64, valid (nq, kf))``."""
    nq = fmax.shape[0]
    pad16 = lambda f: torch.nn.functional.pad(f, (0, -f.shape[1] % 16), value=_NEG)  # noqa: E731
    pyramid = [fmax.clamp_min(_NEG)]
    while pyramid[-1].shape[1] > 4096:
        pyramid.append(pad16(pyramid[-1]).reshape(nq, -1, 16).amax(dim=2))
    top_v, top = _topk(pyramid[-1], min(k, pyramid[-1].shape[1]))
    for child in reversed(pyramid[:-1]):
        w = child.shape[1]
        c3 = pad16(child).reshape(nq, -1, 16)
        v = torch.gather(c3, 1, top[:, :, None].expand(-1, -1, 16)).reshape(nq, -1)
        cand = (top[:, :, None] * 16 + torch.arange(16, device=top.device)).reshape(nq, -1)
        v = torch.where(cand < w, v, _NEG)
        top_v, sel = _topk(v, min(k, v.shape[1]))
        top = torch.gather(cand, 1, sel)
    return top, top_v > 0.5 * _NEG


def _pad_k(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """Pad (nq, kk) results to k columns with -inf / -1."""
    short = k - vals.shape[1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short), value=float("-inf"))
        idxs = torch.nn.functional.pad(idxs, (0, short), value=-1)
    return vals, idxs


def pq_scores(luts, codes, *, compute_dtype=None) -> torch.Tensor:
    """Dense (nq, N) ADC scores (K6 at block 1): small corpora and tests; the
    search is :func:`pq_topk`."""
    codes = _as_tensor(codes).contiguous()
    return adc_finemax(_round_luts(_as_tensor(luts), compute_dtype), codes, 1)


def pq_topk(luts, codes, k: int, *, block: int = _BLOCK, compute_dtype=None,
            n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k: (fp32 values, int64 indices) of the best ``k`` rows per
    query on the tables' device; ``-inf``/-1 pad past the corpus when
    k > N. ``n_valid``: the true row count of codes padded past it
    (:func:`pq_pad_codes`); padded rows never appear in results."""
    luts = _round_luts(_as_tensor(luts), compute_dtype)
    codes = _as_tensor(codes)
    n = codes.shape[0] if n_valid is None else int(n_valid)
    if not 0 < n <= codes.shape[0]:
        raise ValueError(f"n_valid={n} must be in [1, {codes.shape[0]}]")
    if codes.device != luts.device:
        raise ValueError(f"tables on {luts.device}, codes on {codes.device}")
    codes = codes[:n].contiguous()
    if block == _BLOCK and luts.shape[1] * luts.shape[2] > 1024:
        block = 8    # large ksub: 8-row blocks keep the rescore 8x narrower
    if n <= max(4096, 2 * k * block):    # the hierarchy cannot pay for itself
        vals, idxs = _topk(adc_finemax(luts, codes, 1), min(k, n))
        return _pad_k(vals, torch.where(vals > float("-inf"), idxs, -1), k)
    bids, bvalid = _descend_maxima(adc_finemax(luts, codes, block), k)
    raw = adc_gather_scores(luts, codes, bids.contiguous(), block)
    nq, kf = bids.shape
    rows = (bids[:, :, None] * block
            + torch.arange(block, device=bids.device)).reshape(nq, kf * block)
    s = torch.where(bvalid.repeat_interleave(block, dim=1) & (rows < n), raw, float("-inf"))
    vals, pos = _topk(s, min(k, s.shape[1]))
    idxs = torch.gather(rows, 1, pos)
    return vals, torch.where(vals > float("-inf"), idxs, -1)
