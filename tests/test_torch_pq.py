"""dirjax_torch's product quantization (ops/pq.py) and PQIndex held against
dirjax's on the same numpy inputs (CPU). dirjax's K6 runs as its own tests
run it, ``pq_topk(..., use_pallas=True)`` in interpret mode; the port takes
its kernels' route with their plain versions.

Trained state crosses between the packages (``pq_from_jax``, a shared
``init``): the two draw different random samples from the same seed.
Tolerances: fp32 ADC values within 1e-5 (the same table entries summed in
another order: dirjax contracts one-hots, the port adds j = 0 .. m-1), bf16
within 1e-4 (the tables round to the same bf16 values, only the fp32
summation order differs); the index sets equal wherever the k-th/(k+1)-th
margin exceeds 1e-3. Codes, reconstructions and the selection pyramid are
exactly equal.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dirjax import serving as JS
from dirjax.cli.index import main as jindex
from dirjax.ops import pq as J
from dirjax_torch import serving as TS
from dirjax_torch.cli.index import main as tindex
from dirjax_torch.ops import pq as T
from dirjax_torch.utils.checkpoints import pq_from_jax

torch.set_num_threads(1)

ATOL = {None: 1e-5, "bf16": 1e-4}
MARGIN = 1e-3
D, N, NQ = 64, 9000, 5
REPO = __file__.rsplit("/tests/", 1)[0]


def _unit(rng, rows, d=D):
    x = rng.normal(size=(rows, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return _unit(rng, N), _unit(rng, NQ)


def _same_topk(got, want, scores, atol):
    """Values within ``atol``; every returned row carries its plain score;
    the rows above the k-th score by MARGIN are the same rows."""
    (gv, gi), (wv, wi) = (tuple(np.asarray(a) for a in p) for p in (got, want))
    assert gv.shape == wv.shape and gv.dtype == np.float32
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    live = gi >= 0
    np.testing.assert_array_equal(live, wi >= 0)
    np.testing.assert_allclose(np.take_along_axis(scores, np.maximum(gi, 0), 1)[live],
                               gv[live], rtol=0, atol=atol)
    for r in range(len(gv)):
        kth = wv[r, live[r]][-1] if live[r].any() else np.inf
        assert set(gi[r][gv[r] > kth + MARGIN]) == set(wi[r][wv[r] > kth + MARGIN])


def _codebooks(rng, m, ksub, d=D):
    return rng.normal(scale=0.3, size=(m, ksub, d // m)).astype(np.float32)


# --- ops --------------------------------------------------------------------

@pytest.mark.parametrize("ksub", [16, 256])
def test_lloyd_from_shared_init_matches(ksub):
    """train_pq's Lloyd steps from one init: centroids within 1e-5 (the
    assignments agree; sums in another order)."""
    rng = np.random.default_rng(ksub)
    x, m = _unit(rng, 3000), 8
    init = x[:ksub].reshape(ksub, m, D // m).transpose(1, 0, 2).copy()
    want = np.asarray(J.train_pq(x, m, ksub, iters=4, init=jnp.asarray(init), chunk=1000))
    got = T.train_pq(x, m, ksub, iters=4, init=init, chunk=1000)
    assert got.shape == (m, ksub, D // m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_train_pq_seeded_and_checked():
    x = _unit(np.random.default_rng(1), 600)
    a, b = T.train_pq(x, 8, 16, iters=2, seed=3, sample=500), \
        T.train_pq(x, 8, 16, iters=2, seed=3, sample=500)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="ksub"):
        T.train_pq(x, 8, 300)
    with pytest.raises(ValueError, match="training rows"):
        T.train_pq(x[:10], 8, 16)
    with pytest.raises(ValueError, match="divisible"):
        T.train_pq(x, 7, 16)


@pytest.mark.parametrize("ksub", [16, 256])
def test_encode_reconstruct_lookup_match(data, ksub):
    db, q = data
    cb = _codebooks(np.random.default_rng(2), 8, ksub)
    want = np.asarray(J.encode_pq(db, jnp.asarray(cb)))
    got = T.encode_pq(db, torch.from_numpy(cb), chunk=4000)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T.reconstruct_pq(got, torch.from_numpy(cb)).numpy(),
                                  np.asarray(J.reconstruct_pq(want, jnp.asarray(cb))))
    np.testing.assert_allclose(T.pq_lookup(q, torch.from_numpy(cb)).numpy(),
                               np.asarray(J.pq_lookup(q, jnp.asarray(cb))), rtol=0, atol=1e-6)
    assert T.encode_pq(db[:0], torch.from_numpy(cb)).shape == (0, 8)


@pytest.mark.parametrize("ksub,m", [(16, 8), (256, 4)])
@pytest.mark.parametrize("dt", [None, "bf16"])
@pytest.mark.parametrize("n,k", [(N, 10), (N - 7, 100), (903, 20), (N, 1)],
                         ids=["hier-k10", "hier-ragged-k100", "dense", "hier-k1"])
def test_pq_topk_matches_dirjax(data, ksub, m, dt, n, k):
    """Hierarchy at block 64 (ksub 16) and 8 (m*ksub > 1024), and the dense
    path, against dirjax's K6 in interpret mode."""
    db, q = data
    rng = np.random.default_rng(ksub + m)
    cb = _codebooks(rng, m, ksub)
    codes = np.asarray(J.encode_pq(db[:n], jnp.asarray(cb)))
    jl = J.pq_lookup(q, jnp.asarray(cb))
    tl = T.pq_lookup(q, torch.from_numpy(cb))
    want = J.pq_topk(jl, codes, k, compute_dtype=jnp.bfloat16 if dt else None,
                     use_pallas=True)
    got = T.pq_topk(tl, torch.from_numpy(codes), k,
                    compute_dtype=torch.bfloat16 if dt else None)
    assert got[1].dtype == torch.int64 and got[0].shape == (NQ, k)
    lut = tl.to(torch.bfloat16).float() if dt else tl
    scores = T.adc_finemax_reference(lut, torch.from_numpy(codes), 1).numpy()
    _same_topk(got, want, scores, ATOL[dt])


def test_pq_topk_pads_past_the_corpus(data):
    db, q = data
    cb = _codebooks(np.random.default_rng(5), 8, 16)
    codes = T.encode_pq(db[:30], torch.from_numpy(cb))
    padded, n = T.pq_pad_codes(codes)
    jp, jn = J.pq_pad_codes(np.asarray(codes))
    assert n == jn == 30 and torch.equal(padded, torch.from_numpy(np.asarray(jp)))
    tl = T.pq_lookup(q, torch.from_numpy(cb))
    vals, idxs = T.pq_topk(tl, padded, 40, n_valid=n)
    jv, ji = J.pq_topk(J.pq_lookup(q, jnp.asarray(cb)), jp, 40, n_valid=jn)
    np.testing.assert_array_equal(idxs.numpy() < 0, np.asarray(ji) < 0)
    assert (idxs[:, 30:] == -1).all() and torch.isinf(vals[:, 30:]).all()
    np.testing.assert_allclose(vals[:, :30].numpy(), np.asarray(jv)[:, :30], atol=1e-5)
    np.testing.assert_allclose(T.pq_scores(tl, codes).numpy(),
                               np.asarray(J.pq_scores(J.pq_lookup(q, jnp.asarray(cb)),
                                                      np.asarray(codes))), atol=1e-5)


def test_descend_maxima_matches_dirjax():
    """The x16 pyramid with gathers selects exactly what dirjax's one-hot
    dots select, over a width that builds two levels and -inf blocks."""
    rng = np.random.default_rng(6)
    fmax = rng.normal(size=(3, 70001)).astype(np.float32)
    fmax[:, 5:900:7] = -np.inf
    fmax[1, :] = np.round(fmax[1, :], 1)         # many exact ties
    for k in (1, 10, 64):
        ti, tv = T._descend_maxima(torch.from_numpy(fmax), k)
        ji, jv = J._descend_maxima(jnp.asarray(fmax), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [1, 8, 64])
def test_plain_versions_agree(block, dt):
    """adc_finemax_reference is the dense scores' block maxima; the rescore's
    block maxima equal it bit for bit; outside ids give NaN, rows past n
    -inf."""
    rng = np.random.default_rng(block)
    n, m, ksub = 1001, 8, 16
    luts = torch.from_numpy(rng.normal(size=(4, m, ksub)).astype(np.float32)).to(dt)
    codes = torch.from_numpy(rng.integers(0, ksub, size=(n, m)).astype(np.uint8))
    fmax = T.adc_finemax(luts, codes, block)
    nb = -(-n // block)
    dense = T._adc_rows(luts.float(), codes.long())
    want = torch.nn.functional.pad(dense, (0, nb * block - n), value=float("-inf"))
    assert torch.equal(fmax, want.reshape(4, nb, block).amax(2))
    bids = torch.from_numpy(rng.integers(0, nb, size=(4, 9)))
    bids[:, 0] = nb - 1                        # the ragged last block
    raw = T.adc_gather_scores(luts, codes, bids, block)
    assert torch.equal(raw.reshape(4, -1, block).amax(2), torch.gather(fmax, 1, bids))
    bad = T.adc_gather_scores(luts, codes, torch.tensor([[0, nb, -1]] * 4), block)
    assert torch.isnan(bad[:, block:]).all() and not torch.isnan(bad[:, :block]).any()


_K6_LUT_BYTES = 232448 - 2 * 1024 * 16 - 64 * 32 * 4   # csrc/pq.cu kLutBytes


def _k6_stride(j, ksub, esz):
    """csrc/pq.cu k6_stride: 4-byte words from one query's staged tables to
    the next, for j subspaces of esz-byte entries."""
    return ((j * ksub * esz + 3) // 4 + 31) // 32 * 32 + 1


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,ksub", [(8, 16), (32, 16), (32, 256), (128, 256), (7, 3)])
def test_k6_staged_tables_model(m, ksub, dt):
    """A model of K6's staged tables (csrc/pq.cu launch_adc_finemax): 32
    queries' tables, query q's run `stride` words after query q - 1's,
    either resident (all m subspaces, widened to fp32) or streamed `step`
    subspaces at a time as stored (2 fp32 or 4 bf16 at ksub 256). Read
    back at the kernel's offsets they are the (nq, m, ksub) tables, the runs
    never overlap, and the 32 lanes' lookups of one (subspace, code) fall in
    32 different banks."""
    rng = np.random.default_rng(m * ksub)
    luts = torch.from_numpy(rng.normal(size=(32, m, ksub)).astype(np.float32)).to(dt)
    resident = 32 * 4 * _k6_stride(m, ksub, 4) <= _K6_LUT_BYTES
    if resident:
        esz, step, words = 4, m, luts.float().contiguous().view(torch.int32).reshape(32, -1)
    else:   # two buffers of `step` subspaces, a power of two up to 16
        esz, step = luts.element_size(), 1
        while step < 16 and 2 * 32 * 4 * _k6_stride(2 * step, ksub, esz) <= _K6_LUT_BYTES:
            step *= 2
        words = None
    assert (m, ksub) != (32, 16) or resident
    assert (m, ksub) != (32, 256) or step == 8 // esz
    stride = _k6_stride(step, ksub, esz)
    for j0 in range(0, m, step):
        cn = min(step, m - j0)
        assert stride % 32 == 1 and 4 * stride >= cn * ksub * esz
        buf = np.zeros(32 * stride * 4, np.uint8)   # the staged bytes
        for q in range(32):
            run = (luts[q].float() if resident else luts[q])[j0:j0 + cn].contiguous()
            raw = run.view(torch.uint8).numpy().ravel() if words is None else \
                words[q].view(torch.uint8).numpy()[j0 * ksub * 4:(j0 + cn) * ksub * 4]
            buf[4 * q * stride:4 * q * stride + raw.size] = raw
        for jj in range(cn):
            for c in range(ksub):
                at = [4 * q * stride + (jj * ksub + c) * esz for q in range(32)]
                assert len({a // 4 % 32 for a in at}) == 32
                got = np.array([buf[a:a + esz] for a in at]).view(
                    np.float32 if esz == 4 else np.uint16).ravel()
                want = luts[:, j0 + jj, c].float() if esz == 4 else \
                    luts[:, j0 + jj, c].contiguous().view(torch.int16)
                np.testing.assert_array_equal(got, want.numpy().view(got.dtype))


def _rescore_geometry(nq, m, ksub, block, kf, sms=132):
    """csrc/pq.cu launch_rescore: (jg, cpq, upc, warps) -- subspaces staged
    at once, CTAs a query, candidate blocks a CTA, warps a CTA."""
    table = 4 * m * ksub
    jg = m if table <= 96 * 1024 else 96 * 1024 // (4 * ksub) // 32 * 32
    cpq = max(1, min(-(-8 * sms // nq), kf * block * m // table, kf))
    upc = min(-(-kf // cpq), 4096)
    return jg, -(-kf // upc), upc, min(-(-upc * block // 32), 8)


def _rescore_model(luts, codes, bids, block, vec):
    """A model of the rescore kernel (csrc/pq.cu adc_rescore_kernel): CTAs
    of (query, upc candidate blocks), warps walking 32 candidate rows a step
    (one a lane), each row's codes loaded 32 bytes a chunk as
    `vec`-byte little-endian words and read back byte by byte, one fp32
    accumulator a row adding the tables j = 0, 1, ... in order; tables over
    96 KB staged `jg` subspaces at a time with the partial sums kept in the
    output between groups. Returns the output and how often each entry was
    written by its last group."""
    nq, m, ksub = luts.shape
    kf, n = bids.shape[1], codes.shape[0]
    nb = -(-n // block)
    jg, cpq, upc, warps = _rescore_geometry(nq, m, ksub, block, kf)
    lf = luts.float()
    raw = codes.numpy()
    out = torch.full((nq, kf * block), 7.0)      # a sentinel no path writes
    writes = torch.zeros((nq, kf * block), dtype=torch.int32)
    lane = torch.arange(32)
    for q in range(nq):
        for p in range(cpq):
            u0 = p * upc
            units = min(upc, kf - u0)
            rows = units * block
            b = bids[q, u0:u0 + units]
            base = torch.where((b >= 0) & (b < nb), b * block, -1)
            o = out[q, u0 * block:u0 * block + rows]
            wr = writes[q, u0 * block:u0 * block + rows]
            for j0 in range(0, m, jg):
                jn = min(jg, m - j0)
                for w in range(warps):
                    for step in range(w, -(-rows // 32), warps):
                        f = step * 32 + lane
                        f = f[f < rows]
                        u = f // block
                        row = base[u] + f - u * block
                        live = (base[u] >= 0) & (row < n)
                        fl, rl = f[live], row[live]
                        acc = torch.zeros(len(fl)) if j0 == 0 else o[fl].clone()
                        for c in range(0, jn, 32):
                            ln = min(32, jn - c)
                            chunk = np.zeros((len(fl), 32), np.uint8)
                            for v in range(0, ln, vec):   # vec-byte loads, aligned
                                at = rl.numpy() * m + j0 + c + v
                                assert (at % vec == 0).all()
                                chunk[:, v:v + vec] = raw.reshape(-1)[at[:, None] + np.arange(vec)]
                            words = torch.from_numpy(chunk.view("<u4").astype(np.int64))
                            for t in range(ln):
                                code = (words[:, t // 4] >> (8 * (t % 4))) & 0xFF
                                acc = acc + lf[q, j0 + c + t, code]
                        o[fl] = acc
                        if j0 + jn == m:
                            wr[f] += 1
                            past = ~live & (base[u] >= 0)
                            o[f[past]] = float("-inf")
                            o[f[base[u] < 0]] = float("nan")
    return out, writes


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,ksub,vec", [(8, 16, 8), (32, 16, 16), (64, 256, 16),
                                        (128, 256, 16), (12, 16, 4), (7, 256, 1)])
@pytest.mark.parametrize("block,kf", [(1, 300), (8, 7), (64, 1), (64, 30), (100, 3)])
def test_rescore_layout_model(dt, m, ksub, vec, block, kf):
    """The rescore's unit-to-warp mapping and its vector-load layout, modelled
    on the CPU, reproduce adc_gather_scores_reference bit for bit (the same
    fp32 adds in the same order), write every output once, and score within
    1e-5 of dirjax's phase C (the one-hot contraction of the candidate codes
    against the tables). m = 128 at ksub 256 stages its tables in two groups."""
    rng = np.random.default_rng(m * block + kf)
    nq, n = 3, 1601                                   # ragged: 1601 % block != 0
    # tables of the scale a unit query's give (scores of order 1, as the
    # 1e-5 of this file's docstring assumes)
    luts = torch.from_numpy((rng.normal(size=(nq, m, ksub)) / np.sqrt(m))
                            .astype(np.float32)).to(dt)
    codes = torch.from_numpy(rng.integers(0, ksub, size=(n, m)).astype(np.uint8))
    nb = -(-n // block)
    bids = torch.from_numpy(rng.integers(0, nb, size=(nq, kf)))
    bids[0, 0] = nb - 1                               # the ragged last block
    if kf > 2:
        bids[1, 1], bids[2, 2] = -1, nb               # invalid ids: NaN
    got, writes = _rescore_model(luts, codes, bids, block, vec)
    assert (writes == 1).all()
    want = T.adc_gather_scores_reference(luts, codes, bids, block)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
    live = torch.isfinite(want)
    rows = (bids.clamp(0, nb - 1)[:, :, None] * block + torch.arange(block)).reshape(nq, -1)
    for q in range(nq):
        cand = codes[rows[q].clamp(max=n - 1)].numpy()
        ref = np.asarray(J._onehot_scores(jnp.asarray(luts[q:q + 1].float().numpy()),
                                          jnp.asarray(cand)))[0]
        np.testing.assert_allclose(got[q][live[q]].numpy(), ref[live[q].numpy()],
                                   rtol=0, atol=1e-5)


def test_opq_rotation_orthogonal_and_no_worse():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(800, 32)) * np.exp(-np.arange(32) / 6.0)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r, cb = T.train_opq(x, m=4, ksub=16, iters=8, opq_iters=3)
    np.testing.assert_allclose((r @ r.T).numpy(), np.eye(32), atol=1e-5)
    xt = torch.from_numpy(x)

    def err(xs, books):
        return float(((xs - T.reconstruct_pq(T.encode_pq(xs, books), books)) ** 2).sum(1).mean())

    jr, jcb = J.train_opq(x, m=4, ksub=16, iters=8, opq_iters=3)
    want = float(jnp.mean(jnp.sum((x @ np.asarray(jr) - J.reconstruct_pq(
        J.encode_pq(x @ np.asarray(jr), jcb), jcb)) ** 2, 1)))
    # different random draws: the error of either spreads ~10% across seeds
    assert err(xt @ r, cb) <= 1.15 * want
    assert err(xt @ r, cb) <= err(xt, T.train_pq(x, 4, 16, iters=8))


def test_kernel_wrappers_refuse_other_devices():
    luts = torch.empty(2, 4, 16, device="meta")
    codes = torch.empty(300, 4, dtype=torch.uint8, device="meta")
    bids = torch.zeros((2, 3), dtype=torch.int64, device="meta")
    for call in (lambda: T.adc_finemax(luts, codes, 64),
                 lambda: T.adc_gather_scores(luts, codes, bids, 64)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()
    with pytest.raises(ValueError, match="compute_dtype"):
        T.pq_topk(torch.zeros(1, 4, 16), torch.zeros(5, 4, dtype=torch.uint8), 1,
                  compute_dtype=torch.float16)


# --- PQIndex ----------------------------------------------------------------

IDX_N = 3000
AQE = {"k": 5, "alpha": 3.0}


@pytest.fixture(scope="module")
def indexes(data):
    """dirjax's and the port's PQIndex (m=8, ksub=16, int8 rerank rows) over
    the same rows, with dirjax's codebooks."""
    db = data[0][:IDX_N]
    keys = [f"img{i:05d}" for i in range(IDX_N)]
    j = JS.PQIndex(db, m=8, ksub=16, keys=keys, rerank=True, train_iters=8)
    return db, keys, j, pq_from_jax(j.codebooks)


def _pair(indexes, rerank=True, opq=False):
    db, keys, j, trained = indexes
    if opq:
        r, cb = J.train_opq(db, 8, 16, iters=4, opq_iters=2)
        jidx = JS.PQIndex(db, keys=keys, rerank=rerank, _trained=(r, cb))
        trained = pq_from_jax(cb, r)
    else:
        jidx = JS.PQIndex(db, keys=keys, rerank=rerank, _trained=(None, j.codebooks))
    tidx = TS.PQIndex(db, keys=keys, rerank=rerank, device="cpu", _trained=trained)
    np.testing.assert_array_equal(tidx._codes.numpy(), np.asarray(jidx._codes[:IDX_N]))
    return jidx, tidx


def _adc_scores(tidx, q):
    qr = tidx._rotate_queries(torch.from_numpy(q))
    luts = T._round_luts(T.pq_lookup(qr, tidx.codebooks), tidx.compute_dtype)
    return T.adc_finemax_reference(luts, tidx._codes, 1).numpy()


def _exact_scores(tidx, q):
    rows = tidx._rerank_db.float() * tidx._rerank_scales.reshape(-1, 1)
    return (torch.from_numpy(q) @ rows.T).numpy()


@pytest.mark.parametrize("rerank,opq", [(False, False), (True, False), (True, True)],
                         ids=["adc", "rerank", "opq-rerank"])
def test_pq_index_search_matches_dirjax(data, indexes, rerank, opq):
    jidx, tidx = _pair(indexes, rerank, opq)
    q = data[1]
    score = _exact_scores if rerank else _adc_scores
    for k in (1, 10, 50):
        got, want = tidx.search(q, k=k), jidx.search(q, k=k)
        assert got[1].dtype == np.int32
        _same_topk(got, want, score(tidx, q), ATOL[None])
    tidx.compute_dtype, jidx.compute_dtype = torch.bfloat16, jnp.bfloat16
    try:
        _same_topk(tidx.search(q, k=10), jidx.search(q, k=10), score(tidx, q), ATOL["bf16"])
    finally:
        tidx.compute_dtype, jidx.compute_dtype = None, None


def test_pq_index_aqe_matches_dirjax(data, indexes):
    jidx, tidx = _pair(indexes, rerank=False)
    q = data[1]
    expanded = tidx._expand_queries(tidx._queries(q), AQE["k"], AQE["alpha"])
    _same_topk(tidx.search(q, k=10, aqe=AQE), jidx.search(q, k=10, aqe=AQE),
               _adc_scores(tidx, expanded.numpy()), 1e-5)


def test_pq_index_remove_add_compact_match_dirjax(data, indexes):
    jidx, tidx = _pair(indexes, rerank=True)
    db, keys = indexes[0], indexes[1]
    q = data[1]
    _, hits = tidx.search(q, k=10)
    gone = np.unique(hits[:, :3])
    assert jidx.remove(indices=gone) == tidx.remove(indices=gone) == len(gone)
    got = tidx.search(q, k=10, aqe=AQE)
    expanded = tidx._expand_queries(tidx._queries(q), AQE["k"], AQE["alpha"])
    _same_topk(got, jidx.search(q, k=10, aqe=AQE), _exact_scores(tidx, expanded.numpy()),
               1e-5)
    assert not np.isin(got[1], gone).any()
    extra = _unit(np.random.default_rng(8), 40)
    new_keys = [f"new{i}" for i in range(40)]
    jidx.add(extra, keys=new_keys)
    tidx.add(extra, keys=new_keys)
    assert tidx.n == jidx.n == IDX_N + 40
    np.testing.assert_array_equal(tidx._codes.numpy(), np.asarray(jidx._codes[:jidx.n]))
    drop = keys[5:60:3] + new_keys[::7]
    assert jidx.remove(keys=drop) == tidx.remove(keys=drop)
    mapping = tidx.compact()
    np.testing.assert_array_equal(mapping, jidx.compact())
    assert tidx.n_removed == 0 and tidx.n == jidx.n
    q2 = np.concatenate([q, extra[:2]])
    got, want = tidx.search(q2, k=20), jidx.search(q2, k=20)
    _same_topk(got, want, _exact_scores(tidx, q2), 1e-5)
    assert tidx.lookup(got[1][:, :1]) == jidx.lookup(want[1][:, :1])


def test_pq_files_cross_between_packages(data, indexes, tmp_path):
    """A PQ index saved by either package loads in the other (through
    RetrievalIndex.load, tombstones and the OPQ rotation included)."""
    jidx, tidx = _pair(indexes, rerank=True, opq=True)
    for idx in (jidx, tidx):
        idx.remove(keys=indexes[1][:30])
    jidx.save(str(tmp_path / "j.npz"))
    tidx.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as jf, np.load(tmp_path / "t.npz") as tf:
        assert sorted(jf.files) == sorted(tf.files)
        for name in jf.files:
            np.testing.assert_array_equal(jf[name], tf[name])
    t_from_j = TS.RetrievalIndex.load(str(tmp_path / "j.npz"), device="cpu")
    j_from_t = JS.RetrievalIndex.load(str(tmp_path / "t.npz"))
    assert isinstance(t_from_j, TS.PQIndex) and isinstance(j_from_t, JS.PQIndex)
    assert t_from_j.n_removed == 30 and t_from_j.rotation is not None
    q = data[1]
    _same_topk(t_from_j.search(q, k=15), j_from_t.search(q, k=15),
               _exact_scores(t_from_j, q), 1e-5)


def test_pq_from_codes(data, indexes):
    db, keys, j, (_, cb) = indexes
    codes = T.encode_pq(db, cb)
    tidx = TS.PQIndex.from_codes(cb, codes, keys=keys, device="cpu")
    jidx = JS.PQIndex.from_codes(np.asarray(j.codebooks), np.asarray(codes), keys=keys)
    q = data[1]
    _same_topk(tidx.search(q, k=10), jidx.search(q, k=10), _adc_scores(tidx, q), 1e-5)
    with pytest.raises(ValueError, match="codes must be"):
        TS.PQIndex.from_codes(cb, codes[:, :4], device="cpu")


def test_pq_cli_matches_dirjax(data, indexes, tmp_path):
    """``build --pq 8 --pq-rerank`` through the port's CLI answers its own
    file as the in-process index does; dirjax's file, queried by both CLIs
    (the port's as ``python -m dirjax_torch.index --gpu -1``), gives the
    same JSON answer."""
    db, q = indexes[0], data[1]
    np.save(tmp_path / "db.npy", db)
    np.save(tmp_path / "q.npy", q)
    cpu = ["--gpu", "-1"]
    build = ["build", "--descs", str(tmp_path / "db.npy"), "--pq", "8", "--pq-rerank"]
    jindex(build + ["--out", str(tmp_path / "j.npz")] + cpu)
    tindex(build + ["--out", str(tmp_path / "t.npz"), "--opq"] + cpu)
    query = ["query", "--descs", str(tmp_path / "q.npy"), "-k", "12"]
    out = subprocess.run(
        [sys.executable, "-m", "dirjax_torch.index", *query, "--index",
         str(tmp_path / "j.npz"), "--out-json", str(tmp_path / "t.json"), *cpu],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    jindex(query + ["--index", str(tmp_path / "j.npz"), "--out-json",
                    str(tmp_path / "j.json")] + cpu)
    got, want = (json.loads((tmp_path / f).read_text()) for f in ("t.json", "j.json"))
    from_j = TS.RetrievalIndex.load(str(tmp_path / "j.npz"), device="cpu")
    _same_topk(*((np.asarray(a["scores"], np.float32), np.asarray(a["indices"]))
                 for a in (got, want)), _exact_scores(from_j, q), 1e-5)
    query += ["--aqe", "4", "3"]
    own = tindex(query + ["--index", str(tmp_path / "t.npz"), "--adc-bf16"] + cpu)
    tidx = TS.RetrievalIndex.load(str(tmp_path / "t.npz"), device="cpu")
    assert isinstance(tidx, TS.PQIndex) and tidx.rotation is not None
    tidx.compute_dtype = torch.bfloat16
    vals, idxs = tidx.search(q, k=12, aqe={"k": 4, "alpha": 3.0})
    assert own["indices"] == idxs.tolist() and own["scores"] == vals.tolist()
    with pytest.raises(SystemExit, match="int8-queries"):
        tindex(query + ["--index", str(tmp_path / "t.npz"), "--int8-queries"] + cpu)
    with pytest.raises(SystemExit, match="conflicting storage flags"):
        tindex(build + ["--int8", "--out", str(tmp_path / "x.npz")] + cpu)
