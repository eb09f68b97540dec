"""dirjax_torch.ops.topk held against dirjax.ops.topk_pallas on the same numpy
inputs (CPU).

The Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py
runs them; the port runs its kernels' plain versions, which are what a CPU
tensor gets. Tolerances, as tests/test_pallas_kernels.py holds the TPU
kernels to their oracles:
- fp32, bf16 and int8 x bf16 scores: rtol 1e-5 / atol 1e-5 (fp32 sums of
  exact products, taken in another order by XLA and ATen);
- int8 x int8 scores: exactly equal (exact integer sums on both sides);
- indices, fine-block ids and candidate masks: identical (the inputs are
  random, so no two scores tie);
- quantize_db: bit-identical codes and scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dirjax.ops import topk_pallas as J
from dirjax_torch.ops import topk as T

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
D = 128
TILE = 512
MODES = ("fp32", "bf16", "int8", "int8x8")


def _unit(rng, rows, d=D):
    x = rng.normal(size=(rows, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _close(got, want, exact=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _operands(mode, q, db):
    """Kernel operands of one mode in both packages:
    (jax q, jax db, jax scales, torch q, torch db, torch scales)."""
    if mode in ("fp32", "bf16"):
        jdt, tdt = (jnp.float32, torch.float32) if mode == "fp32" \
            else (jnp.bfloat16, torch.bfloat16)
        return (jnp.asarray(q, jdt), jnp.asarray(db, jdt), None,
                torch.from_numpy(q).to(tdt), torch.from_numpy(db).to(tdt), None)
    jdb, js = J.quantize_db(jnp.asarray(db))
    tdb, ts = T.quantize_db(torch.from_numpy(db))
    if mode == "int8":
        jq, tq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    else:
        jq, _ = J._quantize_block(jnp.asarray(q))
        tq, _ = T._quantize_block(torch.from_numpy(q))
    return jq, jdb, js, tq, tdb, ts


@pytest.fixture(scope="module")
def hier():
    """Per mode: the Pallas phase 1, selection and gather on one ragged
    database (nq = 37, n = 3001, tile 512), and the port's operands."""
    rng = np.random.default_rng(7)
    q, db = _unit(rng, 37), _unit(rng, 3001)
    out = {}
    for mode in MODES:
        jq, jdb, js, tq, tdb, ts = _operands(mode, q, db)
        fmax = J._finemax_phase1(jq, jdb, db.shape[0], TILE, js)
        bids, vmask = J._hier_select(fmax, 100, TILE, db.shape[0])
        raw = J._gather_scores(jq, jdb, bids, interpret=True)
        out[mode] = dict(fmax=np.asarray(fmax), bids=np.array(bids),
                         vmask=np.asarray(vmask), raw=np.asarray(raw),
                         tq=tq, tdb=tdb, ts=ts)
    return out


@pytest.mark.parametrize("n,block_rows", [(3001, 65536), (3001, 1000)])
def test_quantize_db_bit_identical(rng, n, block_rows):
    db = _unit(rng, n) * rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)
    jdb, js = J.quantize_db(jnp.asarray(db), block_rows=block_rows)
    tdb, ts = T.quantize_db(torch.from_numpy(db), block_rows=block_rows)
    assert tdb.dtype == torch.int8 and ts.shape == (1, n)
    _close(tdb, jdb, exact=True)
    _close(ts, js, exact=True)


@pytest.mark.parametrize("mode,nq,n,k", [("fp32", 5, 3001, 7), ("bf16", 37, 1500, 16),
                                         ("fp32", 1, 600, 1)])
def test_fused_topk_plain_matches_pallas(rng, mode, nq, n, k):
    """K2's plain version, merged over slabs, against _fused in interpret
    mode (its own top-k over tiles included)."""
    jq, jdb, _, tq, tdb, _ = _operands(mode, _unit(rng, nq), _unit(rng, n))
    jv, ji = J._fused(jq, jdb, k, TILE, True)
    before = dict(T.launches)
    vals, idxs = T.fused_topk(tq, tdb, k)
    assert vals.shape == idxs.shape == (nq, -(-n // 512) * k)
    merged, pos = T._topk(vals, k)
    _close(merged, jv)
    _close(torch.gather(idxs, 1, pos), ji, exact=True)
    assert T.launches == before      # a CPU tensor launches no kernel


@pytest.mark.parametrize("mode", MODES)
def test_finemax_plain_matches_pallas(hier, mode):
    """K3's plain version writes the query-major transpose of the Pallas
    (blocks, nq) maxima; blocks past the rows are -inf."""
    h = hier[mode]
    got = T.finemax(h["tq"], h["tdb"], h["ts"], blocks=h["fmax"].shape[0])
    assert got.shape == h["fmax"].T.shape
    _close(got, h["fmax"].T, exact=mode == "int8x8")


@pytest.mark.parametrize("mode", MODES)
def test_hier_select_same_blocks(hier, mode):
    h = hier[mode]
    bids, vmask = T._hier_select(torch.from_numpy(h["fmax"].T.copy()), 100, TILE, 3001)
    _close(bids, h["bids"], exact=True)
    _close(vmask, h["vmask"], exact=True)


@pytest.mark.parametrize("mode", MODES)
def test_gather_scores_plain_matches_pallas(hier, mode):
    h = hier[mode]
    got = T.gather_scores(h["tq"], h["tdb"], torch.from_numpy(h["bids"]).long())
    _close(got, h["raw"], exact=mode == "int8x8")


# (mode, k, nq, n): every mode, k in {1, 7, 16, 17, 100}, ragged n and
# nq in {1, 3, 8, 37}; n = 300 < TILE puts a quantized database on the
# dense route
RANK_CASES = [
    ("fp32", 1, 3, 2999), ("fp32", 16, 37, 3001), ("fp32", 17, 8, 3001),
    ("bf16", 7, 1, 2051), ("bf16", 100, 37, 3001), ("bf16", 16, 8, 700),
    ("int8", 17, 3, 3001), ("int8", 100, 8, 2999), ("int8", 7, 1, 3001),
    ("int8x8", 100, 37, 3001), ("int8x8", 1, 8, 2051), ("int8", 10, 3, 300),
    ("int8x8", 5, 3, 300),
]


@pytest.mark.parametrize("mode,k,nq,n", RANK_CASES)
def test_rank_topk_fused_matches_dirjax(rng, mode, k, nq, n):
    q, db = _unit(rng, nq), _unit(rng, n)
    _, jdb, js, _, tdb, ts = _operands(mode, q, db)
    opts = dict(tile_rows=TILE, quantize_queries=mode == "int8x8")
    jv, ji = J.rank_topk_fused(jnp.asarray(q), jdb, k, use_pallas=True,
                               db_scales=js, **opts)
    tv, ti = T.rank_topk_fused(torch.from_numpy(q), tdb, k, db_scales=ts, **opts)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64
    _close(tv, jv)
    _close(ti, ji, exact=True)


def test_rank_topk_fused_default_tile_and_errors(rng):
    q, db = torch.from_numpy(_unit(rng, 4)), torch.from_numpy(_unit(rng, 2500))
    want = torch.topk(q @ db.T, 30, dim=1)
    vals, idxs = T.rank_topk_fused(q, db, 30)     # tile_rows 1024: hierarchy
    _close(vals, want.values)
    _close(idxs, want.indices, exact=True)
    with pytest.raises(ValueError, match="exceeds"):
        T.rank_topk_fused(q, db, 2501)
    with pytest.raises(ValueError, match="multiple of 128"):
        T.rank_topk_fused(q, db, 5, tile_rows=1000)
    with pytest.raises(ValueError, match="db_scales"):
        T.rank_topk_fused(q, db.to(torch.int8), 5)
    with pytest.raises(ValueError, match="int8 database"):
        T.rank_topk_fused(q, db, 5, quantize_queries=True)


def _bf16_split(x: torch.Tensor):
    """The fp32 mode's split of csrc/topk.cu: hi = bf16(x), lo = bf16(x - hi),
    both rounded to nearest even."""
    hi = x.bfloat16()
    return hi.float(), (x - hi.float()).bfloat16().float()


@pytest.mark.parametrize("kind", ["random", "self_match", "all_positive"])
def test_fp32_split_arithmetic(kind):
    """The fp32 mode's numeric design, modelled in plain torch at D = 2048:
    each score is hi.hi + hi.lo + lo.hi + lo.lo of the two-part bf16 splits,
    the products exact in fp32 (8-bit by 8-bit mantissas) and summed in fp32,
    the kernel's accumulator type. Within 1e-5 of fp64 (and of the
    plain fp32 version) on random unit queries, on queries equal to database
    rows (a self-match: every product >= 0, so dropping lo.lo, up to 2**-16
    of each, would add up in one direction) and on all-positive rows."""
    rng = np.random.default_rng(21)
    db = _unit(rng, 2048, 2048)
    if kind == "all_positive":
        db = np.abs(db)
    q = db[::37][:48] if kind != "random" else _unit(rng, 48, 2048)
    q, db = torch.from_numpy(np.ascontiguousarray(q)), torch.from_numpy(db)
    (qh, ql), (dh, dl) = _bf16_split(q), _bf16_split(db)
    split = qh @ dh.T
    for a, b in ((qh, dl), (ql, dh), (ql, dl)):
        split = split + a @ b.T
    exact = q.double() @ db.double().T
    assert float((split.double() - exact).abs().max()) <= 1e-5
    assert float((split - T._scores(q, db)).abs().max()) <= 1e-5
