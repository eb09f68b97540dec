"""dirjax_torch's binary hashing (ops/binary.py) held against dirjax's on the
same numpy inputs (CPU): ITQ fitting, encoding, the byte layout, and exact
top-k in symmetric and asymmetric mode. dirjax's K5 runs as its own tests run
it, through ``use_mxu=True, interpret=True``; the port takes its kernels'
route with their plain versions.

Codecs cross between the packages through ``binary_codec_from_jax``. The
search tests use a signed-permutation codec (orthonormal, and its projection
is exact in both packages), so both see the same codes and bf16 queries.
Tolerances: symmetric values and indices exactly equal (integers; both rank
ties to the lower candidate); asymmetric values within 1e-4 (the bf16 query
times ±1 products are exact, only the fp32 summation order differs) and
the index sets equal wherever the k-th/(k+1)-th margin exceeds 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dirjax.ops import binary as J
from dirjax_torch.ops import binary as T
from dirjax_torch.utils.checkpoints import binary_codec_from_jax

torch.set_num_threads(1)

ASYM_ATOL, MARGIN = 1e-4, 1e-3
# (n_bits = d, rows): a ragged n in each; 2048 runs dirjax's kernel on two
# 128-byte chunks per tile
SIZES = [(32, 901), (64, 2101), (2048, 2100)]


def _unit(rng, rows, d):
    x = rng.normal(size=(rows, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _perm_codec(rng, d):
    proj = np.zeros((d, d), np.float32)
    proj[rng.permutation(d), np.arange(d)] = rng.choice([-1.0, 1.0], d)
    mean = (rng.normal(size=d) * 0.01).astype(np.float32)
    return J.BinaryCodec(mean=jnp.asarray(mean), proj=jnp.asarray(proj))


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"bits{s[0]}")
def corpus(request):
    d, n = request.param
    rng = np.random.default_rng(d)
    db, q = _unit(rng, n, d), _unit(rng, 5, d)
    jc = _perm_codec(rng, d)
    tc = binary_codec_from_jax(jc.mean, jc.proj)
    return db, q, jc, tc, J.bytes_for_search(J.binarize(db, jc)), T.binarize(db, tc)


def _plain_scores(q, tc, codes, asym):
    qb, vq = T.binarize_and_project(q, tc)
    qf = vq.bfloat16().float() if asym else T.unpack_pm1(qb)
    return (qf @ T.unpack_pm1(codes).T).numpy()


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("nq,k", [(5, 10), (1, 1), (3, 100)])
def test_search_matches_dirjax(corpus, asym, nq, k):
    db, q, jc, tc, jbytes, tcodes = corpus
    n = len(db)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jbytes[:n]))
    jv, ji = J.hamming_search_fused(q[:nq], jc, jbytes, k, n_valid=n, asym=asym,
                                    use_mxu=True, interpret=True)
    tv, ti = T.hamming_search_fused(q[:nq], tc, tcodes, k, asym=asym)
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    assert tv.shape == ti.shape == (nq, k) and tv.dtype == np.float32
    if not asym:
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
        return
    np.testing.assert_allclose(tv, jv, rtol=0, atol=ASYM_ATOL)
    scores = _plain_scores(q[:nq], tc, tcodes, asym=True)
    np.testing.assert_allclose(np.take_along_axis(scores, ti, 1), tv, atol=ASYM_ATOL)
    for r in range(nq):
        s = np.sort(scores[r])[::-1]
        if k < n and s[k - 1] - s[k] > MARGIN:
            assert set(ti[r]) == set(ji[r])


def test_hamming_topk_on_dirjax_codes(corpus):
    """The symmetric hierarchy and the plain scan over dirjax's own packed
    uint32 codes (a fitted-style codec's bits, handed over as words)."""
    db, q, jc, _, jbytes, _ = corpus
    n = len(db)
    jq = np.asarray(J.binarize(q, jc))
    jv, ji = J.hamming_topk_mxu(jq, jbytes, 10, n_valid=n, interpret=True)
    tv, ti = T.hamming_topk_mxu(jq, np.asarray(jbytes), 10, n_valid=n)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    pv, pi = T.hamming_topk(jq, np.asarray(J.binarize(db, jc)), 10)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    want = np.asarray(J.hamming_topk(jq, np.asarray(J.binarize(db, jc)), 10)[0])
    np.testing.assert_array_equal(pv.numpy(), want)


@pytest.mark.parametrize("n_bits", [32, 64, 256])
def test_binarize_matches_dirjax(n_bits):
    """Packed codes equal dirjax's bit for bit, under a codec dirjax fitted;
    a bit may differ only where the projection is within 1e-5 of 0 (fp32
    sums in another order)."""
    rng = np.random.default_rng(n_bits)
    x = _unit(rng, 3000, 256)
    jc = J.fit_itq(x, n_bits, iters=2)
    tc = binary_codec_from_jax(jc.mean, jc.proj)
    want = np.asarray(J.binarize(x, jc))
    got = T.binarize(x, tc, chunk=700)
    assert got.dtype == torch.uint8 and got.shape == (3000, n_bits // 8)
    differ = np.unpackbits((got.numpy().view(np.uint32) ^ want).view(np.uint8),
                           axis=1, bitorder="little").astype(bool)
    proj = np.asarray(J.project_queries(x, jc))
    assert (np.abs(proj[differ]) < 1e-5).all()
    packed, v = T.binarize_and_project(x[:7], tc)
    np.testing.assert_array_equal(packed.numpy(), got[:7].numpy())
    np.testing.assert_allclose(v.numpy(), proj[:7], rtol=0, atol=1e-6)


def test_layout_helpers_match_dirjax():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, size=(37, 3), dtype=np.uint64).astype(np.uint32)
    tb = T._to_bytes(words)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(J._to_bytes(jnp.asarray(words))))
    assert torch.equal(T._to_bytes(torch.from_numpy(words.view(np.int32))), tb)
    np.testing.assert_array_equal(T.unpack_pm1(tb).numpy(),
                                  np.asarray(J.unpack_pm1(jnp.asarray(words))))
    np.testing.assert_array_equal(T.bytes_for_search(words, tile_rows=128).numpy(),
                                  np.asarray(J.bytes_for_search(words, tile_rows=128)))
    assert tb.numpy().view(np.uint32).tolist() == words.tolist()   # round trip


def _spectrum(rng, n=4000, d=64):
    """Rows whose covariance has well-separated eigenvalues."""
    basis, _ = np.linalg.qr(rng.normal(size=(d, d)))
    scales = np.linspace(3.0, 0.2, d)
    return ((rng.normal(size=(n, d)) * scales) @ basis.T).astype(np.float32)


def test_fit_itq_pca_matches_dirjax():
    """iters=0: each PCA column agrees with dirjax's up to its sign, and the
    sample rows are dirjax's."""
    x = _spectrum(np.random.default_rng(2))
    jc = J.fit_itq(x, 32, iters=0, sample=3000, seed=4)
    tc = T.fit_itq(x, 32, iters=0, sample=3000, seed=4)
    np.testing.assert_allclose(tc.mean.numpy(), np.asarray(jc.mean), atol=1e-6)
    cos = np.abs(np.sum(tc.proj.numpy() * np.asarray(jc.proj), axis=0))
    assert cos.min() > 0.9999


def _quant_loss(x, codec_mean, codec_proj):
    v = (x - np.asarray(codec_mean)) @ np.asarray(codec_proj)
    return float(np.linalg.norm(np.where(v >= 0, 1.0, -1.0) - v))


def test_fit_itq_rotation_matches_dirjax_quality():
    """iters > 0: the rotations differ (torch's and jax's generators), but
    the port's codec is orthonormal and quantizes as well as dirjax's."""
    x = _spectrum(np.random.default_rng(3))
    jc = J.fit_itq(x, 64, iters=20)
    tc = T.fit_itq(x, 64, iters=20)
    p = tc.proj.numpy()
    np.testing.assert_allclose(p.T @ p, np.eye(64), atol=1e-4)
    want = _quant_loss(x, jc.mean, jc.proj)
    assert abs(_quant_loss(x, tc.mean, tc.proj) - want) <= 0.02 * want
    with pytest.raises(ValueError, match="multiple of 32"):
        T.fit_itq(x, 48)


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_plain_versions_agree(asym):
    """bits_finemax_reference equals the dense maxima; the rescore's block
    maxima equal bits_finemax_reference's; blocks outside give NaN."""
    rng = np.random.default_rng(5)
    n, d = 1001, 96
    codes = T.binarize(_unit(rng, n, d), binary_codec_from_jax(
        np.zeros(d, np.float32), np.linalg.qr(rng.normal(size=(d, d)))[0]))
    qb, vq = T.binarize_and_project(_unit(rng, 4, d), binary_codec_from_jax(
        np.zeros(d, np.float32), np.eye(d, dtype=np.float32)))
    q = vq.bfloat16() if asym else qb
    blocks = 2 * 128
    fmax = T.bits_finemax(q, codes, blocks)
    dense = torch.nn.functional.pad(
        T._query_operand(q) @ T.unpack_pm1(codes).T, (0, blocks * 8 - n),
        value=float("-inf")).reshape(4, blocks, 8).amax(2)
    assert torch.equal(fmax, dense) and torch.isinf(fmax[:, -(-n // 8):]).all()
    if asym:
        bids = torch.from_numpy(rng.integers(0, n // 8, size=(4, 24)))
        raw = T.bits_gather_scores(q, codes, bids)
        assert torch.equal(raw.reshape(4, -1, 8).amax(2), torch.gather(fmax, 1, bids))
        bad = T.bits_gather_scores(q, codes, torch.tensor([[0, n // 8, -1]] * 4))
        assert torch.isnan(bad[:, 8:]).all() and not torch.isnan(bad[:, :8]).any()


def test_kernel_wrappers_refuse_other_devices():
    q = torch.empty(2, 8, dtype=torch.uint8, device="meta")
    db = torch.empty(300, 8, dtype=torch.uint8, device="meta")
    for call in (lambda: T.bits_finemax(q, db),
                 lambda: T.bits_gather_scores(q, db, torch.zeros((2, 16), dtype=torch.int64,
                                                                 device="meta"))):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()
    with pytest.raises(ValueError, match="exceeds"):
        T.hamming_search_fused(np.zeros((1, 64), np.float32),
                               binary_codec_from_jax(np.zeros(64), np.eye(64)),
                               torch.zeros((10, 8), dtype=torch.uint8), 11)


@pytest.mark.parametrize("n_bits", [32, 64, 256, 2048])
def test_int8_query_operand_matches_unpack(n_bits):
    """K5's symmetric query operand, the packed codes unpacked to int8 ±1 by
    its wrapper, equals dirjax's unpack_pm1 on the same seeded codes, from
    uint8 bytes and from uint32 words alike."""
    rng = np.random.default_rng(n_bits)
    words = rng.integers(0, 2 ** 32, size=(9, n_bits // 32), dtype=np.uint64).astype(np.uint32)
    got = T.unpack_pm1(T._to_bytes(words)).to(torch.int8)
    assert got.shape == (9, n_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.unpack_pm1(jnp.asarray(words))))
    assert torch.equal(T.unpack_pm1(words).to(torch.int8), got)


def test_int8_operand_dot_is_the_symmetric_score():
    """The integer dot of two codes unpacked to int8 ±1 (what K5's s8 tensor
    cores sum) is n_bits - 2 * hamming."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, size=(5, 32), dtype=np.uint8)
    b = rng.integers(0, 256, size=(7, 32), dtype=np.uint8)
    qa, qb = (T.unpack_pm1(torch.from_numpy(x)).to(torch.int8).long() for x in (a, b))
    dot = (qa[:, None, :] * qb[None, :, :]).sum(-1)
    hamming = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1, dtype=np.int64)
    np.testing.assert_array_equal(dot.numpy(), 256 - 2 * hamming)


def _pm1_bf16x2(x):
    """csrc/tc_score.cuh pm1_bf16x2: bits 0, 1 of x -> a bf16 pair of ±1."""
    return 0xBF80BF80 ^ ((((x & 3) * 0x40008000) & 0xFFFFFFFF) & 0x80008000)


def _pm1_i8x4(x):
    """csrc/tc_score.cuh pm1_i8x4: bits 0-3 of x -> four int8 ±1."""
    return 0xFFFFFFFF ^ (((((x & 15) * 0x00204081) & 0x01010101) * 0xFE) & 0xFFFFFFFF)


def test_kernel_unpack_model():
    """A model of how K5 unpacks a row's 16 bytes of a stage (128 d) into
    its wgmma A fragments (csrc/tc_score.cuh mma_issue, modes 4 and 5): the
    bf16 pairs of each k16 step and the int8 quads of each k32 step that the
    four threads of a quad build, read at the k each holds in the fragment,
    give the row's ±1 dimensions in order."""
    row = np.random.default_rng(7).integers(0, 256, size=16, dtype=np.uint8)
    want = T.unpack_pm1(torch.from_numpy(row)).numpy()
    words = [int(w) for w in row.view("<u4")]
    bf16, i8 = np.zeros(128), np.zeros(128)
    for t in range(4):
        for j in range(8):   # k16 step j: k 2t, 2t + 1 and 2t + 8, 2t + 9
            x = words[j >> 1] >> (16 * (j & 1) + 2 * t)
            for reg, k in ((_pm1_bf16x2(x), 2 * t), (_pm1_bf16x2(x >> 8), 2 * t + 8)):
                for h in range(2):
                    top = np.array([(reg >> (16 * h) & 0xFFFF) << 16], np.uint32)
                    bf16[16 * j + k + h] = top.view(np.float32)[0]
        for j in range(4):   # k32 step j: k 4t .. 4t + 3 and 4t + 16 .. 4t + 19
            x = words[j] >> (4 * t)
            for reg, k in ((_pm1_i8x4(x), 4 * t), (_pm1_i8x4(x >> 16), 4 * t + 16)):
                for h in range(4):
                    i8[32 * j + k + h] = np.array([reg >> (8 * h) & 0xFF], np.uint8).view(np.int8)[0]
    np.testing.assert_array_equal(bf16, want)
    np.testing.assert_array_equal(i8, want)


@pytest.mark.parametrize("stage_d", [128, 512])
def test_asym_stage_sums_model(stage_d):
    """K5's asymmetric mode sums the exact ±bf16 products of each stage
    (128 d, or 512 d for a small query group) from 0 and folds each such sum
    into the score with one rounded fp32 add. Modelled with each stage's sum
    rounded once to fp32: on projected unit queries at 2048 bits the folded
    scores stay within 4e-6 of the exact ones (at most 16 folds of half an
    ulp of scores below 8), inside the kernel's 1e-5."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(_unit(rng, 16, 2048)).bfloat16().double().numpy()
    c = rng.choice([-1.0, 1.0], size=(64, 2048))
    exact = q @ c.T
    n = 2048 // stage_d
    stages = np.einsum("qsd,rsd->qrs", q.reshape(16, n, stage_d),
                       c.reshape(64, n, stage_d)).astype(np.float32)
    score = np.zeros((16, 64), np.float32)
    for s in range(n):
        score = score + stages[:, :, s]
    assert np.abs(score - exact).max() <= 4e-6
    assert np.abs(exact).max() < 8.0
