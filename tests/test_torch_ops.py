"""dirjax_torch.ops held against dirjax.ops on the same numpy inputs (CPU).

Tolerance rtol 2e-4 / atol 2e-5, as tests/test_pallas_kernels.py holds the
Pallas head to its XLA oracle: both sides compute in fp32 but sum in
different orders (XLA vs ATen reductions, a 128..2048-term matmul), and the
pow/log/exp chain of GeM amplifies last-bit differences by about p.
Top-k indices are identical, exact ties included (lower index first, as
``lax.top_k`` ranks them).
The CUDA kernel's own tests are in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dirjax import ops as jops
from dirjax.ops import gem_head as jgem
from dirjax_torch import ops as tops
from dirjax_torch.ops import gem_head as tgem

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _head_inputs(rng, B, H, W, C, D):
    x = (rng.random((B, H, W, C)) + 0.05).astype(np.float32)
    w = (rng.normal(size=(C, D)) * 0.02).astype(np.float32)
    b = (rng.normal(size=(D,)) * 0.01).astype(np.float32)
    mask = np.zeros((B, H, W), bool)
    mask[0, :max(1, H - 3), :max(1, W - 2)] = True
    mask[1:] = True
    return x, w, b, mask


class TestPooling:
    @pytest.mark.parametrize("masked", [False, True])
    def test_gem_pool(self, rng, masked):
        x = (rng.random((3, 5, 7, 16)) + 0.01).astype(np.float32)
        mask = rng.random((3, 5, 7)) > 0.4 if masked else None
        want = jops.gem_pool(jnp.asarray(x), 2.7,
                             mask=None if mask is None else jnp.asarray(mask))
        got = tops.gem_pool(_t(x), 2.7, mask=None if mask is None else _t(mask))
        _close(got, want)

    @pytest.mark.parametrize("pooling", ["mean", "gem"])
    def test_pool_descriptors(self, rng, pooling):
        descs = rng.normal(size=(3, 10, 24)).astype(np.float32)
        want = jops.pool_descriptors([jnp.asarray(d) for d in descs], pooling, 3)
        got = tops.pool_descriptors([_t(d) for d in descs], pooling, 3)
        _close(got, want)

    def test_center_bias_mask(self):
        _close(tops.center_bias_mask(7, 5, 0.5), jops.center_bias_mask(7, 5, 0.5))


class TestGemHeadReference:
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_pallas_interpret(self, rng, masked):
        x, w, b, mask = _head_inputs(rng, 2, 9, 5, 128, 256)
        m = mask if masked else np.ones_like(mask)
        want = jgem._fused_call(jnp.asarray(x), jnp.asarray(m, jnp.float32), 2.5,
                                jnp.asarray(w), jnp.asarray(b), interpret=True)
        got = tgem.gem_head_reference(_t(x), _t(mask) if masked else None, 2.5,
                                      _t(w), _t(b))
        _close(got, want)

    @pytest.mark.parametrize("D", [256, 200])
    def test_matches_jax_reference(self, rng, D):
        # D = 200 is not a multiple of 128: the JAX package takes its XLA
        # composition there; the port's kernel takes any D
        x, w, b, mask = _head_inputs(rng, 3, 6, 4, 64, D)
        want = jgem.gem_head_reference(jnp.asarray(x), jnp.asarray(mask), 3.0,
                                       jnp.asarray(w), jnp.asarray(b))
        got = tgem.gem_head_reference(_t(x), _t(mask), 3.0, _t(w), _t(b))
        _close(got, want)

    def test_dispatcher_takes_reference_on_cpu(self, rng):
        x, w, b, mask = _head_inputs(rng, 2, 4, 3, 32, 48)
        before = tgem.launches
        got = tops.fused_gem_head(_t(x).to(torch.bfloat16), torch.tensor([3.0]),
                                  _t(w), _t(b), mask=_t(mask))
        want = tgem.gem_head_reference(_t(x).to(torch.bfloat16).float(), _t(mask),
                                       3.0, _t(w), _t(b))
        assert tgem.launches == before
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _k1_split_model(x, mask, p, w, b, splits, eps=1e-6):
    """A model of K1's pooling order (csrc/gem_head.cu gem_pool_kernel):
    ``splits`` CTAs a cluster share the H*W cells (the kernel takes the most,
    up to 8, that fit the card at once), 8 warps a split taking every 8th
    cell, a thread's cells summed in increasing order, the warps' sums in
    order 0..7, the splits' in rank order, then the mean and the 1/p root;
    the projection and the L2 as a plain composition. Returns the
    descriptors and each cell's visit count."""
    B, H, W, C = x.shape
    hw = H * W
    xf = x.float().reshape(B, hw, C)
    m = torch.ones((B, hw)) if mask is None else mask.reshape(B, hw).float()
    powed = m[:, :, None] * torch.exp(p * torch.log(xf.clamp_min(eps)))
    total, count = torch.zeros((B, C)), torch.zeros(B)
    visits = torch.zeros(hw, dtype=torch.int32)
    for s in range(splits):
        lo, hi = hw * s // splits, hw * (s + 1) // splits
        cta = torch.zeros((B, C))
        for warp in range(8):
            acc = torch.zeros((B, C))
            for i in range(lo + warp, hi, 8):
                acc = acc + powed[:, i]
                visits[i] += 1
            cta = cta + acc
        total = total + cta
        count = count + m[:, lo:hi].sum(1)
    pooled = torch.exp(torch.log(total / count.clamp_min(1.0)[:, None]) / p)
    v = pooled @ w + b
    return v / v.square().sum(1, keepdim=True).clamp_min(1e-24).sqrt(), visits


class TestGemHeadSplitModel:
    """K1's split-H*W partial sums, combined in the kernel's fixed order,
    against dirjax's gem_head_reference on the same numpy inputs."""

    @pytest.mark.parametrize("B,H,W,C,D", [(1, 1, 1, 100, 64), (9, 5, 7, 2047, 2000),
                                           (17, 3, 5, 128, 256), (2, 9, 5, 256, 128),
                                           (8, 4, 6, 100, 96)])
    @pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
    @pytest.mark.parametrize("p,splits", [(1.0, 8), (3.0, 3), (8.0, 1), (3.0, 7)])
    def test_matches_jax_reference(self, rng, B, H, W, C, D, bf16, p, splits):
        x, w, b, mask = _head_inputs(rng, B, H, W, C, D)
        if B > 2:
            mask[2] = False                             # a row with no valid cell
        xt = _t(x).to(torch.bfloat16) if bf16 else _t(x)
        splits = min(splits, H * W)                     # the kernel's cap
        got, visits = _k1_split_model(xt, _t(mask), p, _t(w), _t(b), splits)
        assert (visits == 1).all()
        want = jgem.gem_head_reference(jnp.asarray(xt.float().numpy()), jnp.asarray(mask),
                                       p, jnp.asarray(w), jnp.asarray(b))
        _close(got, want)


class TestWhitening:
    @pytest.mark.parametrize("whiten", [True, False])
    @pytest.mark.parametrize("whitenv", [None, 4])
    def test_apply_whitening(self, rng, whiten, whitenv):
        # 6 centred rows have rank 5: the 6th eigenvalue is set to exactly
        # 0, as a clipped covariance fit gives it
        pca = tops.fit_pca(rng.normal(size=(6, 12)))
        var = pca.variance.copy()
        var[-1] = 0.0
        pca = pca._replace(variance=var, whiten=whiten)
        X = rng.normal(size=(9, 12)).astype(np.float32)
        want = jops.apply_whitening(X, jops.PCAParams(*pca), whitenp=0.25,
                                    whitenv=whitenv, whitenm=1.5)
        got = tops.apply_whitening(_t(X), pca, whitenp=0.25, whitenv=whitenv,
                                   whitenm=1.5)
        assert np.isfinite(got.numpy()).all()
        _close(got, want)

    def test_zero_eigenvalue_gives_zero_column(self, rng):
        pca = tops.PCAParams(mean=np.zeros(4, np.float32),
                             components=np.eye(4, dtype=np.float32),
                             variance=np.array([2.0, 1.0, 0.5, 0.0], np.float32))
        X = rng.normal(size=(5, 4)).astype(np.float32)
        got = tops.apply_whitening(_t(X), pca, l2norm=False)
        assert (got[:, 3] == 0).all()
        _close(got, jops.apply_whitening(X, jops.PCAParams(*pca), l2norm=False))

    def test_fit_pca_and_matrix(self, rng):
        X = rng.normal(size=(40, 16))
        tp, jp = tops.fit_pca(X), jops.fit_pca(X)
        for a, b in zip(tp[:3], jp[:3]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tops.whitening_matrix(tp, 0.5), jops.whitening_matrix(jp, 0.5)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("stream", ["array", "numpy_chunks", "tensor_chunks"])
    @pytest.mark.parametrize("n_components", [None, 10])
    def test_fit_pca_device(self, rng, stream, n_components):
        """dirjax's fit_pca_device on the same rows, streamed in uneven
        chunks: component |cos| > 1 - 1e-6, variances within 1e-5
        relative, the same signs (each row's largest |entry| positive). The
        rows are what the fit is given in use: L2-normalised descriptors,
        here with a decaying spectrum and a common mean."""
        n, d = 700, 32
        rot, _ = np.linalg.qr(rng.normal(size=(d, d)))
        X = (rng.normal(size=(n, d)) * np.geomspace(1.0, 0.1, d)) @ rot + 0.2
        X = (X / np.linalg.norm(X, axis=1, keepdims=True)).astype(np.float32)
        bounds = [(0, 97), (97, 350), (350, 351), (351, n)]
        want = jops.fit_pca_device([jnp.asarray(X[a:b]) for a, b in bounds], n_components)
        if stream == "array":
            data = _t(X)
        elif stream == "numpy_chunks":
            data = (X[a:b] for a, b in bounds)
        else:
            data = [_t(X[a:b]) for a, b in bounds]
        got = tops.fit_pca_device(data, n_components, device="cpu")
        k = n_components or d
        assert got.components.shape == (k, d) and got.variance.shape == (k,)
        np.testing.assert_allclose(got.mean, want.mean, rtol=0, atol=1e-6)
        cos = np.abs(np.sum(got.components * np.asarray(want.components), axis=1))
        assert cos.min() > 1 - 1e-6, cos
        np.testing.assert_array_equal(np.sign(got.components[np.arange(k), np.argmax(
            np.abs(got.components), axis=1)]), np.ones(k))
        assert np.abs(got.components - np.asarray(want.components)).max() < 1e-3
        np.testing.assert_allclose(got.variance, want.variance, rtol=1e-5)

    def test_fit_pca_device_needs_two_rows(self, rng):
        with pytest.raises(ValueError, match="at least 2 rows"):
            tops.fit_pca_device(rng.normal(size=(1, 8)), device="cpu")
        with pytest.raises(ValueError, match="at least 2 rows"):
            tops.fit_pca_device([], device="cpu")

    def test_fit_pca_device_refuses_tf32(self, rng, monkeypatch):
        """A card fit with TF32 on raises before it touches the card, and
        leaves the process-wide flag as the caller set it."""
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        with pytest.raises(ValueError, match="allow_tf32 = False"):
            tops.fit_pca_device(rng.normal(size=(4, 8)), device="cuda")
        assert torch.backends.cuda.matmul.allow_tf32


class TestQueryExpansion:
    @pytest.mark.parametrize("alpha", [3, 2])
    def test_aqe(self, rng, alpha):
        q = rng.normal(size=(5, 32)).astype(np.float32)
        db = rng.normal(size=(20, 32)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        want = jops.expand_queries(q, db, alpha=alpha, k=4)
        _close(tops.expand_queries(_t(q), _t(db), alpha=alpha, k=4), want)

    @pytest.mark.parametrize("k", [3, 25])
    def test_adba(self, rng, k):
        db = rng.normal(size=(12, 16)).astype(np.float32)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        want = jops.expand_database(db, alpha=3, k=k)
        _close(tops.expand_database(_t(db), alpha=3, k=k), want)


class TestRanking:
    def test_compute_scores(self, rng):
        q = rng.normal(size=(4, 64)).astype(np.float32)
        db = rng.normal(size=(30, 64)).astype(np.float32)
        want = np.asarray(jops.compute_scores(jnp.asarray(q), jnp.asarray(db)))
        _close(tops.compute_scores(_t(q), _t(db)), want)
        np.testing.assert_allclose(tops.compute_scores_chunked(_t(q), db, chunk=7),
                                   want, rtol=RTOL, atol=ATOL)
        vals, idx = tops.rank_topk(_t(q), _t(db), 5)
        np.testing.assert_array_equal(idx.numpy(), np.argsort(-want, axis=1)[:, :5])


def tied_rows(kind, rng, n, d=8):
    """Rows whose scores tie exactly: ``duplicated`` unit rows (every 5th row
    from row 3 repeats the row 3 before it), or ``one_decimal`` rows of
    multiples of 0.5 (one decimal, and exact in binary, so every dot product
    is exact in any summation order), where many distinct rows score alike."""
    if kind == "duplicated":
        x = rng.normal(size=(n, d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        x[3::5] = x[0:n - 3:5][:len(x[3::5])]
        return x.astype(np.float32)
    return (np.round(rng.normal(size=(n, d)) * 2) / 2).astype(np.float32)


class TestTieOrder:
    """Exactly tied scores rank the lower index first, as in dirjax."""

    @pytest.mark.parametrize("kind,d", [("duplicated", 64), ("one_decimal", 8)])
    def test_rank_topk(self, rng, kind, d):
        db = tied_rows(kind, rng, 4096, d)
        q = db[[0, 3, 10, 500]] if kind == "duplicated" else tied_rows(kind, rng, 6, d)
        jv, ji = jops.rank_topk(jnp.asarray(q), jnp.asarray(db), 40)
        tv, ti = tops.rank_topk(_t(q), _t(db), 40)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tv, jv)

    @pytest.mark.parametrize("k", [5, 20])
    def test_expand_queries(self, rng, k):
        db = tied_rows("one_decimal", rng, 3000)
        q = tied_rows("one_decimal", rng, 7)
        want = jops.expand_queries(q, db, alpha=3, k=k)
        _close(tops.expand_queries(_t(q), _t(db), alpha=3, k=k), want)

    @pytest.mark.parametrize("k", [5, 20])
    def test_expand_database(self, rng, k):
        db = tied_rows("one_decimal", rng, 1500)
        want = jops.expand_database(db, alpha=3, k=k)
        _close(tops.expand_database(_t(db), alpha=3, k=k), want)
