"""dirjax_torch.ops held against dirjax.ops on the same numpy inputs (CPU).

Tolerance rtol 2e-4 / atol 2e-5, as tests/test_pallas_kernels.py holds the
Pallas head to its XLA oracle: both sides compute in fp32 but sum in
different orders (XLA vs ATen reductions, a 128..2048-term matmul), and the
pow/log/exp chain of GeM amplifies last-bit differences by about p.
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
