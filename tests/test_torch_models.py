"""dirjax_torch.models and checkpoint I/O held against dirjax (CPU, fp32).

The same dirjax parameters go to both packages through
``state_dict_from_jax_params``. The bar is the one tests/test_models.py
holds dirjax to against the reference: descriptor cosine > 0.9999 and max
abs error <= 1e-4 (fp32 convolutions in XLA and oneDNN sum in different
orders through 18 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dirjax.models import create_model as jcreate
from dirjax.models.rmac import _downsample_mask
from dirjax.utils import checkpoints as jckpt
from dirjax_torch.models import create_model, downsample_mask
from dirjax_torch.utils import checkpoints as tckpt

torch.set_num_threads(1)

OUT_DIM = 48


def _perturb_bn(params, rng):
    """Non-identity BN statistics and a non-default p, so that every
    converted tensor matters."""
    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return np.asarray(node)
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = node["scale"].shape[0]
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(0, 0.1, c).astype(np.float32),
                    "mean": rng.normal(0, 0.1, c).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return {k: walk(v) for k, v in node.items()}

    params = walk(params)
    params["pool_p"] = np.float32(2.6)
    params["fc"]["bias"] = rng.normal(0, 0.05, OUT_DIM).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def jmodel_params():
    rng = np.random.default_rng(1)
    jmodel = jcreate("resnet18_rmac", out_dim=OUT_DIM)
    params = _perturb_bn(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                         rng)
    return jmodel, params


def _jax_descs(jmodel, params, images, mask=None):
    return np.asarray(jmodel.apply(
        params, jnp.asarray(images), mask=None if mask is None else jnp.asarray(mask),
        precision=jax.lax.Precision.HIGHEST))


def _torch_descs(model, images, mask=None):
    with torch.inference_mode():
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        m = None if mask is None else torch.from_numpy(mask)
        return model(x, mask=m).numpy()


def _assert_parity(got, want):
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1)
                                        * np.linalg.norm(want, axis=1))
    assert cos.min() > 0.9999, cos
    assert np.abs(got - want).max() <= 1e-4


def _bucket_batch(rng):
    """Two images of different sizes padded onto one 96x64 canvas."""
    images = np.zeros((2, 96, 64, 3), np.float32)
    mask = np.zeros((2, 96, 64), bool)
    for r, (h, w) in enumerate([(64, 48), (90, 40)]):
        images[r, :h, :w] = rng.normal(size=(h, w, 3))
        mask[r, :h, :w] = True
    return images, mask


class TestDescriptorParity:
    def test_plain_batch(self, jmodel_params):
        jmodel, params = jmodel_params
        model = create_model("resnet18_rmac", out_dim=OUT_DIM)
        tckpt.load_state(model, tckpt.state_dict_from_jax_params(params, model.cfg))
        images = np.random.default_rng(2).normal(size=(2, 64, 48, 3)).astype(np.float32)
        _assert_parity(_torch_descs(model, images),
                       _jax_descs(jmodel, params, images))

    def test_bucket_masked_batch(self, jmodel_params):
        jmodel, params = jmodel_params
        model = create_model("resnet18_rmac", out_dim=OUT_DIM)
        tckpt.load_state(model, tckpt.state_dict_from_jax_params(params, model.cfg))
        images, mask = _bucket_batch(np.random.default_rng(3))
        _assert_parity(_torch_descs(model, images, mask),
                       _jax_descs(jmodel, params, images, mask))

    @pytest.mark.parametrize("pooling", ["max", "avg"])
    def test_other_heads(self, pooling):
        jmodel = jcreate("resnet18_rmac", out_dim=OUT_DIM, pooling=pooling)
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(4)))
        model = create_model("resnet18_rmac", out_dim=OUT_DIM, pooling=pooling)
        tckpt.load_state(model, tckpt.state_dict_from_jax_params(params, model.cfg))
        images, mask = _bucket_batch(np.random.default_rng(5))
        _assert_parity(_torch_descs(model, images, mask),
                       _jax_descs(jmodel, params, images, mask))

    def test_params_roundtrip(self, jmodel_params):
        _, params = jmodel_params
        cfg = create_model("resnet18_rmac", out_dim=OUT_DIM).cfg
        back = tckpt.jax_params_from_state_dict(
            tckpt.state_dict_from_jax_params(params, cfg), cfg)
        flat_a, tree_a = jax.tree.flatten(params)
        flat_b, tree_b = jax.tree.flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw,fused", [
    ({}, True),
    ({"center_bias": 0.5}, False),
    ({"norm_features": True}, False),
    ({"without_fc": True}, False),
    ({"pooling": "max"}, False),
])
def test_head_gate(monkeypatch, kw, fused):
    """Only GeM with no center bias, no feature L2 and an FC layer goes
    through fused_gem_head (dirjax/models/rmac.py:152-154), whatever the
    device; it gets the fc weight as a view, not a copy."""
    from dirjax_torch.models import rmac

    seen = []
    real = rmac.fused_gem_head

    def spy(x, p, w, b, mask=None):
        seen.append(w)
        return real(x, p, w, b, mask=mask)

    model = create_model("resnet18_rmac", out_dim=OUT_DIM, **kw)
    monkeypatch.setattr(rmac, "fused_gem_head", spy, raising=True)
    images = np.random.default_rng(10).normal(size=(2, 64, 48, 3)).astype(np.float32)
    out = _torch_descs(model, images)
    assert out.shape[0] == 2 and np.isfinite(out).all()
    assert len(seen) == int(fused)
    if fused:
        assert seen[0].data_ptr() == model.fc.weight.data_ptr()
        assert seen[0].T.is_contiguous()


@pytest.mark.parametrize("h,w", [(96, 64), (100, 70), (33, 31), (20, 12)])
def test_downsample_mask_ragged_edge(h, w):
    rng = np.random.default_rng(h * w)
    mask = np.zeros((3, h, w), bool)
    for r in range(3):
        mask[r, :rng.integers(1, h + 1), :rng.integers(1, w + 1)] = True
    fh, fw = -(-h // 32), -(-w // 32)
    want = np.asarray(_downsample_mask(jnp.asarray(mask), 32, fh, fw))
    got = downsample_mask(torch.from_numpy(mask), 32, fh, fw).numpy()
    np.testing.assert_array_equal(got, want)


class TestCheckpoints:
    def _jax_checkpoint(self, jmodel_params, pca):
        jmodel, params = jmodel_params
        return jckpt.Checkpoint(model=jmodel, params=params,
                                preprocess={"mean": [0.4, 0.5, 0.6],
                                            "std": [0.2, 0.25, 0.3]},
                                pca={"Landmarks_clean": pca}, extra={"epoch": 3})

    @pytest.mark.parametrize("fmt", ["native", "torch"])
    def test_reads_dirjax_checkpoint(self, tmp_path, jmodel_params, fmt):
        from dirjax.ops import fit_pca

        pca = fit_pca(np.random.default_rng(6).normal(size=(60, OUT_DIM)))
        ck = self._jax_checkpoint(jmodel_params, pca)
        path = str(tmp_path / ("m.npz" if fmt == "native" else "m.pt"))
        if fmt == "native":
            jckpt.save_native(path, ck)
        else:
            jckpt.save_torch_checkpoint(path, ck)
        got = tckpt.load_checkpoint(path)
        assert got.model.arch == "resnet18_rmac"
        assert got.preprocess == ck.preprocess and got.extra == {"epoch": 3}
        for a, b in zip(got.pca["Landmarks_clean"], pca):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        images, mask = _bucket_batch(np.random.default_rng(7))
        _assert_parity(_torch_descs(got.model, images, mask),
                       _jax_descs(ck.model, ck.params, images, mask))

    def test_dirjax_reads_port_native(self, tmp_path, jmodel_params):
        from dirjax_torch.ops import fit_pca

        model = create_model("resnet18_rmac", out_dim=OUT_DIM)
        tckpt.load_state(model, tckpt.state_dict_from_jax_params(
            jmodel_params[1], model.cfg))
        pca = fit_pca(np.random.default_rng(8).normal(size=(30, OUT_DIM)))
        path = str(tmp_path / "port.npz")
        tckpt.save_native(path, tckpt.Checkpoint(model=model, preprocess={
            "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
            pca={"0": pca}))
        back = jckpt.load_native(path)
        assert back.model.arch == "resnet18_rmac" and "0" in back.pca
        images = np.random.default_rng(9).normal(size=(2, 64, 48, 3)).astype(np.float32)
        _assert_parity(_torch_descs(model, images),
                       _jax_descs(back.model, back.params, images))
