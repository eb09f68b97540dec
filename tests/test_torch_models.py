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


# --- every dirjax architecture: FPN heads, ResNeXt, BN folding ---------------

NEW_ARCHS = ["resnet18_fpn_rmac", "resnet50_fpn_rmac", "resnet101_fpn_rmac",
             "resnet152_fpn_rmac", "resnet101_fpn0_rmac", "resnext101_32x4d_rmac"]
DESC_ATOL = 1e-5   # fp32 unit descriptors, TF32 off on both sides


def _perturb_all(params, rng):
    """Non-identity BN statistics, the last BN of each residual branch
    scaled down (activations stay bounded through 50 blocks, as in trained
    ResNets), non-default GeM powers (each pool its own) and a non-zero fc
    bias."""
    def bn(c, lo, hi):
        return {"scale": rng.uniform(lo, hi, c).astype(np.float32),
                "bias": rng.normal(0, 0.1, c).astype(np.float32),
                "mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}

    def walk(node, last=False):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return np.asarray(node)
        if set(node) == {"scale", "bias", "mean", "var"}:
            return bn(node["scale"].shape[0], *((0.1, 0.3) if last else (0.5, 1.5)))
        last_bn = "bn3" if "bn3" in node else "bn2"
        return {k: walk(v, "conv1" in node and k == last_bn) for k, v in node.items()}

    params = walk(params)
    for i, name in enumerate(k for k in sorted(params) if k.startswith("pool_p")):
        params[name] = np.float32(2.6 + 0.4 * i)
    params["fc"]["bias"] = rng.normal(0, 0.05, params["fc"]["bias"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def arch_models():
    """arch -> (dirjax model, perturbed params, the port's model with the
    same weights); keeps only the last arch asked for (full-width models)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache.clear()
            jmodel = jcreate(arch)
            params = _perturb_all(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(11))),
                                  np.random.default_rng(12))
            model = create_model(arch)
            tckpt.load_state(model, tckpt.state_dict_from_jax_params(params, model.cfg))
            cache[arch] = (jmodel, params, model.eval())
        return cache[arch]
    return get


def _small_bucket_batch(rng):
    """Two 64x48 canvases, the second holding a 40x32 image (bucket mask)."""
    images = rng.normal(size=(2, 64, 48, 3)).astype(np.float32)
    mask = np.ones((2, 64, 48), bool)
    mask[1, 40:] = False
    mask[1, :, 32:] = False
    images[1][~mask[1]] = 0.0
    return images, mask


def test_every_dirjax_name_resolves():
    from dirjax.models import model_names as jnames
    from dirjax_torch.models import model_config, model_names

    # every dirjax name, and beside them the port's ViT descriptor, which
    # dirjax does not have
    assert sorted(set(model_names()) - set(jnames())) == ["dinov2_vitl14_reg_rmac"]
    assert set(jnames()) <= set(model_names())
    for arch in jnames():
        j, t = jcreate(arch).config, model_config(arch)
        assert (t.out_dim, t.fc_in_dim, t.fpn_mode, t.pooling, t.gemp) == \
            (j.out_dim, j.fc_in_dim, j.fpn_mode, j.pooling, j.gemp), arch
        assert (t.backbone.layers, t.backbone.groups, t.backbone.base_width,
                t.backbone.block) == (j.backbone.layers, j.backbone.groups,
                                      j.backbone.base_width, j.backbone.block), arch


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "bucket"])
def test_new_architecture_descriptors(arch_models, arch, masked):
    """dirjax's descriptors within 1e-5 for the FPN heads (fpn_mode 1 and 0)
    and ResNeXt-101 32x4d at full width, with and without a bucket mask
    (C4 masked at stride 16, C5 at 32)."""
    jmodel, params, model = arch_models(arch)
    images, mask = _small_bucket_batch(np.random.default_rng(13))
    m = mask if masked else None
    got, want = _torch_descs(model, images, m), _jax_descs(jmodel, params, images, m)
    assert got.shape == (2, jmodel.config.out_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=DESC_ATOL)


@pytest.mark.parametrize("arch", ["resnet18_rmac", "resnext101_32x4d_rmac", "resnet50_fpn_rmac"])
def test_fold_batchnorm(arch_models, arch):
    """The folded copy's weights are dirjax's fold bit for bit; its
    descriptors are dirjax's folded model's and the unfolded model's within
    1e-5; the model it was made from is left as it was. In bf16 its
    descriptors are dirjax's folded bf16 model's within cosine 0.9999 and
    1e-3 (dirjax's own bf16 is 4.3e-4 from its fp32 on these inputs)."""
    from dirjax.models import fold_batchnorm as jfold
    from dirjax_torch.models import fold_batchnorm, is_folded

    jmodel, params, model = arch_models(arch)
    folded = fold_batchnorm(model)
    assert is_folded(folded) and not is_folded(model)
    jparams = dict(params, backbone=jfold(params["backbone"]))
    stem = jparams["backbone"]["stem"]
    np.testing.assert_array_equal(folded.conv1.weight.detach().numpy(),
                                  stem["conv"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(folded.conv1.bias.detach().numpy(), stem["bias"])
    block = jparams["backbone"]["layer2"][0]
    np.testing.assert_array_equal(folded.layer2[0].downsample[0].bias.detach().numpy(),
                                  block["downsample"]["bias"])
    np.testing.assert_array_equal(folded.layer2[0].conv2.weight.detach().numpy(),
                                  block["conv2"].transpose(3, 2, 0, 1))
    assert not any("bn" in k or "downsample.1" in k for k in folded.state_dict())
    images, mask = _small_bucket_batch(np.random.default_rng(14))
    got = _torch_descs(folded, images, mask)
    np.testing.assert_allclose(got, _jax_descs(jmodel, jparams, images, mask),
                               rtol=0, atol=DESC_ATOL)
    np.testing.assert_allclose(got, _torch_descs(model, images, mask), rtol=0, atol=DESC_ATOL)
    with torch.inference_mode():
        got = folded(torch.from_numpy(images).permute(0, 3, 1, 2), mask=torch.from_numpy(mask),
                     dtype=torch.bfloat16).float().numpy()
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(images), mask=jnp.asarray(mask),
                                   dtype=jnp.bfloat16))
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() > 0.9999, cos
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_folded_block_epilogue_in_fp32(kind):
    """A folded block adds its biases and its shortcut in fp32 and rounds
    to bf16 once, at its end, as dirjax/models/resnet.py:327-347 does. The
    branch here nearly cancels its shortcut (bias -4 against inputs in
    [4, 4.25)), so the outputs lie below 1 and are held to two bf16 ulps
    there (2^-7); a bf16 epilogue rounds at magnitude 4 (ulp 2^-5) and
    misses by about 0.019."""
    from dirjax.models import resnet as jr
    from dirjax_torch.models import resnet as tr

    name, cin = ("resnet18", 64) if kind == "basic" else ("resnet50", 256)
    rng = np.random.default_rng(21)
    p = jax.tree.map(np.asarray, jr._init_block(jax.random.PRNGKey(3), jr.RESNET_CONFIGS[name],
                                                cin, 64, 1))
    for key in [k for k in p if k.startswith("bn")]:
        c = p[key]["scale"].shape[0]
        p[key] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                  "bias": rng.normal(0, 0.1, c).astype(np.float32),
                  "mean": rng.normal(0, 0.1, c).astype(np.float32),
                  "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    last = "bn2" if kind == "basic" else "bn3"
    p[last]["scale"] *= 0.01
    p[last]["bias"][:] = -4.0
    fp = jr.fold_batchnorm(p)
    cfg = tr.RESNET_CONFIGS[name]
    block = (tr.BasicBlock if kind == "basic" else tr.Bottleneck)(cfg, cin, 64, 1)
    for key in [k for k in fp if k.startswith("conv")]:
        conv = getattr(block, key)
        conv.weight.data = torch.from_numpy(fp[key].transpose(3, 2, 0, 1).copy())
        conv.bias = torch.nn.Parameter(torch.from_numpy(fp["bias" + key[4:]]))
        setattr(block, "bn" + key[4:], None)
    x = torch.from_numpy(rng.uniform(4.0, 4.25, (2, 12, 10, cin)).astype(np.float32)).bfloat16()
    want = np.asarray(jr._apply_block_folded(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), fp, jr.RESNET_CONFIGS[name], 1,
        dtype=jnp.bfloat16, precision=None).astype(jnp.float32))
    with torch.inference_mode():
        got = block(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last),
                    torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.abs(want).max() < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7)


@pytest.mark.parametrize("arch,fused", [("resnext101_32x4d_rmac", True),
                                        ("resnet18_fpn_rmac", False),
                                        ("resnet101_fpn0_rmac", False)])
def test_fpn_heads_skip_the_fused_head(monkeypatch, arch, fused):
    """K1's wrapper serves the plain heads only, ResNeXt's included; the
    FPN heads pool and project without it, as dirjax gates it
    (dirjax/models/rmac.py:145-153)."""
    from dirjax_torch.models import rmac

    calls = []
    real = rmac.fused_gem_head
    monkeypatch.setattr(rmac, "fused_gem_head",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = _torch_descs(create_model(arch, out_dim=OUT_DIM),
                       np.random.default_rng(15).normal(size=(1, 64, 48, 3)).astype(np.float32))
    assert out.shape == (1, OUT_DIM) and np.isfinite(out).all()
    assert len(calls) == int(fused)
