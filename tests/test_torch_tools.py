"""The port's tooling and small host modules held against dirjax's on the CPU:
the ``dead_floor`` whitening of rank-deficient fits, the three debug mains
(``python -m dirjax_torch.{models,datasets,data}``), ``validate_oracle``,
``graft_entry``, ``model_size``, ``register_model``,
``create_model(pretrained=)``, ``extract_image_features(ret_imgs=)``,
``FeatureExtractor.call_adaptive``, ``BinaryCodec.n_words`` and
``utils.{misc,timer}``.

Tolerances: whitened rows within 1e-5 (fp32 products of two libraries, unit
rows); the folded fp64 (W, b) equal; every stdout, image and count equal.
"""

import os
import random
import runpy
import sys
from functools import partial

import numpy as np
import pytest
import torch
from PIL import Image

import dirjax.ops.whitening as JW
from dirjax_torch.ops import whitening as TW

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# --------------------------------------------------------------------------
# dead_floor (dirjax/ops/whitening.py:139-192)
# --------------------------------------------------------------------------

def _rank_deficient():
    """300 rows of rank 12 in 64 dimensions, as tests/test_round4_fixes.py
    builds them, and dirjax's fit of them."""
    rng = np.random.default_rng(0)
    basis = rng.standard_normal((12, 64)).astype(np.float32)
    x = rng.standard_normal((300, 12)).astype(np.float32) @ basis
    p = JW.fit_pca_device(x)
    return x, TW.PCAParams(*(np.asarray(a) for a in p[:3]), whiten=bool(p.whiten)), p


@pytest.mark.parametrize("whitenv", [None, 20])
def test_dead_floor_matches_dirjax(whitenv):
    """With dead_floor=1e-7 the fp32 noise directions of a rank-deficient fit
    fold to 0 as dirjax folds them, and the 12 real ones agree; the folded
    (W, b) equal dirjax's and agree with the applied whitening."""
    x, pca, jpca = _rank_deficient()
    got = TW.apply_whitening(torch.from_numpy(x), pca, whitenp=0.5, whitenv=whitenv,
                             dead_floor=1e-7).numpy()
    want = np.asarray(JW.apply_whitening(x, jpca, whitenp=0.5, whitenv=whitenv,
                                         dead_floor=1e-7))
    var = pca.variance[:whitenv]
    dead = var <= var.max() * 1e-7
    assert dead.any() and (~dead).sum() == 12
    assert np.isfinite(got).all() and not np.abs(got[:, dead]).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    w, b = TW.whitening_matrix(pca, whitenp=0.5, whitenv=whitenv, dead_floor=1e-7)
    jw, jb = JW.whitening_matrix(jpca, whitenp=0.5, whitenv=whitenv, dead_floor=1e-7)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(b, jb)
    folded = x @ w + b
    folded /= np.linalg.norm(folded, axis=1, keepdims=True)
    np.testing.assert_allclose(folded, got, atol=2e-4)


def test_dead_floor_default_is_the_unfloored_rule():
    """dead_floor=0.0 (the default) is the rule every caller had: the noise
    directions with a positive variance divide unfloored (not zeroed)."""
    x, pca, _ = _rank_deficient()
    xt = torch.from_numpy(x)
    plain = TW.apply_whitening(xt, pca, whitenp=0.5)
    assert torch.equal(plain, TW.apply_whitening(xt, pca, whitenp=0.5, dead_floor=0.0))
    noise = torch.from_numpy((pca.variance > 0) & (pca.variance <= pca.variance.max() * 1e-7))
    assert noise.any() and plain[:, noise].abs().amax() > 0
    w0, b0 = TW.whitening_matrix(pca, whitenp=0.5)
    w1, b1 = TW.whitening_matrix(pca, whitenp=0.5, dead_floor=0.0)
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_array_equal(b0, b1)


# --------------------------------------------------------------------------
# debug mains
# --------------------------------------------------------------------------

def _run_main(module, argv, capsys, seed=None):
    """stdout of ``python -m module *argv`` run in this process."""
    old = sys.argv
    sys.argv = [module] + list(argv)
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
    try:
        runpy.run_module(module, run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def test_models_main_matches_dirjax(capsys):
    want = _run_main("dirjax.models", [], capsys)
    got = _run_main("dirjax_torch.models", [], capsys)
    # dirjax's listing, and in its order the port's ViT descriptor, which
    # dirjax does not have
    vit = "  dinov2_vitl14_reg_rmac"
    assert vit in got.splitlines()
    assert [line for line in got.splitlines() if line != vit] == want.splitlines()
    assert "resnet101_rmac" in got


def test_datasets_main_matches_dirjax(capsys, tmp_path):
    from dirjax_torch.datasets import make_synthetic_benchmark

    make_synthetic_benchmark(str(tmp_path / "revisited"), seed=1)
    spec = f"Synthetic('{tmp_path}')"
    for argv in ([spec], [spec, "1"]):
        want = _run_main("dirjax.datasets", argv, capsys)
        got = _run_main("dirjax_torch.datasets", argv, capsys)
        assert got == want and got


def test_data_main_matches_dirjax(capsys, tmp_path):
    rng = np.random.default_rng(0)
    src = str(tmp_path / "in.png")
    Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)).save(src)
    chain = "RandomScale(40, 70), RandomCrop(32), ColorJitter(0.2, 0.2, 0.2, 0.05)"
    outs = {}
    for pkg in ("dirjax", "dirjax_torch"):
        out = str(tmp_path / f"{pkg}.png")
        text = _run_main(f"{pkg}.data", [chain, src, out, "2"], capsys, seed=3)
        outs[pkg] = (text.replace(pkg + ".png", "X").replace(pkg + "_", "X_"),
                     [np.asarray(Image.open(out.replace(".", f"_{i}.", 1))) for i in (0, 1)])
    assert outs["dirjax_torch"][0] == outs["dirjax"][0]
    assert "sample 1: size=" in outs["dirjax"][0]
    for a, b in zip(outs["dirjax_torch"][1], outs["dirjax"][1]):
        np.testing.assert_array_equal(a, b)


def test_validate_oracle_reports_missing_inputs(capsys, tmp_path, monkeypatch):
    import validate_oracle as J
    from dirjax_torch import validate_oracle as T

    monkeypatch.delenv("DB_ROOT", raising=False)
    monkeypatch.delenv("DIR_ROOT", raising=False)
    monkeypatch.chdir(tmp_path)
    assert J.main([]) == 2
    want = capsys.readouterr().out
    assert T.main(["--gpu", "-1"]) == 2
    got = capsys.readouterr().out
    assert got == want and "CANNOT RUN" in got and "Resnet101-AP-GeM.pt" in got
    monkeypatch.setenv("DB_ROOT", str(tmp_path / "nowhere"))
    assert J.main([]) == T.main([]) == 2
    out = capsys.readouterr().out.split("CANNOT RUN")
    assert out[1] == out[2] and "is not a directory" in out[1]


# --------------------------------------------------------------------------
# graft_entry
# --------------------------------------------------------------------------

def test_graft_entry_forward():
    from dirjax_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    out = fn(*args)
    assert out.shape == (1, 2048) and out.dtype == torch.float32
    assert float(out[0].norm()) == pytest.approx(1.0, abs=1e-2)   # bf16, L2-normalized


def test_graft_entry_dryrun_two_ranks(capsys):
    from dirjax_torch.graft_entry import dryrun_multichip

    dryrun_multichip(2)
    out = capsys.readouterr().out
    for part in ("train loss=", "sharded extraction (2, 64)", "AQE ok", "int8 sharded",
                 "PQ/ADC", "IVF-ADC", "binary-hash"):
        assert part in out, (part, out)


# --------------------------------------------------------------------------
# the host remainder
# --------------------------------------------------------------------------

def test_model_size_matches_dirjax():
    from dirjax.models import model_size as jsize
    from dirjax_torch.models import create_model, init_weights, model_size
    from dirjax_torch.utils.checkpoints import jax_params_from_state_dict

    model = init_weights(create_model("resnet18_rmac", out_dim=32),
                         torch.Generator().manual_seed(0))
    want = jsize(jax_params_from_state_dict(model.state_dict(), model.cfg))
    assert model_size(model) == model_size(model.state_dict()) == want > 1e7


def test_register_model_and_pretrained_refusal(monkeypatch):
    import dirjax.models as JM
    import dirjax_torch.models.registry as R
    from dirjax_torch.models import create_model, model_names, register_model

    monkeypatch.setattr(R, "_FACTORIES", dict(R._FACTORIES))
    register_model("tiny_rmac", partial(R._rmac_config, "resnet18", None, out_dim=16))
    assert "tiny_rmac" in model_names()
    model = create_model("tiny_rmac", gemp=4)
    assert model.arch == "tiny_rmac" and model.cfg.out_dim == 16 and model.cfg.gemp == 4
    with torch.inference_mode():
        assert model.eval()(torch.rand(1, 3, 32, 32)).shape == (1, 16)
    with pytest.raises(NotImplementedError, match="load_checkpoint"):
        create_model("resnet18_rmac", pretrained="imagenet")
    with pytest.raises(NotImplementedError, match="load_checkpoint"):
        JM.create_model("resnet18_rmac", pretrained="imagenet")
    with pytest.raises(NameError, match="unknown model architecture"):
        create_model("nope", pretrained="imagenet")


class _Recorder:
    """A duck-typed dirjax extractor returning zeros: ``ret_imgs`` returns
    the loader's images whatever the extractor computes, and this spares a
    jax compile."""

    def __init__(self, preprocess):
        self.preprocess = preprocess

    def __call__(self, images, mask=None):
        return np.zeros((len(images), 4), np.float32)


@pytest.mark.parametrize("batching", ["group", "bucket"])
def test_ret_imgs_and_call_adaptive(tmp_path, batching):
    import dirjax.datasets as JD
    from dirjax.extraction import extract_image_features as jextract
    from dirjax_torch.datasets import Synthetic, make_synthetic_benchmark
    from dirjax_torch.extraction import FeatureExtractor, extract_image_features
    from dirjax_torch.models import create_model

    make_synthetic_benchmark(str(tmp_path / "revisited"), image_size=(40, 30), seed=2)
    db = Synthetic(str(tmp_path))
    ex = FeatureExtractor(create_model("resnet18_rmac", out_dim=16), "cpu")
    trf = "RandomScale(40, 52)" if batching == "bucket" else ""
    random.seed(0)
    imgs, descs = extract_image_features(db, trf, ex, batching=batching, batch_size=4,
                                         threads=1, ret_imgs=True)
    random.seed(0)
    want, _ = jextract(JD.Synthetic(str(tmp_path)), trf, _Recorder(ex.preprocess),
                       batching=batching, batch_size=4, threads=1, ret_imgs=True)
    assert len(imgs) == len(want) == len(db) == descs.shape[0]
    for a, b in zip(imgs, want):
        np.testing.assert_array_equal(a, b)
    batch = np.stack([im for im in imgs[:3]]) if batching == "group" else \
        np.stack([im[:30, :30] for im in imgs[:3]])
    np.testing.assert_allclose(ex.call_adaptive(batch), ex(batch).numpy(), rtol=0, atol=1e-6)


def test_binary_codec_n_words():
    from dirjax.ops.binary import BinaryCodec as JC
    from dirjax_torch.ops.binary import BinaryCodec

    for bits in (32, 256, 2048):
        codec = BinaryCodec(mean=torch.zeros(2048), proj=torch.zeros(2048, bits))
        assert codec.n_words == JC(mean=np.zeros(2048), proj=np.zeros((2048, bits))).n_words \
            == bits // 32


def test_misc_and_timer_match_dirjax(tmp_path):
    import dirjax.utils.misc as JM
    import dirjax.utils.timer as JT
    from dirjax_torch.utils import misc, timer

    x = np.linspace(-3, 3, 13)
    np.testing.assert_array_equal(misc.sigmoid(x, 2.0, 0.5), JM.sigmoid(x, 2.0, 0.5))
    np.testing.assert_array_equal(misc.sigmoid_range(x, -1.0, 2.0),
                                  JM.sigmoid_range(x, -1.0, 2.0))
    path = str(tmp_path / "a" / "b" / "f.npy")
    misc.assert_outpath(path, ".npy")
    misc.touch(path)
    assert os.path.isfile(path)
    with pytest.raises(AssertionError):
        misc.assert_outpath(path, ".npz")
    synced, res = [], {}
    with timer.timed("t", res, sync=lambda: synced.append(1)):
        timer.tic("x")
    assert synced == [1] and res["t"] >= 0 and timer.toc("x") >= 0
    assert timer.timed.__doc__ != JT.timed.__doc__     # the torch sync, not a jax block
    assert "torch.cuda.synchronize" in timer.timed.__doc__
