"""The port's extraction tail held against dirjax on the CPU: checkpoint
export (``save_torch_checkpoint``) and tolerant loading across the two
packages, for the plain and the FPN heads, and the extract_features,
fit_whitening and extract_kapture command lines with ``--gpu -1``.

Tolerances: descriptors of one checkpoint in the two packages within atol
1e-5 (fp32 unit vectors; XLA and oneDNN convolutions sum in other orders).
A PCA fitted on those descriptors moves with them: means within 1e-5,
variances within 1e-4 relative and components at |cos| > 0.999, on the
components whose variance stands clear of the rank-deficient tail (12
images in 32 dimensions). kapture goes through ``tests/kapture_shim.py``.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import dirjax.datasets as D
from dirjax.models import create_model as jcreate
from dirjax.ops import fit_pca as jfit_pca
from dirjax.utils import checkpoints as jckpt
from dirjax_torch.models import create_model
from dirjax_torch.ops import PCAParams
from dirjax_torch.utils import checkpoints as tckpt

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
OUT_DIM = 32
ATOL = 1e-5


def _jax_descs(jmodel, params, images):
    return np.asarray(jmodel.apply(params, images,
                                   precision=jax.lax.Precision.HIGHEST))


def _torch_descs(model, images):
    with torch.inference_mode():
        return model(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()


def _images(seed=0):
    return np.random.default_rng(seed).normal(size=(2, 64, 48, 3)).astype(np.float32)


def _jax_model(arch, seed=0):
    jmodel = jcreate(arch, out_dim=OUT_DIM)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    for name in [k for k in params if k.startswith("pool_p")]:
        params[name] = np.float32(2.7 if name.endswith("c4") else 3.3)
    return jmodel, params


def _port_model(arch, params):
    model = create_model(arch, out_dim=OUT_DIM)
    return tckpt.load_state(model, tckpt.state_dict_from_jax_params(params, model.cfg)).eval()


ARCHS = ["resnet18_rmac", "resnet18_fpn_rmac", "resnet101_fpn0_rmac"]


class TestTorchCheckpointExport:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_port_pt_loads_in_dirjax(self, tmp_path, arch):
        """A .pt from save_torch_checkpoint is the reference schema:
        dirjax's reader takes it and gives the same descriptors, PCA,
        preprocess and extras."""
        jmodel, params = _jax_model(arch)
        model = _port_model(arch, params)
        pca = PCAParams(*jfit_pca(np.random.default_rng(1).normal(size=(40, OUT_DIM))))
        ck = tckpt.Checkpoint(model=model, preprocess={"mean": [0.4, 0.5, 0.6],
                                                       "std": [0.2, 0.25, 0.3]},
                              pca={"Landmarks_clean": pca}, extra={"epoch": 7})
        path = str(tmp_path / "port.pt")
        tckpt.save_torch_checkpoint(path, ck)
        back = jckpt.load_checkpoint(path)
        assert back.model.arch == arch and back.extra == {"epoch": 7}
        assert back.preprocess == ck.preprocess
        for a, b in zip(back.pca["Landmarks_clean"], pca):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        images = _images()
        np.testing.assert_allclose(_torch_descs(model, images),
                                   _jax_descs(back.model, back.params, images),
                                   rtol=0, atol=ATOL)
        mine = tckpt.load_checkpoint(path)
        np.testing.assert_array_equal(_torch_descs(mine.model, images),
                                      _torch_descs(model, images))

    @pytest.mark.parametrize("arch", ARCHS)
    def test_dirjax_pt_loads_in_port(self, tmp_path, arch):
        jmodel, params = _jax_model(arch, seed=2)
        path = str(tmp_path / "jax.pt")
        jckpt.save_torch_checkpoint(path, jckpt.Checkpoint(
            model=jmodel, params=params, preprocess=jmodel.preprocess))
        got = tckpt.load_checkpoint(path)
        assert got.model.arch == arch and got.model.cfg.fpn_mode == jmodel.config.fpn_mode
        images = _images(3)
        np.testing.assert_allclose(_torch_descs(got.model, images),
                                   _jax_descs(jmodel, params, images), rtol=0, atol=ATOL)

    def test_refuses_a_folded_model(self, tmp_path):
        from dirjax_torch.models import fold_batchnorm

        model = fold_batchnorm(create_model("resnet18_rmac", out_dim=OUT_DIM))
        with pytest.raises(ValueError, match="folded"):
            tckpt.save_torch_checkpoint(str(tmp_path / "f.pt"), tckpt.Checkpoint(
                model=model, preprocess=model.cfg.preprocess))


class TestLoadTolerant:
    @pytest.mark.parametrize("arch", ["resnet18_rmac", "resnet18_fpn_rmac"])
    @pytest.mark.parametrize("delete_fc", [False, True])
    def test_reports_and_merges_as_dirjax(self, capsys, arch, delete_fc):
        """The same "Missing layer" / "Bad shape" lines, in the same order,
        and the same merged weights as dirjax's load_tolerant, from a
        checkpoint with a missing layer, a bad shape and a foreign key."""
        jmodel, init = _jax_model(arch, seed=4)
        _, other = _jax_model(arch, seed=5)
        sd = {f"module.{k}": v for k, v in
              jckpt.params_to_state_dict(other, jmodel).items()}
        del sd["module.layer1.0.conv1.weight"]
        del sd["module.bn1.running_var"]
        sd["module.layer2.0.bn2.weight"] = np.ones(3, np.float32)
        sd["module.fc.weight"] = np.zeros((OUT_DIM + 1, 512), np.float32)
        sd["module.unused.weight"] = np.zeros(2, np.float32)
        if "module.conv1x5.weight" in sd:
            sd["module.conv1x5.weight"] = sd["module.conv1x5.weight"][:, :7]
        want = jckpt.load_tolerant(init, jmodel, sd, delete_fc=delete_fc)
        jlines = capsys.readouterr().out.splitlines()

        model = _port_model(arch, init)   # the same fresh values as dirjax's
        got = tckpt.load_tolerant(model, {k: torch.from_numpy(np.array(v))
                                          for k, v in sd.items()}, delete_fc=delete_fc)
        tlines = capsys.readouterr().out.splitlines()
        assert got is model and tlines == jlines
        assert any("Missing layer layer1.0.conv1.weight" in x for x in tlines)
        assert any("Bad shape for layer layer2.0.bn2.weight" in x for x in tlines)
        assert any("fc.weight" in x for x in tlines) != delete_fc
        expect = tckpt.state_dict_from_jax_params(want, model.cfg)
        for name, value in model.state_dict().items():
            np.testing.assert_array_equal(value.numpy(), expect[name], err_msg=name)


# --- the command lines ---------------------------------------------------------

@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_cli"))
    D.Synthetic(root, revisited=True)
    return root


@pytest.fixture(scope="module", params=["resnet18_rmac", "resnet18_fpn_rmac"])
def cli_ckpt(request, tmp_path_factory):
    jmodel, params = _jax_model(request.param, seed=6)
    pca = jfit_pca(np.random.default_rng(7).normal(size=(64, OUT_DIM)))
    path = str(tmp_path_factory.mktemp("cli_ckpt") / "model.npz")
    jckpt.save_native(path, jckpt.Checkpoint(model=jmodel, params=params,
                                             preprocess=jmodel.preprocess,
                                             pca={"Landmarks_clean": pca}))
    return path


@pytest.mark.parametrize("whiten", [[], ["--whiten", "Landmarks_clean"]], ids=["raw", "whitened"])
def test_extract_features_cli(synth_root, cli_ckpt, tmp_path, whiten):
    from dirjax.cli.extract_features import main as jmain
    from dirjax_torch.cli.extract_features import main as tmain

    argv = ["--dataset", f"Synthetic('{synth_root}')", "--checkpoint", cli_ckpt,
            "--gpu", "-1", "--threads", "2", "--trfs", "", "Scale(40)", *whiten]
    jmain(argv + ["--output", str(tmp_path / "j" / "feats.npy")])
    tmain(argv + ["--output", str(tmp_path / "t" / "feats.npy")])
    for part in ("dbdescs", "qdescs"):
        want = np.load(tmp_path / "j" / f"feats.{part}.npy")
        got = np.load(tmp_path / "t" / f"feats.{part}.npy")
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _fit_argv(synth_root, ckpt, out, *extra):
    return ["--dataset", f"SyntheticLabels('{synth_root}')", "--checkpoint", ckpt,
            "--name", "SynClean", "--out", out, "--trfs", "Scale(48), CenterCrop(48)",
            "--max-images", "16", "--gpu", "-1", "--threads", "2", *extra]


@pytest.mark.parametrize("device_fit", [False, True], ids=["host_svd", "device_fit"])
@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_fit_whitening_cli(synth_root, cli_ckpt, tmp_path, device_fit, fmt):
    """The port's fit_whitening writes the PCA dirjax's writes (within the
    movement of the descriptors it is fitted on), in a checkpoint both
    packages read; test_dir then whitens with it."""
    from dirjax.cli.fit_whitening import main as jmain
    from dirjax_torch.cli.fit_whitening import main as tmain
    from dirjax_torch.cli.test_dir import main as td_main

    extra = ["--device-fit"] if device_fit else []
    jout, tout = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    jmain(_fit_argv(synth_root, cli_ckpt, jout, *extra))
    tmain(_fit_argv(synth_root, cli_ckpt, tout, *extra))
    want = jckpt.load_checkpoint(jout).pca["SynClean"]
    got_port = tckpt.load_checkpoint(tout)
    got = jckpt.load_checkpoint(tout).pca["SynClean"]   # dirjax reads the port's file
    for a, b in zip(got, got_port.pca["SynClean"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(got.mean, want.mean, rtol=0, atol=ATOL)
    var, wvar = np.asarray(got.variance), np.asarray(want.variance)
    clear = wvar > 1e-3 * wvar[0]
    assert clear.sum() >= 5 and got.components.shape == want.components.shape
    np.testing.assert_allclose(var[clear], wvar[clear], rtol=1e-4)
    cos = np.abs(np.sum(np.asarray(got.components)[clear] * np.asarray(want.components)[clear],
                        axis=1))
    assert cos.min() > 0.999, cos
    res = td_main(["--dataset", f"Synthetic('{synth_root}')", "--checkpoint", tout,
                   "--whiten", "SynClean", "--gpu", "-1", "--threads", "2"])
    assert 0.0 <= res["mAP-medium"] <= 1.0


@pytest.fixture
def kapture_shim():
    """The repository's fake kapture package, taken out of sys.modules
    again afterwards."""
    sys.path.insert(0, TESTS)
    import kapture_shim as shim

    before = {k for k in sys.modules if k.split(".")[0] == "kapture"}
    shim.install()
    yield shim
    for k in [k for k in sys.modules if k.split(".")[0] == "kapture" and k not in before]:
        del sys.modules[k]
    sys.path.remove(TESTS)


def _kapture_root(path):
    from PIL import Image

    rec = path / "sensors" / "records_data"
    rec.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (48, 40, 3)).astype(np.uint8)).save(
            rec / f"frame{i}.jpg")
    return str(path)


def test_extract_kapture_cli(kapture_shim, cli_ckpt, tmp_path, capsys):
    """The same .gfeat files as dirjax's extract_kapture; a second run
    finds every image done."""
    from dirjax.cli.extract_kapture import main as jmain
    from dirjax_torch.cli.extract_kapture import main as tmain

    roots = {}
    for name, main in (("j", jmain), ("t", tmain)):
        roots[name] = _kapture_root(tmp_path / name)
        main(["--kapture-root", roots[name], "--checkpoint", cli_ckpt, "--gpu", "-1",
              "--threads", "2", "--whiten", "Landmarks_clean"])
    ftype = "model"   # the checkpoint's basename
    fdir = {k: os.path.join(r, "reconstruction", "global_features", ftype)
            for k, r in roots.items()}
    files = sorted(f for f in os.listdir(fdir["t"]) if f.endswith(".gfeat"))
    assert files == [f"frame{i}.jpg.gfeat" for i in range(3)]
    assert sorted(os.listdir(fdir["t"])) == sorted(os.listdir(fdir["j"]))
    with open(os.path.join(fdir["t"], "global_features.txt")) as f, \
            open(os.path.join(fdir["j"], "global_features.txt")) as g:
        assert f.read() == g.read()
    for f in files:
        got = np.fromfile(os.path.join(fdir["t"], f), np.float32)
        want = np.fromfile(os.path.join(fdir["j"], f), np.float32)
        assert got.shape == (OUT_DIM,)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    capsys.readouterr()
    tmain(["--kapture-root", roots["t"], "--checkpoint", cli_ckpt, "--gpu", "-1"])
    assert "already extracted" in capsys.readouterr().out


def test_extract_kapture_needs_the_package(monkeypatch):
    for name in [k for k in sys.modules if k.split(".")[0] == "kapture"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "kapture", None)   # an import of it raises
    from dirjax_torch.cli.extract_kapture import extract_kapture_global_features

    with pytest.raises(ImportError, match="requires the 'kapture' package"):
        extract_kapture_global_features("/nonexistent", None, "t", "")
