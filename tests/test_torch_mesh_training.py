"""The port's sharded training held against dirjax's on the CPU: the DP+TP
step (whole-batch and two-pass), ``fit(mesh=...)`` with npz and sharded
checkpoints, ``TrainCheckpointer`` (dirjax's ``orbax_ckpt`` API on
``torch.distributed.checkpoint``) and the train CLI's ``--mesh`` and
``--ckpt-format``.

Multi-rank runs are three worlds of 4 gloo ranks (``test_torch_dist_worker``:
the sharded step, the mesh fits, the checkpoint runs) and two
``torch.distributed.run`` launches of the CLI; dirjax runs on conftest's
virtual devices. Weights cross from the port's seeded init to
dirjax through ``jax_params_from_state_dict``. Tolerances, dirjax's mesh
bounds (``tests/test_mesh_training.py``): one sharded SGD step's loss within
1e-5 and every parameter within rtol 2e-4 / atol 2e-5; ``fit``'s per-epoch
loss within rtol 1e-4 / atol 1e-5 and its weights within rtol 2e-4 / atol
2e-5. Resuming from a sharded checkpoint and from the npz files gives the
same weights to rtol 1e-6 (the same arithmetic on restored state).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dirjax.datasets as JD
import dirjax.train as JT
from dirjax.models import create_model as jcreate
from dirjax.parallel import make_mesh as jmake_mesh
from test_torch_dist_worker import REPO, run_world

from dirjax_torch import train as TT
from dirjax_torch.datasets import ImageListLabels
from dirjax_torch.models import create_model, init_weights
from dirjax_torch.utils.checkpoints import jax_params_from_state_dict
from dirjax_torch.utils.dist_ckpt import TrainCheckpointer, is_checkpoint_dir

torch.set_num_threads(1)
WORLD = 4
STEP = dict(arch="resnet18_rmac", out_dim=64, nq=10, batch_size=8, optimizer="sgd",
            learning_rate=1e-2)
FIT = dict(arch="resnet18_rmac", out_dim=32, batch_size=8, nq=10, learning_rate=3e-4,
           image_size=32, threads=2, optimizer="sgd", trfs="Scale(36), CenterCrop(32)")


def _seeded(arch, out_dim, seed=0):
    """The port's seeded init (dirjax's distributions) and its state as numpy."""
    model = init_weights(create_model(arch, out_dim=out_dim), torch.Generator().manual_seed(seed))
    return model, {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_params(sd: dict, arch, out_dim):
    cfg = create_model(arch, out_dim=out_dim).cfg
    return jax_params_from_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                                      cfg)


def _same_params(got_sd: dict, want_params, arch, out_dim, rtol=2e-4, atol=2e-5):
    got = jax.tree.leaves(_jax_params(got_sd, arch, out_dim))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g).reshape(np.shape(w)), w, rtol=rtol, atol=atol)


def _sd(out: dict) -> dict:
    return {k[3:]: v for k, v in out.items() if k.startswith("sd/")}


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    """dirjax's mesh-training set: 16 images of 4 colour classes, 40x40."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("meshtrain"))
    rng = np.random.default_rng(0)
    rows = []
    for i in range(16):
        cls = i % 4
        base = np.zeros((40, 40, 3), np.uint8)
        base[..., cls % 3] = 60 + 40 * (cls // 3)
        noise = rng.integers(0, 50, size=base.shape, dtype=np.uint8)
        Image.fromarray(base + noise).save(f"{root}/img{i}.jpg")
        rows.append(f"img{i}.jpg c{cls}")
    with open(f"{root}/train.txt", "w") as f:
        f.write("\n".join(rows))
    return root


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The worlds' arrays (the step's and the fit's seeded weights, the
    step's batch) and the directory their runs write checkpoints to."""
    rng = np.random.default_rng(0)
    _, step_sd = _seeded("resnet18_rmac", 64, seed=1)
    _, fit_sd = _seeded("resnet18_rmac", 32, seed=2)
    inp = {**{f"step/{k}": v for k, v in step_sd.items()},
           **{f"start/{k}": v for k, v in fit_sd.items()},
           "images": rng.normal(size=(8, 64, 64, 3)).astype(np.float32),
           "labels": np.array([0, 0, 1, 1, 2, 2, 3, 3])}
    return inp, tmp_path_factory.mktemp("runs")


def _world(tmp_path_factory, inp, cases: dict) -> dict:
    """One world of WORLD ranks on ``cases`` (name -> (case, kwargs)), run
    in order; each case's outputs by name."""
    names = list(cases)
    outs = run_world(str(tmp_path_factory.mktemp("world")), WORLD,
                     [list(cases[n]) for n in names], inp)
    return dict(zip(names, outs))


# Three worlds, each well inside run_world's TIMEOUT under a loaded CPU: the
# sharded step, the mesh fits, and the checkpoint runs (whose resumes read
# what the cases before them wrote, so they share one world).
_STEP_KW = {"mesh": [2, 2], "model": "step", "images": "images", "labels": "labels"}


@pytest.fixture(scope="module")
def step_world(tmp_path_factory, inputs):
    return _world(tmp_path_factory, inputs[0], {
        "step": ("train_step", {**_STEP_KW, "cfg": STEP}),
        "step_mb": ("train_step", {**_STEP_KW, "cfg": dict(STEP, microbatch=4)}),
        "per_rank": ("per_rank_loss", {**_STEP_KW, "cfg": STEP})})


@pytest.fixture(scope="module")
def fit_world(tmp_path_factory, inputs, labeled):
    fit_kw = {"cfg": dict(FIT, epochs=1), "root": labeled}
    return _world(tmp_path_factory, inputs[0], {
        "fit": ("fit", {**fit_kw, "mesh": [2, 2], "steps": 2}),
        "fit_mb": ("fit", {**fit_kw, "mesh": [2, 2], "steps": 1,
                           "cfg": dict(FIT, epochs=1, microbatch=4)}),
        "divisible": ("fit", {**fit_kw, "mesh": [WORLD, 1], "steps": 1,
                              "cfg": dict(FIT, epochs=1, batch_size=6)})})


@pytest.fixture(scope="module")
def ckpt_world(tmp_path_factory, inputs, labeled):
    inp, runs = inputs
    fit_kw = {"cfg": dict(FIT, epochs=1), "root": labeled}
    resumed = dict(FIT, epochs=3)
    return _world(tmp_path_factory, inp, {
        "npz_1": ("fit", {**fit_kw, "mesh": [2, 2], "steps": 1, "out_dir": str(runs / "npz")}),
        "npz_3": ("fit", {**fit_kw, "mesh": [WORLD, 1], "steps": 1, "cfg": resumed,
                          "out_dir": str(runs / "npz"),
                          "resume": str(runs / "npz" / "checkpoint.npz")}),
        "dcp_1": ("fit", {**fit_kw, "mesh": [2, 2], "steps": 1, "out_dir": str(runs / "dcp"),
                          "ckpt_format": "orbax"}),
        "dcp_3": ("fit", {**fit_kw, "mesh": [2, 2], "steps": 1, "cfg": resumed,
                          "out_dir": str(runs / "dcp"), "ckpt_format": "orbax",
                          "resume": str(runs / "dcp" / "orbax")}),
        "dist_ckpt": ("dist_ckpt", {"mesh": [2, 2], "directory": str(runs / "sharded")})})


@pytest.mark.parametrize("microbatch", [0, 4], ids=["whole", "two_pass"])
def test_sharded_step_matches_dirjax(inputs, step_world, microbatch):
    """One SGD step at (data 2, db 2) against dirjax's make_sharded_train_step
    on make_mesh(2, 2): loss within 1e-5, parameters within rtol 2e-4 /
    atol 2e-5; the FC gathered back is whole."""
    inp, outs = inputs[0], step_world
    cfg = JT.TrainConfig(**STEP, microbatch=microbatch)
    jmodel = jcreate("resnet18_rmac", out_dim=64)
    params = _jax_params({k[5:]: v for k, v in inp.items() if k.startswith("step/")},
                         "resnet18_rmac", 64)
    mesh = jmake_mesh(2, 2, devices=jax.devices()[:4])
    tx = JT.make_optimizer(cfg, params)
    step, shard_args = JT.make_sharded_train_step(jmodel, cfg, tx, mesh)
    p, o, x, y = shard_args(params, tx.init(params), jnp.asarray(inp["images"]),
                            jnp.asarray(inp["labels"]))
    new, _, loss = step(p, o, x, y)
    got = outs["step_mb" if microbatch else "step"]
    assert abs(float(got["loss"][0]) - float(loss)) <= 1e-5
    assert got["sd/fc.weight"].shape == (64, 512)
    _same_params(_sd(got), new, "resnet18_rmac", 64)


def test_global_loss_is_not_a_per_rank_loss(step_world):
    """What is held: the listwise loss over the global batch. Each rank's
    loss over its own rows, averaged as a data-parallel wrapper takes it,
    is another number on the same batch."""
    outs = step_world
    got = outs["per_rank"]
    assert abs(float(got["global"][0]) - float(outs["step"]["loss"][0])) <= 1e-6
    assert abs(float(got["per_rank_mean"][0]) - float(got["global"][0])) > 1e-3


@pytest.fixture(scope="module")
def jfits(labeled, inputs):
    """dirjax's fit from the same weights, whole-batch (2 steps) and two-pass
    (1 step)."""
    inp = inputs[0]
    params = _jax_params({k[6:]: v for k, v in inp.items() if k.startswith("start/")},
                         "resnet18_rmac", 32)
    data = JD.ImageListLabels(f"{labeled}/train.txt", root=labeled)
    whole = JT.fit(data, JT.TrainConfig(epochs=1, **FIT), params=params, steps_per_epoch=2)
    two = JT.fit(data, JT.TrainConfig(epochs=1, microbatch=4, **FIT), params=params,
                 steps_per_epoch=1)
    return whole, two


@pytest.mark.parametrize("name", ["fit", "fit_mb"])
def test_mesh_fit_matches_dirjax(fit_world, jfits, name):
    """test_mesh_training.py: the mesh fit's loss and final weights against
    dirjax's fit (whole-batch and two-pass)."""
    outs = fit_world
    _, params, hist = jfits[name == "fit_mb"]
    got = outs[name]
    assert got["epochs"].tolist() == [0]
    np.testing.assert_allclose(got["losses"], [h["loss"] for h in hist], rtol=1e-4, atol=1e-5)
    _same_params(_sd(got), params, "resnet18_rmac", 32)


def test_mesh_fit_checkpoints_and_resume(inputs, ckpt_world):
    """npz written by rank 0 with the whole FC, resumed on a (4, 1) mesh;
    a sharded checkpoint directory resumed on (2, 2): both run epochs 1 and
    2 and end with the same weights; the directory keeps the newest 2 steps."""
    outs, runs = ckpt_world, inputs[1]
    assert os.path.exists(runs / "npz" / "checkpoint.npz")
    assert outs["npz_3"]["epochs"].tolist() == outs["dcp_3"]["epochs"].tolist() == [1, 2]
    np.testing.assert_allclose(outs["npz_1"]["losses"], outs["dcp_1"]["losses"], rtol=1e-6)
    for k, v in _sd(outs["npz_3"]).items():
        np.testing.assert_allclose(_sd(outs["dcp_3"])[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    with TrainCheckpointer(str(runs / "dcp" / "orbax")) as ck:
        assert ck.all_steps() == [1, 2]
        assert ck.read_extra()["epoch"] == 2


def test_mesh_batch_divisibility_asserted(fit_world):
    assert "data axis" in str(fit_world["divisible"]["error"])


def test_sharded_checkpoint_restores_onto_shards(ckpt_world):
    """A DTensor sharded over "db" restores only this rank's rows, and into
    a plain tensor as the whole array."""
    out = ckpt_world["dist_ckpt"]
    assert out["local_ok"].tolist() == [True]
    np.testing.assert_array_equal(out["whole"], np.arange(64.0).reshape(8, 8))
    assert out["step"].tolist() == [7] and out["epoch"].tolist() == [0]
    assert out["steps"].tolist() == [0]


def test_resume_a_mesh_checkpoint_on_one_device(inputs, ckpt_world, labeled, tmp_path):
    """The sharded steps a (2, 2) mesh wrote resume in a single-process fit
    (the FC rows land in one tensor), at the mesh run's weights."""
    outs, runs = ckpt_world, inputs[1]
    import shutil

    ckdir = str(tmp_path / "orbax")
    shutil.copytree(runs / "dcp" / "orbax", ckdir)
    data = ImageListLabels(f"{labeled}/train.txt", root=labeled)
    model, hist = TT.fit(data, TT.TrainConfig(**dict(FIT, epochs=3)), steps_per_epoch=1,
                         resume=ckdir, device="cpu")
    assert hist == []          # epoch 2 is done: nothing left to run, weights restored
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), _sd(outs["dcp_3"])[k], err_msg=k)


# --- TrainCheckpointer in one process -----------------------------------------

def test_checkpointer_roundtrip_retention_and_errors(tmp_path):
    """dirjax's test_orbax_ckpt.py cases: params, optimizer state and extra
    round-trip exactly (a bf16 leaf keeps its dtype); the newest
    max_to_keep steps remain; an empty directory has nothing to restore."""
    params = {"conv.w": torch.arange(12.0).reshape(3, 4), "fc": torch.ones(4, dtype=torch.bfloat16)}
    opt = {"state/conv.w/exp_avg": torch.full((3, 4), 0.5), "step_count": torch.tensor(3)}
    with TrainCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(0, params, opt, extra={"epoch": 0, "best": 0.25, "arch": "r18"})
        ck.wait()
        p2, o2, ex = ck.restore({k: torch.zeros_like(v) for k, v in params.items()},
                                {k: torch.zeros_like(v) for k, v in opt.items()})
    for k in params:
        assert torch.equal(p2[k], params[k]) and p2[k].dtype == params[k].dtype
    for k in opt:
        assert torch.equal(o2[k], opt[k])
    assert ex == {"epoch": 0, "best": 0.25, "arch": "r18"}
    assert is_checkpoint_dir(str(tmp_path / "ck")) and not is_checkpoint_dir(str(tmp_path))

    with TrainCheckpointer(str(tmp_path / "keep"), max_to_keep=2) as ck:
        for step in range(4):
            ck.save(step, {"w": torch.full((2,), float(step))})
        ck.wait()
        assert ck.latest_step() == 3 and ck.all_steps() == [2, 3]
        p, _, ex = ck.restore({"w": torch.zeros(2)}, step=2)
    assert p["w"].tolist() == [2.0, 2.0] and ex == {}

    with TrainCheckpointer(str(tmp_path / "empty"), async_save=False) as ck:
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            ck.restore({"w": torch.zeros(2)})


def test_fit_orbax_format_resume_and_refusals(labeled, tmp_path):
    """fit(ckpt_format="orbax") in one process, resumed from its directory
    for exactly the remaining epochs; a wrong arch is refused, and so is a
    directory of dirjax's orbax checkpoints, by name."""
    from dirjax.utils.orbax_ckpt import TrainCheckpointer as JCheckpointer

    data = ImageListLabels(f"{labeled}/train.txt", root=labeled)
    out = str(tmp_path / "run")
    TT.fit(data, TT.TrainConfig(**dict(FIT, epochs=1)), out_dir=out, steps_per_epoch=1,
           ckpt_format="orbax", device="cpu")
    ckdir = os.path.join(out, "orbax")
    assert is_checkpoint_dir(ckdir)
    _, hist = TT.fit(data, TT.TrainConfig(**dict(FIT, epochs=3)), out_dir=out,
                     steps_per_epoch=1, ckpt_format="orbax", resume=ckdir, device="cpu")
    assert [h["epoch"] for h in hist] == [1, 2] and np.isfinite([h["loss"] for h in hist]).all()
    with TrainCheckpointer(ckdir) as ck:
        assert ck.latest_step() == 2
    with pytest.raises(ValueError, match="resume arch"):
        TT.fit(data, TT.TrainConfig(**dict(FIT, arch="resnet50_rmac", epochs=4)),
               resume=ckdir, device="cpu")
    jdir = str(tmp_path / "jax_orbax")
    with JCheckpointer(jdir, async_save=False) as ck:
        ck.save(0, {"w": jnp.zeros(2)}, extra={"epoch": 0, "arch": FIT["arch"]})
    with pytest.raises(ValueError, match="orbax checkpoints written by dirjax"):
        TT.fit(data, TT.TrainConfig(**dict(FIT, epochs=2)), resume=jdir, device="cpu")


# --- the CLI --------------------------------------------------------------------

def _cli_args(labeled, out, *extra):
    return ["--dataset", f"ImageListLabels('{labeled}/train.txt', root='{labeled}')",
            "--arch", "resnet18_rmac", "--out-dim", "32", "--epochs", "1",
            "--batch-size", "8", "--steps-per-epoch", "1", "--optimizer", "sgd",
            "--trfs", "Scale(36), CenterCrop(32)", "--threads", "2", "--gpu", "-1",
            "--out-dir", out, *extra]


@pytest.mark.parametrize("mesh,fmt", [("2", "npz"), ("1,2", "orbax")])
def test_cli_mesh_under_torchrun(labeled, tmp_path, mesh, fmt):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    dirjax_torch.train ... --mesh M --gpu -1``: DP, then TP with sharded
    checkpoints; both ranks print the same finite loss."""
    out = str(tmp_path / "cli")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "dirjax_torch.train",
           *_cli_args(labeled, out, "--mesh", mesh, "--ckpt-format", fmt)]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    # the ranks share one stdout, so their lines may interleave
    losses = re.findall(r"epoch 0: loss (\d+\.\d{4})", res.stdout)
    assert len(losses) == 2 and len(set(losses)) == 1, res.stdout[-2000:]
    assert np.isfinite(float(losses[0]))
    if fmt == "npz":
        assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    else:
        with TrainCheckpointer(os.path.join(out, "orbax")) as ck:
            assert ck.latest_step() == 0


def test_cli_mesh_world_of_one(labeled, tmp_path):
    """Without a torchrun environment, --mesh 1,1 runs a world of 1 and
    leaves no process group behind."""
    import torch.distributed as dist

    from dirjax_torch.cli.train import main

    hist = main(_cli_args(labeled, str(tmp_path / "one"), "--mesh", "1,1"))
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert not dist.is_initialized()
