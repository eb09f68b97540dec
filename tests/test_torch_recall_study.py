"""dirjax_torch's recall study (``dirjax_torch/recall_study.py``) held against
the repository's ``recall_study.py`` on the CPU, on the same inputs.

* Render: the factors are drawn with the jax keys ``_scene_batch`` and
  ``_query_views`` use and fed to the port's renderers; the images agree
  within 1e-5 (fp32 transcendentals of another library).
* One ``train`` step on the same batch and weights (resnet18_rmac, 64x64,
  batch 8, 4 views): fp32 loss and every tensor after the update within
  1e-5, BN running statistics included (dirjax's ``optax.adam`` updates
  every leaf, so a port that froze them would sit a step of lr = 1e-4 away);
  the bf16 loss within 1e-2.
* ``extract --cpu``: descriptors of the same images and weights at cosine
  >= 0.999 to dirjax's bf16 ``apply_descriptor``; dirjax's npz keys, shapes
  and ``src``; the non-finite gate.
* ``evaluate --cpu`` against dirjax's ``evaluate`` on one seeded file,
  one case per tier group, both grading on dirjax's whitened rows (the
  port's own whitening is held to dirjax's apart, within ``WHITEN_TOL``:
  its fp32 Gram sums in another order, which flips int8 roundings by
  machine). Both packages draw their k-means rows from
  generators that cannot agree, so the cases pin both to one initial draw
  (the first rows), as ``test_torch_pq.py`` shares an ``init``. Spectrum
  within 1e-4, ``rank_for_99pct`` and ``src_is_top1`` equal; recall equal
  on the int8, PQ, IVF and PCA-256 tiers and the tuners' params equal; OPQ
  and ITQ within ``SVD_TOL`` (see there).
* The port's own: ``--seed`` and ``--scene-shift``, whose defaults are
  dirjax's fixed values; the indexes ``evaluate`` hands out; TF32 off
  inside a stage and the caller's flags after it.

torch runs on one thread. dirjax's kernels run in interpret mode.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dirjax.train as JT
from dirjax.models import create_model as jcreate
from dirjax.models.rmac import apply_descriptor
from dirjax_torch import recall_study as RS
from dirjax_torch import train as TT
from dirjax_torch.models import create_model as tcreate
from dirjax_torch.models import init_weights
from dirjax_torch.utils.checkpoints import (jax_params_from_state_dict, load_state,
                                            state_dict_from_jax_params)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import recall_study as JR  # noqa: E402

torch.set_num_threads(1)

# OPQ's rotation comes from SVDs (dirjax's fp32, the port's fp64) and ITQ's
# from a random initial rotation neither package can draw as the other does:
# the two learn different rotations of equal quality. On the evaluate file
# the port's own OPQ and ITQ recall moves by under 0.05 between seeds 0..4
# (test_svd_tiers_seed_spread), so a recall within 0.1 is "of equal
# quality", and a broken tier (recall near chance, 0.03 at k = 10 there) is
# far outside it.
SVD_TOL = 0.1
SVD_TIERS = ("opq", "itq")


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# scene synthesis
# --------------------------------------------------------------------------

def _jax_scene_factors(key, n, h, w):
    """The draws of dirjax's ``_scene_batch(key, n, h, w)``."""
    ks = jax.random.split(key, 8)
    u = jax.random.uniform
    return RS.SceneFactors(
        g=_t(u(ks[0], (n, 1, 1, 3, 3))),
        bc=_t(u(ks[1], (n, 8, 2))),
        bs=_t(u(ks[2], (n, 8, 1), minval=0.02, maxval=0.15)),
        bcol=_t(u(ks[3], (n, 8, 3), minval=-0.8, maxval=0.8)),
        th=_t(u(ks[4], (n, 1, 1, 1), maxval=np.pi)),
        fr=_t(u(ks[6], (n, 1, 1, 1), minval=4.0, maxval=40.0)),
        ph=_t(u(ks[5], (n, 1, 1, 1), maxval=2 * np.pi)),
        noise=_t(jax.random.normal(ks[7], (n, h, w, 3))))


def _jax_view_factors(key, n):
    """The draws of dirjax's ``_query_views(key, imgs)``."""
    ks = jax.random.split(key, 5)
    scale = jax.random.uniform(ks[0], (n,), minval=0.82, maxval=0.96)
    return RS.ViewFactors(
        scale=_t(scale),
        oy=_t(jax.random.uniform(ks[1], (n,)) * (1.0 - scale)),
        ox=_t(jax.random.uniform(ks[2], (n,)) * (1.0 - scale)),
        bright=_t(jax.random.uniform(ks[4], (n, 1, 1, 1), minval=0.9, maxval=1.1)))


def test_render_matches_dirjax():
    n, h, w = 4, 64, 48
    key, qkey = jax.random.PRNGKey(1000), jax.random.PRNGKey(5000)
    want = np.asarray(JR._scene_batch(key, n, h, w))
    got = RS.render_scenes(_jax_scene_factors(key, n, h, w), h, w)
    assert got.shape == (n, h, w, 3) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5
    want_q = np.asarray(JR._query_views(qkey, jnp.asarray(want)))
    got_q = RS.render_query_views(_t(want), _jax_view_factors(qkey, n))
    assert np.abs(got_q.numpy() - want_q).max() <= 1e-5
    assert np.abs(want_q - want).max() > 0.1      # the views are not the scenes


def test_draws_are_seeded_and_classes_fixed():
    a = RS.db_scenes(3, 2, 32, 24, "cpu")
    assert torch.equal(a, RS.db_scenes(3, 2, 32, 24, "cpu"))
    assert not torch.equal(a, RS.db_scenes(4, 2, 32, 24, "cpu"))
    f = RS.draw_scene_factors(64, 8, 8, torch.Generator().manual_seed(0))
    # th, fr and ph are three independent draws (dirjax's r4 fix)
    th, fr, ph = (x.flatten() for x in (f.th / math.pi, (f.fr - 4) / 36, f.ph / (2 * math.pi)))
    assert max(abs(float(np.corrcoef(a_, b_)[0, 1]))
               for a_, b_ in ((th, fr), (th, ph), (fr, ph))) < 0.5
    # a class's base scene is the same at every step; its views are not
    v0 = RS.class_views(0, [5, 9], 2, 32, 32, "cpu")
    v1 = RS.class_views(1, [9], 2, 32, 32, "cpu")
    assert v0.shape == (4, 32, 32, 3) and not torch.equal(v0[2:], v1)
    base = RS.render_scenes(RS.draw_scene_factors(
        1, 32, 32, torch.Generator().manual_seed((RS.CLASS_SEED << 32) | 9)), 32, 32)
    ident = RS.ViewFactors(scale=torch.ones(1), oy=torch.zeros(1), ox=torch.zeros(1),
                           bright=torch.ones(1, 1, 1, 1))
    assert torch.allclose(RS.render_query_views(base, ident), base, atol=1e-6)


# --------------------------------------------------------------------------
# train: one step against dirjax's (plain Adam on every leaf)
# --------------------------------------------------------------------------

LR = 1e-4


def _weights(arch, seed, out_dim=None):
    """(port model, dirjax model, dirjax params) with the port's seeded init."""
    kw = {} if out_dim is None else {"out_dim": out_dim}
    model = init_weights(tcreate(arch, **kw), torch.Generator().manual_seed(seed))
    jmodel = jcreate(arch, **kw)
    return model, jmodel, jax_params_from_state_dict(model.state_dict(), model.cfg)


def _step_pair(dtype):
    """One study step of each package on the same batch and weights:
    (dirjax loss, dirjax state dict after, dirjax gradients, port loss, port
    model after, port gradients, state dict before); the gradients are read
    from each Adam's first moment, (1 - beta1) * g after one step."""
    model, jmodel, params = _weights("resnet18_rmac", 0)
    before = state_dict_from_jax_params(params, model.cfg)
    cls = np.random.default_rng(0).integers(0, 256, size=2)
    images = RS.class_views(0, cls, 4, 64, 64, "cpu").numpy()
    labels = np.repeat(cls, 4)
    jcfg = JT.TrainConfig(arch="resnet18_rmac", loss="ap", batch_size=8, image_size=64,
                          learning_rate=LR, seed=0)
    tx = optax.adam(LR)
    jstep = JT.make_train_step(jmodel, jcfg, tx, dtype=jnp.float32 if dtype == "fp32"
                               else jnp.bfloat16)
    new, state, jloss = jstep(params, tx.init(params), jnp.asarray(images),
                              jnp.asarray(labels))
    jgrad = state_dict_from_jax_params(jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                                    state[0].mu), model.cfg)
    tcfg = TT.TrainConfig(arch="resnet18_rmac", loss="ap", batch_size=8, image_size=64,
                          learning_rate=LR, seed=0)
    model.train()
    opt = RS.study_optimizer(model, LR)
    step = TT.make_train_step(model, tcfg, opt,
                              dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)
    tloss = float(step(images, labels))
    tgrad = {k: opt.state[p]["exp_avg"] / 0.1 for k, p in model.named_parameters()}
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, new), model.cfg)
    return float(jloss), want, jgrad, tloss, model, tgrad, before


def test_train_step_matches_dirjax_fp32():
    """Loss within 1e-5; every tensor, BN statistics included, trained by
    plain Adam as dirjax's: gradients within 1e-6, and each element after
    the step within 1e-5 wherever either gradient reaches 1e-6. Below that
    the first Adam step, lr * g / (|g| + 1e-8), follows fp32 summation noise
    (one element of 147,456 in a conv moved 2.8e-5 apart at |g| ~ 1e-8); there
    the two agree within the step's own bound, 2 lr."""
    jloss, want, jgrad, tloss, model, tgrad, before = _step_pair("fp32")
    assert abs(tloss - jloss) <= 1e-5
    sd = model.state_dict()
    assert sd.keys() == want.keys() == tgrad.keys()
    noisy = 0
    for k in sd:
        got, exp = sd[k].numpy(), np.asarray(want[k])
        gt, gj = tgrad[k].numpy(), np.asarray(jgrad[k])
        np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-6, err_msg=k)
        firm = np.maximum(np.abs(gt), np.abs(gj)) >= 1e-6
        np.testing.assert_allclose(got[firm], exp[firm], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, exp, rtol=0, atol=2 * LR, err_msg=k)
        noisy += int((np.abs(got - exp) > 1e-5).sum())
    assert noisy <= 10
    # the BN statistics are trained leaves: they moved, as dirjax's did
    for k in ("bn1.running_mean", "bn1.running_var", "layer3.0.downsample.1.running_var"):
        assert not torch.equal(sd[k], torch.as_tensor(np.asarray(before[k]))), k
        assert not np.array_equal(np.asarray(want[k]), np.asarray(before[k])), k


def test_train_step_bf16_loss():
    jloss, _, _, tloss, _, _, _ = _step_pair("bf16")
    assert abs(tloss - jloss) <= 1e-2


def test_train_stage_saves_a_checkpoint_dirjax_reads(tmp_path):
    from dirjax.utils.checkpoints import load_native as jload

    out = str(tmp_path / "ck.npz")
    res = RS.main(["train", "--cpu", "--arch", "resnet18_rmac", "--steps", "2",
                   "--batch", "4", "--views", "2", "--n-classes", "8", "--size", "32",
                   "--out", out])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    ck = jload(out)
    assert ck.model.arch == "resnet18_rmac"
    assert ck.extra["steps"] == 2 and ck.extra["n_classes"] == 8
    assert ck.extra["loss_last25"] == round(sum(res["losses"]) / 2, 4)


def test_train_seed_picks_the_initial_weights(tmp_path):
    """``--seed`` (dirjax fixes 0) draws the initial weights: the same seed
    trains the same model, another seed another."""
    def run(seed, name):
        out = str(tmp_path / name)
        RS.main(["train", "--cpu", "--arch", "resnet18_rmac", "--steps", "1", "--batch", "4",
                 "--views", "2", "--n-classes", "8", "--size", "32", "--seed", str(seed),
                 "--out", out])
        return np.load(out)

    a, again, other = run(0, "a.npz"), run(0, "b.npz"), run(1, "c.npz")
    weights = [k for k in a.files if k.endswith("/conv1")]
    assert weights
    for k in weights:
        np.testing.assert_array_equal(a[k], again[k])
        assert not np.array_equal(a[k], other[k]), k


# --------------------------------------------------------------------------
# extract
# --------------------------------------------------------------------------

EXTRACT = ["--arch", "resnet18_rmac", "--n-db", "32", "--n-q", "16", "--batch", "16",
           "--size", "64"]


def test_extract_matches_dirjax(tmp_path):
    out = str(tmp_path / "t.npz")
    RS.main(["extract", "--cpu", *EXTRACT, "--out", out])
    got = np.load(out)
    jout = str(tmp_path / "j.npz")
    JR.main(["extract", "--cpu", *EXTRACT, "--out", jout])
    want = np.load(jout)
    assert sorted(got.files) == sorted(want.files) == ["db", "q", "src"]
    for k in got.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["src"], want["src"])
    # the same images and weights through dirjax's bf16 forward
    model, jmodel, params = _weights("resnet18_rmac", 7)
    imgs = [RS.db_scenes(i, 16, 64, 64, "cpu") for i in range(2)]
    q = RS.query_views(0, imgs[0])
    fwd = jax.jit(lambda p, x: apply_descriptor(p, x, jmodel.config, dtype=jnp.bfloat16))
    for mine, x in ((got["db"], torch.cat(imgs)), (got["q"], q)):
        ref = np.asarray(fwd(params, jnp.asarray(x.numpy())))
        cos = (mine * ref).sum(1) / (np.linalg.norm(mine, axis=1) * np.linalg.norm(ref, axis=1))
        assert cos.min() >= 0.999, cos.min()


def test_extract_seed_and_scene_shift(tmp_path):
    """dirjax's fixed values are the defaults; ``--scene-shift 1`` moves every
    generator seed by one (its first batch is the default's second) and
    ``--seed`` draws other random weights."""
    def run(name, *flags):
        out = str(tmp_path / name)
        RS.main(["extract", "--cpu", *EXTRACT, *flags, "--out", out])
        return np.load(out)

    default = run("d.npz")
    np.testing.assert_array_equal(run("e.npz", "--seed", "7", "--scene-shift", "0")["db"],
                                  default["db"])
    shifted = run("s.npz", "--scene-shift", "1")
    np.testing.assert_array_equal(shifted["db"][:16], default["db"][16:])
    np.testing.assert_array_equal(shifted["src"], default["src"])
    assert not np.allclose(shifted["q"], default["q"])
    assert not np.allclose(run("w.npz", "--seed", "8")["db"], default["db"])


def test_extract_gate_refuses_nonfinite(tmp_path, monkeypatch):
    from dirjax_torch.models import RMACDescriptor

    real = RMACDescriptor.forward
    monkeypatch.setattr(RMACDescriptor, "forward",
                        lambda self, *a, **kw: real(self, *a, **kw) * torch.nan)
    with pytest.raises(RuntimeError, match="non-finite"):
        RS.main(["extract", "--cpu", *EXTRACT, "--out", str(tmp_path / "d.npz")])
    assert not (tmp_path / "d.npz").exists()


@pytest.mark.parametrize("stage", [["train"], ["extract"], ["evaluate"]])
def test_stages_refuse_without_cuda(stage, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda, which is not available"):
        RS.main(stage + ["--out", str(tmp_path / "x")])


# --------------------------------------------------------------------------
# evaluate
# --------------------------------------------------------------------------

N, D, NQ = 320, 288, 32


@pytest.fixture(scope="module")
def descs(tmp_path_factory):
    """Clustered rows (40 centres) and noisy copies of the first NQ as
    queries, seeded."""
    rng = np.random.default_rng(0)
    centres = rng.normal(size=(N // 8, D)).astype(np.float32)
    db = centres[rng.integers(0, len(centres), N)] + 0.5 * rng.normal(size=(N, D))
    q = db[:NQ] + 0.1 * rng.normal(size=(NQ, D))
    path = str(tmp_path_factory.mktemp("recall") / "descs.npz")
    np.savez(path, db=db.astype(np.float32), q=q.astype(np.float32), src=np.arange(NQ))
    return path


@pytest.fixture
def first_rows(monkeypatch):
    """Both packages' k-means start from the same rows: the first ones."""
    import dirjax_torch.ops.ivf as tivf
    import dirjax_torch.ops.pq as tpq

    def first(x, count, g):
        return torch.arange(count, device=x.device)

    monkeypatch.setattr(tpq, "_sample_rows", first)
    monkeypatch.setattr(tivf, "_sample_rows", first)
    monkeypatch.setattr(jax.random, "choice",
                        lambda key, n, shape, replace=True: jnp.arange(shape[0]))


@pytest.fixture
def dirjax_whitening(monkeypatch):
    """The port's ``evaluate`` whitens its rows with dirjax's PCA fit and
    ``apply_whitening`` on the same rows, so both packages grade their tiers
    on identical whitened descriptors; its PCA (the spectrum it reports) is
    still its own fit. The port's study whitening is held to dirjax's apart
    (``test_study_whitening_matches_dirjax``): the two fp32 Gram matrices sum
    in different orders, and one int8 rounding flipped by that moves a
    recall graded at tolerance 0.0."""
    from dirjax.ops.whitening import apply_whitening, fit_pca_device

    own = RS.study_whitening

    def study_whitening(raw_db):
        pca, _ = own(raw_db)
        jpca = fit_pca_device(raw_db.cpu().numpy())

        def whiten(x, whitenv=None):
            return torch.from_numpy(np.array(apply_whitening(
                x.cpu().numpy(), jpca, whitenp=0.5, whitenv=whitenv,
                dead_floor=1e-7))).to(x.device)

        return pca, whiten

    monkeypatch.setattr(RS, "study_whitening", study_whitening)


GROUPS = ["int8", "pq_m|opq", "pca256", "ivf|tuner", "itq512|itq2048"]


@pytest.mark.parametrize("group", GROUPS)
def test_evaluate_matches_dirjax(descs, first_rows, dirjax_whitening, group, tmp_path):
    JR.main(["evaluate", "--descs", descs, "--out", str(tmp_path / "j.json"),
             "--tiers", group])
    want = json.load(open(tmp_path / "j.json"))
    got = RS.main(["evaluate", "--cpu", "--descs", descs, "--out", str(tmp_path / "t.json"),
                   "--tiers", group])
    assert json.load(open(tmp_path / "t.json")) == got
    assert {k: got[k] for k in ("n_db", "dim", "n_q", "src_is_top1")} == \
        {k: want[k] for k in ("n_db", "dim", "n_q", "src_is_top1")}
    assert got["spectrum"].keys() == want["spectrum"].keys()
    assert got["spectrum"]["rank_for_99pct"] == want["spectrum"]["rank_for_99pct"]
    for k, v in got["spectrum"].items():
        assert abs(v - want["spectrum"][k]) <= 1e-4, k
    assert got["tiers"].keys() == want["tiers"].keys() and got["tiers"]
    for name, row in got["tiers"].items():
        assert row.keys() == want["tiers"][name].keys(), name
        assert row.get("note") == want["tiers"][name].get("note")
        tol = SVD_TOL if any(t in name for t in SVD_TIERS) else 0.0
        for k, v in row.items():
            if k.startswith("recall@"):
                assert abs(v - want["tiers"][name][k]) <= tol, (name, k, v,
                                                               want["tiers"][name][k])
    tuners = sorted(k for k in got if k.startswith("tuner"))
    assert tuners == sorted(k for k in want if k.startswith("tuner"))
    for t in tuners:
        assert got[t]["params"] == want[t]["params"] and got[t]["index"] == want[t]["index"]
        assert got[t]["met"] == want[t]["met"]
        assert got[t]["tune_recall"] == want[t]["tune_recall"]


#: the port's study whitening against dirjax's on the evaluate file's rows
#: (whitened rows are unit length, elements up to 0.42): the fp32 Gram
#: matrices of the two fits sum in different orders, and var^-0.5 magnifies
#: that on the smallest axes (variance 9e-4 against 0.9 at the top) about
#: 33x; measured 1.6e-4 at most on this CPU. With dirjax's PCA in both,
#: the rows are 2.6e-6 apart; a wrong whitening power or a missing
#: dead_floor moves them by 1e-2 and more.
WHITEN_TOL = 5e-4


def test_study_whitening_matches_dirjax(descs):
    """``study_whitening`` (the port's fit on the rows' device, whitenp 0.5,
    dead_floor 1e-7) against dirjax's ``fit_pca_device`` and
    ``apply_whitening``, full-dim and whitenv = 256, database and queries,
    within WHITEN_TOL; the variances within 1e-6 of each other."""
    from dirjax.ops.whitening import apply_whitening, fit_pca_device

    data = np.load(descs)
    pca, whiten = RS.study_whitening(torch.from_numpy(data["db"]))
    jpca = fit_pca_device(data["db"])
    np.testing.assert_allclose(np.asarray(pca.variance), np.asarray(jpca.variance),
                               rtol=0, atol=1e-6)
    for whitenv in (None, 256):
        for k in ("db", "q"):
            got = whiten(torch.from_numpy(data[k]), whitenv).numpy()
            want = np.asarray(apply_whitening(data[k], jpca, whitenp=0.5, whitenv=whitenv,
                                              dead_floor=1e-7))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=WHITEN_TOL,
                                       err_msg=f"{k}, whitenv {whitenv}")


def test_svd_tiers_seed_spread(descs):
    """The ground of SVD_TOL: the port's OPQ and ITQ recall@k over seeds 0..4
    on the evaluate file spreads by at most SVD_TOL / 2."""
    from dirjax_torch.ops.whitening import apply_whitening, fit_pca_device
    from dirjax_torch.serving import BinaryIndex, PQIndex
    from dirjax_torch.tuning import exact_ground_truth, recall_at_k

    data = np.load(descs)
    db, q = torch.from_numpy(data["db"]), torch.from_numpy(data["q"])
    pca = fit_pca_device(db, device="cpu")
    db, q = (apply_whitening(x, pca, dead_floor=1e-7) for x in (db, q))
    gt = {k: exact_ground_truth(q.numpy(), db.numpy(), k) for k in (1, 10, 100)}
    builds = {"opq": lambda s: PQIndex(db, m=32, ksub=16, opq=True, seed=s, train_iters=10,
                                       device="cpu"),
              "itq_asym": lambda s: BinaryIndex(db, n_bits=D, seed=s, device="cpu")}
    for name, build in builds.items():
        rec = np.array([[recall_at_k(idx.search(q, k=k)[1], gt[k]) for k in gt]
                        for idx in map(build, range(5))])
        assert (rec.max(0) - rec.min(0)).max() <= SVD_TOL / 2, (name, rec)


def test_evaluate_hands_out_the_indexes_it_graded(descs, tmp_path):
    """``graded`` receives every graded tier's index, queries and knobs: a
    search with them gives the recall the tier was graded at."""
    from dirjax_torch.tuning import exact_ground_truth, recall_at_k

    graded = {}
    res = RS.main(["evaluate", "--cpu", "--descs", descs, "--out", str(tmp_path / "o.json"),
                   "--tiers", "int8|pca256|ivf256|itq512"], graded=graded)
    assert set(graded) == set(res["tiers"]) and len(graded) == 10
    assert graded["int8_w8q"][2] == {"int8_queries": True}
    data = np.load(descs)
    _, whiten = RS.study_whitening(torch.from_numpy(data["db"]))
    db, q = (whiten(torch.from_numpy(data[k])).numpy() for k in ("db", "q"))
    for k in (1, 10, 100):
        gt = exact_ground_truth(q, db, k)
        for name, (index, queries, knobs) in graded.items():
            got = recall_at_k(index.search(queries, k=k, **knobs)[1], gt)
            assert round(got, 4) == res["tiers"][name][f"recall@{k}"], (name, k)


def test_stages_restore_the_tf32_flags(descs, tmp_path, monkeypatch):
    """A stage runs with TF32 off and leaves the caller's flags as they
    were."""
    real, seen = RS._device, []

    def device(args):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real(args)

    monkeypatch.setattr(RS, "_device", device)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        RS.main(["evaluate", "--cpu", "--descs", descs, "--out", str(tmp_path / "o.json"),
                 "--tiers", "^int8$"])
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert seen == [(False, False)] and after == (True, True)


def test_evaluate_section_and_incremental_merge(descs, tmp_path):
    """--section nests; --tiers regrades the matching tiers of a section and
    keeps its others."""
    out = str(tmp_path / "o.json")
    RS.main(["evaluate", "--cpu", "--descs", descs, "--out", out, "--section", "flat",
             "--tiers", "int8"])
    first = json.load(open(out))["flat"]
    assert set(first["tiers"]) == {"int8", "int8_w8q"}
    assert first["tiers"]["int8"]["recall@1"] >= 0.8
    RS.main(["evaluate", "--cpu", "--descs", descs, "--out", out, "--section", "trained",
             "--tiers", "^int8$"])
    RS.main(["evaluate", "--cpu", "--descs", descs, "--out", out, "--section", "flat",
             "--tiers", "^int8$"])
    doc = json.load(open(out))
    assert set(doc) == {"flat", "trained"}
    assert doc["flat"]["tiers"] == first["tiers"]
    assert set(doc["trained"]["tiers"]) == {"int8"}


def test_evaluate_gate_refuses_meaningless_descriptors(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "garbage.npz")
    np.savez(path, db=rng.normal(size=(64, 32)).astype(np.float32),
             q=rng.normal(size=(8, 32)).astype(np.float32), src=np.arange(8))
    with pytest.raises(RuntimeError, match="src_is_top1"):
        RS.main(["evaluate", "--cpu", "--descs", path, "--out", str(tmp_path / "o.json"),
                 "--tiers", "int8"])
    assert not (tmp_path / "o.json").exists()
