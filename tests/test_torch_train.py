"""dirjax_torch's training slice held against dirjax's on the CPU: the losses
and their gradients (ties included), the batch objectives, the learning-rate
schedules, the optimizers, one train step (whole-batch and two-pass, all
five losses, BN frozen or trained), a short ``fit``, checkpoints and resume,
dropout, and the train CLI.

Inputs are made from a seed with numpy; dirjax's parameters cross to the
port through ``state_dict_from_jax_params``. Tolerances, each stated where
it is used: loss values and their gradients within 1e-5 (fp32 sums in
another order); schedules within rtol 1e-7 plus base * 2**-22 (optax
evaluates them in fp32, the port in fp64); injected-
gradient optimizer steps within 1e-6; one train step within dirjax's own
two-pass bounds (loss 1e-5, parameters atol 1e-5 / rtol 1e-4); ``fit``'s
per-epoch losses within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dirjax.datasets as JD
import dirjax.loss as JL
import dirjax.train as JT
from dirjax.models import create_model as jcreate
from dirjax.models.rmac import apply_descriptor
from dirjax.utils.checkpoints import Checkpoint as JCheckpoint
from dirjax.utils.checkpoints import load_native as jload_native
from dirjax.utils.checkpoints import save_native as jsave_native
from dirjax_torch import loss as TL
from dirjax_torch import train as TT
from dirjax_torch.datasets import SyntheticLabels
from dirjax_torch.models import create_model as tcreate
from dirjax_torch.utils.checkpoints import (jax_params_from_state_dict, load_state,
                                            state_dict_from_jax_params)

torch.set_num_threads(1)

ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded(arch, out_dim, seed=0):
    """(dirjax model, its params as numpy): dirjax's initial distributions
    drawn by the port (``init_weights``) from a seeded generator, which
    spares jax's first-call compiles of its own init."""
    from dirjax_torch.models import init_weights

    model = init_weights(tcreate(arch, out_dim=out_dim), torch.Generator().manual_seed(seed))
    return jcreate(arch, out_dim=out_dim), jax_params_from_state_dict(model.state_dict(),
                                                                     model.cfg)


def _port_model(jmodel, params):
    """The port's model of ``jmodel``'s architecture with dirjax's weights."""
    model = tcreate(jmodel.arch, out_dim=jmodel.config.out_dim)
    return load_state(model, state_dict_from_jax_params(_np(params), model.cfg))


def _same_params(model, params, atol, rtol=0.0):
    got = jax.tree.leaves(jax_params_from_state_dict(model.state_dict(), model.cfg))
    want = jax.tree.leaves(_np(params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g).reshape(np.shape(w)), w,
                                   atol=atol, rtol=rtol)


def _grad(fn, *args):
    """Value and gradients of a scalar torch function w.r.t. each arg."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    val = fn(*ts)
    grads = torch.autograd.grad(val, ts)
    return float(val.detach()), [g.numpy() for g in grads]


# --- losses ---------------------------------------------------------------

def _tied_scores(rng, n=7, m=11, nq=25):
    """Scores in [-1, 1] with exact ties: +-1 (clip bounds and the end bins)
    and exact bin centres ``1 - 2i/(nq-1)``; labels with a row holding no
    positive."""
    x = rng.uniform(-1, 1, size=(n, m)).astype(np.float32)
    centres = (1.0 - 2.0 * np.arange(nq) / (nq - 1)).astype(np.float32)
    x[0, :4] = [1.0, -1.0, 1.0, -1.0]
    x[1, :6] = centres[[0, 3, 6, 12, 18, 24]]
    x[2] = 1.0
    label = (rng.random((n, m)) < 0.4).astype(np.float32)
    label[3] = 0.0                       # no positive: AP 0, not NaN
    label[0, :2] = 1.0
    return x, label


AP_LOSSES = {
    "ap": (JL.APLoss(nq=25, min=-1.0, max=1.0), TL.APLoss(nq=25, min=-1.0, max=1.0)),
    "ap_nq7_01": (JL.APLoss(nq=7), TL.APLoss(nq=7)),
    "tap": (JL.TAPLoss(nq=25, min=-1.0, max=1.0), TL.TAPLoss(nq=25, min=-1.0, max=1.0)),
    "taps": (JL.TAPLoss(nq=25, min=-1.0, max=1.0, simplified=True),
             TL.TAPLoss(nq=25, min=-1.0, max=1.0, simplified=True)),
    "ap_dist": (JL.APLoss_dist(nq=25, min=-1.0, max=1.0),
                TL.APLoss_dist(nq=25, min=-1.0, max=1.0)),
    "tap_dist": (JL.TAPLoss_dist(nq=25, min=-1.0, max=1.0),
                 TL.TAPLoss_dist(nq=25, min=-1.0, max=1.0)),
}


@pytest.mark.parametrize("name", sorted(AP_LOSSES))
@pytest.mark.parametrize("weighted", [False, True])
def test_ap_losses_and_gradients(name, weighted):
    """Value within 1e-5 of dirjax's and the gradient w.r.t. the scores
    within 1e-5 of jax.grad, at ties of the clip and the bins too."""
    jloss, tloss = AP_LOSSES[name]
    rng = np.random.default_rng(0)
    x, label = _tied_scores(rng)
    qw = rng.uniform(0.5, 1.5, size=len(x)).astype(np.float32) if weighted else None
    kw = {} if qw is None else {"qw": jnp.asarray(qw)}
    want, jgrad = jax.value_and_grad(lambda s: jloss(s, jnp.asarray(label), **kw))(
        jnp.asarray(x))
    tkw = {} if qw is None else {"qw": torch.from_numpy(qw)}
    got, (tgrad,) = _grad(lambda s: tloss(s, torch.from_numpy(label), **tkw), x)
    assert abs(got - float(want)) <= ATOL
    np.testing.assert_allclose(tgrad, np.asarray(jgrad), atol=ATOL, rtol=0)
    aps = tloss.ap(torch.from_numpy(x), torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(aps, np.asarray(jloss.ap(jnp.asarray(x), jnp.asarray(label))),
                               atol=ATOL)
    assert np.isfinite(aps).all() and aps[3] == 0.0   # no positive: AP 0


def test_ap_loss_api():
    """``ret='AP'``, ``measures`` and ``quantize_scores`` as dirjax's."""
    rng = np.random.default_rng(1)
    x, label = _tied_scores(rng)
    j, t = AP_LOSSES["ap"]
    np.testing.assert_allclose(
        t(torch.from_numpy(x), torch.from_numpy(label), ret="AP").numpy(),
        np.asarray(j(jnp.asarray(x), jnp.asarray(label), ret="AP")), atol=ATOL)
    assert t.measures(torch.from_numpy(x), torch.from_numpy(label)).keys() == {"loss_ap"}
    assert AP_LOSSES["taps"][1].measures(torch.from_numpy(x),
                                         torch.from_numpy(label)).keys() == {"loss_taps"}
    np.testing.assert_allclose(TL.quantize_scores(torch.from_numpy(x), 25, -1, 1).numpy(),
                               np.asarray(JL.quantize_scores(jnp.asarray(x), 25, -1, 1)),
                               atol=1e-6)
    with pytest.raises(ValueError, match="Bad return"):
        t(torch.from_numpy(x), torch.from_numpy(label), ret="mAP")


@pytest.mark.parametrize("cls,kw", [("TripletMarginLoss", {}),
                                    ("TripletMarginLoss", {"swap": True, "margin": 0.3}),
                                    ("TripletLogExpLoss", {}),
                                    ("TripletLogExpLoss", {"swap": True, "p": 1.0})])
def test_triplet_losses_and_gradients(cls, kw):
    """Value within 1e-5 and gradients w.r.t. anchor, positive and negative
    within 1e-5 of jax.grad; with the margin at 0.3 some triplets sit on
    the hinge's flat side."""
    rng = np.random.default_rng(2)
    a, p, n = (rng.normal(size=(9, 16)).astype(np.float32) * 0.3 for _ in range(3))
    jloss, tloss = getattr(JL, cls)(**kw), getattr(TL, cls)(**kw)
    want, jg = jax.value_and_grad(lambda *t: jloss(*t), argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n))
    got, tg = _grad(tloss, a, p, n)
    assert abs(got - float(want)) <= ATOL
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
    dp, dn = rng.uniform(0, 2, 5).astype(np.float32), rng.uniform(0, 2, 5).astype(np.float32)
    np.testing.assert_allclose(
        tloss.from_distances(torch.from_numpy(dp), torch.from_numpy(dn)).numpy(),
        np.asarray(jloss.from_distances(jnp.asarray(dp), jnp.asarray(dn))), atol=ATOL)
    assert tloss.eval_func(0.7, 0.2) == pytest.approx(jloss.eval_func(0.7, 0.2))
    np.testing.assert_allclose(TL.sim_to_dist(torch.tensor([0.3, -1.0, 1.0])).numpy(),
                               np.asarray(JL.sim_to_dist(jnp.asarray([0.3, -1.0, 1.0]))),
                               atol=1e-6)


def _exact_unit_rows(rng, n, d=16):
    """Unit rows of +-1/4 entries: every dot product k/8 is exact in any
    summation order, so duplicates score exactly 1.0 (the clip bound and
    bin 0's centre) on both sides."""
    return (rng.choice([-0.25, 0.25], size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("loss", ["ap", "tap", "taps", "triplet", "tripletlogexp"])
@pytest.mark.parametrize("multicrop", [False, True])
def test_batch_objectives(loss, multicrop):
    """make_batch_objective's value within 1e-5 and its gradient w.r.t. the
    descriptors within 1e-5 of jax.grad (absolute, or relative where it is
    large). Multi-crop batches repeat each row
    (crops_per_image = 2): exact duplicate scores of 1.0 and tied mining
    distances, where the clip and ``amax``/``amin`` split the gradient as
    jax does; a class with one member has no positive."""
    rng = np.random.default_rng(3)
    cfg = TT.TrainConfig(loss=loss, nq=25, margin=0.5)
    jcfg = JT.TrainConfig(loss=loss, nq=25, margin=0.5)
    if multicrop:
        descs = np.repeat(_exact_unit_rows(rng, 5), 2, axis=0)
        labels = np.repeat(np.array([0, 1, 1, 2, 3]), 2)
    else:
        d = rng.normal(size=(10, 24)).astype(np.float32)
        descs = d / np.linalg.norm(d, axis=1, keepdims=True)
        labels = np.array([0, 0, 1, 1, 1, 2, 3, 3, 4, 0])
    jobj, tobj = JT.make_batch_objective(jcfg), TT.make_batch_objective(cfg)
    want, jg = jax.value_and_grad(lambda x: jobj(x, jnp.asarray(labels)))(jnp.asarray(descs))
    got, (tg,) = _grad(lambda x: tobj(x, torch.from_numpy(labels)), descs)
    assert np.isfinite(got) and abs(got - float(want)) <= ATOL
    # TAP's exact ties divide by c + 1e-8 with c near 0: gradients of 1e6
    # on both sides, held to 1e-5 relative there
    np.testing.assert_allclose(tg, np.asarray(jg), atol=ATOL, rtol=ATOL)


# --- schedules and optimizers -------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "cosine", "step", "step25"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_schedules_match_optax(schedule, warmup):
    """make_lr_schedule at steps 0-120 against dirjax's optax schedule:
    rtol 1e-7 plus base * 2**-22 absolute. optax evaluates in fp32 and the
    port in fp64: fp32 holds 3e-5 as 2.9999996e-5 (1.5e-7 relative), and
    one fp32 rounding of the cosine's argument (in [0, pi)) moves its value
    by up to base * 2**-22, which near the cosine's end is the whole
    difference. A warmup's step 0 is exactly 0."""
    base = 3e-4
    kw = dict(learning_rate=base, warmup_steps=warmup, lr_decay=0.3,
              lr_schedule=schedule[:4] if schedule.startswith("step") else schedule,
              lr_decay_steps=25 if schedule == "step25" else 0)
    got = TT.make_lr_schedule(TT.TrainConfig(**kw), total_steps=100)
    want = JT.make_lr_schedule(JT.TrainConfig(**kw), total_steps=100)
    for step in range(121):
        w = float(want(step)) if callable(want) else float(want)
        assert abs(got(step) - w) <= 1e-7 * abs(w) + base * 2.0 ** -22, (step, got(step), w)
    if warmup:
        assert got(0) == 0.0 and got(5) == pytest.approx(base / 2)
    with pytest.raises(ValueError, match="lr_schedule"):
        TT.make_lr_schedule(TT.TrainConfig(lr_schedule="poly"))
    with pytest.raises(ValueError, match="total step"):
        TT.make_lr_schedule(TT.TrainConfig(lr_schedule="cosine"))


@pytest.fixture(scope="module")
def small_model():
    return _seeded("resnet18_rmac", 8)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("freeze_bn", [True, False])
def test_optimizers_match_optax(small_model, optimizer, freeze_bn):
    """AdamW and SGD with momentum (weight decay on, a warmup then a cosine,
    so step 0 has lr 0 and moves nothing) against make_optimizer's optax
    chain, fed the same injected gradients for 5 steps: every parameter,
    BN statistics included, within 1e-6. Frozen BN tensors get no update,
    no decay and no optimizer state."""
    jmodel, params = small_model
    kw = dict(optimizer=optimizer, freeze_bn=freeze_bn, learning_rate=1e-2,
              weight_decay=0.05, momentum=0.9, lr_schedule="cosine", warmup_steps=2)
    jcfg, tcfg = JT.TrainConfig(**kw), TT.TrainConfig(**kw)
    tx = JT.make_optimizer(jcfg, params, total_steps=5)
    state = tx.init(params)
    model = _port_model(jmodel, params)
    opt = TT.make_optimizer(tcfg, model, total_steps=5)
    bn_before = {k: v.clone() for k, v in model.state_dict().items() if ".bn" in k or
                 k.startswith("bn") or "downsample.1" in k}
    rng = np.random.default_rng(4)
    jparams = params

    @jax.jit
    def update(grads, state, jparams):
        updates, state = tx.update(grads, state, jparams)
        return optax.apply_updates(jparams, updates), state

    for step in range(5):
        grads = jax.tree.map(lambda p: rng.normal(size=np.shape(p)).astype(np.float32)
                             * 0.1, jparams)
        jparams, state = update(grads, state, jparams)
        tgrads = state_dict_from_jax_params(grads, model.cfg)
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(tgrads[name].copy())
        opt.step()
        if step == 0:    # warmup: lr 0 on the first update
            _same_params(model, params, atol=0.0)
    _same_params(model, jparams, atol=1e-6)
    frozen = [torch.equal(v, model.state_dict()[k]) for k, v in bn_before.items()]
    assert all(frozen) if freeze_bn else not any(frozen)
    assert TT._step_count(opt) == 5


# --- one train step against dirjax's make_train_step ----------------------

_STEP_REF = {}


def _is_bn(path) -> bool:
    """dirjax's BN leaves: under a key that starts with 'bn' (``_bn_labels``)."""
    return any(str(getattr(k, "key", "")).startswith("bn") for k in path)


def _jax_step_reference(loss, freeze_bn):
    """dirjax's make_train_step on resnet18_rmac (out_dim 32, 32x32, batch 8,
    SGD momentum 0, no decay, lr 1e-3): (params before, loss, params after,
    images, labels), computed once per loss. Under SGD without momentum or
    decay, dirjax's frozen step is its trained step with every BN leaf left
    as it was (``multi_transform`` with ``set_to_zero``; the forward reads
    the same BN values either way): the frozen reference is made so, and
    ``test_frozen_reference_is_dirjax_frozen_step`` holds dirjax to that."""
    if freeze_bn:
        jmodel, params, loss_val, new, images, labels = _jax_step_reference(loss, False)
        new = jax.tree_util.tree_map_with_path(
            lambda path, a, b: b if _is_bn(path) else a, new, _np(params))
        return jmodel, params, loss_val, new, images, labels
    key = loss
    if key not in _STEP_REF:
        cfg = JT.TrainConfig(**_step_kw(loss, freeze_bn))
        jmodel, params = _seeded(cfg.arch, cfg.out_dim)
        rng = np.random.default_rng(0)
        images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
        labels = (np.arange(8) % 4).astype(np.int32)
        tx = JT.make_optimizer(cfg, params)
        step = JT.make_train_step(jmodel, cfg, tx)
        new, _, loss_val = step(params, tx.init(params), jnp.asarray(images),
                                jnp.asarray(labels))
        _STEP_REF[key] = (jmodel, params, float(loss_val), _np(new), images, labels)
    return _STEP_REF[key]


def _step_kw(loss, freeze_bn, microbatch=0):
    return dict(arch="resnet18_rmac", out_dim=32, nq=10, batch_size=8, loss=loss,
                optimizer="sgd", momentum=0.0, weight_decay=0.0, learning_rate=1e-3,
                freeze_bn=freeze_bn, microbatch=microbatch, margin=0.5)


@pytest.mark.parametrize("loss", ["ap", "tap", "taps", "triplet", "tripletlogexp"])
@pytest.mark.parametrize("freeze_bn", [True, False], ids=["bn_frozen", "bn_trained"])
@pytest.mark.parametrize("microbatch", [0, 2, 4], ids=["whole", "mb2", "mb4"])
def test_train_step_matches_dirjax(loss, freeze_bn, microbatch):
    """The port's whole-batch and two-pass steps against dirjax's whole-batch
    make_train_step: loss within 1e-5, every parameter after the SGD step
    within atol 1e-5 / rtol 1e-4 (dirjax's own two-pass bounds,
    tests/test_two_pass.py). With BN trained, BN scale, bias, mean and var
    move as dirjax's; frozen, they stay bit for bit."""
    jmodel, params, want_loss, want, images, labels = _jax_step_reference(loss, freeze_bn)
    cfg = TT.TrainConfig(**_step_kw(loss, freeze_bn, microbatch))
    model = _port_model(jmodel, params).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = TT.make_optimizer(cfg, model)
    make = TT.make_two_pass_train_step if microbatch else TT.make_train_step
    got_loss = float(make(model, cfg, opt)(images, labels))
    assert abs(got_loss - want_loss) <= ATOL
    _same_params(model, want, atol=1e-5, rtol=1e-4)
    after = model.state_dict()
    for k in ("bn1.running_var", "layer2.0.downsample.1.running_mean", "layer3.1.bn2.weight"):
        assert torch.equal(after[k], before[k]) == freeze_bn, k
    assert not torch.equal(after["fc.weight"], before["fc.weight"])


def test_frozen_reference_is_dirjax_frozen_step():
    """dirjax's own freeze_bn=True step equals the frozen reference above
    (its trained step with the BN leaves restored) to the last bit."""
    jmodel, params, want_loss, want, images, labels = _jax_step_reference("ap", True)
    cfg = JT.TrainConfig(**_step_kw("ap", True))
    tx = JT.make_optimizer(cfg, params)
    new, _, loss_val = JT.make_train_step(jmodel, cfg, tx)(
        params, tx.init(params), jnp.asarray(images), jnp.asarray(labels))
    assert float(loss_val) == want_loss
    for a, b in zip(jax.tree.leaves(_np(new)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_two_pass_rejects_a_microbatch_that_does_not_divide():
    cfg = TT.TrainConfig(**_step_kw("ap", True, microbatch=3))
    model = tcreate("resnet18_rmac", out_dim=8)
    with pytest.raises(ValueError, match="must divide"):
        TT.make_two_pass_train_step(model, cfg, TT.make_optimizer(cfg, model))


# --- dropout --------------------------------------------------------------

def test_dropout_rule_and_generator():
    """dropout_p applies only with train=True: keep with probability 1 -
    rate, scaled by 1 / keep, zero otherwise (C4 and C5 in the FPN heads);
    train=True without a generator raises; one seed, one draw."""
    from dirjax_torch.models.rmac import _dropout

    x = torch.rand(4, 8, 5, 5) + 0.5
    y = _dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert 0.6 < kept.float().mean() < 0.9
    images = torch.rand(2, 3, 64, 64)
    for arch in ("resnet18_rmac", "resnet18_fpn_rmac"):
        model = tcreate(arch, out_dim=8, dropout_p=0.5)
        with pytest.raises(ValueError, match="Generator"):
            model(images, train=True)
        a = model(images, train=True, generator=torch.Generator().manual_seed(1))
        b = model(images, train=True, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.allclose(a, model(images, train=False))


# --- fit, checkpoints, resume, CLI ------------------------------------------

FIT_KW = dict(arch="resnet18_rmac", out_dim=16, nq=10, batch_size=4, epochs=2,
              threads=1, trfs="Scale(40), CenterCrop(32)", image_size=32,
              learning_rate=3e-4)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_synth"))
    JD.SyntheticLabels(root)       # materialises the images once
    return root


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """dirjax weights for the parity runs, and their native checkpoint."""
    jmodel, params = _seeded("resnet18_rmac", 16, seed=1)
    path = str(tmp_path_factory.mktemp("train_ckpt") / "start.npz")
    jsave_native(path, JCheckpoint(model=jmodel, params=params,
                                   preprocess=jmodel.preprocess))
    return jmodel, params, path


@pytest.fixture(scope="module")
def jfit(synth, start):
    """dirjax's fit history: two epochs of two Adam steps on SyntheticLabels
    (deterministic chain, one loader thread) with a val set."""
    _, params, _ = start
    return JT.fit(JD.SyntheticLabels(synth), JT.TrainConfig(**FIT_KW), params=params,
                  steps_per_epoch=2, val_dataset=JD.SyntheticLabels(synth))[2]


def test_fit_matches_dirjax(synth, start, jfit):
    """The port's fit from the same weights: per-epoch loss and val loss
    within 1e-4 of dirjax's."""
    jmodel, params, _ = start
    want = jfit
    _, got = TT.fit(SyntheticLabels(synth), TT.TrainConfig(**FIT_KW),
                    model=_port_model(jmodel, params), steps_per_epoch=2,
                    val_dataset=SyntheticLabels(synth), device="cpu")
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [0, 1]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 and abs(g["val_loss"] - w["val_loss"]) <= 1e-4


def test_checkpoint_resume_and_refusals(synth, start, tmp_path):
    """A port run's checkpoint.npz (and .best) loads in dirjax's load_native
    with equal descriptors (1e-5); resume continues at the next epoch with
    the optimizer's state and step count; a dirjax optimizer file, another
    arch, an unknown ckpt_format and dropout_p raise (mesh= and the sharded
    checkpoints are tests/test_torch_mesh_training.py's)."""
    jmodel, params, _ = start
    ds = SyntheticLabels(synth)
    out = str(tmp_path / "run")
    cfg = TT.TrainConfig(**{**FIT_KW, "epochs": 1})
    model, hist = TT.fit(ds, cfg, model=_port_model(jmodel, params), out_dir=out,
                         steps_per_epoch=2, device="cpu")
    path = os.path.join(out, "checkpoint.npz")
    assert os.path.exists(path + ".best") and os.path.exists(path + ".opt")
    ck = jload_native(path)
    images = np.random.default_rng(5).normal(size=(2, 48, 40, 3)).astype(np.float32)
    want = np.asarray(apply_descriptor(ck.params, jnp.asarray(images), ck.model.config))
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    with np.load(path + ".opt") as f:
        assert "state/fc.weight/exp_avg" in f.files and "leaf00000" not in f.files

    resumed, hist2 = TT.fit(ds, TT.TrainConfig(**{**FIT_KW, "epochs": 3}), out_dir=out,
                            steps_per_epoch=2, resume=path, device="cpu")
    assert [h["epoch"] for h in hist2] == [1, 2] and np.isfinite([h["loss"] for h in hist2]).all()
    opt = TT.make_optimizer(cfg, resumed)
    TT._load_opt_state(path + ".opt", resumed, opt)
    assert TT._step_count(opt) == 6
    assert float(opt.state_dict()["state"][0]["step"]) == 6

    with pytest.raises(ValueError, match="resume arch"):
        TT.fit(ds, TT.TrainConfig(**{**FIT_KW, "arch": "resnet50_rmac"}), resume=path,
               device="cpu")
    with open(path + ".opt", "wb") as f:      # dirjax's optax leaves
        np.savez(f, leaf00000=np.zeros(3))
    with pytest.raises(ValueError, match="checkpoint.npz.opt"):
        TT.fit(ds, TT.TrainConfig(**{**FIT_KW, "epochs": 4}), resume=path, device="cpu")
    os.unlink(path + ".opt")         # no optimizer file: a fresh state, as dirjax
    _, hist3 = TT.fit(ds, TT.TrainConfig(**{**FIT_KW, "epochs": 4}), resume=path,
                      steps_per_epoch=1, device="cpu")
    assert [h["epoch"] for h in hist3] == [3]
    with pytest.raises(ValueError, match="ckpt_format"):
        TT.fit(ds, cfg, ckpt_format="tensorstore", device="cpu")
    with pytest.raises(ValueError, match="dropout_p"):
        TT.fit(ds, cfg, model=tcreate("resnet18_rmac", out_dim=16, dropout_p=0.1),
               device="cpu")


def test_train_cli_matches_dirjax(synth, start, jfit, tmp_path, capsys):
    """``python -m dirjax_torch.train --gpu -1 --checkpoint`` (dirjax's
    native file of the same weights) with fit's config in flags: per-epoch
    losses within 1e-4 of dirjax's fit, dirjax's epoch lines, and --resume
    continues with the next epoch; the evaluation set (--eval-dataset)
    becomes the monitor."""
    from dirjax_torch.cli.train import main as tmain

    _, _, ckpt = start
    argv = ["--dataset", f"SyntheticLabels('{synth}')", "--arch", "resnet18_rmac",
            "--out-dim", "16", "--nq", "10", "--batch-size", "4", "--lr", "3e-4",
            "--steps-per-epoch", "2", "--threads", "1", "--trfs", "Scale(40), CenterCrop(32)",
            "--gpu", "-1"]
    got = tmain(argv + ["--epochs", "2", "--checkpoint", ckpt, "--out-dir", str(tmp_path / "t")])
    assert [h["epoch"] for h in got] == [0, 1]
    for g, w in zip(got, jfit):
        assert abs(g["loss"] - w["loss"]) <= 1e-4
    out = capsys.readouterr().out
    assert f"epoch 0: loss {got[0]['loss']:.4f}" in out and "Launching on >> CPU <<" in out
    again = tmain(argv + ["--epochs", "3", "--out-dir", str(tmp_path / "t"),
                               "--resume", str(tmp_path / "t" / "checkpoint.npz"),
                               "--eval-dataset", f"Synthetic('{synth}')"])
    assert [h["epoch"] for h in again] == [2] and 0.0 <= again[0]["mAP-medium"] <= 1.0
