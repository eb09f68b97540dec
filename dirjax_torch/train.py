"""Training: AP-loss fine-tuning of descriptor models (counterpart of
``dirjax/train.py``).

* listwise AP-loss on in-batch similarity matrices (each image queries the
  rest of the batch — the Siamese multi-crop recipe of Revaud et al.), or
  batch-hard mined triplets,
* BatchNorm statistics frozen by default: with ``freeze_bn`` every BN
  tensor (scale, bias, mean, var) stays out of the optimizer; without it all
  four are trained, the statistics by gradient descent as in dirjax, whose
  BN leaves are all parameters,
* ``torch.optim.AdamW`` or ``SGD`` with dirjax's schedules as a
  ``LambdaLR``, read at the step's own count before the increment (optax's
  rule: a warmup's first step has lr 0),
* a whole-batch step and the exact two-pass step (descriptors grad-free,
  the loss differentiated at the descriptor boundary, each microbatch
  recomputed and back-propagated against its share),
* checkpoint/resume in dirjax's native npz format (which dirjax's
  ``load_native`` reads) with the reference's ``.best`` copy, and the
  optimizer state in ``checkpoint.npz.opt``, an npz of named arrays that
  belongs to the port; or sharded checkpoints of
  :mod:`.utils.dist_ckpt` (``ckpt_format="orbax"``, dirjax's name),
* the sharded step (:func:`make_sharded_train_step`, ``fit(mesh=...)``):
  data parallel over the mesh's "data" axis and the FC tensor parallel over
  "db", computing exactly the unsharded step, as dirjax's GSPMD step does.

On the card the step runs the backbone forward and backward on cuDNN and the
plain GeM -> FC -> L2 head (the fused kernel K1 has no backward and is
never called with a gradient); the per-epoch evaluations run without grad
and launch K1. fp32 training turns TF32 off; ``dtype=torch.bfloat16`` runs
the convolutions in bf16 with fp32 parameters, as dirjax's
``dtype=bfloat16`` does. ``python -m dirjax_torch.train`` runs the CLI.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from contextlib import contextmanager
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import loss as losses
from .data.loader import BalancedSampler, get_loader, iterate_batches
from .models import RMACDescriptor, create_model, init_weights
from .models.resnet import BatchNormAffine
from .ops.normalize import l2_normalize
from .parallel.mesh import axis_rank, axis_size, mesh_device
from .parallel.ranking import gather_shards
from .utils.checkpoints import Checkpoint, load_native, save_native

__all__ = ["TrainConfig", "make_loss", "batch_ap_loss", "make_lr_schedule",
           "make_two_pass_train_step", "make_batch_objective",
           "batch_hard_triplet_loss", "make_optimizer", "make_train_step",
           "make_sharded_train_step", "shard_fc", "unshard_fc",
           "fit", "save_checkpoint", "evaluate_val_loss", "evaluate_retrieval"]


@dataclass
class TrainConfig:
    arch: str = "resnet101_rmac"
    out_dim: int = 2048
    loss: str = "ap"        # 'ap' | 'tap' | 'taps' | 'triplet' | 'tripletlogexp'
    nq: int = 25
    margin: float = 1.0         # triplet margin (torch default)
    learning_rate: float = 1e-4
    lr_schedule: str = "constant"   # 'constant' | 'cosine' | 'step'
    lr_decay: float = 0.1           # step-schedule decay factor
    lr_decay_steps: int = 0         # step-schedule period (0: total_steps/3)
    warmup_steps: int = 0           # linear warmup prepended to any schedule
    weight_decay: float = 1e-6
    momentum: float = 0.9
    optimizer: str = "adam"     # 'adam' | 'sgd'
    freeze_bn: bool = True
    epochs: int = 1
    batch_size: int = 16
    #: Siamese multi-crop batches: each sampled image appears this many
    #: times per batch, each through an independent draw of the random
    #: transform chain — in-batch positives at multiple crops
    crops_per_image: int = 1
    image_size: int = 224
    trfs: str = "RandomScale(256,288), RandomCrop(224), RandomFlip()"
    seed: int = 0
    threads: int = 8
    #: two-pass backprop: descriptors are computed grad-free, the listwise
    #: loss is differentiated at the descriptor boundary, then each
    #: microbatch is recomputed and back-propagated against its descriptor
    #: gradient — exact listwise gradients with O(microbatch) activation
    #: memory instead of O(batch). 0 disables; must divide batch_size.
    microbatch: int = 0
    #: loader policy for corrupt/undecodable images: 'raise' or 'skip'
    on_error: str = "raise"


def make_loss(cfg: TrainConfig):
    # in-batch cosine scores live in [-1, 1]
    if cfg.loss == "ap":
        return losses.APLoss(nq=cfg.nq, min=-1.0, max=1.0)
    if cfg.loss == "tap":
        return losses.TAPLoss(nq=cfg.nq, min=-1.0, max=1.0)
    if cfg.loss == "taps":
        return losses.TAPLoss(nq=cfg.nq, min=-1.0, max=1.0, simplified=True)
    if cfg.loss == "triplet":
        return losses.TripletMarginLoss(margin=cfg.margin)
    if cfg.loss == "tripletlogexp":
        return losses.TripletLogExpLoss()
    raise ValueError(f"unknown loss {cfg.loss}")


def make_batch_objective(cfg: TrainConfig) -> Callable:
    """(descs, labels) -> scalar loss: listwise AP over in-batch scores for
    the AP family, batch-hard mined triplets for the TL family."""
    loss_fn = make_loss(cfg)
    if cfg.loss in ("triplet", "tripletlogexp"):
        return partial(batch_hard_triplet_loss, loss_fn=loss_fn)
    return partial(batch_ap_loss, loss_fn=loss_fn)


def _offdiag_indices(n: int) -> np.ndarray:
    """(n, n-1) column indices excluding the diagonal (each image ranks the
    rest of the batch, never itself)."""
    idx = np.arange(n)[None, :].repeat(n, axis=0)
    return np.stack([row[row != i] for i, row in enumerate(idx)])


def batch_ap_loss(descs, labels, loss_fn):
    """Listwise loss over the in-batch similarity matrix."""
    n = descs.shape[0]
    scores = descs.float() @ descs.float().T
    match = (labels[:, None] == labels[None, :]).float()
    cols = torch.from_numpy(_offdiag_indices(n)).to(descs.device)
    scores_od = torch.gather(scores, 1, cols)
    match_od = torch.gather(match, 1, cols)
    # queries with no in-batch positive contribute AP=0 either way; weight
    # them out so the mean is over informative queries
    has_pos = (match_od.sum(dim=1) > 0).float()
    qw = has_pos / torch.clamp_min(has_pos.sum(), 1.0) * n
    return loss_fn(losses._clip(scores_od, -1.0, 1.0), match_od, qw=qw)


def batch_hard_triplet_loss(descs, labels, loss_fn):
    """Batch-hard triplet mining: each anchor pairs with its FARTHEST
    same-label row and NEAREST different-label row; anchors lacking a
    positive or a negative are weighted out of the mean. The reductions are
    ``amax``/``amin``, which split a tie's gradient as jax's max does."""
    n = descs.shape[0]
    d = losses._pairwise_distance(descs[:, None, :], descs[None, :, :],
                                  loss_fn.p, loss_fn.eps)       # (n, n)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=descs.device)
    pos_mask = same & ~eye
    neg_mask = ~same
    d_p = torch.amax(torch.where(pos_mask, d, -torch.inf), dim=1)
    d_n = torch.amin(torch.where(neg_mask, d, torch.inf), dim=1)
    valid = torch.isfinite(d_p) & torch.isfinite(d_n)
    per = loss_fn.from_distances(torch.where(valid, d_p, 0.0),
                                 torch.where(valid, d_n, 1.0))
    per = torch.where(valid, per, 0.0)
    return torch.sum(per) / torch.clamp_min(torch.sum(valid), 1)


def _bn_modules(model: nn.Module):
    """Every BatchNorm of the backbone: the stem's ``bn1``, each block's
    ``bnN`` and each ``downsample.1`` (dirjax's walk freezes every key that
    starts with ``bn``)."""
    return [m for m in model.modules() if isinstance(m, BatchNormAffine)]


def _trained_parameters(model: nn.Module, freeze_bn: bool) -> list:
    """The tensors the optimizer updates, in ``named_parameters`` order.
    ``freeze_bn``: the four BN tensors keep ``requires_grad=False`` and stay
    out of the optimizer (optax's ``set_to_zero``: no update, no decay, no
    state). Otherwise each BN's ``running_mean``/``running_var`` become
    parameters, trained like every other leaf, as dirjax trains them."""
    for bn in _bn_modules(model):
        if not freeze_bn:
            for name in ("running_mean", "running_var"):
                if name in bn._buffers:
                    value = bn._buffers.pop(name)
                    bn.register_parameter(name, nn.Parameter(value.detach().clone()))
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            t.requires_grad_(not freeze_bn)
    return [p for p in model.parameters() if p.requires_grad]


def make_lr_schedule(cfg: TrainConfig, total_steps: Optional[int] = None
                     ) -> Callable[[int], float]:
    """Learning rate as a function of the optimizer's step count (0 on the
    first update), dirjax's optax schedules in fp64: ``constant``,
    ``cosine`` (to 0 over ``total_steps - warmup_steps``), ``step``
    (staircase decay by ``lr_decay`` every ``lr_decay_steps``, default
    ``total_steps / 3``), each after an optional linear warmup from 0 whose
    end hands the next schedule its count from 0."""
    base = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        def sched(count):
            return base
    elif cfg.lr_schedule == "cosine":
        if not total_steps:
            raise ValueError("cosine schedule needs the total step count")
        decay_steps = max(1, total_steps - cfg.warmup_steps)

        def sched(count):
            return base * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps)
                                                / decay_steps))
    elif cfg.lr_schedule == "step":
        period = cfg.lr_decay_steps or max(1, (total_steps or 3) // 3)

        def sched(count):
            if count <= 0 or cfg.lr_decay == 0:
                return base
            return base * cfg.lr_decay ** math.floor(count / period)
    else:
        raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule}")
    warmup = cfg.warmup_steps
    if not warmup:
        return sched

    def warmed(count):
        if count < warmup or cfg.lr_schedule == "constant":
            # linear 0 -> base, held at base afterwards
            return base * min(max(count, 0), warmup) / warmup
        return sched(count - warmup)
    return warmed


def make_optimizer(cfg: TrainConfig, model: nn.Module,
                   total_steps: Optional[int] = None) -> torch.optim.Optimizer:
    """``torch.optim.AdamW`` (optax's ``adamw``: betas 0.9/0.999, eps 1e-8,
    decay on every trained leaf) or ``SGD`` (``add_decayed_weights`` then
    ``sgd(momentum)``: no dampening, no Nesterov) over the trained tensors
    of ``model`` (see :func:`_trained_parameters`; BN freezing is set up
    here). Its learning rate follows :func:`make_lr_schedule` through a
    ``LambdaLR`` (``optimizer.lr_schedule``) that each ``optimizer.step()``
    advances after the update."""
    lr = make_lr_schedule(cfg, total_steps)
    params = _trained_parameters(model, cfg.freeze_bn)
    base = cfg.learning_rate
    if cfg.optimizer == "adam":
        opt = torch.optim.AdamW(params, lr=base, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=base, momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay, dampening=0.0,
                              nesterov=False)
    else:
        raise ValueError(cfg.optimizer)
    opt.lr_schedule = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: lr(count) / base if base else 0.0)
    opt.register_step_post_hook(lambda o, args, kwargs: o.lr_schedule.step())
    return opt


def _step_count(opt: torch.optim.Optimizer) -> int:
    return int(opt.lr_schedule.last_epoch)


def _set_step_count(opt: torch.optim.Optimizer, count: int) -> None:
    """Put the schedule at ``count`` updates done (a resumed run)."""
    sched = opt.lr_schedule
    sched.last_epoch = count
    for group, lam in zip(opt.param_groups, sched.lr_lambdas):
        group["lr"] = group["initial_lr"] * lam(count)
    sched._last_lr = [g["lr"] for g in opt.param_groups]


def _device_batch(model: nn.Module, images, labels):
    """NHWC images (host arrays or tensors) -> NCHW channels_last on the
    model's device (a view, as FeatureExtractor makes it), labels as int64
    there."""
    device = next(model.parameters()).device
    x = torch.as_tensor(images, dtype=torch.float32, device=device)
    y = torch.as_tensor(np.asarray(labels) if isinstance(labels, list) else labels,
                        device=device).to(torch.int64)
    return x.permute(0, 3, 1, 2), y


def make_train_step(model: RMACDescriptor, cfg: TrainConfig,
                    optimizer: torch.optim.Optimizer, dtype=torch.float32):
    """One whole-batch update: ``step(images, labels) -> loss`` (a detached
    0-d tensor) on ``model`` and ``optimizer``, in place."""
    batch_obj = make_batch_objective(cfg)

    def step(images, labels):
        x, y = _device_batch(model, images, labels)
        optimizer.zero_grad(set_to_none=True)
        loss_val = batch_obj(model(x, dtype=dtype, train=True), y)
        loss_val.backward()
        optimizer.step()
        return loss_val.detach()

    return step


def _two_pass_loss_and_grads(model, x, y, objective, m: int, dtype):
    """Loss, with the parameters' gradients summed into their ``.grad``,
    via backprop split at the descriptor boundary (see
    :func:`make_two_pass_train_step`). ``m`` is the microbatch size."""
    micro = list(zip(x.split(m), range(0, len(x), m)))
    # (1) descriptors only; no activation outlives its microbatch
    with torch.no_grad():
        descs = torch.cat([model(xb, dtype=dtype, train=True) for xb, _ in micro])
    # (2) listwise loss + its gradient at the descriptor boundary
    descs.requires_grad_(True)
    loss_val = objective(descs, y)
    (ddescs,) = torch.autograd.grad(loss_val, descs)
    # (3) each microbatch again, pulled back against its share
    for xb, start in micro:
        model(xb, dtype=dtype, train=True).backward(ddescs[start:start + len(xb)])
    return loss_val.detach()


def make_two_pass_train_step(model: RMACDescriptor, cfg: TrainConfig,
                             optimizer: torch.optim.Optimizer, dtype=torch.float32):
    """Memory-bounded train step with EXACT listwise gradients.

    The listwise AP loss couples every descriptor in the batch, so naive
    microbatching would change its semantics and plain reverse-mode autodiff
    stores activations for the whole batch. This step instead splits
    backprop at the descriptor boundary:

      1. forward every microbatch under ``torch.no_grad()`` — only the
         (B, D) descriptors survive;
      2. differentiate the loss w.r.t. the descriptors (tiny);
      3. for each microbatch, run the forward again with grad enabled and
         ``backward`` its descriptor gradient; the ``.grad`` fields sum.

    Then the optimizer steps once. Peak activation memory is O(microbatch)
    whatever the batch size; the extra cost is one recomputed forward."""
    batch_obj = make_batch_objective(cfg)
    m = cfg.microbatch
    if not (m > 0 and cfg.batch_size % m == 0):
        raise ValueError(f"microbatch {m} must divide batch_size {cfg.batch_size}")

    def step(images, labels):
        x, y = _device_batch(model, images, labels)
        optimizer.zero_grad(set_to_none=True)
        loss_val = _two_pass_loss_and_grads(model, x, y, batch_obj, m, dtype)
        optimizer.step()
        return loss_val

    return step


# --------------------------------------------------------------------------
# the sharded step: DP over "data", the FC's TP over "db"
# --------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Megatron's input function of a column-parallel layer: identity
    forward, ``all_reduce(SUM)`` of the gradient over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """``all_gather`` of each rank's part along ``dim`` over a mesh axis
    forward, this rank's slice of the gradient backward: every rank of the
    axis computes the same function of the gathered tensor, so its own
    slice of that function's gradient is the whole gradient of its part."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.width, ctx.index = dim, x.shape[dim], axis_rank(mesh, axis)
        return gather_shards(x, mesh, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None, None


def _sharded_descriptors(model: RMACDescriptor, x, dtype, mesh):
    """The training forward of this rank's images with the FC split over
    "db" (this rank holds its rows of ``fc.weight`` and ``fc.bias``): the
    pooled features enter through :class:`_Copy`, the partial projections
    leave through :class:`_Gather`, and the L2 is taken on the full vector."""
    cfg = model.cfg
    d = model.pooled(x, dtype=dtype, train=True)
    if cfg.norm_features:
        d = l2_normalize(d, dim=1)
    if not cfg.without_fc:
        d = _Copy.apply(d.float(), mesh.get_group("db"))
        d = _Gather.apply(d @ model.fc.weight.T + model.fc.bias, mesh, "db", 1)
    return l2_normalize(d, dim=-1)


def _sum_gradients(model: nn.Module, mesh) -> None:
    """``all_reduce(SUM)`` of every gradient over "data", in one buffer:
    each rank's gradient is its slice's share of the global loss's."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def make_sharded_train_step(model: RMACDescriptor, cfg: TrainConfig,
                            optimizer: torch.optim.Optimizer, mesh, dtype=torch.float32):
    """The SPMD train step on a ("data", "db") mesh: ``step(images, labels)
    -> loss``, every rank given the same global batch, which must divide by
    the "data" size. It computes exactly the unsharded step, as dirjax's
    GSPMD step does (``dirjax/train.py:295-353``):

    * DP over "data": each rank forwards its contiguous slice of the batch;
      the descriptors are all-gathered (:class:`_Gather`), every rank takes
      the listwise loss over the GLOBAL batch, and the gradients are summed
      over "data" (a per-rank loss with averaged gradients, as DDP would
      take it, is another loss);
    * TP over "db": ``model``'s FC must hold this rank's output rows
      (:func:`shard_fc`, before the optimizer's first step); every other
      tensor is whole on every rank. The optimizers act element by element,
      so a rank's update of its rows is the slice of the full update;
    * ``cfg.microbatch``: the two-pass step on the rank's slice, in
      microbatches of ``microbatch / data`` rows (:func:`make_two_pass_train_step`),
      with the descriptors gathered before the loss.

    BN is affine in the training forward (no batch statistics), so no rank
    needs another's activations."""
    batch_obj = make_batch_objective(cfg)
    m = cfg.microbatch
    if m and cfg.batch_size % m:
        raise ValueError(f"microbatch {m} must divide batch_size {cfg.batch_size}")
    n_data, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    m_local = max(1, m // n_data)
    if not model.cfg.without_fc and \
            model.fc.weight.shape[0] * axis_size(mesh, "db") != model.cfg.out_dim:
        raise ValueError("the FC must hold this rank's rows over db: call "
                         "shard_fc(model, optimizer, mesh) first")

    def step(images, labels):
        if len(images) % n_data:
            raise AssertionError(f"a batch of {len(images)} must divide by data axis {n_data}")
        b = len(images) // n_data
        x, y = _device_batch(model, images[r * b:(r + 1) * b], labels)
        optimizer.zero_grad(set_to_none=True)
        if m:
            loss_val = _sharded_two_pass(model, x, y, batch_obj, m_local, dtype, mesh)
        else:
            descs = _Gather.apply(_sharded_descriptors(model, x, dtype, mesh), mesh, "data", 0)
            loss_val = batch_obj(descs, y)
            loss_val.backward()
            loss_val = loss_val.detach()
        _sum_gradients(model, mesh)
        optimizer.step()
        return loss_val

    return step


def _sharded_two_pass(model, x, y, objective, m: int, dtype, mesh):
    """:func:`_two_pass_loss_and_grads` on a mesh: the rank's microbatches
    without grad, the descriptors gathered over "data", the global loss's
    gradient at the descriptors, the rank's slice of it pulled back through
    each recomputed microbatch."""
    micro = list(zip(x.split(m), range(0, len(x), m)))
    with torch.no_grad():
        local = torch.cat([_sharded_descriptors(model, xb, dtype, mesh) for xb, _ in micro])
    descs = gather_shards(local, mesh, "data")
    descs.requires_grad_(True)
    loss_val = objective(descs, y)
    (ddescs,) = torch.autograd.grad(loss_val, descs)
    b = len(x)
    own = ddescs[axis_rank(mesh, "data") * b:][:b]
    for xb, start in micro:
        _sharded_descriptors(model, xb, dtype, mesh).backward(own[start:start + len(xb)])
    return loss_val.detach()


def _fc_tensors(model: RMACDescriptor) -> list:
    return [] if model.cfg.without_fc else [model.fc.weight, model.fc.bias]


def shard_fc(model: RMACDescriptor, optimizer: torch.optim.Optimizer, mesh) -> None:
    """Keep this rank's rows of ``fc.weight`` and ``fc.bias`` (output
    features ``c*w .. (c+1)*w`` for the rank's "db" coordinate ``c``), and
    the same rows of their optimizer state, in place: the optimizer keeps
    its tensors. ``out_dim`` must divide by the "db" size."""
    n_db, c = axis_size(mesh, "db"), axis_rank(mesh, "db")
    for p in _fc_tensors(model):
        full = p.shape[0]
        if full % n_db:
            raise ValueError(f"out_dim {full} must divide by the db axis {n_db}")
        rows = slice(c * (full // n_db), (c + 1) * (full // n_db))
        p.grad = None
        p.data = p.data[rows].clone()
        state = optimizer.state.get(p, {})
        for key, v in state.items():
            if torch.is_tensor(v) and v.dim() and v.shape[0] == full:
                state[key] = v[rows].clone()


def unshard_fc(model: RMACDescriptor, optimizer: torch.optim.Optimizer, mesh) -> None:
    """The inverse of :func:`shard_fc`: gather the FC rows (and their
    optimizer state) over "db", in place, on every rank."""
    for p in _fc_tensors(model):
        local = p.shape[0]
        p.grad = None
        p.data = gather_shards(p.data, mesh, "db")
        state = optimizer.state.get(p, {})
        for key, v in state.items():
            if torch.is_tensor(v) and v.dim() and v.shape[0] == local:
                state[key] = gather_shards(v, mesh, "db")


@contextmanager
def _whole_fc(model, optimizer, mesh):
    """The whole FC inside the block (evaluation, npz checkpoints); this
    rank's rows again after it. Nothing to do off a mesh."""
    if mesh is None:
        yield
        return
    unshard_fc(model, optimizer, mesh)
    try:
        yield
    finally:
        shard_fc(model, optimizer, mesh)


def _mesh_batches(make_batches, device):
    """Rank 0 decodes each global batch and broadcasts it to every rank as
    ``(images, labels)`` tensors on ``device``: the loader's random
    transforms draw from process-global state, so ranks decoding on their
    own would crop differently. The end of the epoch is broadcast too."""
    src = dist.get_rank() == 0
    batches = iter(make_batches()) if src else None
    while True:
        head = torch.zeros(5, dtype=torch.int64, device=device)
        batch = next(batches, None) if src else None
        if batch is not None:
            head = torch.tensor([1, *batch.images.shape], dtype=torch.int64, device=device)
        dist.broadcast(head, 0)
        if not int(head[0]):
            return
        shape = tuple(int(v) for v in head[1:])
        if src:
            images = torch.as_tensor(batch.images, dtype=torch.float32, device=device)
            labels = torch.as_tensor(np.asarray(batch.fields["label"]), device=device)
            images, labels = images.contiguous(), labels.to(torch.int64)
        else:
            images = torch.empty(shape, dtype=torch.float32, device=device)
            labels = torch.empty(shape[0], dtype=torch.int64, device=device)
        dist.broadcast(images, 0)
        dist.broadcast(labels, 0)
        yield images, labels


def save_checkpoint(state: Checkpoint, is_best: bool, filename: str):
    """Native-format save with the reference's ``.best`` copy semantics
    (``common.py:102-114``)."""
    try:
        save_native(filename, state)
        if is_best:
            shutil.copyfile(filename, filename + ".best")
            filename = filename + ".best"
        print("saving to " + filename)
    except OSError as e:
        print(f"Error: Could not save checkpoint at {filename}, skipping ({e})")


def _param_names(model: nn.Module, opt: torch.optim.Optimizer) -> list:
    """The state_dict name of each tensor the optimizer holds, in its order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in opt.param_groups for p in g["params"]]


def _save_opt_state(path: str, model: nn.Module, opt: torch.optim.Optimizer) -> None:
    """The optimizer's per-tensor state as named arrays
    (``state/<tensor name>/<field>``), the trained tensors' names, the
    optimizer's class and its step count; no pickle."""
    names = _param_names(model, opt)
    arrays = {}
    for idx, fields in opt.state_dict()["state"].items():
        for field_name, value in fields.items():
            if torch.is_tensor(value):
                arrays[f"state/{names[idx]}/{field_name}"] = value.detach().cpu().numpy()
    meta = {"optimizer": type(opt).__name__, "params": names,
            "step_count": _step_count(opt)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _load_opt_state(path: str, model: nn.Module, opt: torch.optim.Optimizer) -> None:
    """Restore :func:`_save_opt_state`'s file into ``opt`` (its
    hyper-parameters stay the config's) and the schedule's step count.
    Raises, naming the file, on dirjax's ``leafNNNNN`` layout or another
    optimizer or set of trained tensors."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    if "__meta__" not in arrays:
        raise ValueError(f"{path} is not an optimizer state of dirjax_torch "
                         f"(keys {sorted(arrays)[:3]}...; dirjax writes optax "
                         "leaves, which this trainer cannot resume from)")
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    names = _param_names(model, opt)
    if meta["optimizer"] != type(opt).__name__ or meta["params"] != names:
        raise ValueError(f"{path} holds the state of {meta['optimizer']} over "
                         f"{len(meta['params'])} tensors; this run trains "
                         f"{len(names)} tensors with {type(opt).__name__}")
    state = {}
    for idx, name in enumerate(names):
        prefix = f"state/{name}/"
        fields = {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
                  if k.startswith(prefix)}
        if fields:   # load_state_dict moves them to their tensor's device
            state[idx] = fields
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)
    _set_step_count(opt, int(meta["step_count"]))


def evaluate_val_loss(model: RMACDescriptor, cfg: TrainConfig, val_dataset,
                      dtype=torch.float32) -> float:
    """Mean in-batch loss over the validation dataset (deterministic
    center-crop chain), with the train step's own batch objective. Runs
    under ``torch.inference_mode()``: on the card the head launches K1."""
    batch_obj = make_batch_objective(cfg)
    chain = f"Scale({cfg.image_size + 32}), CenterCrop({cfg.image_size})"
    loader = get_loader(val_dataset, chain, preprocess=model.cfg.preprocess,
                        output=("img", "label"), totensor=True)
    losses_v = []
    with torch.inference_mode():
        for batch in iterate_batches(loader, range(len(val_dataset)),
                                     batch_size=cfg.batch_size,
                                     threads=cfg.threads, batching="group"):
            if len(batch.indices) < 2:
                continue
            x, y = _device_batch(model, batch.images, batch.fields["label"])
            losses_v.append(float(batch_obj(model(x, dtype=dtype), y)))
    return float(np.mean(losses_v)) if losses_v else float("nan")


def evaluate_retrieval(model: RMACDescriptor, eval_db, cfg: TrainConfig,
                       dtype=torch.float32, trfs: str = "", mesh=None) -> dict:
    """mAP of the current weights on a retrieval benchmark (the metric that
    matters for model selection; loss is only a proxy). The extractor shares
    ``model`` (and sets it to eval mode); on a mesh it is a
    :class:`~dirjax_torch.parallel.ShardedExtractor` over "data" (the model
    whole on every rank)."""
    from .extraction import FeatureExtractor, eval_model

    if mesh is not None:
        from .parallel.extraction import ShardedExtractor

        extractor = ShardedExtractor(model, mesh, dtype=dtype)
    else:
        extractor = FeatureExtractor(model, next(model.parameters()).device, dtype=dtype)
    return eval_model(eval_db, extractor, trfs, threads=cfg.threads)


def _retrieval_monitor(res: dict) -> Optional[float]:
    """Scalar to MINIMIZE from an eval_model result: -mAP (medium when the
    protocol is revisited)."""
    for key in ("mAP-medium", "mAP"):
        if key in res:
            return -float(res[key])
    return None


def _ckpt_state(model: RMACDescriptor, optimizer: torch.optim.Optimizer, mesh):
    """``(params, opt_state)`` for :class:`~.utils.dist_ckpt.TrainCheckpointer`:
    the model's state_dict, and the optimizer's per-tensor state as
    ``state/<tensor name>/<field>`` with its step count. On a mesh the FC
    rows (and their state) are DTensors sharded over "db", replicated over
    "data", so each shard is written once."""
    sharded = set()
    if mesh is not None and not model.cfg.without_fc:
        sharded = {"fc.weight", "fc.bias"}

    def wrap(name, t):
        if name not in sharded or not t.dim():
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard

        return DTensor.from_local(t, mesh, [Replicate(), Shard(0)], run_check=False)

    params = {k: wrap(k, v) for k, v in model.state_dict().items()}
    names = _param_names(model, optimizer)
    opt_state = {"step_count": torch.tensor(_step_count(optimizer))}
    for idx, fields in optimizer.state_dict()["state"].items():
        for field_name, v in fields.items():
            if torch.is_tensor(v):
                opt_state[f"state/{names[idx]}/{field_name}"] = wrap(names[idx], v)
    return params, opt_state


def _restore_ckpt(ckptr, model: RMACDescriptor, optimizer: torch.optim.Optimizer, mesh) -> None:
    """Load the latest step of ``ckptr`` into ``model`` and ``optimizer``
    (this rank's FC rows on a mesh), whatever layout wrote it. The
    optimizer's state templates come from the step's own shapes; its class
    and trained tensors must match the run's (``extra``)."""
    extra = ckptr.read_extra()
    names = _param_names(model, optimizer)
    if extra.get("optimizer") != type(optimizer).__name__ or extra.get("params") != names:
        raise ValueError(f"{ckptr.directory} holds the state of {extra.get('optimizer')} over "
                         f"{len(extra.get('params', []))} tensors; this run trains "
                         f"{len(names)} tensors with {type(optimizer).__name__}")
    params, _ = _ckpt_state(model, optimizer, mesh)
    tensors = dict(model.named_parameters())
    opt_t = {}
    for key, (size, dtype) in ckptr.saved_shapes().items():
        if not key.startswith("opt_state."):
            continue
        key = key[len("opt_state."):]
        p = tensors[key.split("/")[1]] if key.startswith("state/") else None
        if p is None or not len(size):
            opt_t[key] = torch.zeros(tuple(size), dtype=dtype)
        else:   # shaped as its tensor, sharded where its tensor is
            like = torch.zeros(p.shape, dtype=dtype, device=p.device)
            opt_t[key] = _ckpt_state_wrap(params, key.split("/")[1], like)
    params, opt, _ = ckptr.restore(params, opt_t)
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa: E731
    model.load_state_dict({k: local(v) for k, v in params.items()})
    state = {}
    for idx, name in enumerate(names):
        prefix = f"state/{name}/"
        fields = {k[len(prefix):]: local(v) for k, v in opt.items() if k.startswith(prefix)}
        if fields:
            state[idx] = fields
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)
    _set_step_count(optimizer, int(opt["step_count"]))


def _ckpt_state_wrap(params: dict, name: str, like: torch.Tensor):
    """``like`` wrapped as ``params[name]`` is: a DTensor on the same mesh
    and placements where the parameter is sharded."""
    ref = params.get(name)
    if ref is None or not hasattr(ref, "to_local"):
        return like
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(like, ref.device_mesh, ref.placements, run_check=False)


def fit(dataset, cfg: TrainConfig, *, val_dataset=None,
        model: Optional[RMACDescriptor] = None, out_dir: Optional[str] = None,
        dtype=torch.float32, steps_per_epoch: Optional[int] = None,
        progress: bool = False, resume: Optional[str] = None, eval_dataset=None,
        eval_trfs: str = "", mesh=None, ckpt_format: str = "npz",
        device="cuda"):
    """Fine-tune on a labeled dataset; returns (model, history).

    ``model``: the initial weights (dirjax's ``params``); by default
    ``cfg.arch`` drawn from dirjax's initial distributions with a generator
    seeded by ``cfg.seed``. It moves to ``device`` and is trained in place.

    ``resume``: a checkpoint.npz written by a previous fit (weights,
    optimizer state from ``.opt`` when present, epoch counter and best
    monitor), or a checkpoint directory of ``ckpt_format="orbax"``.

    ``eval_dataset``: a retrieval benchmark evaluated each epoch; its mAP
    is recorded in the history and becomes the best-checkpoint monitor.

    ``mesh``: a ("data", "db") mesh (:func:`dirjax_torch.parallel.make_mesh`;
    every rank calls ``fit`` alike). The step is
    :func:`make_sharded_train_step` on the mesh's device: the batch
    data-parallel over "data", the FC tensor-parallel over "db". Rank 0
    decodes each global batch and broadcasts it; a batch too short to
    train (< 2 rows) is skipped and a ragged one truncated to a multiple of
    ``lcm(microbatch, data)``, each decided on the global batch, so every
    rank makes the same collectives and ends with the same history. The
    evaluations see the whole FC (the retrieval one through a
    :class:`~dirjax_torch.parallel.ShardedExtractor`); npz checkpoints hold
    the whole FC and rank 0 writes them. The returned model is whole.

    ``ckpt_format``: ``"npz"`` (dirjax's native files) or ``"orbax"``:
    sharded, async checkpoints under ``out_dir/orbax``, written by
    :mod:`dirjax_torch.utils.dist_ckpt` on ``torch.distributed.checkpoint``
    (the option keeps dirjax's name; the format is torch's, and a dirjax
    orbax directory is refused by name).

    A config with ``dropout_p`` is refused, since dirjax's steps cannot
    train it (they pass no key). On the card in fp32, TF32 is turned off
    for the process, as the CLIs' ``setup_device`` turns it off."""
    from .utils.dist_ckpt import TrainCheckpointer

    if ckpt_format not in ("npz", "orbax"):
        raise ValueError(f"ckpt_format must be 'npz' or 'orbax', got {ckpt_format!r}")
    if cfg.microbatch and cfg.batch_size % cfg.microbatch:
        raise ValueError(f"microbatch {cfg.microbatch} must divide batch_size "
                         f"{cfg.batch_size}")
    n_data = 1
    if mesh is not None:
        n_data = axis_size(mesh, "data")
        if cfg.batch_size % n_data:
            raise AssertionError(f"batch_size {cfg.batch_size} must divide by data axis "
                                 f"{n_data}")
        device = mesh_device(mesh)
    device = torch.device(device)
    writer = mesh is None or dist.get_rank() == 0
    if device.type == "cuda" and dtype == torch.float32:
        # fp32 training runs fp32 convolutions and matmuls, as setup_device
        # sets them for the CLIs (torch lets cuDNN take TF32 by default)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if model is None:
        model = init_weights(create_model(cfg.arch, out_dim=cfg.out_dim),
                             torch.Generator().manual_seed(cfg.seed))
    if model.cfg.dropout_p is not None:
        raise ValueError("dropout_p cannot be trained: dirjax's train steps pass "
                         "no PRNG key to the dropout (ROADMAP queue 3)")

    start_epoch = 0
    best = float("inf")
    opt_path = resume_ckptr = None
    if resume and os.path.isdir(resume):
        resume_ckptr = TrainCheckpointer(resume)
        rex = resume_ckptr.read_extra()
        if rex.get("arch", cfg.arch) != cfg.arch:
            raise ValueError(f"resume arch {rex.get('arch')} != config arch {cfg.arch}")
        start_epoch = int(rex.get("epoch", -1)) + 1
        best = float(rex.get("best", float("inf")))
    elif resume:
        ckpt = load_native(resume)
        if ckpt.model.arch != cfg.arch:
            raise ValueError(f"resume arch {ckpt.model.arch} != config arch {cfg.arch}")
        model = ckpt.model
        start_epoch = int(ckpt.extra.get("epoch", -1)) + 1
        # restore the best monitor so a post-resume epoch can't silently
        # overwrite checkpoint.npz.best with a worse model
        best = float(ckpt.extra.get("best", float("inf")))
        opt_path = resume + ".opt"
    model = model.to(device).train()

    loader = get_loader(dataset, cfg.trfs, preprocess=model.cfg.preprocess,
                        output=("img", "label"), totensor=True,
                        on_error=cfg.on_error)
    sampler = BalancedSampler(dataset, rng=np.random.default_rng(cfg.seed))

    # total optimizer steps (sizes cosine/step schedules): sampler draws x
    # crops per epoch, optionally truncated by steps_per_epoch
    per_epoch = len(sampler) * cfg.crops_per_image
    if steps_per_epoch:
        per_epoch = min(per_epoch, steps_per_epoch * cfg.batch_size)
    total_steps = max(1, per_epoch // cfg.batch_size) * cfg.epochs

    optimizer = make_optimizer(cfg, model, total_steps=total_steps)
    if opt_path and os.path.exists(opt_path):
        _load_opt_state(opt_path, model, optimizer)
    if mesh is not None:
        shard_fc(model, optimizer, mesh)
        step = make_sharded_train_step(model, cfg, optimizer, mesh, dtype=dtype)
    else:
        make = make_two_pass_train_step if cfg.microbatch else make_train_step
        step = make(model, cfg, optimizer, dtype=dtype)
    if resume_ckptr is not None:
        _restore_ckpt(resume_ckptr, model, optimizer, mesh)
    # a ragged group batch is cut to a multiple of this (the balanced
    # sampler re-draws the rest next epoch)
    multiple = math.lcm(max(1, cfg.microbatch), n_data)

    history = []
    ckptr = None
    for epoch in range(start_epoch, cfg.epochs):
        order = list(iter(sampler))
        if cfg.crops_per_image > 1:
            # adjacent repeats land in the same batch; each repeat gets an
            # independent random-transform draw (Siamese multi-crop)
            order = [i for i in order for _ in range(cfg.crops_per_image)]
        if steps_per_epoch:
            order = order[: steps_per_epoch * cfg.batch_size]
        epoch_losses = []

        def epoch_batches():
            batches = iterate_batches(loader, order, batch_size=cfg.batch_size,
                                      threads=cfg.threads, batching="group")
            if progress and writer:
                import tqdm

                batches = tqdm.tqdm(batches, desc=f"epoch {epoch}")
            return batches

        if mesh is None:
            batches = ((b.images, b.fields["label"]) for b in epoch_batches())
        else:
            batches = _mesh_batches(epoch_batches, device)
        for images, labels in batches:
            if len(images) < 2:
                continue
            if multiple > 1:
                keep = len(images) // multiple * multiple
                if keep < 2:
                    continue
                images, labels = images[:keep], labels[:keep]
            epoch_losses.append(float(step(images, labels)))
        mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
        record = {"epoch": epoch, "loss": mean_loss}
        monitor = mean_loss
        with _whole_fc(model, optimizer, mesh):
            if val_dataset is not None:
                record["val_loss"] = evaluate_val_loss(model, cfg, val_dataset, dtype=dtype)
                monitor = record["val_loss"]
            if eval_dataset is not None:
                res = evaluate_retrieval(model, eval_dataset, cfg, dtype=dtype,
                                         trfs=eval_trfs, mesh=mesh)
                model.train()   # the extractor set eval mode on the shared module
                record.update({k: v for k, v in res.items() if isinstance(v, float)})
                m = _retrieval_monitor(res)
                if m is not None:
                    monitor = m  # select by mAP when a benchmark is given
            history.append(record)
            is_best = monitor < best
            best = min(best, monitor)
            extra = {"epoch": epoch}
            if np.isfinite(best):
                extra["best"] = float(best)
            if out_dir and ckpt_format == "npz":
                path = os.path.join(out_dir, "checkpoint.npz")
                if writer:
                    save_checkpoint(Checkpoint(model=model, preprocess=model.cfg.preprocess,
                                               extra=extra), is_best, path)
                    _save_opt_state(path + ".opt", model, optimizer)
                if mesh is not None:   # every rank returns once the files exist
                    dist.barrier()
        if out_dir and ckpt_format == "orbax":
            if ckptr is None:
                ckptr = TrainCheckpointer(os.path.join(out_dir, "orbax"))
            ckptr.save(epoch, *_ckpt_state(model, optimizer, mesh),
                       extra={**extra, "arch": cfg.arch, "monitor": float(monitor),
                              "optimizer": type(optimizer).__name__,
                              "params": _param_names(model, optimizer)})
    if ckptr is not None:
        ckptr.close()
    if mesh is not None:
        unshard_fc(model, optimizer, mesh)
    return model, history


if __name__ == "__main__":
    from .cli.train import main as _cli_main

    _cli_main()
