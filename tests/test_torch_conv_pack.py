"""The backbones' packed conv operands (``dirjax_torch/models/resnet.py``
``_conv_operands``), made once per convolution and reused while its
parameters stay the same, held against ``ops/conv.py``'s per-call packing on
the CPU (``pack_weights`` runs on any device; only a launch needs the card).

* The cached bf16 weights, fp32 scale and shift equal a fresh pack of the
  same parameters bit for bit, and the BN affine equals
  ``BatchNormAffine.affine()``.
* A second call returns the same operands; every way the parameters
  change (``load_state_dict``, an in-place edit, ``fold_batchnorm``'s copy,
  ``.to()``, an optimizer step, a BN statistic) repacks, and a forward after
  the change equals a fresh model's.
"""

import copy

import pytest
import torch

from dirjax_torch.models import resnet as tr
from dirjax_torch.ops import conv as tconv

torch.set_num_threads(1)

# (config, cin, planes, stride): a bottleneck with a downsample, ResNeXt's
# grouped one, a basic block
BLOCKS = {"bottleneck_s2": ("resnet50", 64, 32, 2), "resnext": ("resnext101_32x4d", 256, 64, 1),
          "basic": ("resnet18", 32, 32, 1)}


def _block(name, seed=0, folded=False):
    cfg_name, cin, planes, stride = BLOCKS[name]
    cfg = tr.RESNET_CONFIGS[cfg_name]
    torch.manual_seed(seed)
    block = (tr.BasicBlock if cfg.block == "basic" else tr.Bottleneck)(cfg, cin, planes, stride)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, tr.BatchNormAffine):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    block = block.eval()
    if folded:
        holder = torch.nn.Module()
        holder.conv1, holder.bn1 = torch.nn.Conv2d(3, 4, 1, bias=False), tr.BatchNormAffine(4)
        for s in range(4):
            holder.add_module(f"layer{s + 1}", torch.nn.Sequential(block) if s == 0
                              else torch.nn.Sequential())
        block = tr.fold_batchnorm(holder).layer1[0]
    return block, cin


def _pairs(block):
    """(conv, bn or None) of every convolution of the block."""
    out = [(getattr(block, f"conv{c}"), getattr(block, f"bn{c}"))
           for c in (1, 2, 3) if hasattr(block, f"conv{c}")]
    if block.downsample is not None:
        ds = block.downsample
        out.append((ds[0], ds[1] if len(ds) > 1 else None))
    return out


def _fresh(conv, bn, device="cpu"):
    """The per-call packing of ``fused_conv``: the affine, then pack_weights."""
    with torch.no_grad():
        scale, shift = (None, conv.bias) if bn is None else bn.affine()
        return tconv.pack_weights(conv.weight, conv.groups, scale, shift, device)


def _same(a, b):
    for k in ("w", "scale", "shift"):
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(a[k], b[k]), k
    assert a["groups"] == b["groups"] and a["extra"] == b["extra"]


def _forward(block, x):
    with torch.inference_mode():
        return block(x, torch.bfloat16)


def _input(cin, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, cin, 9, 7), generator=g).bfloat16().contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("folded", [False, True], ids=["affine", "folded"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_cached_operands_equal_a_fresh_pack(name, folded):
    """Bit for bit: the bf16 weights in (cout, kh, kw, cin / groups), the
    fp32 scale and shift (folded: no scale, the bias as shift)."""
    block, _ = _block(name, folded=folded)
    for conv, bn in _pairs(block):
        cached = tr._conv_operands(conv, bn, torch.device("cpu"))
        _same(cached, _fresh(conv, bn))
        want_w = conv.weight.detach().to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
        assert torch.equal(cached["w"], want_w)
        assert (cached["scale"] is None) == folded
        assert cached["shift"].dtype == torch.float32


def test_stem_weights_are_padded_once():
    """The stem's 3 input channels packed as 4, the fourth zero."""
    conv, bn = torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False), tr.BatchNormAffine(64)
    cached = tr._conv_operands(conv, bn, torch.device("cpu"))
    assert cached["w"].shape == (64, 7, 7, 4) and cached["extra"] == 1
    assert torch.equal(cached["w"][..., :3], conv.weight.detach().bfloat16().permute(0, 2, 3, 1))
    assert not cached["w"][..., 3].any()


def test_bn_affine_equals_batchnorm_affine():
    """The cached (scale, shift) are ``BatchNormAffine.affine()`` bit for bit."""
    block, _ = _block("bottleneck_s2")
    for conv, bn in _pairs(block):
        scale, shift = bn.affine()
        cached = tr._conv_operands(conv, bn, torch.device("cpu"))
        assert torch.equal(cached["scale"], scale.detach()) and \
            torch.equal(cached["shift"], shift.detach())


def test_operands_are_reused_while_the_parameters_stay():
    """Two forwards: every convolution's operands are the same objects."""
    block, cin = _block("bottleneck_s2")
    x = _input(cin)
    first = _forward(block, x)
    ids = [id(tr._conv_operands(c, b, x.device)) for c, b in _pairs(block)]
    assert torch.equal(_forward(block, x), first)
    assert ids == [id(tr._conv_operands(c, b, x.device)) for c, b in _pairs(block)]
    assert tr._conv_operands(block.conv1, block.bn1, torch.device("meta")) is not \
        tr._conv_operands(block.conv1, block.bn1, torch.device("cpu"))


def _change(how, block, other):
    """Change ``block``'s parameters as ``how`` says (to ``other``'s values
    where it loads them); returns the block to run."""
    if how == "load_state_dict":
        block.load_state_dict(other.state_dict())
    elif how == "in_place":
        with torch.no_grad():
            block.conv2.weight.mul_(-1.5)
    elif how == "bn_statistic":
        with torch.no_grad():
            block.bn2.running_var.mul_(4.0)
    elif how == "fold_batchnorm":
        holder = torch.nn.Module()
        holder.conv1, holder.bn1 = torch.nn.Conv2d(3, 4, 1, bias=False), tr.BatchNormAffine(4)
        for s in range(4):
            holder.add_module(f"layer{s + 1}", torch.nn.Sequential(block) if s == 0
                              else torch.nn.Sequential())
        block = tr.fold_batchnorm(holder).layer1[0]
    elif how == "to":
        block = block.double().float()
    elif how == "optimizer_step":
        opt = torch.optim.SGD(block.parameters(), lr=0.5)
        x = _input(block.conv1.in_channels).float()
        block.train()
        block(x, torch.float32, grad_safe=True).square().mean().backward()
        opt.step()
        block.eval()
    return block


@pytest.mark.parametrize("how", ["load_state_dict", "in_place", "bn_statistic",
                                 "fold_batchnorm", "to", "optimizer_step"])
def test_a_change_of_parameters_repacks(how):
    """After the change every convolution's cached operands equal a fresh
    pack of its new parameters, and the block's bf16 forward equals a copy
    that never ran (nothing cached)."""
    block, cin = _block("bottleneck_s2")
    x = _input(cin)
    before = _forward(block, x)
    old = {id(c): tr._conv_operands(c, b, x.device) for c, b in _pairs(block)}
    block = _change(how, block, _block("bottleneck_s2", seed=7)[0])
    never_ran = copy.deepcopy(block)
    for m in never_ran.modules():
        m.__dict__.pop("_packed_operands", None)
    after = _forward(block, x)
    assert torch.equal(after, _forward(never_ran, x))
    # a round trip through fp64 moves the storages, not the values
    assert torch.equal(after, before) == (how == "to")
    for conv, bn in _pairs(block):
        cached = tr._conv_operands(conv, bn, x.device)
        _same(cached, _fresh(conv, bn))
    changed = [c for c, b in _pairs(block)
               if old.get(id(c)) is not tr._conv_operands(c, b, x.device)]
    assert changed
