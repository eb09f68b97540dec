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
* The operands of the kernel's paths for ResNeXt's grouped 3x3s and the
  stem: the block-diagonal span packing (``span_weights``), used as a dense
  convolution over each 64-channel span in fp32, is the grouped convolution
  within 1e-6 of its products' magnitude; a shape no path takes (a group
  width that does not divide 64, more channels out than in, channels not
  in multiples of 64, a stem stride past 2) is refused at packing, while
  ``fused_conv`` on the CPU still runs its plain version; the stem path's
  operand (an fp32 NHWC input rounded to bf16 as the kernel stages it,
  round to nearest even, the fourth channel zero) is modelled in numpy and
  the wrapper passes the input as it lies; and every convolution of every
  architecture takes one of the three paths (``conv_path``, the kernel's
  rule; the card tests hold the built library to the same names).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dirjax_torch.models import resnet as tr
from dirjax_torch.ops import conv as tconv

torch.set_num_threads(1)

# (config, cin, planes, stride): a bottleneck with a downsample, ResNeXt's
# grouped one, a basic block, each at the least widths the kernel takes
BLOCKS = {"bottleneck_s2": ("resnet50", 64, 64, 2), "resnext": ("resnext101_32x4d", 256, 64, 1),
          "basic": ("resnet18", 64, 64, 1)}


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


def _block_diagonal(w):
    """(cout, kh, kw, g) per-group weights as (cout, kh, kw, 64), row n's g
    channels at its group's place in its 64-channel span, written out one
    row at a time."""
    cout, kh, kw, g = w.shape
    out = torch.zeros((cout, kh, kw, 64), dtype=w.dtype)
    for n in range(cout):
        c0 = n % 64 // g * g
        out[n, :, :, c0:c0 + g] = w[n]
    return out


def _same(a, b):
    for k in ("w", "scale", "shift"):
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(a[k], b[k]), k
    assert a["groups"] == b["groups"]


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
        if conv.groups > 1:   # the wgmma path's spans: each row's group in place
            want_w = _block_diagonal(want_w)
        assert torch.equal(cached["w"], want_w)
        assert (cached["scale"] is None) == folded
        assert cached["shift"].dtype == torch.float32


def test_stem_weights_are_padded_once():
    """The stem's 3 input channels packed as 4, the fourth zero."""
    conv, bn = torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False), tr.BatchNormAffine(64)
    cached = tr._conv_operands(conv, bn, torch.device("cpu"))
    assert cached["w"].shape == (64, 7, 7, 4)
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


# --- the operands of the grouped and stem paths ---------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("g", [4, 8, 16, 32])
def test_span_packing_is_the_grouped_conv(g, stride):
    """Each 64-channel span's block-diagonal weights as a dense fp32 conv of
    that span's input, concatenated over the spans, equal conv_reference of
    the grouped conv within 1e-6 of the products' magnitude (the same
    products, summed in another order, plus exact zeros)."""
    rng = np.random.default_rng(g + stride)
    cin = 128 if g < 32 else 256
    groups = cin // g
    x = torch.from_numpy(rng.normal(size=(2, cin, 11, 9)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, (9 * g) ** -0.5, (cin, g, 3, 3)).astype(np.float32))
    assert tconv.conv_path(cin, cin, groups, 3, 3, stride) == "wgmma 128x64 grouped"
    packed = tconv.pack_weights(w, groups)
    spans = packed["w"].float().permute(0, 3, 1, 2)         # (cout, 64, kh, kw)
    assert torch.equal(packed["w"], _block_diagonal(w.bfloat16().permute(0, 2, 3, 1)))
    xb = x.bfloat16().float()
    got = torch.cat([F.conv2d(xb[:, 64 * s:64 * s + 64], spans[64 * s:64 * s + 64], None,
                              stride, 1) for s in range(cin // 64)], dim=1)
    want = tconv.conv_reference(x, w, stride, 1, groups, out_dtype=torch.float32)
    mag = tconv.reference_magnitude(x, w, stride, 1, groups)
    assert got.shape == want.shape
    assert ((got - want).abs() <= 1e-6 * mag).all()


@pytest.mark.parametrize("cin,cout,groups,k", [(96, 96, 8, 3), (192, 192, 16, 3),
                                               (128, 256, 32, 3), (96, 96, 24, 3),
                                               (96, 96, 8, 5)],
                         ids=["g12", "g12_wide", "cout_2x", "cin_not_64s", "g12_5x5"])
def test_shapes_without_a_hopper_path_are_refused(cin, cout, groups, k):
    """A group width that does not divide 64, more channels out than in, or
    channels not in multiples of 64: no path of the kernel takes it, so
    packing its operands raises before anything could launch; ``fused_conv``
    on a CPU tensor still runs the plain version, which takes any shape."""
    assert tconv.conv_path(cin, cout, groups, k, k) is None
    gen = torch.Generator().manual_seed(3)
    w = torch.randn((cout, cin // groups, k, k), generator=gen)
    with pytest.raises(ValueError, match="no path of the conv kernel"):
        tconv.pack_weights(w, groups)
    x = torch.randn((2, cin, 7, 6), generator=gen)
    assert torch.equal(tconv.fused_conv(x, w, 1, k // 2, groups),
                       tconv.conv_reference(x, w, 1, k // 2, groups))


def test_stem_stride_past_two_is_refused():
    """The stem path takes stride 1 and 2: a stem-shaped conv at stride 3
    packs its weights (they show no stride) and is refused with its input."""
    assert tconv.conv_path(3, 64, 1, 7, 7, 3) is None
    w, x = torch.randn(64, 3, 7, 7), torch.randn(1, 3, 23, 19)
    packed = tconv.pack_weights(w)
    with pytest.raises(ValueError, match="stride 3"):
        tconv.pack_input(x, packed, 3, 3)


def _bf16_rne(a: np.ndarray) -> np.ndarray:
    """fp32 -> the bits of bf16 rounded to nearest even, by integer
    arithmetic on the fp32 bits (the kernel's __floats2bfloat162_rn)."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


@pytest.mark.parametrize("hw", [(37, 29), (24, 32)], ids=["odd", "even"])
def test_stem_operand_is_the_padded_bf16_input(hw):
    """The stem path's operand modelled in numpy (each fp32 channel rounded
    to bf16, nearest even, a zero fourth channel): the stem path gets the
    fp32 input as it lies (no copy), which that model rounds, and an NCHW
    input one NHWC bf16 copy, equal to the model's first three channels."""
    rng = np.random.default_rng(7)
    H, W = hw
    x = torch.from_numpy((rng.normal(size=(2, H, W, 3)) * 3).astype(np.float32))
    x[0, 0, 0] = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)])   # ties to even
    x = x.permute(0, 3, 1, 2)                                   # channels_last, as given
    model = np.zeros((2, H, W, 4), np.uint16)
    model[..., :3] = _bf16_rne(x.permute(0, 2, 3, 1).numpy())
    want = torch.from_numpy(model.view(np.int16)).view(torch.bfloat16)

    stem = tconv.pack(x, torch.randn(64, 3, 7, 7), 2, 3)
    assert tconv.conv_path(3, 64, 1, 7, 7, 2) == "stem wgmma 128x64"
    assert stem["x_fp32"] and stem["x"].data_ptr() == x.data_ptr() and stem["dims"][3] == 3
    assert torch.equal(torch.cat([stem["x"].permute(0, 2, 3, 1).bfloat16(),
                                  torch.zeros((2, H, W, 1), dtype=torch.bfloat16)], 3), want)
    nchw = tconv.pack(x.contiguous(), torch.randn(64, 3, 7, 7), 2, 3)
    assert not nchw["x_fp32"] and nchw["x"].shape == (2, H, W, 3)
    assert torch.equal(nchw["x"], want[..., :3])


def test_every_architecture_takes_a_hopper_path():
    """Every convolution of every architecture dirjax names: its grouped
    3x3s take the span path, its stem the stem path, the rest the wgmma
    path; none is refused. The port's ViT descriptors, which dirjax
    does not name, run no convolution: their patch embedding is a GEMM."""
    from dirjax_torch.models import create_model, is_vit
    from dirjax_torch.models.registry import model_names

    seen = set()
    for arch in model_names():
        if is_vit(arch):
            continue
        with torch.device("meta"):
            model = create_model(arch)
        for m in model.modules():
            if not isinstance(m, torch.nn.Conv2d):
                continue
            path = tconv.conv_path(m.in_channels, m.out_channels, m.groups, *m.kernel_size,
                                   m.stride[0])
            if m.groups > 1:
                assert path == "wgmma 128x64 grouped", (arch, m)
            elif m.in_channels == 3:
                assert path == "stem wgmma 128x64", (arch, m)
            else:
                assert path.startswith("wgmma 128x"), (arch, m)
            seen.add(path)
    assert seen == {"wgmma 128x64 grouped", "stem wgmma 128x64", "wgmma 128x64",
                    "wgmma 128x128"}
