"""The bf16 inference convolution contract (``dirjax_torch/ops/conv.py``)
held against dirjax on the CPU.

dirjax's inference forward (``grad_safe=False``) runs each convolution on
bf16 operands with an fp32 output (``preferred_element_type``) and its BN,
residual add and ReLU in fp32 on that output (``dirjax/models/resnet.py:159-278,
327-347``; the FPN merge, ``dirjax/models/rmac.py:169-179``); only a
block's output is cast to bf16. The port's blocks and FPN merge take
``fused_conv`` in bf16 inference, whose CPU path is its plain version (an
fp32 convolution of the bf16-rounded operands).

Bounds: bf16 outputs may differ from dirjax's in at most 1e-3 of their
elements and by a mean |difference| of at most 1e-5. Both sides sum the
same products in fp32 in different orders (XLA against oneDNN), which moves
a sum by a few fp32 ulps and flips its bf16 rounding where it lies next to a
rounding boundary: a few 1e-5 of the elements, one bf16 ulp each. A conv
output rounded to bf16 before the epilogue (what the port did before) moves
about 30% of them, by up to one ulp at their magnitude (mean 2.7e-3). fp32
outputs are held to rtol 1e-5 / atol 1e-5 (the accumulation order over K).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dirjax.models import resnet as jr
from dirjax_torch.models import resnet as tr
from dirjax_torch.ops import conv as tconv

torch.set_num_threads(1)

SHARE_APART = 1e-3    # bf16 elements that may differ from dirjax's
MEAN_APART = 1e-5     # mean |difference| of bf16 outputs
FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _bn(rng, c, lo=0.5, hi=1.5):
    return {"scale": rng.uniform(lo, hi, c).astype(np.float32),
            "bias": rng.normal(0, 0.1, c).astype(np.float32),
            "mean": rng.normal(0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _apart(got: np.ndarray, want: np.ndarray):
    """(share of elements not equal, mean |difference|)."""
    assert got.shape == want.shape
    return float(np.mean(got != want)), float(np.abs(got - want).mean())


def _assert_bf16_close(got: np.ndarray, want: np.ndarray):
    share, mean = _apart(got, want)
    assert share <= SHARE_APART and mean <= MEAN_APART, (share, mean)


def _assert_fp32_close(got: np.ndarray, want: np.ndarray):
    """At most SHARE_APART of the elements beyond FP32_TOL, mean |difference|
    at most MEAN_APART: an fp32 output downstream of a bf16 cast (the FPN's
    C4 into conv3c4) inherits the cast's rare flips."""
    diff = np.abs(got - want)
    share = float(np.mean(diff > FP32_TOL["atol"] + FP32_TOL["rtol"] * np.abs(want)))
    assert share <= SHARE_APART and diff.mean() <= MEAN_APART, (share, diff.mean())


# --- blocks -----------------------------------------------------------------

# (config, cin, planes, stride): stride 1 keeps the shortcut, stride 2 adds
# the downsample; ResNeXt's grouped 3x3 has 32 groups of 4 channels
BLOCKS = {
    "basic_s1": ("resnet18", 64, 64, 1),
    "basic_s2": ("resnet18", 64, 128, 2),
    "bottleneck_s1": ("resnet50", 256, 64, 1),
    "bottleneck_s2": ("resnet50", 256, 128, 2),
    "resnext_s2": ("resnext101_32x4d", 256, 64, 2),
}


def _block_params(name, cin, planes, stride, seed):
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jr._init_block(jax.random.PRNGKey(seed),
                                                jr.RESNET_CONFIGS[name], cin, planes, stride))
    for key in [k for k in p if k.startswith("bn")]:
        p[key] = _bn(rng, p[key]["scale"].shape[0])
    if "downsample" in p:
        p["downsample"]["bn"] = _bn(rng, p["downsample"]["bn"]["scale"].shape[0])
    x = rng.normal(0, 1, (2, 12, 10, cin)).astype(np.float32)
    return p, torch.from_numpy(x).bfloat16()


def _port_block(name, cin, planes, stride, p, folded):
    """The port's block with dirjax's (folded, if ``folded``) weights."""
    cfg = tr.RESNET_CONFIGS[name]
    block = (tr.BasicBlock if cfg.block == "basic" else tr.Bottleneck)(cfg, cin, planes, stride)

    def load(conv, bn_mod, w, bn=None, bias=None):
        conv.weight.data = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        if bias is not None:
            conv.bias = torch.nn.Parameter(torch.from_numpy(bias))
        if bn is not None:
            bn_mod.weight.data, bn_mod.bias.data = torch.from_numpy(bn["scale"]), \
                torch.from_numpy(bn["bias"])
            bn_mod.running_mean.data, bn_mod.running_var.data = \
                torch.from_numpy(bn["mean"]), torch.from_numpy(bn["var"])

    for key in [k for k in p if k.startswith("conv")]:
        c = key[4:]
        if folded:
            load(getattr(block, key), None, p[key], bias=p["bias" + c])
            setattr(block, "bn" + c, None)
        else:
            load(getattr(block, key), getattr(block, "bn" + c), p[key], bn=p["bn" + c])
    if "downsample" in p:
        ds = p["downsample"]
        if folded:
            load(block.downsample[0], None, ds["conv"], bias=ds["bias"])
            del block.downsample[1]
        else:
            load(block.downsample[0], block.downsample[1], ds["conv"], bn=ds["bn"])
    return block.eval()


def _run_port_block(block, x, grad_safe=False):
    with torch.inference_mode():
        y = block(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last),
                  torch.bfloat16, grad_safe=grad_safe)
    assert y.dtype == torch.bfloat16
    return y.float().permute(0, 2, 3, 1).numpy()


SEEDS = range(31, 36)
SEED_SLACK = 10       # a single seed's allowance over SHARE_APART / MEAN_APART


def _block_apart(block, folded, grad_safe=False, port_grad_safe=None):
    """(share, mean) of the port's block against dirjax's for each seed;
    ``port_grad_safe`` runs the port's block on another route than
    dirjax's."""
    name, cin, planes, stride = BLOCKS[block]
    fn = jr._apply_block_folded if folded else jr._apply_block
    kw = {} if folded else {"grad_safe": grad_safe}
    out = []
    for seed in SEEDS:
        p, x = _block_params(name, cin, planes, stride, seed)
        if folded:
            p = jr.fold_batchnorm(p)
        want = np.asarray(fn(jnp.asarray(x.float().numpy(), jnp.bfloat16), p,
                             jr.RESNET_CONFIGS[name], stride, dtype=jnp.bfloat16,
                             precision=None, **kw).astype(jnp.float32))
        route = grad_safe if port_grad_safe is None else port_grad_safe
        got = _run_port_block(_port_block(name, cin, planes, stride, p, folded), x, route)
        out.append(_apart(got, want))
    return np.array(out)


def _assert_blocks_close(apart):
    """SHARE_APART and MEAN_APART on the median over SEEDS, SEED_SLACK times
    them on every seed. A flipped bf16 rounding of a block's intermediate
    (from the order of the fp32 sums) moves outputs of the next convolution
    across a rounding boundary, so a seed now and then reads more than
    SHARE_APART of its elements apart, and how far a flip spreads depends on
    the oneDNN kernel the CPU picks: on one machine the most was 2.9e-3
    (basic_s1 affine, seed 35; grad_safe bottleneck_s1 seed 31, 3.5e-3),
    on another 5.14e-3 (bottleneck_s2 affine, seed 34: 158 of 30,720
    outputs; mean 2.1e-5). The median does not follow such a seed, and
    rounding every conv output to bf16 moves 20-31% of them in every seed:
    the per-seed bound, 1e-2, stays 20x below that. The per-convolution
    check (``test_bf16_inference_convs_match_dirjax``) holds each
    convolution to SHARE_APART itself, with no slack."""
    median = np.median(apart, axis=0)
    assert median[0] <= SHARE_APART and median[1] <= MEAN_APART, apart
    assert (apart[:, 0] <= SEED_SLACK * SHARE_APART).all() and \
        (apart[:, 1] <= SEED_SLACK * MEAN_APART).all(), apart


@pytest.mark.parametrize("folded", [False, True], ids=["affine", "folded"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bf16_inference_block_matches_dirjax(block, folded):
    """The port's bf16 inference block (BasicBlock / Bottleneck, affine or
    folded, with and without a downsample; ResNeXt's grouped one) against
    dirjax's ``_apply_block`` / ``_apply_block_folded`` with
    ``grad_safe=False``."""
    _assert_blocks_close(_block_apart(block, folded))


def _nchw(a: np.ndarray, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _conv_apart(block, folded):
    """Each convolution of the block, teacher-forced: the port's convolution
    (``models/resnet.py``'s ``_fused_conv_bn`` / ``_fused_shortcut``, the
    calls its block makes) and dirjax's ``_conv`` + ``_bn`` (folded: + the
    bias; ``dirjax/models/resnet.py:159-191, 327-347``) on the same bf16
    input, dirjax's own intermediate, so that no flipped rounding upstream
    reaches the convolution under test. Returns {conv: [(share, mean) or,
    for the downsample's fp32 output, (share beyond FP32_TOL, mean)] for
    each seed}."""
    name, cin, planes, stride = BLOCKS[block]
    cfg = jr.RESNET_CONFIGS[name]
    out = {}
    for seed in SEEDS:
        p, x = _block_params(name, cin, planes, stride, seed)
        if folded:
            p = jr.fold_batchnorm(p)
        port = _port_block(name, cin, planes, stride, p, folded)

        def jax_conv(inp, w, bn_or_bias, s, pad, groups=1):
            y = jr._conv(jnp.asarray(inp, jnp.bfloat16), w, s, pad, groups, dtype=jnp.bfloat16,
                         precision=None)
            return y + bn_or_bias if folded else jr._bn(y, bn_or_bias)

        def affine(c, ds=False):
            if ds:
                return p["downsample"]["bias" if folded else "bn"]
            return p[("bias" if folded else "bn") + c]

        def port_conv(inp, c, relu="post", residual=None, out_dtype=torch.bfloat16):
            conv = getattr(port, "conv" + c)
            with torch.inference_mode():
                y = tr._fused_conv_bn(_nchw(inp), conv, getattr(port, "bn" + c), relu=relu,
                                      residual=residual, out_dtype=out_dtype)
            assert y.dtype == out_dtype
            return y.float().permute(0, 2, 3, 1).numpy()

        def bf16(a):
            return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))

        xf = x.float().numpy()
        convs = ["1", "2"] if cfg.block == "basic" else ["1", "2", "3"]
        pads = {"1": 1, "2": 1} if cfg.block == "basic" else {"1": 0, "2": 1, "3": 0}
        strides = {"1": stride} if cfg.block == "basic" else {"2": stride}
        groups = {"2": cfg.groups} if cfg.block != "basic" else {}
        # the shortcut: the block input, or the downsample's fp32 BN output
        residual, res_t = xf, x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if "downsample" in p:
            residual = np.asarray(jax_conv(xf, p["downsample"]["conv"], affine(None, True),
                                           stride, 0))
            with torch.inference_mode():
                got = tr._fused_shortcut(_nchw(xf), port.downsample)
            assert got.dtype == torch.float32
            got = got.permute(0, 2, 3, 1).numpy()
            diff = np.abs(got - residual)
            out.setdefault("downsample", []).append(
                (float(np.mean(diff > FP32_TOL["atol"] + FP32_TOL["rtol"] * np.abs(residual))),
                 float(diff.mean())))
            res_t = _nchw(residual, torch.float32)
        inp = xf
        for c in convs:
            y = jax_conv(inp, p["conv" + c], affine(c), strides.get(c, 1), pads[c],
                         groups.get(c, 1))
            last = c == convs[-1]
            want = bf16(jax.nn.relu(y + residual) if last else jax.nn.relu(y))
            got = port_conv(inp, c, residual=res_t if last else None)
            out.setdefault("conv" + c, []).append(_apart(got, want))
            inp = want   # dirjax's intermediate feeds the next convolution
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize("folded", [False, True], ids=["affine", "folded"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bf16_inference_convs_match_dirjax(block, folded):
    """Every convolution of the port's bf16 inference block (conv1/bn1,
    conv2/bn2, conv3/bn3 with the residual, the downsample), each on
    dirjax's own bf16 intermediate, against dirjax's ``_conv`` + ``_bn``:
    SHARE_APART and MEAN_APART on every seed, no slack (a bf16 output;
    the downsample's fp32 output: the share beyond FP32_TOL). Only this
    check sees a fault on each convolution rather than through a chain of
    them; rounding the conv output to bf16 before the epilogue fails it on
    every convolution."""
    for conv_name, apart in _conv_apart(block, folded).items():
        assert (apart[:, 0] <= SHARE_APART).all() and (apart[:, 1] <= MEAN_APART).all(), \
            (conv_name, apart)


@pytest.mark.parametrize("block", ["basic_s2", "bottleneck_s1", "bottleneck_s2"])
def test_grad_safe_block_matches_dirjax(block):
    """``grad_safe=True`` (training) keeps today's route: the conv emitted in
    bf16 and widened, as dirjax's ``grad_safe`` branch does
    (``dirjax/models/resnet.py:171-177``); both round each conv output to
    bf16 and agree as the inference routes do. The two routes differ: the
    bf16-output route is far from dirjax's inference block."""
    _assert_blocks_close(_block_apart(block, False, grad_safe=True))
    wrong = np.median(_block_apart(block, False, grad_safe=False, port_grad_safe=True), axis=0)
    assert wrong[0] > 0.05 and wrong[1] > 1e-4, wrong


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
@pytest.mark.parametrize("arch", ["resnet18_rmac", "resnet18_fpn_rmac"])
def test_bf16_descriptors_match_dirjax(arch, train):
    """Whole models in bf16: the port's ``forward(train=...)`` against
    dirjax's ``apply(train=...)`` (``grad_safe=train``; the inference plain
    head through K1's plain version), cosine > 0.9999 and 1e-3, the bar of
    ``test_torch_models.py::test_fold_batchnorm``'s bf16 check. (Element
    shares are no measure at this depth: a flipped rounding spreads through
    every later block.)"""
    from dirjax.models import create_model as jcreate
    from dirjax_torch.models import create_model
    from dirjax_torch.utils import checkpoints as tckpt

    jmodel = jcreate(arch)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(33)

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if set(node) == {"scale", "bias", "mean", "var"}:
            return _bn(rng, node["scale"].shape[0])
        return {k: walk(v) if isinstance(v, (dict, list)) else v for k, v in node.items()}

    params["backbone"] = walk(params["backbone"])
    model = create_model(arch)
    tckpt.load_state(model, tckpt.state_dict_from_jax_params(params, model.cfg))
    images = rng.normal(size=(2, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(images), train=train,
                                   dtype=jnp.bfloat16))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(images).permute(0, 3, 1, 2), dtype=torch.bfloat16,
                           train=train).numpy()
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() > 0.9999, cos
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# --- the FPN merge ------------------------------------------------------------

def _jax_fpn_merge(c4, c5, w1x5, w3c4):
    """``dirjax/models/rmac.py:169-179`` (fpn_mode 1), bf16 compute."""
    dtype = jnp.bfloat16
    up = jnp.repeat(jnp.repeat(c5, 2, axis=1), 2, axis=2)
    up = up[:, :c4.shape[1], :c4.shape[2], :]
    merged = jax.lax.conv_general_dilated(
        up.astype(dtype), w1x5.astype(dtype), (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    c4 = c4 + jax.nn.relu(merged)
    c4 = jax.lax.conv_general_dilated(
        c4.astype(dtype), w3c4.astype(dtype), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    return jax.nn.relu(c4)


@pytest.mark.parametrize("hw", [(8, 6), (7, 5)], ids=["even", "ragged"])
def test_fpn_merge_matches_dirjax(hw):
    """The port's bf16 inference FPN merge (``RMACDescriptor._fpn_merge``)
    against dirjax's lines, on bf16 C4 / C5 maps: fp32 output within
    FP32_TOL. A ragged C4 crops the upsampled C5."""
    from dirjax_torch.models import create_model

    model = create_model("resnet18_fpn_rmac", out_dim=16).eval()
    rng = np.random.default_rng(34)
    h, w = hw
    # C4 and C5 are block outputs: post-ReLU
    c4 = np.maximum(rng.normal(0, 1, (2, h, w, 256)), 0).astype(np.float32)
    c5 = np.maximum(rng.normal(0, 1, (2, (h + 1) // 2, (w + 1) // 2, 512)), 0).astype(np.float32)
    w1x5 = rng.normal(0, 512 ** -0.5, (1, 1, 512, 256)).astype(np.float32)
    w3c4 = rng.normal(0, (9 * 256) ** -0.5, (3, 3, 256, 256)).astype(np.float32)
    model.conv1x5.weight.data = torch.from_numpy(np.ascontiguousarray(w1x5.transpose(3, 2, 0, 1)))
    model.conv3c4.weight.data = torch.from_numpy(np.ascontiguousarray(w3c4.transpose(3, 2, 0, 1)))
    t4, t5 = (torch.from_numpy(a).bfloat16() for a in (c4, c5))
    want = np.asarray(_jax_fpn_merge(jnp.asarray(t4.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(t5.float().numpy(), jnp.bfloat16),
                                     w1x5, w3c4))
    with torch.inference_mode():
        got = model._fpn_merge(*(t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
                                 for t in (t4, t5)), torch.bfloat16)
    assert got.dtype == torch.float32
    _assert_fp32_close(got.permute(0, 2, 3, 1).numpy(), want)
    with torch.inference_mode():   # the bf16-output route (training's) is far from it
        wrong = model._fpn_merge(*(t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
                                   for t in (t4, t5)), torch.bfloat16, train=True)
    assert np.abs(wrong.permute(0, 2, 3, 1).numpy() - want).mean() > 1e-4


# --- the plain version against jax's conv -------------------------------------

# name: (cin, cout, k, stride, pad, groups, scale, shift, residual, relu, out)
EPILOGUES = {
    "stem_bn_relu": (3, 64, 7, 2, 3, 1, True, True, None, "post", "bf16"),
    "conv1x1_bn_relu": (64, 32, 1, 1, 0, 1, True, True, None, "post", "bf16"),
    "conv3x3_s2_bn_relu": (32, 32, 3, 2, 1, 1, True, True, None, "post", "bf16"),
    "downsample_bn": (64, 128, 1, 2, 0, 1, True, True, None, "none", "fp32"),
    "conv3_bn_res_bf16": (32, 128, 1, 1, 0, 1, True, True, "bf16", "post", "bf16"),
    "conv3_bn_res_fp32": (32, 128, 1, 1, 0, 1, True, True, "fp32", "post", "bf16"),
    "folded_bias_relu": (64, 32, 3, 1, 1, 1, False, True, None, "post", "bf16"),
    "fpn_relu_then_add": (128, 64, 1, 1, 0, 1, False, False, "bf16", "pre", "fp32"),
    "fpn_relu": (64, 64, 3, 1, 1, 1, False, False, None, "post", "fp32"),
    "grouped_4": (128, 128, 3, 1, 1, 32, True, True, None, "post", "bf16"),
    "grouped_8_s2": (64, 64, 3, 2, 1, 8, True, True, None, "post", "bf16"),
    "plain_fp32": (16, 16, 3, 1, 1, 1, False, False, None, "none", "fp32"),
}


@pytest.mark.parametrize("case", sorted(EPILOGUES))
def test_plain_version_matches_jax_conv(case):
    """``conv_reference`` (and ``fused_conv`` on CPU tensors, which is it)
    against ``jax.lax.conv_general_dilated(..., preferred_element_type=f32)``
    followed by the same epilogue in jnp fp32, for every epilogue the
    backbones use, Cin = 3 and grouped convolutions included."""
    cin, cout, k, stride, pad, groups, has_scale, has_shift, res, relu, out = EPILOGUES[case]
    rng = np.random.default_rng(35)
    x = rng.normal(0, 1, (2, 11, 9, cin)).astype(np.float32)
    w = rng.normal(0, (k * k * cin / groups) ** -0.5, (k, k, cin // groups, cout)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32) if has_scale else None
    shift = rng.normal(0, 0.1, cout).astype(np.float32) if has_shift else None
    ho, wo = tconv.conv_output_hw(11, 9, k, k, stride, pad)
    r = None
    if res is not None:
        r = rng.normal(0, 1, (2, ho, wo, cout)).astype(np.float32)
        if res == "bf16":
            r = torch.from_numpy(r).bfloat16().float().numpy()

    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.float32)
    v = acc
    if scale is not None:
        v = v * scale
    if shift is not None:
        v = v + shift
    if relu == "pre":
        v = jax.nn.relu(v)
    if r is not None:
        v = v + r
    if relu == "post":
        v = jax.nn.relu(v)
    out_dtype = torch.bfloat16 if out == "bf16" else torch.float32
    want = np.asarray(v.astype(jnp.bfloat16).astype(jnp.float32) if out == "bf16" else v)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    rt = None
    if r is not None:
        rt = torch.from_numpy(r).permute(0, 3, 1, 2)
        rt = rt.bfloat16() if res == "bf16" else rt
    got = tconv.fused_conv(xt, torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                           stride, pad, groups, t(scale), t(shift), rt, relu, out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, cout, ho, wo)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.float().permute(0, 2, 3, 1).numpy()
    if out == "bf16":
        _assert_bf16_close(got, want)
    else:
        np.testing.assert_allclose(got, want, **FP32_TOL)


# --- the wrapper off the CPU ------------------------------------------------

def test_wrapper_refuses_a_gradient_off_the_cpu():
    """Off the CPU the kernel runs, and it has no backward: with grad mode
    on, an operand that requires grad raises before any launch (checked on
    meta tensors here; the card test repeats it on CUDA tensors). Under
    no_grad a tensor that is on neither cuda nor the CPU raises too: there
    is no other path."""
    x = torch.empty((1, 8, 4, 4), device="meta")
    w = torch.empty((8, 8, 1, 1), device="meta")
    for args in ((x.requires_grad_(True), w), (x.detach(), w.requires_grad_(True))):
        with pytest.raises(RuntimeError, match="no backward"):
            tconv.fused_conv(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        tconv.fused_conv(x, w)
    with pytest.raises(ValueError, match="relu"):
        tconv.fused_conv(x.detach(), w.detach(), relu="after")


def test_pack_refuses_what_the_kernel_does_not_take():
    """``pack`` lays the kernel's operands out (device-neutral, so checked on
    CPU tensors) and refuses what the kernel cannot run: output channels a
    group not a multiple of 4 (its epilogue takes 4 at a time), input
    channels a group not a multiple of 4 in a grouped convolution, a shape
    no path of the kernel takes, a base address off 16 bytes (a view with a
    storage offset), a residual of another shape."""
    x = torch.randn(1, 64, 5, 5).bfloat16().contiguous(memory_format=torch.channels_last)
    w = torch.randn(64, 64, 3, 3)
    assert tconv.pack(x, w, padding=1)["out"].shape == (1, 5, 5, 64)
    with pytest.raises(ValueError, match="multiple of 4"):
        tconv.pack(x, torch.randn(66, 64, 3, 3), padding=1)            # 66 outputs
    with pytest.raises(ValueError, match="multiple of 4"):
        tconv.pack(x, w[:, :6].contiguous(), groups=4)                 # 6 channels a group
    with pytest.raises(ValueError, match="no path"):                   # 24 channels
        tconv.pack(x[:, :24], w[:24, :24].contiguous(), padding=1)
    # NHWC memory 2 bytes into its storage
    residual = torch.randn(1 + 5 * 5 * 64).bfloat16()[1:].view(1, 5, 5, 64).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="16-byte"):
        tconv.pack(x, w, padding=1, residual=residual)
    with pytest.raises(ValueError, match="residual"):
        tconv.pack(x, w, padding=1, residual=x[:, :, :4])


def test_cpu_path_keeps_gradients():
    """On the CPU the plain version is ordinary autograd: the wrapper does
    not refuse a gradient there (the CPU training tests take grad_safe
    anyway)."""
    x = torch.randn(1, 4, 5, 5, requires_grad=True)
    w = torch.randn(8, 4, 3, 3, requires_grad=True)
    tconv.fused_conv(x, w, padding=1, relu="post", out_dtype=torch.float32).sum().backward()
    assert x.grad is not None and w.grad is not None
