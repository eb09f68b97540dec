"""The ViT's fused LayerScale residual update and LayerNorm
(``dirjax_torch/ops/residual_norm.py``, ``csrc/residual_norm.cu``) and the
blocks chained through it (``models/vit.py``).

On the CPU: the wrapper's refusals, its plain composition against
``addcmul_`` + ``F.layer_norm`` + ``.to`` bit for bit, and the chained
forward against the unfused per-block loop bit for bit.

On the card (marked ``cuda``, skipped without one), the kernel against the
plain composition run on the card:

- the stream ``z`` within 2^-22 of |z| + |gamma * y|, a few fp32 ulps of
  its summands: the kernel takes one fma where the composition may round
  the product first;
- an fp32 output within rtol 1e-5 / atol 1e-5: the row's mean and variance
  are summed in another order (two passes in registers against ATen's
  Welford), a few fp32 ulps of values of order 1;
- a bf16 output within one bf16 ulp (2^-7 of its magnitude, plus the fp32
  slack), and unequal in at most 1e-3 of its elements: the same fp32
  value rounded, so they differ only where it lies within a few fp32 ulps
  of a bf16 rounding boundary (about 2^-15 of the elements).

The file imports no jax, so on a machine with the card run it without
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vit_norm.py
"""

import pytest
import torch
import torch.nn.functional as F

from dirjax_torch.models import ViTConfig, ViTDescriptor, ViTDescriptorConfig, vit
from dirjax_torch.ops import residual_norm as rn

torch.set_num_threads(1)

TINY = ViTConfig("tiny", embed_dim=128, depth=3, num_heads=2, mlp_dim=512, pos_grid=4)
EPS = 1e-6
BF16_APART = 1e-3


def operands(shape, branch, seed=0, device="cpu"):
    """z (fp32), y (``branch`` dtype or None), gamma, weight, bias drawn as
    the ViT's are: the stream off zero, LayerScale 0.1-0.5."""
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    z = torch.randn(shape, generator=g) * 2.0 + 0.5
    y = None if branch is None else torch.randn(shape, generator=g).to(branch)
    gamma = None if branch is None else torch.rand(d, generator=g) * 0.4 + 0.1
    w = torch.rand(d, generator=g) * 0.4 + 0.8
    b = torch.randn(d, generator=g) * 0.05
    return [None if t is None else t.to(device) for t in (z, y, gamma, w, b)]


def composition(z, y, gamma, w, b, out_dtype):
    if y is not None:
        z.addcmul_(y, gamma)
    return F.layer_norm(z, z.shape[-1:], w, b, EPS).to(out_dtype)


# --------------------------------------------------------------------------
# the CPU
# --------------------------------------------------------------------------

def _refusal_cases():
    z, y, gamma, w, b = operands((2, 6, 128), torch.bfloat16)
    wide = operands((2, 6, 256), torch.bfloat16)
    return {
        "z_bf16": ((z.bfloat16(), y, gamma, w, b, torch.bfloat16), "fp32 stream"),
        "z_2d": ((z[0], y[0], gamma, w, b, torch.bfloat16), "fp32 stream"),
        "y_fp16": ((z, y.half(), gamma, w, b, torch.bfloat16), "y must be bf16 or fp32"),
        "out_fp16": ((z, y, gamma, w, b, torch.float16), "out_dtype"),
        "gamma_fp64": ((z, y, gamma.double(), w, b, torch.bfloat16), "gamma must be"),
        "weight_bf16": ((z, y, gamma, w.bfloat16(), b, torch.bfloat16), "weight must be"),
        "z_transposed": ((z.transpose(1, 2).contiguous().transpose(1, 2), y, gamma, w, b,
                          torch.bfloat16), "rows must be contiguous"),
        "z_strided_cols": ((wide[0][..., ::2], None, None, w, b, torch.bfloat16),
                           "rows must be contiguous"),
        "y_other_strides": ((z[:, 1:], y[:, 1:].contiguous(), gamma, w, b, torch.bfloat16),
                            "strides"),
        "y_other_shape": ((z, y[:, 1:], gamma, w, b, torch.bfloat16), "shape"),
        "gamma_other_d": ((z, y, wide[2], w, b, torch.bfloat16), "gamma must be"),
        "bias_other_d": ((z, y, gamma, w, wide[4], torch.bfloat16), "bias must be"),
        "y_without_gamma": ((z, y, None, w, b, torch.bfloat16), "together"),
        "gamma_without_y": ((z, None, gamma, w, b, torch.bfloat16), "together"),
        "misaligned": ((torch.zeros(2 * 6 * 128 + 1)[1:].view(2, 6, 128), None, None, w, b,
                        torch.bfloat16), "aligned"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, match = _refusal_cases()[case]
    z, y, gamma, w, b, out_dtype = args
    with pytest.raises(ValueError, match=match):
        rn.fused_residual_norm(z, y, gamma, w, b, EPS, out_dtype)


@pytest.mark.parametrize("d", [64, 100, 192, 1664, 2048])
def test_wrapper_refuses_d_the_kernel_does_not_take(d):
    z, y, gamma, w, b = operands((1, 3, d), torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        rn.fused_residual_norm(z, y, gamma, w, b, EPS, torch.bfloat16)


@pytest.mark.parametrize("d", [128, 384, 1536])
def test_wrapper_refuses_an_fp32_branch_into_a_bf16_output(d):
    """The kernel is not built for it (the fp32 forward writes fp32): the
    call raises before it touches the stream."""
    z, y, gamma, w, b = operands((3, 5, d), torch.float32, seed=d)
    before = z.clone()
    with pytest.raises(ValueError, match="fp32 out_dtype"):
        rn.fused_residual_norm(z, y, gamma, w, b, EPS, torch.bfloat16)
    assert torch.equal(z, before)


@pytest.mark.parametrize("branch,out_dtype", [
    (None, torch.bfloat16), (None, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32)])
@pytest.mark.parametrize("d", [128, 384, 1536])
def test_cpu_path_is_the_plain_composition(d, branch, out_dtype):
    """The CPU path is addcmul_ + F.layer_norm + .to, bit for bit, on the
    stream and the output."""
    z, y, gamma, w, b = operands((3, 5, d), branch, seed=d)
    z_want = z.clone()
    want = composition(z_want, y, gamma, w, b, out_dtype)
    got = rn.fused_residual_norm(z, y, gamma, w, b, EPS, out_dtype)
    assert got.dtype == out_dtype and got.is_contiguous() and got.shape == (3, 5, d)
    assert torch.equal(got, want)
    assert torch.equal(z, z_want)


def test_cpu_path_takes_the_patch_rows_of_a_stream():
    """The last launch's operands: z[:, front:] and y[:, front:] of a token
    stream; the front rows stay as they were, the output is a contiguous
    fp32 map of the patch rows."""
    z, y, gamma, w, b = operands((2, 9, 128), torch.bfloat16)
    before = z.clone()
    got = rn.fused_residual_norm(z[:, 5:], y[:, 5:], gamma, w, b, EPS, torch.float32)
    want_z = before.clone()
    want = composition(want_z[:, 5:], y[:, 5:], gamma, w, b, torch.float32)
    assert got.is_contiguous() and got.shape == (2, 4, 128)
    assert torch.equal(got, want) and torch.equal(z, want_z)
    assert torch.equal(z[:, :5], before[:, :5])


@pytest.fixture(scope="module")
def tiny():
    import plain_vit_gem as plain

    model = ViTDescriptor(ViTDescriptorConfig(backbone=TINY, out_dim=128), "tiny").eval()
    model.load_state_dict(plain.draw({k: v.shape for k, v in model.state_dict().items()}, 22))
    return model


def unfused_patch_map(model, images, dtype):
    """The forward as it ran before the blocks were chained: each block on
    its own with three launches a residual update (addcmul_, layer_norm,
    .to), then the final norm on the patch tokens."""
    cfg = model.vit_cfg
    B, _, H, W = images.shape
    p, d = cfg.patch_size, cfg.embed_dim
    h, w = cfg.grid(H, W)
    front = 1 + cfg.num_registers
    x = images.permute(0, 2, 3, 1)[:, :h * p, :w * p]
    rows = (x.reshape(B, h, p, w, p, 3).permute(0, 1, 3, 2, 4, 5).to(dtype)
            .reshape(B * h * w, p * p * 3))
    patches = F.linear(rows, *model._patch_operands(dtype)).view(B, h * w, d)
    z = torch.empty((B, front + h * w, d), dtype=torch.float32, device=images.device)
    z[:, 0] = model.cls_token[0, 0] + model.pos_embed[0, 0]
    z[:, 1:front] = model.register_tokens[0]
    torch.add(patches, model._patch_pos(h, w), out=z[:, front:])
    for blk in model.blocks:
        z.addcmul_(blk.attn(blk.norm1(z).to(dtype), dtype), blk.ls1.gamma)
        z.addcmul_(blk.mlp(blk.norm2(z).to(dtype), dtype), blk.ls2.gamma)
    return model.norm(z[:, front:]).view(B, h, w, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chained_blocks_are_the_unfused_loop(tiny, dtype):
    """On the CPU the chained forward (each residual update with the next
    norm) gives the unfused per-block loop's patch map bit for bit, and
    makes 2 * depth + 1 fused calls."""
    g = torch.Generator().manual_seed(7)
    images = torch.randn((2, 3, 74, 45), generator=g)
    calls = vit.residual_norm_calls
    with torch.inference_mode():
        got = tiny.patch_map(images, dtype)
        want = unfused_patch_map(tiny, images, dtype)
    assert vit.residual_norm_calls - calls == 2 * TINY.depth + 1
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def check_against_composition(z0, y, gamma, w, b, out_dtype, rows=slice(None)):
    """The kernel on a copy of z0 (its rows ``rows`` of the token axis)
    against the composition on another copy."""
    z_got, z_want = z0.clone(), z0.clone()
    got = rn.fused_residual_norm(z_got[:, rows], None if y is None else y[:, rows], gamma, w, b, EPS,
                           out_dtype)
    want = composition(z_want[:, rows], None if y is None else y[:, rows], gamma, w, b,
                       out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.is_contiguous() and got.shape == want.shape
    if y is None:
        assert torch.equal(z_got, z0)
    else:
        summands = z0[:, rows].abs() + (gamma * y[:, rows].float()).abs()
        assert ((z_got[:, rows] - z_want[:, rows]).abs() <= 2.0 ** -22 * summands).all()
        if rows.start:
            assert torch.equal(z_got[:, :rows.start], z0[:, :rows.start])
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return 0.0
    diff = (got.float() - want.float()).abs()
    assert (diff <= want.float().abs() * 2.0 ** -7 + 1e-5).all()
    apart = (got != want).float().mean().item()
    assert apart <= BF16_APART, apart
    return apart


@pytest.mark.cuda
@pytest.mark.parametrize("branch,out_dtype", [
    (None, torch.bfloat16), (None, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32)])
@pytest.mark.parametrize("d", [128, 384, 1024, 1536])
def test_kernel_matches_the_composition(cuda, d, branch, out_dtype):
    """3 x 37 rows: 111, not a multiple of the 8 rows a CTA takes."""
    check_against_composition(*operands((3, 37, d), branch, seed=d, device=cuda), out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", [torch.bfloat16, torch.float32])
def test_kernel_takes_the_patch_rows_of_a_stream(cuda, branch):
    """The last launch: z[:, 5:] and y[:, 5:] of a (2, 5 + 301, 1024)
    stream, an fp32 map out; the five front rows untouched."""
    check_against_composition(*operands((2, 306, 1024), branch, seed=3, device=cuda),
                              torch.float32, rows=slice(5, None))


@pytest.mark.cuda
def test_kernel_at_the_main_path_shape(cuda):
    """(8, 4,020, 1,024), a bf16 branch and output, as cell 6's blocks
    launch it."""
    apart = check_against_composition(
        *operands((8, 4020, 1024), torch.bfloat16, seed=8, device=cuda), torch.bfloat16)
    print(f"bf16 outputs apart: {apart:.2e}")


@pytest.mark.cuda
def test_kernel_refuses_a_gradient(cuda):
    z, y, gamma, w, b = operands((1, 4, 128), torch.bfloat16, device=cuda)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        rn.fused_residual_norm(z, y, gamma, w, b, EPS, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_launches_the_kernel_2_depth_plus_1_times(cuda, tiny, dtype):
    """The tiny ViT on the card: 2 * depth + 1 fused calls, each a launch
    of the kernel, which the profile shows beside no addcmul or LayerNorm
    kernel; the
    patch map within 1e-4 (fp32) or 0.02 (bf16) of the unfused loop run on
    the card: the few bf16 rows a ulp apart feed three blocks of bf16
    GEMMs."""
    from torch.profiler import ProfilerActivity, profile

    model = tiny.to(cuda)
    images = torch.randn((2, 3, 74, 45), generator=torch.Generator().manual_seed(7)).to(cuda)
    try:
        calls, launches = vit.residual_norm_calls, rn.launches
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = model.patch_map(images, dtype)
            torch.cuda.synchronize()
        assert vit.residual_norm_calls - calls == 2 * TINY.depth + 1
        assert rn.launches - launches == 2 * TINY.depth + 1
        names = [e.key for e in prof.key_averages()]
        # the counters count the launches; the profile, which may lose
        # events, shows the kernel ran and the unfused ones did not
        assert [n for n in names if "residual_norm_kernel" in n], names
        assert not [n for n in names if "addcmul" in n or "layer_norm" in n], names
        with torch.inference_mode():
            want = unfused_patch_map(model, images, dtype)
        torch.testing.assert_close(got, want, rtol=0.02 if dtype == torch.bfloat16 else 1e-4,
                                   atol=0.02 if dtype == torch.bfloat16 else 1e-4)
    finally:
        tiny.to("cpu")

