"""bf16 convolution with an fp32 output and a fused fp32 epilogue: the
inference convolution of dirjax's backbones (``dirjax/models/resnet.py:159-191``,
``_conv`` with ``preferred_element_type=float32`` followed by ``_bn``, the
residual add and ReLU; the FPN merge, ``dirjax/models/rmac.py:169-179``).

:func:`fused_conv` computes ``epi(conv(bf16(x), bf16(w)))`` with the
convolution accumulated and kept in fp32, and ``epi`` in fp32::

    v = acc * scale[c] + shift[c]      (each optional: a folded conv passes its bias as shift)
    v = relu(v)                         (relu="pre")
    v = v + residual                    (optional, bf16 or fp32)
    v = relu(v)                         (relu="post")

written as ``out_dtype``. Tensors are NCHW in ``channels_last`` memory, as
the port's backbone keeps them; the output is too.

On a CUDA tensor it launches the hand-written implicit-GEMM kernel of
``csrc/conv.cu`` on one of three paths, which the shape picks
(:func:`conv_path`: wgmma for channels in multiples of 64, wgmma over
64-channel spans for ResNeXt's grouped 3x3s, the stem kernel for the
3-channel stem), and raises for a shape none takes; on a CPU tensor it runs
:func:`conv_reference`, the plain PyTorch version (an fp32 convolution over
the bf16-rounded operands), which takes any shape and is also the kernel's
oracle. No other path exists. Packing (:func:`pack_weights`,
:func:`pack_input`) refuses a shape no path takes on every device. The
kernel has no backward: on the card it raises when grad mode is on and an
operand requires grad; training takes the model's ``grad_safe`` route
(``models/resnet.py``), as dirjax's does.

The operands that do not change between calls (the packed bf16 weights,
the fp32 scale and shift, and on the card the weights' TMA tensor map) are
:func:`pack_weights`' dict; :func:`fused_conv_packed` runs a convolution on
such a dict, which the backbones make once per convolution and reuse
(``models/resnet.py``), so a forward issues the kernel, its output
allocation and little else. :func:`fused_conv` packs them per call.

Bound on the card: one read of the input, weights and residual and one write
of the output against ``2 * M * cout * K`` tensor-core operations; see the
source's note.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["fused_conv", "fused_conv_packed", "conv_reference", "conv_output_hw", "pack",
           "pack_weights", "pack_input", "run_packed", "launch_args", "kernel_path",
           "conv_path", "span_weights", "reference_magnitude", "agreement", "SUM_ORDER_RTOL",
           "launches"]

#: launches of the CUDA kernel in this process (reset it to count a run)
launches = 0

#: how far two fp32 sums of the same K products, taken in other orders, may
#: lie apart, relative to the sum of the products' magnitudes. The kernel
#: adds K / 16 MMA slices one after another, each sum rounded once: at worst
#: K / 16 errors of 2^-24 each (288 at the backbones' largest K, 4608: 1.7e-5,
#: above this bound), but rounding errors of either sign add up as a random
#: walk, about sqrt(K / 16) of them (17: 1.0e-6). The bound is empirical:
#: ``agreement``'s ``max_rel`` reads the ratio, and its largest over every
#: fp32-output shape of chip_smoke.py's fused conv phase was 8.5e-7 on an
#: NVIDIA H100 80GB HBM3 (700 W)
SUM_ORDER_RTOL = 2.0 ** -16

_RELU = {"none": 0, "pre": 1, "post": 2}

#: bytes of a CUtensorMap (the weights' TMA descriptor, built on the host)
_MAP_BYTES = 128


def conv_output_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int):
    return (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1


def conv_path(cin: int, cout: int, groups: int = 1, kh: int = 1, kw: Optional[int] = None,
              stride: int = 1) -> Optional[str]:
    """The path the kernel takes for a convolution of this shape, by
    csrc/conv.cu's rule (``dirjax_conv_path``), written out here so that
    the operands are packed for it on any device:

    - "wgmma 128x128" / "wgmma 128x64": groups 1, cin and cout multiples
      of 64 (the tile is 64 wide where cout is not a multiple of 128);
    - "wgmma 128x64 grouped": a grouped conv with as many channels out as
      in, cin / groups dividing 64 and cin a multiple of 64, over 64-channel
      spans (its weights :func:`span_weights`; every grouped 3x3 of ResNeXt);
    - "stem wgmma 128x64": groups 1, at most 4 input channels, 64 outputs,
      kh and kw at most 7, stride at most 2 (the 7x7/2 stem of every
      architecture), whose kernel reads an fp32 or bf16 NHWC input where it
      lies;

    None where no path takes the shape."""
    kw = kh if kw is None else kw
    if groups > 1 and cin == cout and cin % groups == 0 and 64 % (cin // groups) == 0 \
            and cin % 64 == 0:
        return "wgmma 128x64 grouped"
    if groups == 1 and cin % 64 == 0 and cout % 64 == 0:
        return f"wgmma 128x{128 if cout % 128 == 0 else 64}"
    if groups == 1 and cin <= 4 and cout == 64 and kh <= 7 and kw <= 7 and stride <= 2:
        return "stem wgmma 128x64"
    return None


def _path_or_raise(cin, cout, groups, kh, kw, stride=1) -> str:
    """:func:`conv_path`, or a ValueError naming the shape where no path
    takes it."""
    path = conv_path(cin, cout, groups, kh, kw, stride)
    if path is None:
        raise ValueError(
            f"no path of the conv kernel takes cin {cin}, cout {cout}, groups {groups}, "
            f"kernel {kh}x{kw}, stride {stride}: it takes groups 1 with cin and cout "
            "multiples of 64 (wgmma), a grouped conv with cin == cout a multiple of 64 "
            "and cin / groups dividing 64 (wgmma over 64-channel spans), or at most 4 "
            "input channels, 64 outputs, kh and kw at most 7 and stride at most 2 (stem)")
    return path


def span_weights(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """A grouped convolution's weights (cout, cin / groups, kh, kw) as its
    wgmma path reads them, over 64-channel spans: (cout, kh, kw, 64), row n
    holding at each tap the 64 input channels of its span n // 64, its own
    group's weights where that group's channels lie and zeros elsewhere (a
    block-diagonal 64 x 64 block a tap). The zeros add exact zeros to each
    fp32 sum. Keeps the dtype and device."""
    cout, g, kh, kw = weight.shape
    first = torch.arange(cout, device=weight.device) % 64 // g * g   # n's group in its span
    cols = first[:, None] + torch.arange(g, device=weight.device)
    out = weight.new_zeros((cout, kh, kw, 64))
    return out.scatter_(3, cols[:, None, None, :].expand(cout, kh, kw, g),
                        weight.permute(0, 2, 3, 1))


def _epilogue(y, scale, shift, residual, relu):
    if scale is not None:
        y = y * scale.float()[:, None, None]
    if shift is not None:
        y = y + shift.float()[:, None, None]
    if relu == "pre":
        y = F.relu(y)
    if residual is not None:
        y = y + residual.float()
    if relu == "post":
        y = F.relu(y)
    return y


def conv_reference(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding: int = 0,
                   groups: int = 1, scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None, relu: str = "none",
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: the fp32 convolution of the bf16-rounded operands,
    then the epilogue in fp32, cast once to ``out_dtype``."""
    if relu not in _RELU:
        raise ValueError(f"relu must be one of {sorted(_RELU)}, got {relu!r}")
    y = F.conv2d(x.to(torch.bfloat16).float(), weight.to(torch.bfloat16).float(), None,
                 stride, padding, 1, groups)
    return _epilogue(y, scale, shift, residual, relu).to(out_dtype)


def reference_magnitude(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                        padding: int = 0, groups: int = 1,
                        scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|scale| * conv(|bf16(x)|, |bf16(w)|), fp32: the magnitude a reordered
    sum's error is measured against (:data:`SUM_ORDER_RTOL`), scaled as the
    epilogue scales the sum."""
    m = F.conv2d(x.to(torch.bfloat16).float().abs(), weight.to(torch.bfloat16).float().abs(),
                 None, stride, padding, 1, groups)
    return m if scale is None else m * scale.float().abs()[:, None, None]


def agreement(got: torch.Tensor, want: torch.Tensor, magnitude: torch.Tensor) -> dict:
    """The kernel's output against the plain version's on the same inputs:
    ``apart`` is the share of elements not equal, ``over`` the share that
    differ by more than SUM_ORDER_RTOL * ``magnitude`` (the sums' order),
    plus, for a bf16 output, one bf16 ulp of the larger value (a sum that
    moved across a rounding boundary); ``max_abs_err`` the largest
    difference; for an fp32 output, ``max_rel`` the largest difference over
    its magnitude (what SUM_ORDER_RTOL bounds; None for bf16, where a
    rounding flip dominates it)."""
    diff = (got.float() - want.float()).abs()
    allow = SUM_ORDER_RTOL * magnitude.float()
    max_rel = None
    if got.dtype == torch.bfloat16:
        _, exp = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
        allow = allow + torch.ldexp(torch.ones_like(allow), exp - 8)
    elif diff.numel():
        max_rel = float((diff / magnitude.float().clamp_min(torch.finfo(torch.float32).tiny))
                        .max())
    n = max(diff.numel(), 1)
    return {"apart": float((diff > 0).sum()) / n, "over": float((diff > allow).sum()) / n,
            "max_abs_err": float(diff.max()) if diff.numel() else 0.0, "max_rel": max_rel}


def fused_conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding: int = 0,
               groups: int = 1, scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
               relu: str = "none", out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x`` (B, Cin, H, W), ``weight`` (Cout, Cin / groups, kh, kw), ``scale``
    and ``shift`` (Cout,), ``residual`` (B, Cout, Ho, Wo); zero padding on
    both sides. Returns (B, Cout, Ho, Wo) ``out_dtype`` in channels_last
    memory."""
    if relu not in _RELU:
        raise ValueError(f"relu must be one of {sorted(_RELU)}, got {relu!r}")
    if x.device.type == "cpu":
        return conv_reference(x, weight, stride, padding, groups, scale, shift, residual,
                              relu, out_dtype)
    _refuse_grad(x, weight, scale, shift, residual)
    return run_packed(pack(x, weight, stride, padding, groups, scale, shift, residual, relu,
                           out_dtype))


def fused_conv_packed(x: torch.Tensor, weights: dict, stride: int = 1, padding: int = 0,
                      residual: Optional[torch.Tensor] = None, relu: str = "none",
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`fused_conv` on :func:`pack_weights`' operands (the weight, its
    groups, scale and shift); on a CPU tensor the plain version of the
    same weight, scale and shift."""
    if relu not in _RELU:
        raise ValueError(f"relu must be one of {sorted(_RELU)}, got {relu!r}")
    if x.device.type == "cpu":
        return conv_reference(x, weights["weight"], stride, padding, weights["groups"],
                              weights["scale"], weights["shift"], residual, relu, out_dtype)
    _refuse_grad(x, weights["weight"], residual)
    return run_packed(pack_input(x, weights, stride, padding, residual, relu, out_dtype))


def _refuse_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("fused_conv has no backward: call it under torch.no_grad() or "
                           "inference_mode(), or run the backbone with grad_safe=True")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"fused_conv runs on cuda or cpu, not {tensors[0].device}")


def pack(x, weight, stride=1, padding=0, groups=1, scale=None, shift=None, residual=None,
         relu="none", out_dtype=torch.bfloat16) -> dict:
    """The kernel's operands on x's CUDA device, laid out as it reads them
    (NHWC bf16 input, (cout, kh, kw, cin / groups) bf16 weights, fp32
    per-channel vectors, an NHWC residual) and its NHWC output allocated:
    what :func:`run_packed` launches on. Raises on what the kernel does not
    take."""
    return pack_input(x, pack_weights(weight, groups, scale, shift, x.device), stride, padding,
                      residual, relu, out_dtype)


def pack_weights(weight, groups=1, scale=None, shift=None, device=None) -> dict:
    """The operands of one convolution that stay the same from call to call,
    on ``device`` (default: the weight's): ``w``, the weights cast to bf16
    and permuted to (cout, kh, kw, cin / groups), with the stem's 3 input
    channels padded to 4 with zeros, or for a grouped conv on the wgmma
    path its :func:`span_weights`; ``scale`` and ``shift`` in fp32;
    ``weight`` and ``groups`` as given; ``wmap``, the
    weights' tensor map, which the first launch on the card builds. Raises
    on what the kernel does not take, a shape no path takes included (the
    stride, which the weights do not show, is checked by
    :func:`pack_input`)."""
    if weight.dim() != 4:
        raise ValueError(f"weight must be 4-D, got {tuple(weight.shape)}")
    device = weight.device if device is None else torch.device(device)
    cout, cin_g, kh, kw = weight.shape
    if cout % groups:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit {groups} groups")
    if (cout // groups) % 4:
        raise ValueError(f"the kernel's epilogue takes 4 channels at a time: cout / groups = "
                         f"{cout // groups} must be a multiple of 4")
    extra = -cin_g % 4
    if extra and groups != 1:
        raise ValueError(f"grouped convolution with {cin_g} channels a group: the "
                         "kernel takes a multiple of 4")
    path = _path_or_raise(cin_g * groups, cout, groups, kh, kw)
    wb = weight.detach().to(device=device, dtype=torch.bfloat16)
    if path == "wgmma 128x64 grouped":
        wp = span_weights(wb, groups)
    else:
        wp = wb.permute(0, 2, 3, 1)
    if extra:   # zero channels add exact zeros to every sum (the stem's 3 channels)
        wp = F.pad(wp, (0, extra))

    def per_channel(t, name):
        if t is None:
            return None
        if t.shape != (cout,):
            raise ValueError(f"{name} must be ({cout},), got {tuple(t.shape)}")
        return t.detach().to(device=device, dtype=torch.float32).contiguous()

    p = {"w": wp.contiguous(), "scale": per_channel(scale, "scale"),
         "shift": per_channel(shift, "shift"), "weight": weight, "groups": groups,
         "wmap": None}
    _check_aligned(p, ("w", "scale", "shift"))
    return p


def pack_input(x, weights: dict, stride=1, padding=0, residual=None, relu="none",
               out_dtype=torch.bfloat16) -> dict:
    """:func:`pack`'s dict from the input, the residual and
    :func:`pack_weights`' operands (which must lie on x's device). An input
    or residual in channels_last memory is read where it lies (its memory
    is NHWC); anything else is copied to NHWC. The stem path reads an fp32
    or bf16 input as it is (``x_fp32``); any other input is cast to bf16.
    Raises on a shape no path takes at this stride."""
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D, got {tuple(x.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or fp32, got {out_dtype}")
    B, cin, H, W = x.shape
    cout, cin_g, kh, kw = weights["weight"].shape
    groups = weights["groups"]
    if cin_g * groups != cin:
        raise ValueError(f"weight {tuple(weights['weight'].shape)} does not fit {cin} "
                         f"channels in {groups} groups")
    dev = x.device
    if weights["w"].device != dev:
        raise ValueError(f"the packed weights lie on {weights['w'].device}, x on {dev}")
    ho, wo = conv_output_hw(H, W, kh, kw, stride, padding)
    stem = _path_or_raise(cin, cout, groups, kh, kw, stride).startswith("stem")
    if x.dtype != torch.bfloat16 and not (stem and x.dtype == torch.float32):
        x = x.to(torch.bfloat16)
    if not x.is_contiguous(memory_format=torch.channels_last):
        xh = torch.empty((B, H, W, cin), dtype=torch.bfloat16, device=dev)
        x = xh.copy_(x.permute(0, 2, 3, 1))
    res_kind = 0
    if residual is not None:
        if residual.shape != (B, cout, ho, wo) or residual.device != dev:
            raise ValueError(f"residual must be ({B}, {cout}, {ho}, {wo}) on {dev}, "
                             f"got {tuple(residual.shape)} on {residual.device}")
        if residual.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"residual must be bf16 or fp32, got {residual.dtype}")
        res_kind = 1 if residual.dtype == torch.bfloat16 else 2
        if not residual.is_contiguous(memory_format=torch.channels_last):
            residual = residual.permute(0, 2, 3, 1).contiguous()
    p = {"x": x, "x_fp32": x.dtype == torch.float32, "weights": weights,
         "residual": residual, "res_kind": res_kind,
         "relu": _RELU[relu],
         "out": torch.empty((B, ho, wo, cout), dtype=out_dtype, device=dev),
         "dims": (B, H, W, cin, cout, kh, kw, stride, padding, groups, ho, wo)}
    _check_aligned(p, ("x", "residual"))
    return p


def _check_aligned(p: dict, names) -> None:
    """The kernel's 16-byte loads and stores: a view that starts mid-vector
    is refused."""
    for name in names:
        if p[name] is not None and p[name].data_ptr() % 16:
            raise ValueError(f"{name} starts at an address that is not 16-byte aligned "
                             f"(a view with a storage offset): pass a fresh tensor")


def kernel_path(cin: int, cout: int, groups: int = 1, kh: int = 1, kw: Optional[int] = None,
                stride: int = 1) -> Optional[str]:
    """The path the built kernel takes for a convolution of this shape on
    the card, named as :func:`conv_path` names it (the library's rule, which
    that function mirrors); None where the library refuses the shape."""
    from ..kernels.build import load_library

    code = load_library().dirjax_conv_path(cin, cout, groups, kh, kh if kw is None else kw,
                                           stride)
    return {0: None, 1: "stem wgmma 128x64", 2: "wgmma 128x64 grouped"}.get(
        code, f"wgmma 128x{code}")


def run_packed(p: dict) -> torch.Tensor:
    """Launch the kernel on :func:`pack`'s operands; returns the output as
    (B, Cout, Ho, Wo) in channels_last memory. The first launch on a set of
    packed weights builds their tensor map and keeps it with them."""
    global launches
    out = p["out"]
    if out.numel() == 0:
        return out.permute(0, 3, 1, 2)
    fn, args = launch_args(p, out)
    if out.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(out.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"conv kernel launch failed: cudaError {err}")
    launches += 1
    return out.permute(0, 3, 1, 2)


def launch_args(p: dict, out: torch.Tensor):
    """(the C entry point, its arguments) that write :func:`pack`'s
    convolution into ``out`` (NHWC, like ``p["out"]``) on the current
    stream of its device; builds the weights' tensor map on their first
    launch."""
    from ..kernels.build import load_library

    lib = load_library()
    weights = p["weights"]
    if weights["wmap"] is None:
        B, H, W, cin, cout, kh, kw, stride, padding, groups, ho, wo = p["dims"]
        wmap = ctypes.create_string_buffer(_MAP_BYTES)
        with torch.cuda.device(out.device):
            err = lib.dirjax_conv_weight_map(weights["w"].data_ptr(), cin, cout, kh, kw,
                                             groups, wmap)
        if err != 0:
            raise RuntimeError(f"conv weight tensor map failed: cudaError {err}")
        weights["wmap"] = wmap.raw
    scale, shift, residual = weights["scale"], weights["shift"], p["residual"]
    return lib.dirjax_conv_fused, (
        p["x"].data_ptr(), p["x_fp32"], weights["w"].data_ptr(), weights["wmap"],
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(),
        None if residual is None else residual.data_ptr(),
        p["res_kind"], p["relu"], out.data_ptr(), out.dtype == torch.bfloat16,
        *p["dims"], torch._C._cuda_getCurrentRawStream(out.device.index))
