"""The vision transformer's LayerScale residual update fused with the next
LayerNorm (``models/vit.py``).

:func:`fused_residual_norm` takes the fp32 residual stream ``z`` (B, n, D), an
optional branch output ``y`` (bf16 or fp32, the layout of ``z``) with its
LayerScale ``gamma``, and a LayerNorm's ``weight``, ``bias`` and ``eps``:

    z += gamma * y                       (in place, fp32; skipped without y)
    out = layer_norm(z) * weight + bias  (fp32 inside), returned in out_dtype

On a CUDA tensor it launches the hand-written kernel of
``csrc/residual_norm.cu`` or raises; on a CPU tensor it runs
:func:`residual_norm_reference`, the plain composition (``addcmul_``,
``F.layer_norm``, ``.to``) that is also the kernel's oracle. No other path
exists, and both devices take the same inputs: D a multiple of 128 up to
1536; ``z``'s rows contiguous and D apart inside a batch entry (so
``z[:, front:]`` of a token stream is taken), ``y`` of the same shape and
strides, and fp32 only with an fp32 output (the fp32 forward); ``gamma``,
``weight``, ``bias`` contiguous fp32 (D,); every row 16-byte aligned.
Anything else raises.

The kernel has no backward, so on the card it raises when grad mode is on
and any input requires grad (the ViT runs inference only, under
``torch.inference_mode()``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["fused_residual_norm", "residual_norm_reference", "launches"]

#: D the kernel takes: a multiple of D_STEP (a warp's float4s) up to MAX_D
D_STEP, MAX_D = 128, 1536
_OUT = {torch.bfloat16: 1, torch.float32: 0}
_BRANCH = {torch.bfloat16: 1, torch.float32: 2}

#: launches of the CUDA kernel in this process (reset it to count a run)
launches = 0


def residual_norm_reference(z: torch.Tensor, y: Optional[torch.Tensor],
                            gamma: Optional[torch.Tensor], weight: torch.Tensor,
                            bias: torch.Tensor, eps: float,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """Plain composition: ``z.addcmul_(y, gamma)`` (where ``y`` is given),
    then ``F.layer_norm(z)`` cast to ``out_dtype``."""
    if y is not None:
        z.addcmul_(y, gamma)
    return F.layer_norm(z, z.shape[-1:], weight, bias, eps).to(out_dtype)


def fused_residual_norm(z: torch.Tensor, y: Optional[torch.Tensor],
                        gamma: Optional[torch.Tensor], weight: torch.Tensor,
                        bias: torch.Tensor, eps: float,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """``z += gamma * y`` in place (where ``y`` is given), then the
    LayerNorm of each row of ``z`` as a contiguous (B, n, D) tensor of
    ``out_dtype`` (see the module docstring for what is taken)."""
    _check(z, y, gamma, weight, bias, out_dtype)
    if z.device.type == "cpu":
        return residual_norm_reference(z, y, gamma, weight, bias, eps, out_dtype)
    if z.device.type != "cuda":
        raise ValueError(f"fused_residual_norm runs on cuda or cpu, not {z.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (z, y, gamma, weight, bias)):
        raise RuntimeError("fused_residual_norm has no backward: call it under "
                           "torch.no_grad() or inference_mode()")
    return _launch(z, y, gamma, weight, bias, eps, out_dtype)


def _check(z, y, gamma, weight, bias, out_dtype) -> None:
    if z.dim() != 3 or z.dtype != torch.float32:
        raise ValueError(f"z must be a (B, n, D) fp32 stream, got {tuple(z.shape)} {z.dtype}")
    B, n, D = z.shape
    if D % D_STEP or not D_STEP <= D <= MAX_D:
        raise ValueError(f"D must be a multiple of {D_STEP} from {D_STEP} to {MAX_D}, got {D}")
    if z.stride(2) != 1 or z.stride(1) != D or z.stride(0) % 4 or (
            B > 1 and z.stride(0) < n * D):
        raise ValueError(f"z's rows must be contiguous and D apart within a batch entry, "
                         f"got strides {z.stride()}")
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be bf16 or fp32, got {out_dtype}")
    if (y is None) != (gamma is None):
        raise ValueError("y and gamma come together")
    if y is not None:
        if y.shape != z.shape or y.stride() != z.stride():
            raise ValueError(f"y must have z's shape {tuple(z.shape)} and strides {z.stride()}, "
                             f"got {tuple(y.shape)} and {y.stride()}")
        if y.dtype not in _BRANCH:
            raise ValueError(f"y must be bf16 or fp32, got {y.dtype}")
        if y.dtype == torch.float32 and out_dtype != torch.float32:
            raise ValueError("an fp32 y takes an fp32 out_dtype (the fp32 forward)")
    for name, t in (("gamma", gamma), ("weight", weight), ("bias", bias)):
        if t is not None and (t.shape != (D,) or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 ({D},), got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("y", y), ("gamma", gamma), ("weight", weight), ("bias", bias)):
        if t is not None and t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
    for name, t in (("z", z), ("y", y), ("gamma", gamma), ("weight", weight), ("bias", bias)):
        if t is not None and t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")


def _launch(z, y, gamma, weight, bias, eps, out_dtype) -> torch.Tensor:
    global launches
    from ..kernels.build import load_library

    B, n, D = z.shape
    out = torch.empty((B, n, D), dtype=out_dtype, device=z.device)
    if B == 0 or n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(z.device):
        err = lib.dirjax_residual_norm(
            z.data_ptr(), z.stride(0), None if y is None else y.data_ptr(),
            0 if y is None else _BRANCH[y.dtype], None if gamma is None else gamma.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(), _OUT[out_dtype], B, n, D,
            eps, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"residual_norm kernel launch failed: cudaError {err}")
    launches += 1
    return out
