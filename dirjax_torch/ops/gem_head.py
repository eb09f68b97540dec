"""Fused descriptor head: masked GeM pool -> FC -> L2 (counterpart of
``dirjax/ops/gem_head.py``).

:func:`fused_gem_head` keeps the JAX layout at its interface: x is NHWC
(B, H, W, C), W is (C, D). On a CUDA tensor it launches the hand-written
kernel of ``csrc/gem_head.cu`` or raises; on a CPU tensor it runs
:func:`gem_head_reference`, the plain PyTorch version that is also the
kernel's oracle. No other path exists.

The kernel reads W in ``torch.nn.Linear``'s own (D, C) row-major storage, so
on the card W must be the transposed view ``linear.weight.T``: the model
passes its weight without a copy, and any other layout raises.

The kernel has no backward: its output has no autograd link. So on the card
it raises when grad mode is on and any of ``x``, ``p``, ``w``, ``b``
requires grad, where a forward would otherwise drop every gradient without
an error. Training takes the plain head (``RMACDescriptor.forward(...,
train=True)``, as dirjax gates its kernel), and evaluations run under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .normalize import l2_normalize
from .pooling import gem_pool

__all__ = ["fused_gem_head", "gem_head_reference", "launches"]

_EPS = 1e-6

#: launches of the CUDA kernel in this process (reset it to count a run)
launches = 0


def gem_head_reference(x: torch.Tensor, mask: Optional[torch.Tensor], p,
                       w: torch.Tensor, b: torch.Tensor,
                       eps: float = _EPS) -> torch.Tensor:
    """Plain composition: gem_pool -> fp32 x @ W + b -> L2-normalize."""
    pooled = gem_pool(x, p, eps=eps, mask=mask)
    return l2_normalize(pooled.float() @ w + b)


def fused_gem_head(x: torch.Tensor, p, w: torch.Tensor, b: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   eps: float = _EPS) -> torch.Tensor:
    """GeM-pool an NHWC map over its ``mask``ed (B, H, W) cells, project
    with (C, D) weights + bias, L2-normalize -> (B, D) fp32. On the card,
    ``w`` is ``linear.weight.T`` (see the module docstring)."""
    if x.device.type == "cpu":
        return gem_head_reference(x.float(), mask, p, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gem_head runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (x, p, w, b)):
        raise RuntimeError("fused_gem_head has no backward: call it under "
                           "torch.no_grad() or inference_mode(), or train through "
                           "the plain head (forward(..., train=True))")
    return _launch(x, p, w, b, mask, eps)


def _launch(x, p, w, b, mask, eps) -> torch.Tensor:
    global launches
    from ..kernels.build import load_library

    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (B, H, W, C) fp32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (permute a channels_last map)")
    B, H, W, C = x.shape
    if w.shape[0] != C or w.dim() != 2 or b.shape != (w.shape[1],):
        raise ValueError(f"W must be ({C}, D) and b (D,), got {tuple(w.shape)} "
                         f"and {tuple(b.shape)}")
    for name, t in (("w.T", w.T), ("b", b)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 on {x.device} "
                             "(pass W as linear.weight.T)")
    mask_kind = 0
    if mask is not None:
        if mask.shape != (B, H, W) or mask.device != x.device:
            raise ValueError(f"mask must be ({B}, {H}, {W}) on {x.device}, got "
                             f"{tuple(mask.shape)} on {mask.device}")
        # the kernel reads a bool mask's bytes as they are (no conversion
        # launch on the main path); any other mask as fp32
        if mask.dtype == torch.bool:
            mask, mask_kind = mask.contiguous(), 1
        else:
            mask, mask_kind = mask.to(torch.float32).contiguous(), 2
    p = torch.as_tensor(p, dtype=torch.float32, device=x.device).detach().reshape(1)
    D = w.shape[1]
    out = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    if C == 0 or D == 0:
        raise ValueError("C and D must be positive")

    lib = load_library()
    with torch.cuda.device(x.device):
        pooled = torch.empty((B, C), dtype=torch.float32, device=x.device)
        # the projection's done-counters, one per 8 batch rows (the kernel zeroes them)
        counters = torch.empty((-(-B // 8),), dtype=torch.int32, device=x.device)
        err = lib.dirjax_gem_head(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            None if mask is None else mask.data_ptr(), mask_kind, p.data_ptr(),
            w.data_ptr(), b.data_ptr(), pooled.data_ptr(), counters.data_ptr(),
            out.data_ptr(), B, H * W, C, D, eps, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gem_head kernel launch failed: cudaError {err}")
    launches += 1
    return out
