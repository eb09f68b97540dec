"""Global spatial pooling and multi-chain descriptor pooling (counterpart of
``dirjax/ops/pooling.py``).

Feature maps are NHWC at these functions, as in the JAX package, so the two
compare like with like; a ``channels_last`` NCHW backbone output is already
an NHWC view after ``permute(0, 2, 3, 1)``. Masks are (B, H, W) bool.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .normalize import l2_normalize

__all__ = [
    "gem_pool", "mac_pool", "avg_pool", "global_pool",
    "sympow", "sympow_pool", "pool_descriptors", "center_bias_mask",
]


def _spatial_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over H, W of an NHWC tensor, restricted to mask==True cells."""
    if mask is None:
        return x.mean(dim=(1, 2))
    m = mask.to(x.dtype)[..., None]
    total = (x * m).sum(dim=(1, 2))
    count = m.sum(dim=(1, 2)).clamp_min(1.0)
    return total / count


def gem_pool(x: torch.Tensor, p, eps: float = 1e-6,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Generalized-mean pool an NHWC map to (B, C), accumulating in fp32
    whatever the input dtype (pow/root chains lose too much in bf16)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=x.device).reshape(())
    powed = x.float().clamp_min(eps).pow(p)
    return _spatial_mean(powed, mask).pow(1.0 / p).to(x.dtype)


def mac_pool(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global max pool (MAC) over H, W of NHWC -> (B, C)."""
    if mask is not None:
        x = torch.where(mask[..., None], x, torch.finfo(x.dtype).min)
    return x.amax(dim=(1, 2))


def avg_pool(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global average pool over H, W of NHWC -> (B, C)."""
    return _spatial_mean(x, mask)


def global_pool(x: torch.Tensor, pooling: str, p=3.0,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on the reference's pooling names: 'gem*', 'max', 'avg'."""
    if pooling.startswith("gem"):
        return gem_pool(x, p, mask=mask)
    if pooling == "max":
        return mac_pool(x, mask=mask)
    if pooling == "avg":
        return avg_pool(x, mask=mask)
    raise ValueError(f"unknown pooling: {pooling}")


def sympow(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    """Signed power: sign(x) * clamp(|x|, eps)^p."""
    s = torch.sign(x)
    return (x * s).clamp_min(eps).pow(p) * s


def sympow_pool(descs: torch.Tensor, p) -> torch.Tensor:
    """Signed-power mean over dim 0 (the 'gem' combination of chains)."""
    return sympow(sympow(descs, p).mean(dim=0), 1.0 / float(p))


def pool_descriptors(descs: Union[torch.Tensor, Sequence[torch.Tensor]],
                     pooling: str = "mean", gemp: float = 3.0,
                     l2norm: bool = True) -> torch.Tensor:
    """Combine (S, N, D) per-chain descriptors into (N, D), then optionally
    L2-normalize."""
    if isinstance(descs, (list, tuple)):
        if len(descs) == 1:
            return l2_normalize(descs[0]) if l2norm else descs[0]
        descs = torch.stack(list(descs), dim=0)
    if pooling == "mean":
        out = descs.mean(dim=0)
    elif pooling == "gem":
        out = sympow_pool(descs, gemp)
    else:
        raise ValueError(f"Bad pooling mode: {pooling}")
    return l2_normalize(out) if l2norm else out


def center_bias_mask(h: int, w: int, bias: float, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """A 4x4 map with (1+bias) in the centre 2x2, bilinearly upsampled to
    (h, w) with align_corners=True."""
    base = torch.ones((4, 4), dtype=torch.float32, device=device)
    base[1:3, 1:3] += bias
    ys = torch.linspace(0.0, 3.0, h, device=device)
    xs = torch.linspace(0.0, 3.0, w, device=device)
    y0 = ys.floor().long().clamp(0, 2)
    x0 = xs.floor().long().clamp(0, 2)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    tl = base[y0][:, x0]
    tr = base[y0][:, x0 + 1]
    bl = base[y0 + 1][:, x0]
    br = base[y0 + 1][:, x0 + 1]
    out = (tl * (1 - wy) * (1 - wx) + tr * (1 - wy) * wx
           + bl * wy * (1 - wx) + br * wy * wx)
    return out.to(dtype)
