"""Plain float32 forward of DINOv2's ViT with registers under the GeM -> FC
-> L2 head: the yardstick the port's ``dirjax_torch/models/vit.py`` is held
to in the tests. It imports nothing of the port and runs plain torch, no
kernel, no cache, no batching trick: the patch embedding as the stride-14
convolution, the position table resampled on every call, attention as
``softmax(q k^T / sqrt(hd)) v`` with the whole score matrix. Call it with
TF32 off (:func:`forward` turns it off itself).

It follows DINOv2's ``vision_transformer.py`` (``prepare_tokens_with_masks``,
``interpolate_pos_encoding`` with ``interpolate_antialias=True`` and
``interpolate_offset=0``, ``Block``, ``Attention``, ``Mlp``, ``LayerScale``)
with these departures:

- an input whose sides are not whole patches is cropped to whole patches
  (the last H mod 14 rows and W mod 14 columns dropped), where DINOv2
  asserts divisibility;
- the head is this repository's GeM (p from ``adpool.p``, clamped at 1e-6)
  over the final-normed patch tokens, then the FC and an L2 normalisation,
  where DINOv2 returns its class token;
- the final LayerNorm is applied to every token, as DINOv2 applies it, and
  only the patch tokens are pooled.

``operand`` rounds each operand of every linear layer (the patch embedding
and the FC included) and of both attention products before it is used: the
identity for the fp32 forward, an fp8 rounding for a control.

:func:`draw` gives seeded weights under which every block counts.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

GEM_EPS = 1e-6


def draw(shapes: Dict[str, torch.Size], seed: int) -> Dict[str, torch.Tensor]:
    """A state dict of the given shapes (DINOv2's keys and the head's) from
    ``seed``: linear weights N(0, 1/fan_in) (the qkv projection 2^2/fan_in,
    so attention rows are peaked), biases N(0, 0.02^2), LayerNorm gains
    U(0.8, 1.2) and shifts N(0, 0.05^2), LayerScale gammas U(0.1, 0.5) (not
    DINOv2's 1e-5 initialisation, under which every block would be nearly
    the identity), the class, register and position tokens N(0, 0.5^2), the
    mask token 0, GeM's p 3."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in shapes.items():
        if key.endswith("gamma"):
            v = torch.rand(shape, generator=g) * 0.4 + 0.1
        elif "norm" in key:
            v = (torch.rand(shape, generator=g) * 0.4 + 0.8 if key.endswith("weight")
                 else torch.randn(shape, generator=g) * 0.05)
        elif key.endswith(".bias"):
            v = torch.randn(shape, generator=g) * 0.02
        elif key.endswith(".weight"):
            fan_in = math.prod(shape[1:])
            v = torch.randn(shape, generator=g) * (2.0 if "qkv" in key else 1.0) / fan_in ** 0.5
        elif key == "mask_token":
            v = torch.zeros(shape)
        elif key == "adpool.p":
            v = torch.full(shape, 3.0)
        else:
            v = torch.randn(shape, generator=g) * 0.5
        sd[key] = v
    return sd


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (amax to 448), in fp32."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def positions(sd: Dict[str, torch.Tensor], h: int, w: int) -> torch.Tensor:
    """(1, 1 + h*w, D): the class position and the patch table on the h x w
    grid, as DINOv2's ``interpolate_pos_encoding`` gives them."""
    table = sd["pos_embed"].float()
    m = math.isqrt(table.shape[1] - 1)
    if (h, w) == (m, m):
        return table
    grid = table[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(h, w), mode="bicubic", antialias=True)
    return torch.cat([table[:, :1], grid.permute(0, 2, 3, 1).reshape(1, h * w, -1)], dim=1)


def _linear(x, sd, key, op):
    return op(x) @ op(sd[key + ".weight"].float()).T + sd[key + ".bias"].float()


def _layer_norm(x, sd, key, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[key + ".weight"].float(),
                        sd[key + ".bias"].float(), eps)


def tokens(sd: Dict[str, torch.Tensor], widths: dict, images: torch.Tensor,
           operand: Callable = _identity, probe: Optional[list] = None) -> torch.Tensor:
    """The final-normed tokens (B, N, D) of normalized NCHW fp32 ``images``.
    ``probe``, a list, gets for each block the norms of the residual stream
    before it and of what the block added, and its attention matrices."""
    op = operand
    p, heads, eps = widths["patch_size"], widths["num_heads"], widths["ln_eps"]
    b, _, height, width = images.shape
    h, w = height // p, width // p
    x = F.conv2d(op(images[:, :, :h * p, :w * p].float()),
                 op(sd["patch_embed.proj.weight"].float()),
                 sd["patch_embed.proj.bias"].float(), stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["cls_token"].float().expand(b, -1, -1), x], dim=1)
    x = x + positions(sd, h, w)
    x = torch.cat([x[:, :1], sd["register_tokens"].float().expand(b, -1, -1), x[:, 1:]],
                  dim=1)
    n, d = x.shape[1], x.shape[2]
    for i in range(widths["depth"]):
        pre = f"blocks.{i}."
        before = x
        y = _layer_norm(x, sd, pre + "norm1", eps)
        qkv = _linear(y, sd, pre + "attn.qkv", op).reshape(b, n, 3, heads, d // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (op(q) @ op(k).transpose(-2, -1) / math.sqrt(d // heads)).softmax(dim=-1)
        out = (op(attn) @ op(v)).transpose(1, 2).reshape(b, n, d)
        x = x + sd[pre + "ls1.gamma"].float() * _linear(out, sd, pre + "attn.proj", op)
        y = _layer_norm(x, sd, pre + "norm2", eps)
        hidden = F.gelu(_linear(y, sd, pre + "mlp.fc1", op))
        x = x + sd[pre + "ls2.gamma"].float() * _linear(hidden, sd, pre + "mlp.fc2", op)
        if probe is not None:
            probe.append({"stream": before.norm().item(), "added": (x - before).norm().item(),
                          "attn": attn})
    return _layer_norm(x, sd, "norm", eps)


@torch.no_grad()
def forward(sd: Dict[str, torch.Tensor], widths: dict, images: torch.Tensor,
            operand: Callable = _identity, probe: Optional[list] = None) -> torch.Tensor:
    """(B, out_dim) fp32 unit descriptors of normalized NCHW ``images``."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = tokens(sd, widths, images, operand, probe)
        patches = x[:, 1 + widths["num_registers"]:]
        gp = sd["adpool.p"].float().reshape(())
        pooled = patches.clamp_min(GEM_EPS).pow(gp).mean(dim=1).pow(1.0 / gp)
        desc = operand(pooled) @ operand(sd["fc.weight"].float()).T + sd["fc.bias"].float()
        return desc / desc.norm(dim=1, keepdim=True).clamp_min(1e-12)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
