"""Plain float32 forward of DINOv2's ViT with registers under the GeM -> FC
-> L2 head: the yardstick of the vision transformer cells. The benchmark's
copy of ``tests/plain_vit_gem.py``, with the interface of
``reference/resnet_gem.py``.

It reads the raw state dict the benchmark drew (``harness/vit_weights.py``)
and the configuration's widths, and runs plain torch with TF32 off: the
patch embedding as the stride-14 convolution, the position table resampled
on every call (bicubic, ``antialias=True``, no offset), attention as
``softmax(q k^T / sqrt(hd)) v`` with the whole score matrix, exact GELU,
LayerNorm, LayerScale, then GeM (p from ``adpool.p``) over the final-normed
patch tokens, the FC and an L2 normalisation. It imports nothing of the
program. Departures from DINOv2: an input whose sides are not whole patches
is cropped to whole patches (DINOv2 asserts divisibility), and the head is
this repository's GeM, FC and L2 (DINOv2 returns its class token).

``precision="fp8"`` is the control: every operand of every linear layer
(the patch embedding and the FC included) and of both attention products
rounded to float8 e4m3 (one scale a tensor, amax to 448), summed in fp32,
the step below the configuration's bf16.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

GEM_EPS = 1e-6
FP8_MAX = 448.0
# images a pass: the score matrices of one pass are chunk x heads x N^2 fp32
CHUNK = 2


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (amax to 448), back in fp32."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
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


class Forward:
    """The descriptor forward of one configuration's ``model`` widths."""

    def __init__(self, model: dict, preprocess: dict, sd: Dict[str, torch.Tensor],
                 precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.model, self.sd, self.precision = model, sd, precision
        self.mean = torch.tensor(preprocess["mean"], dtype=torch.float32)
        self.std = torch.tensor(preprocess["std"], dtype=torch.float32)

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.precision == "fp8" else t

    def _linear(self, x, key: str) -> torch.Tensor:
        op = self._operand
        return op(x) @ op(self.sd[key + ".weight"].float()).T + self.sd[key + ".bias"].float()

    def _norm(self, x, key: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.sd[key + ".weight"].float(),
                            self.sd[key + ".bias"].float(), float(self.model["ln_eps"]))

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The final-normed tokens (B, N, D) of normalized NCHW fp32 ``x``."""
        m, sd, op = self.model, self.sd, self._operand
        p, heads = m["patch_size"], m["num_heads"]
        b, _, height, width = x.shape
        h, w = height // p, width // p
        x = F.conv2d(op(x[:, :, :h * p, :w * p]), op(sd["patch_embed.proj.weight"].float()),
                     sd["patch_embed.proj.bias"].float(), stride=p)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([sd["cls_token"].float().expand(b, -1, -1), x], dim=1)
        x = x + positions(sd, h, w)
        x = torch.cat([x[:, :1], sd["register_tokens"].float().expand(b, -1, -1), x[:, 1:]],
                      dim=1)
        n, d = x.shape[1], x.shape[2]
        for i in range(m["depth"]):
            pre = f"blocks.{i}."
            qkv = self._linear(self._norm(x, pre + "norm1"), pre + "attn.qkv")
            q, k, v = qkv.reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
            attn = (op(q) @ op(k).transpose(-2, -1) / math.sqrt(d // heads)).softmax(dim=-1)
            out = (op(attn) @ op(v)).transpose(1, 2).reshape(b, n, d)
            del attn, q, k, v, qkv
            x = x + sd[pre + "ls1.gamma"].float() * self._linear(out, pre + "attn.proj")
            hidden = F.gelu(self._linear(self._norm(x, pre + "norm2"), pre + "mlp.fc1"))
            x = x + sd[pre + "ls2.gamma"].float() * self._linear(hidden, pre + "mlp.fc2")
        return self._norm(x, "norm")

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, out_dim) fp32 unit descriptors, on the
        images' device, CHUNK images a pass."""
        return torch.cat([self._descriptors(images[i:i + CHUNK])
                          for i in range(0, len(images), CHUNK)])

    def _descriptors(self, images: torch.Tensor) -> torch.Tensor:
        dev = images.device
        x = images.permute(0, 3, 1, 2).float() / 255.0
        x = (x - self.mean.to(dev)[None, :, None, None]) / self.std.to(dev)[None, :, None, None]
        patches = self.tokens(x)[:, 1 + self.model["num_registers"]:]
        gp = self.sd["adpool.p"].float().reshape(())
        pooled = patches.clamp_min(GEM_EPS).pow(gp).mean(dim=1).pow(1.0 / gp)
        desc = self._operand(pooled) @ self._operand(self.sd["fc.weight"].float()).T \
            + self.sd["fc.bias"].float()
        return desc / desc.norm(dim=1, keepdim=True).clamp_min(1e-12)


class Extractor:
    """The reference in the program's ``FeatureExtractor``'s place (the
    control): (B, H, W, 3) uint8 batches to (B, out_dim) descriptors on
    ``device``, in ``precision``."""

    def __init__(self, config: dict, sd: Dict[str, torch.Tensor], device,
                 precision: str = "fp8"):
        self.device = torch.device(device)
        self.preprocess = dict(config["preprocess"])
        self.forward = Forward(config["model"], config["preprocess"], sd, precision)

    @torch.no_grad()
    def __call__(self, images, mask=None) -> torch.Tensor:
        if mask is not None:
            raise ValueError("the reference takes whole images, not padded buckets")
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self.forward(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
