"""Plain float32 ResNet / ResNeXt-GeM descriptor forward: the yardstick of the
extraction cells.

It reads the raw state dict the benchmark drew (``harness/weights.py``) and
the configuration's widths, decodes the JPEG bytes with PIL itself, and runs
``F.conv2d`` with TF32 off, the batch norm as its eval formula, GeM (p from
``adpool.p``), the FC and an L2 normalisation. It imports nothing of the
program. ``precision="fp8"`` is the control: every convolution's and the
FC's operands rounded to float8 e4m3 (one scale a tensor, amax to 448),
summed in fp32, the step below the configuration's bf16.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
GEM_EPS = 1e-6
FP8_MAX = 448.0


def decode(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of an image file."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (amax to 448), back in fp32."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


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

    def _conv(self, x, key: str, stride: int = 1, groups: int = 1) -> torch.Tensor:
        w = self.sd[key + ".weight"].float()
        return F.conv2d(self._operand(x), self._operand(w), None, stride,
                        w.shape[-1] // 2, 1, groups)

    def _bn(self, x, key: str) -> torch.Tensor:
        sd = self.sd
        inv = sd[key + ".weight"] / torch.sqrt(sd[key + ".running_var"] + BN_EPS)
        shift = sd[key + ".bias"] - sd[key + ".running_mean"] * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]

    def _block(self, x, prefix: str, stride: int, has_downsample: bool) -> torch.Tensor:
        out = F.relu(self._bn(self._conv(x, prefix + ".conv1"), prefix + ".bn1"))
        out = F.relu(self._bn(self._conv(out, prefix + ".conv2", stride, self.model["groups"]),
                              prefix + ".bn2"))
        out = self._bn(self._conv(out, prefix + ".conv3"), prefix + ".bn3")
        shortcut = x
        if has_downsample:
            shortcut = self._bn(self._conv(x, prefix + ".downsample.0", stride),
                                prefix + ".downsample.1")
        return F.relu(out + shortcut)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, out_dim) fp32 unit descriptors, on the
        images' device."""
        dev = images.device
        x = images.permute(0, 3, 1, 2).float() / 255.0
        x = (x - self.mean.to(dev)[None, :, None, None]) / self.std.to(dev)[None, :, None, None]
        x = F.relu(self._bn(self._conv(x, "conv1", 2), "bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for s, blocks in enumerate(self.model["layers"]):
            for b in range(blocks):
                prefix = f"layer{s + 1}.{b}"
                x = self._block(x, prefix, 2 if s > 0 and b == 0 else 1,
                                prefix + ".downsample.0.weight" in self.sd)
        p = self.sd["adpool.p"].float().reshape(())
        pooled = x.clamp_min(GEM_EPS).pow(p).mean(dim=(2, 3)).pow(1.0 / p)
        desc = self._operand(pooled) @ self._operand(self.sd["fc.weight"].float()).T \
            + self.sd["fc.bias"]
        return desc / desc.norm(dim=1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def descriptors(model: dict, preprocess: dict, sd: Dict[str, torch.Tensor],
                paths: Sequence[str], device, precision: str = "fp32",
                batch: int = 8) -> np.ndarray:
    """Descriptors of the image files at ``paths`` (grouped by size, ``batch``
    at a time), in their order, with TF32 off."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        fwd = Forward(model, preprocess, sd, precision)
        pixels = [decode(p) for p in paths]
        out = np.zeros((len(paths), model["out_dim"]), np.float32)
        shapes: Dict[tuple, list] = {}
        for i, px in enumerate(pixels):
            shapes.setdefault(px.shape, []).append(i)
        for idx in shapes.values():
            for start in range(0, len(idx), batch):
                part = idx[start:start + batch]
                x = torch.from_numpy(np.stack([pixels[i] for i in part])).to(device)
                out[part] = fwd(x).cpu().numpy()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


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
