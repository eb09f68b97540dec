"""ResNet backbone with a BN-affine forward (counterpart of
``dirjax/models/resnet.py``).

Modules are named after the reference state_dict (``conv1``, ``bn1``,
``layerN.B.convC``/``bnC``, ``downsample.0``/``.1``), so reference weights
load with ``load_state_dict``. Activations are NCHW in ``channels_last``
memory format. ``dtype`` is the conv compute dtype: the BN affine, ReLU and
residual add run in fp32, and each block writes its output in ``dtype``
(``dirjax/models/resnet.py:278``), as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNetConfig", "RESNET_CONFIGS", "ResNet", "BatchNormAffine",
           "BN_EPS", "RGB_MEANS", "RGB_STDS"]

BN_EPS = 1e-5

RGB_MEANS = (0.485, 0.456, 0.406)
RGB_STDS = (0.229, 0.224, 0.225)

_BLOCK_EXPANSION = {"basic": 1, "bottleneck": 4}
_STAGE_PLANES = (64, 128, 256, 512)


@dataclass(frozen=True)
class ResNetConfig:
    block: str                  # 'basic' | 'bottleneck'
    layers: Tuple[int, ...]     # blocks per stage
    name: str = "resnet"

    @property
    def expansion(self) -> int:
        return _BLOCK_EXPANSION[self.block]

    @property
    def out_channels(self) -> int:
        return 512 * self.expansion


RESNET_CONFIGS = {
    "resnet18": ResNetConfig("basic", (2, 2, 2, 2), "resnet18"),
    "resnet50": ResNetConfig("bottleneck", (3, 4, 6, 3), "resnet50"),
    "resnet101": ResNetConfig("bottleneck", (3, 4, 23, 3), "resnet101"),
    "resnet152": ResNetConfig("bottleneck", (3, 8, 36, 3), "resnet152"),
}


class BatchNormAffine(nn.Module):
    """Inference batch norm evaluated as one fp32 affine,
    x * (w / sqrt(var + eps)) + (b - mean * w / sqrt(var + eps)).
    Same state_dict keys as ``nn.BatchNorm2d`` but ``num_batches_tracked``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * scale
        return x.float() * scale[:, None, None] + shift[:, None, None]


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def _conv_layer(cin, cout, k, stride=1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = _conv_layer(cin, planes, 3, stride)
        self.bn1 = BatchNormAffine(planes)
        self.conv2 = _conv_layer(planes, planes, 3)
        self.bn2 = BatchNormAffine(planes)
        self.downsample = _downsample(cin, planes, stride)

    def forward(self, x, dtype):
        out = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        out = self.bn2(_conv(out, self.conv2, dtype))
        return _finish(out, x, self.downsample, dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        cout = planes * 4
        self.conv1 = _conv_layer(cin, planes, 1)
        self.bn1 = BatchNormAffine(planes)
        self.conv2 = _conv_layer(planes, planes, 3, stride)
        self.bn2 = BatchNormAffine(planes)
        self.conv3 = _conv_layer(planes, cout, 1)
        self.bn3 = BatchNormAffine(cout)
        self.downsample = _downsample(cin, cout, stride)

    def forward(self, x, dtype):
        out = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        out = F.relu(self.bn2(_conv(out, self.conv2, dtype)))
        out = self.bn3(_conv(out, self.conv3, dtype))
        return _finish(out, x, self.downsample, dtype)


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv_layer(cin, cout, 1, stride), BatchNormAffine(cout))


def _finish(out, x, downsample, dtype):
    residual = x if downsample is None else downsample[1](
        _conv(x, downsample[0], dtype))
    return F.relu(out + residual.float()).to(dtype)


class ResNet(nn.Module):
    """Stem + four stages; ``features`` returns the C5 map (B, C5, H/32, W/32)."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.backbone_cfg = cfg
        block = BasicBlock if cfg.block == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNormAffine(64)
        cin = 64
        for s, (planes, nblocks) in enumerate(zip(_STAGE_PLANES, cfg.layers)):
            blocks = []
            for b in range(nblocks):
                stride = 2 if (s > 0 and b == 0) else 1
                blocks.append(block(cin, planes, stride))
                cin = planes * cfg.expansion
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))

    def features(self, x: torch.Tensor, dtype: torch.dtype = torch.float32):
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        # MaxPool2d(3, 2, 1) pads with -inf, as dirjax's reduce_window does
        x = F.max_pool2d(x.to(dtype), 3, 2, 1)
        for s in range(4):
            for block in getattr(self, f"layer{s + 1}"):
                x = block(x, dtype)
        return x
