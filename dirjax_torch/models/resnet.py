"""ResNet and ResNeXt backbones with a BN-affine forward, and BN folding
(counterpart of ``dirjax/models/resnet.py``).

Modules are named after the reference state_dict (``conv1``, ``bn1``,
``layerN.B.convC``/``bnC``, ``downsample.0``/``.1``), so reference weights
load with ``load_state_dict``. Activations are NCHW in ``channels_last``
memory format. ``dtype`` is the conv compute dtype: the BN affine, ReLU and
residual add run in fp32, and each block writes its output in ``dtype``
(``dirjax/models/resnet.py:278``), as the JAX package does.

Two routes, by dirjax's ``grad_safe`` (``dirjax/models/resnet.py:159-185``):
- bf16 with ``grad_safe=False`` (inference): every convolution, the stem's,
  each block's (grouped ones included) and each downsample's, is
  :func:`~dirjax_torch.ops.conv.fused_conv_packed` (the operands packed
  once per convolution, ``_conv_operands``): bf16 operands, the output kept
  in fp32 into the fused fp32 epilogue (BN affine or folded bias, residual
  add, ReLU), as dirjax's ``preferred_element_type=float32`` keeps it. The
  stem and the blocks write bf16, the downsample fp32 (dirjax's
  ``_bn(_conv(...))``). On the card that is the kernel of ``csrc/conv.cu``;
  on the CPU its plain version.
- fp32, and bf16 with ``grad_safe=True`` (training): ``_conv``, a cuDNN
  convolution in ``dtype`` widened to fp32, then the epilogue as separate
  fp32 ops. In bf16 that is dirjax's ``grad_safe`` branch, which emits the
  conv in bf16 and widens it.

:func:`fold_batchnorm` (``dirjax/models/resnet.py:285-348``) returns a copy
whose convolutions carry each BN as a per-output-channel scale and a bias;
that copy adds each bias, and runs ReLU and the residual add, in fp32 as
``dirjax/models/resnet.py:327-347`` does, and writes each block's output in
``dtype``. Nothing folds unless the caller does, as in dirjax.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import fused_conv_packed, pack_weights
from ..utils import timer

__all__ = ["ResNetConfig", "RESNET_CONFIGS", "ResNet", "BatchNormAffine",
           "BN_EPS", "RGB_MEANS", "RGB_STDS", "fold_batchnorm", "is_folded"]

BN_EPS = 1e-5

RGB_MEANS = (0.485, 0.456, 0.406)
RGB_STDS = (0.229, 0.224, 0.225)

_BLOCK_EXPANSION = {"basic": 1, "bottleneck": 4}
_STAGE_PLANES = (64, 128, 256, 512)


@dataclass(frozen=True)
class ResNetConfig:
    """``groups``/``base_width`` make the bottleneck's 3x3 a grouped conv of
    width ``planes * base_width / 64 * groups`` (ResNeXt,
    ``dirjax/models/resnet.py:42-88``)."""

    block: str                  # 'basic' | 'bottleneck'
    layers: Tuple[int, ...]     # blocks per stage
    name: str = "resnet"
    groups: int = 1
    base_width: int = 64

    @property
    def expansion(self) -> int:
        return _BLOCK_EXPANSION[self.block]

    def mid_width(self, planes: int) -> int:
        """Bottleneck middle width."""
        return int(planes * self.base_width / 64.0) * self.groups

    @property
    def out_channels(self) -> int:
        return 512 * self.expansion

    @property
    def c4_channels(self) -> int:
        return 256 * self.expansion


RESNET_CONFIGS = {
    "resnet18": ResNetConfig("basic", (2, 2, 2, 2), "resnet18"),
    "resnet50": ResNetConfig("bottleneck", (3, 4, 6, 3), "resnet50"),
    "resnet101": ResNetConfig("bottleneck", (3, 4, 23, 3), "resnet101"),
    "resnet152": ResNetConfig("bottleneck", (3, 8, 36, 3), "resnet152"),
    "resnext101_32x4d": ResNetConfig("bottleneck", (3, 4, 23, 3), "resnext101_32x4d",
                                     groups=32, base_width=4),
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

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift), each (C,) fp32."""
        scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.affine()
        return x.float() * scale[:, None, None] + shift[:, None, None]


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """conv in ``dtype``, widened to fp32; a folded conv's bias is added in
    fp32 (dirjax's ``_conv`` emits fp32 and adds the bias after it)."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                 conv.padding, conv.dilation, conv.groups).float()
    return y if conv.bias is None else y + conv.bias.float()[:, None, None]


def _conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn, dtype: torch.dtype) -> torch.Tensor:
    """conv, then its BN as an fp32 affine; folded (``bn`` None), the conv's
    own bias in fp32."""
    y = _conv(x, conv, dtype)
    return y if bn is None else bn(y)


def _fused_route(dtype: torch.dtype, grad_safe: bool) -> bool:
    """dirjax's inference contract: bf16 convolutions with an fp32 output,
    unless ``grad_safe`` (training)."""
    return dtype == torch.bfloat16 and not grad_safe


def _conv_operands(conv: nn.Conv2d, bn, device) -> dict:
    """``conv``'s packed operands on ``device``: its bf16 weights and its BN
    affine (folded: its bias), as ``fused_conv`` packs them per call, made
    once and kept on the module while its and the BN's parameters stay the
    same. The key is each tensor's storage address and version counter, so
    a new storage or an in-place write (``load_state_dict``,
    ``fold_batchnorm``'s copy, ``.to()``, an optimizer step) repacks; a
    write through ``.data``, which PyTorch leaves out of the version
    counter, is not seen."""
    tensors = (conv._parameters["weight"], conv._parameters["bias"])
    if bn is not None:
        tensors += (bn._parameters["weight"], bn._parameters["bias"],
                    bn._buffers["running_mean"], bn._buffers["running_var"])
    key = (device,) + tuple(None if t is None else (t.data_ptr(), t._version) for t in tensors)
    cached = conv.__dict__.get("_packed_operands")
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.inference_mode(False), torch.no_grad():
        scale, shift = (None, conv.bias) if bn is None else bn.affine()
        packed = pack_weights(conv.weight, conv.groups, scale, shift, device)
    conv.__dict__["_packed_operands"] = (key, packed)
    return packed


def _fused_conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn, relu: str = "post",
                   residual=None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """conv in bf16 with its BN affine (folded: its bias) and the rest of the
    epilogue fused, in fp32, written as ``out_dtype``; the weights, scale
    and shift packed once (``_conv_operands``). The wrapper's host time is
    the span ``conv.call``."""
    call = timer.begin()
    out = fused_conv_packed(x, _conv_operands(conv, bn, x.device), conv.stride[0],
                            conv.padding[0], residual, relu, out_dtype)
    timer.end(call, "conv.call")
    return out


def _fused_shortcut(x: torch.Tensor, downsample) -> torch.Tensor:
    """The block input (bf16), or the downsample's BN output in fp32, as
    dirjax's ``_bn(_conv(...))`` keeps it."""
    if downsample is None:
        return x
    return _fused_conv_bn(x, downsample[0], downsample[1] if len(downsample) > 1 else None,
                          relu="none", out_dtype=torch.float32)


def _conv_layer(cin, cout, k, stride=1, groups=1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cfg: ResNetConfig, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = _conv_layer(cin, planes, 3, stride)
        self.bn1 = BatchNormAffine(planes)
        self.conv2 = _conv_layer(planes, planes, 3)
        self.bn2 = BatchNormAffine(planes)
        self.downsample = _downsample(cin, planes, stride)

    def forward(self, x, dtype, grad_safe=False):
        if _fused_route(dtype, grad_safe):
            out = _fused_conv_bn(x, self.conv1, self.bn1)
            return _fused_conv_bn(out, self.conv2, self.bn2,
                                  residual=_fused_shortcut(x, self.downsample))
        out = F.relu(_conv_bn(x, self.conv1, self.bn1, dtype))
        out = _conv_bn(out, self.conv2, self.bn2, dtype)
        return _finish(out, x, self.downsample, dtype)


class Bottleneck(nn.Module):
    def __init__(self, cfg: ResNetConfig, cin: int, planes: int, stride: int):
        super().__init__()
        mid, cout = cfg.mid_width(planes), planes * 4
        self.conv1 = _conv_layer(cin, mid, 1)
        self.bn1 = BatchNormAffine(mid)
        self.conv2 = _conv_layer(mid, mid, 3, stride, cfg.groups)
        self.bn2 = BatchNormAffine(mid)
        self.conv3 = _conv_layer(mid, cout, 1)
        self.bn3 = BatchNormAffine(cout)
        self.downsample = _downsample(cin, cout, stride)

    def forward(self, x, dtype, grad_safe=False):
        if _fused_route(dtype, grad_safe):
            out = _fused_conv_bn(x, self.conv1, self.bn1)
            out = _fused_conv_bn(out, self.conv2, self.bn2)
            return _fused_conv_bn(out, self.conv3, self.bn3,
                                  residual=_fused_shortcut(x, self.downsample))
        out = F.relu(_conv_bn(x, self.conv1, self.bn1, dtype))
        out = F.relu(_conv_bn(out, self.conv2, self.bn2, dtype))
        out = _conv_bn(out, self.conv3, self.bn3, dtype)
        return _finish(out, x, self.downsample, dtype)


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv_layer(cin, cout, 1, stride), BatchNormAffine(cout))


def _finish(out, x, downsample, dtype):
    """ReLU of the fp32 branch plus the shortcut, in fp32, written in
    ``dtype``."""
    residual = x if downsample is None else _conv_bn(
        x, downsample[0], downsample[1] if len(downsample) > 1 else None, dtype)
    return F.relu(out + residual.to(out.dtype)).to(dtype)


class ResNet(nn.Module):
    """Stem + four stages; ``features`` returns the C5 map (B, C5, H/32,
    W/32), or (C4, C5) with ``out_layer=-1`` for the FPN heads."""

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
                blocks.append(block(cfg, cin, planes, stride))
                cin = planes * cfg.expansion
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))

    def features(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                 out_layer: int = 0, grad_safe: bool = False):
        """``grad_safe``: dirjax's flag, True in training (the module
        docstring's two routes)."""
        x = x.contiguous(memory_format=torch.channels_last)
        if _fused_route(dtype, grad_safe):
            x = _fused_conv_bn(x, self.conv1, self.bn1)
        else:
            x = F.relu(_conv_bn(x, self.conv1, self.bn1, dtype))
        # MaxPool2d(3, 2, 1) pads with -inf, as dirjax's reduce_window does
        x = F.max_pool2d(x.to(dtype), 3, 2, 1)
        for s in range(4):
            for block in getattr(self, f"layer{s + 1}"):
                x = block(x, dtype, grad_safe)
            if s == 2:
                c4 = x
        return (c4, x) if out_layer == -1 else x


def _fold_pair(conv: nn.Conv2d, bn: BatchNormAffine) -> None:
    """w' = w * s / sqrt(v + eps) per output channel, b' = b - m * s /
    sqrt(v + eps), in numpy's fp32 on the host as
    ``dirjax/models/resnet.py:295-299`` (torch's CPU sqrt is not correctly
    rounded, numpy's is: the folded weights equal dirjax's bit for bit)."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    inv = host(bn.weight) / np.sqrt(host(bn.running_var) + np.float32(BN_EPS))
    weight = host(conv.weight) * inv[:, None, None, None]
    bias = host(bn.bias) - host(bn.running_mean) * inv
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(weight))
        conv.bias = nn.Parameter(torch.from_numpy(bias).to(conv.weight.device))


def fold_batchnorm(model: ResNet) -> ResNet:
    """A copy of ``model`` with every (conv, BN) pair folded into (conv',
    bias); inference only. ``model`` is left as it was."""
    model = copy.deepcopy(model)
    _fold_pair(model.conv1, model.bn1)
    model.bn1 = None
    for s in range(4):
        for block in getattr(model, f"layer{s + 1}"):
            for c in (1, 2, 3):
                if hasattr(block, f"conv{c}"):
                    _fold_pair(getattr(block, f"conv{c}"), getattr(block, f"bn{c}"))
                    setattr(block, f"bn{c}", None)
            if block.downsample is not None:
                _fold_pair(block.downsample[0], block.downsample[1])
                del block.downsample[1]
    return model


def is_folded(model: ResNet) -> bool:
    return model.bn1 is None
