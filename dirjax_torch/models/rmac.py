"""Global-descriptor head, plain R-MAC family (counterpart of
``dirjax/models/rmac.py``): backbone -> (center bias) -> global pooling
(GeM with learnable p / MAC / avg) -> (feature L2) -> FC -> L2-norm, giving
a (B, out_dim) unit descriptor.

The GeM -> FC -> L2 tail always goes to
:func:`~dirjax_torch.ops.gem_head.fused_gem_head` when the config admits it
(the gate of ``dirjax/models/rmac.py:152-154``: GeM, no center bias, no
feature L2, an FC layer); that function runs the CUDA kernel on the card
and its plain version on the CPU. The other head variants take the plain
composition, which is different math and not a fallback. FPN heads are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gem_head import fused_gem_head
from ..ops.normalize import l2_normalize
from ..ops.pooling import center_bias_mask, global_pool
from .resnet import RGB_MEANS, RGB_STDS, ResNet, ResNetConfig

__all__ = ["DescriptorConfig", "RMACDescriptor", "downsample_mask"]


@dataclass(frozen=True)
class DescriptorConfig:
    backbone: ResNetConfig
    out_dim: int = 2048
    pooling: str = "gem"          # 'gem' | 'max' (MAC) | 'avg'
    gemp: float = 3.0
    center_bias: float = 0.0
    norm_features: bool = False
    without_fc: bool = False
    dropout_p: Optional[float] = None  # training only; unused at inference

    @property
    def feat_dim(self) -> int:
        return self.out_dim

    @property
    def fc_in_dim(self) -> int:
        return self.backbone.out_channels

    @property
    def preprocess(self) -> dict:
        return {"mean": list(RGB_MEANS), "std": list(RGB_STDS), "input_size": 224}


class GeneralizedMeanPoolingP(nn.Module):
    """Holds GeM's learnable power as ``adpool.p`` (shape (1,))."""

    def __init__(self, p: float):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), float(p)))


def downsample_mask(mask: torch.Tensor, stride: int, fh: int, fw: int) -> torch.Tensor:
    """Min-pool an input-resolution (B, H, W) bool mask by ``stride`` and
    align it to the (B, fh, fw) feature grid: a feature cell is valid only
    when its whole stride window is. The backbone emits ceil(H/stride)
    cells; a ragged-edge cell has a partial window, which is invalid by the
    same rule, so the mask is padded invalid up to whole windows first."""
    m = mask[:, None].float()
    pad_h = max(fh * stride - m.shape[2], 0)
    pad_w = max(fw * stride - m.shape[3], 0)
    m = F.pad(m, (0, pad_w, 0, pad_h))
    return (-F.max_pool2d(-m, stride, stride))[:, 0, :fh, :fw] > 0.5


class RMACDescriptor(ResNet):
    """ResNet backbone + descriptor head, with the reference's flat
    state_dict keys (backbone keys, ``adpool.p``, ``fc``)."""

    def __init__(self, cfg: DescriptorConfig, arch: str = ""):
        super().__init__(cfg.backbone)
        self.cfg = cfg
        self.arch = arch
        if cfg.pooling.startswith("gem"):
            self.adpool = GeneralizedMeanPoolingP(cfg.gemp)
        if not cfg.without_fc:
            self.fc = nn.Linear(cfg.fc_in_dim, cfg.out_dim)

    def forward(self, images: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``images``: NCHW float, already normalized. ``mask``: optional
        (B, H, W) bool validity map at input resolution for padded bucket
        batches. Returns (B, out_dim) fp32 unit descriptors."""
        cfg = self.cfg
        x = self.features(images, dtype)
        nhwc = x.permute(0, 2, 3, 1)  # a view: x is channels_last
        feat_mask = None
        if mask is not None:
            feat_mask = downsample_mask(mask, 32, x.shape[2], x.shape[3])
        p = self.adpool.p if cfg.pooling.startswith("gem") else cfg.gemp
        if (cfg.pooling.startswith("gem") and cfg.center_bias == 0
                and not cfg.norm_features and not cfg.without_fc):
            # the kernel widens bf16 itself and reads fc.weight in place
            return fused_gem_head(nhwc, p, self.fc.weight.T, self.fc.bias,
                                  mask=feat_mask)
        if cfg.center_bias > 0:
            bias = center_bias_mask(nhwc.shape[1], nhwc.shape[2], cfg.center_bias,
                                    dtype=nhwc.dtype, device=nhwc.device)
            nhwc = nhwc * bias[None, :, :, None]
        desc = global_pool(nhwc, cfg.pooling, p=p, mask=feat_mask)
        if cfg.norm_features:
            desc = l2_normalize(desc, dim=1)
        if not cfg.without_fc:
            desc = desc.float() @ self.fc.weight.T + self.fc.bias
        return l2_normalize(desc, dim=-1)
