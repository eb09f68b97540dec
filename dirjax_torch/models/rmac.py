"""Global-descriptor heads, R-MAC family, plain and FPN (counterpart of
``dirjax/models/rmac.py``): backbone -> (center bias) -> global pooling
(GeM with learnable p / MAC / avg) -> (feature L2) -> FC -> L2-norm, giving
a (B, out_dim) unit descriptor.

The plain head's GeM -> FC -> L2 tail always goes to
:func:`~dirjax_torch.ops.gem_head.fused_gem_head` when the config admits it
(the gate of ``dirjax/models/rmac.py:145-153``: no FPN, GeM, no center bias,
no feature L2, an FC layer); that function runs the CUDA kernel on the card
and its plain version on the CPU. The other head variants take the plain
composition, which is different math and not a fallback.

The FPN heads (``dirjax/models/rmac.py:129-198``) pool C4 and C5 apart and
concatenate [d4, d5] before the FC. ``fpn_mode`` 1 first merges C5 into C4:
C5 upsampled x2 by nearest neighbour and cropped to C4, ``conv1x5`` (1x1),
ReLU, added to C4, then ``conv3c4`` (3x3, pad 1) and ReLU; ``fpn_mode`` 0
pools both maps as they are. A bucket mask reaches C4 at stride 16 and C5 at
stride 32. Like dirjax (and the reference), the FPN head accepts
``center_bias`` and never applies it.

``forward(..., train=True)`` is the training forward
(``dirjax/models/rmac.py:130-201``): the backbone and the FPN merge run
with ``grad_safe`` (cuDNN convolutions, not the fused-epilogue kernel of
``ops/conv.py``, which has no backward), the plain head takes the plain
composition, never the K1 kernel (dirjax gates it the same way), and
``dropout_p`` drops backbone features (C4 and C5 in the FPN heads) with a
caller's ``torch.Generator``. :func:`init_weights` draws
dirjax's initial distributions (``init_descriptor``).

:class:`ViTDescriptor` puts the same plain GeM -> FC -> L2 head, on K1, over
DINOv2's vision transformer (``models/vit.py``): GeM pools the final-normed
patch tokens as a (B, h, w, D) fp32 map. It is for inference on whole
images: a bucket ``mask`` and the training forward are refused.
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
from .resnet import (RGB_MEANS, RGB_STDS, BatchNormAffine, ResNet, ResNetConfig,
                     _fused_conv_bn, _fused_route)
from .vit import ViTConfig, VisionTransformer

__all__ = ["DescriptorConfig", "RMACDescriptor", "ViTDescriptorConfig", "ViTDescriptor",
           "downsample_mask", "init_weights"]


@dataclass(frozen=True)
class DescriptorConfig:
    backbone: ResNetConfig
    out_dim: int = 2048
    pooling: str = "gem"          # 'gem' | 'max' (MAC) | 'avg'
    gemp: float = 3.0
    center_bias: float = 0.0
    norm_features: bool = False
    without_fc: bool = False
    dropout_p: Optional[float] = None  # training only (forward(train=True))
    fpn_mode: Optional[int] = None  # None: plain head; 1: merge C5 into C4; 0: no merge

    @property
    def feat_dim(self) -> int:
        return self.out_dim

    @property
    def fc_in_dim(self) -> int:
        if self.fpn_mode is None:
            return self.backbone.out_channels
        return self.backbone.c4_channels + self.backbone.out_channels

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


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """dirjax's rule: keep with probability ``1 - rate`` and scale by
    ``1 / keep``, zero otherwise."""
    keep = 1.0 - rate
    drawn = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(drawn < keep, x / keep, 0.0)


def init_weights(model: "RMACDescriptor", generator: torch.Generator) -> "RMACDescriptor":
    """dirjax's initial distributions (``init_descriptor``, ``init_resnet``):
    every conv He-normal with fan = kh*kw*cout (the FPN head's too), BN the
    identity, GeM's p = gemp, the FC uniform in +-1/sqrt(fan_in) with a zero
    bias. Draws from ``generator``; returns ``model``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                cout, _, kh, kw = m.weight.shape
                m.weight.normal_(0.0, (2.0 / (kh * kw * cout)) ** 0.5, generator=generator)
            elif isinstance(m, nn.Linear):
                bound = m.in_features ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()
            elif isinstance(m, BatchNormAffine):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, GeneralizedMeanPoolingP):
                m.p.fill_(model.cfg.gemp)
    return model


class RMACDescriptor(ResNet):
    """ResNet backbone + descriptor head, with the reference's flat
    state_dict keys (backbone keys, ``adpool.p``, ``fc``; FPN: ``conv1x5``,
    ``conv3c4``, ``adpoolx5.p``, ``adpoolc4.p``)."""

    def __init__(self, cfg: DescriptorConfig, arch: str = ""):
        super().__init__(cfg.backbone)
        self.cfg = cfg
        self.arch = arch
        # registered in the order of dirjax's state_dict export
        # (``dirjax/utils/checkpoints.py:146-157``), so listings agree
        if cfg.fpn_mode is not None:
            dim1, dim2 = cfg.backbone.c4_channels, cfg.backbone.out_channels
            if cfg.pooling == "gem":
                self.adpoolx5 = GeneralizedMeanPoolingP(cfg.gemp)
                self.adpoolc4 = GeneralizedMeanPoolingP(cfg.gemp)
            if cfg.fpn_mode == 1:
                self.conv1x5 = nn.Conv2d(dim2, dim1, 1, bias=False)
                self.conv3c4 = nn.Conv2d(dim1, dim1, 3, padding=1, bias=False)
        elif cfg.pooling.startswith("gem"):
            self.adpool = GeneralizedMeanPoolingP(cfg.gemp)
        if not cfg.without_fc:
            self.fc = nn.Linear(cfg.fc_in_dim, cfg.out_dim)

    def forward(self, images: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``images``: NCHW float, already normalized. ``mask``: optional
        (B, H, W) bool validity map at input resolution for padded bucket
        batches. ``train``: the training forward (plain head; ``dropout_p``
        draws from ``generator``, which it then needs). Returns (B, out_dim)
        fp32 unit descriptors."""
        cfg = self.cfg
        drop = cfg.dropout_p is not None and train
        if drop and generator is None:
            raise ValueError("dropout_p with train=True needs a torch.Generator")
        if (not train and cfg.fpn_mode is None and cfg.pooling.startswith("gem")
                and cfg.center_bias == 0 and not cfg.norm_features and not cfg.without_fc):
            x = self.features(images, dtype)
            feat_mask = None
            if mask is not None:
                feat_mask = downsample_mask(mask, 32, x.shape[2], x.shape[3])
            # the kernel widens bf16 itself and reads fc.weight in place
            return fused_gem_head(x.permute(0, 2, 3, 1), self.adpool.p, self.fc.weight.T,
                                  self.fc.bias, mask=feat_mask)
        return self._tail(self.pooled(images, mask, dtype, generator if drop else None,
                                      train=train))

    def pooled(self, images: torch.Tensor, mask: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None,
               train: bool = False) -> torch.Tensor:
        """The plain forward up to the tail: (B, C) pooled features, before
        the feature L2, the FC and the L2 (what the tensor-parallel train
        step projects itself). With a ``generator``, ``dropout_p`` drops the
        backbone features first. ``train`` is the backbone's ``grad_safe``
        (``models/resnet.py``), as dirjax passes it."""
        cfg = self.cfg
        if cfg.fpn_mode is not None:
            return self._fpn_pool(images, mask, dtype, generator, train)
        x = self.features(images, dtype, grad_safe=train)
        if generator is not None:
            x = _dropout(x, cfg.dropout_p, generator)
        nhwc = x.permute(0, 2, 3, 1)  # a view: x is channels_last
        feat_mask = None
        if mask is not None:
            feat_mask = downsample_mask(mask, 32, x.shape[2], x.shape[3])
        p = self.adpool.p if cfg.pooling.startswith("gem") else cfg.gemp
        if cfg.center_bias > 0:
            bias = center_bias_mask(nhwc.shape[1], nhwc.shape[2], cfg.center_bias,
                                    dtype=nhwc.dtype, device=nhwc.device)
            nhwc = nhwc * bias[None, :, :, None]
        return global_pool(nhwc, cfg.pooling, p=p, mask=feat_mask)

    def _fpn_pool(self, images, mask, dtype, generator=None, train=False) -> torch.Tensor:
        """[d4, d5]: C4 (merged with C5 in fpn_mode 1) and C5, each pooled
        over its own mask; with a ``generator``, both dropped out first. The
        merge's two convolutions take the backbone's route (``train`` is
        ``grad_safe``): in bf16 inference each is the fused conv with an fp32
        output, ``conv1x5``'s ReLU and the C4 add in its epilogue."""
        cfg = self.cfg
        c4, c5 = self.features(images, dtype, out_layer=-1, grad_safe=train)
        if cfg.fpn_mode == 1:
            c4 = self._fpn_merge(c4, c5, dtype, train)
        if generator is not None:
            c4 = _dropout(c4, cfg.dropout_p, generator)
            c5 = _dropout(c5, cfg.dropout_p, generator)
        c4_mask = c5_mask = None
        if mask is not None:
            c4_mask = downsample_mask(mask, 16, c4.shape[2], c4.shape[3])
            c5_mask = downsample_mask(mask, 32, c5.shape[2], c5.shape[3])
        gem = cfg.pooling == "gem"
        d5 = global_pool(c5.permute(0, 2, 3, 1), cfg.pooling,
                         p=self.adpoolx5.p if gem else cfg.gemp, mask=c5_mask)
        d4 = global_pool(c4.permute(0, 2, 3, 1), cfg.pooling,
                         p=self.adpoolc4.p if gem else cfg.gemp, mask=c4_mask)
        return torch.cat([d4.float(), d5.float()], dim=1)

    def _fpn_merge(self, c4, c5, dtype, train=False) -> torch.Tensor:
        """fpn_mode 1 (``dirjax/models/rmac.py:169-179``): relu(conv3c4(C4 +
        relu(conv1x5(C5 upsampled x2, cropped to C4)))), fp32."""
        up = F.interpolate(c5, scale_factor=2, mode="nearest")[:, :, :c4.shape[2], :c4.shape[3]]
        if _fused_route(dtype, train):
            c4 = _fused_conv_bn(up, self.conv1x5, None, relu="pre", residual=c4,
                                out_dtype=torch.float32)
            return _fused_conv_bn(c4, self.conv3c4, None, relu="post", out_dtype=torch.float32)
        merged = F.conv2d(up.to(dtype), self.conv1x5.weight.to(dtype))
        c4 = c4.float() + F.relu(merged.float())
        return F.relu(F.conv2d(c4.to(dtype), self.conv3c4.weight.to(dtype), padding=1).float())

    def _tail(self, desc: torch.Tensor) -> torch.Tensor:
        """(feature L2) -> FC -> L2 of pooled (B, C) descriptors."""
        cfg = self.cfg
        if cfg.norm_features:
            desc = l2_normalize(desc, dim=1)
        if not cfg.without_fc:
            desc = desc.float() @ self.fc.weight.T + self.fc.bias
        return l2_normalize(desc, dim=-1)


@dataclass(frozen=True)
class ViTDescriptorConfig:
    """A vision transformer under the plain GeM -> FC -> L2 head. The other
    head options of :class:`DescriptorConfig` are held at the values this
    head has, so checkpoints record them alike."""

    backbone: ViTConfig
    out_dim: int = 1024
    pooling: str = "gem"
    gemp: float = 3.0
    center_bias: float = 0.0
    norm_features: bool = False
    without_fc: bool = False
    dropout_p: Optional[float] = None

    @property
    def fc_in_dim(self) -> int:
        return self.backbone.embed_dim

    @property
    def preprocess(self) -> dict:
        return {"mean": list(RGB_MEANS), "std": list(RGB_STDS), "input_size": 224}


class ViTDescriptor(VisionTransformer):
    """DINOv2's backbone + the GeM -> FC -> L2 head, with DINOv2's state-dict
    keys, ``adpool.p`` and ``fc``."""

    def __init__(self, cfg: ViTDescriptorConfig, arch: str = ""):
        super().__init__(cfg.backbone)
        self.cfg = cfg
        self.arch = arch
        self.adpool = GeneralizedMeanPoolingP(cfg.gemp)
        self.fc = nn.Linear(cfg.fc_in_dim, cfg.out_dim)

    def forward(self, images: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``images``: NCHW float, already normalized. Returns (B, out_dim)
        fp32 unit descriptors; GeM, the FC and the L2 run in fp32 on K1."""
        if mask is not None:
            raise ValueError(f"{self.arch or 'a ViT descriptor'} takes whole images: extract "
                             "with batching='group', not padded and masked buckets")
        if train:
            raise NotImplementedError(f"{self.arch or 'a ViT descriptor'} runs inference "
                                      "only: it has no training forward")
        x = self.patch_map(images, dtype)
        return fused_gem_head(x, self.adpool.p, self.fc.weight.T, self.fc.bias)
