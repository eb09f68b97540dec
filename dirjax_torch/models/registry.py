"""Model registry and factory (counterpart of ``dirjax/models/registry.py``):
every architecture name dirjax registers (``resnet{18,50,101,152}_rmac``,
``resnet{18,50,101,152}_fpn_rmac``, ``resnet101_fpn0_rmac`` and
``resnext101_32x4d_rmac``) resolves through a registry of factories
(:func:`register_model`) to a
:class:`~dirjax_torch.models.rmac.DescriptorConfig`, and :func:`create_model`
returns an :class:`~dirjax_torch.models.rmac.RMACDescriptor` with its
``arch`` name attached. The port adds DINOv2's ViT-L/14 with 4 registers
under the same GeM -> FC -> L2 head (``dinov2_vitl14_reg_rmac``): a
:class:`~dirjax_torch.models.rmac.ViTDescriptorConfig` and a
:class:`~dirjax_torch.models.rmac.ViTDescriptor`, for inference only.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Union

import numpy as np
import torch

from .resnet import RESNET_CONFIGS
from .rmac import DescriptorConfig, RMACDescriptor, ViTDescriptor, ViTDescriptorConfig
from .vit import VIT_CONFIGS, ViTConfig

__all__ = ["create_model", "is_vit", "model_config", "model_names", "model_size",
           "register_model"]

_FACTORIES: Dict[str, Callable[..., DescriptorConfig]] = {}


def model_size(params) -> int:
    """Total number of elements of a model's state (an ``nn.Module``'s
    ``state_dict``, BN statistics included, or a mapping of arrays), as
    dirjax counts its parameter pytree (reference ``utils/common.py:178-184``)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return int(sum(np.prod(np.shape(v)) for v in params.values()))


def register_model(name: str, factory: Callable[..., DescriptorConfig]) -> None:
    """Make ``create_model(name, **kwargs)`` build ``factory(**kwargs)``."""
    _FACTORIES[name] = factory


def model_names() -> list:
    return sorted(_FACTORIES)


def _rmac_config(backbone: str, fpn_mode=None, *, out_dim=None, norm_features=False,
                 pooling="gem", gemp=3, center_bias=0, dropout_p=None,
                 without_fc=False, **_ignored) -> DescriptorConfig:
    """Keyword names follow the reference's checkpoint ``model_options``, and
    unknown keys are ignored as there. The FPN heads' default ``out_dim`` is
    C4's plus C5's width (``dirjax/models/registry.py:65-67``), the plain
    heads' 2048."""
    bb = RESNET_CONFIGS[backbone]
    if out_dim is None:
        out_dim = bb.c4_channels + bb.out_channels if fpn_mode is not None else 2048
    return DescriptorConfig(
        backbone=bb, out_dim=out_dim, pooling=pooling, gemp=gemp,
        center_bias=center_bias, norm_features=norm_features,
        without_fc=without_fc, dropout_p=dropout_p, fpn_mode=fpn_mode)


for _bb in ("resnet18", "resnet50", "resnet101", "resnet152"):
    register_model(f"{_bb}_rmac", partial(_rmac_config, _bb, None))
    register_model(f"{_bb}_fpn_rmac", partial(_rmac_config, _bb, 1))
register_model("resnet101_fpn0_rmac", partial(_rmac_config, "resnet101", 0))
register_model("resnext101_32x4d_rmac", partial(_rmac_config, "resnext101_32x4d", None))


def _vit_config(bb: ViTConfig, *, out_dim=None, pooling="gem", gemp=3, center_bias=0,
                norm_features=False, without_fc=False, dropout_p=None,
                **_ignored) -> ViTDescriptorConfig:
    """The ViT takes the plain GeM -> FC -> L2 head alone; any other head
    option is refused. ``out_dim`` defaults to the embedding width."""
    if (pooling != "gem" or center_bias or norm_features or without_fc
            or dropout_p is not None):
        raise ValueError(f"the ViT descriptor ({bb.name}) takes only the GeM -> FC -> L2 head")
    return ViTDescriptorConfig(backbone=bb, out_dim=bb.embed_dim if out_dim is None else out_dim,
                               gemp=gemp)


register_model("dinov2_vitl14_reg_rmac", partial(_vit_config, VIT_CONFIGS["vitl14_reg"]))


def model_config(arch: str, **kwargs) -> Union[DescriptorConfig, ViTDescriptorConfig]:
    """The config the factory registered under ``arch`` builds."""
    if arch not in _FACTORIES:
        raise NameError(f"unknown model architecture '{arch}'. Select one of: "
                        + ", ".join(model_names()))
    return _FACTORIES[arch](**kwargs)


def is_vit(model_or_arch) -> bool:
    """True for a ViT descriptor, or the name of one's architecture."""
    if isinstance(model_or_arch, str):
        return isinstance(model_config(model_or_arch), ViTDescriptorConfig)
    return isinstance(model_or_arch, ViTDescriptor)


def create_model(arch: str, pretrained: str = "",
                 **kwargs) -> Union[RMACDescriptor, ViTDescriptor]:
    """A randomly initialised descriptor model of ``arch``; load weights with
    :mod:`dirjax_torch.utils.checkpoints` (``pretrained`` is refused, as
    dirjax refuses it)."""
    cfg = model_config(arch, **kwargs)
    if pretrained:
        raise NotImplementedError(
            "use dirjax_torch.utils.checkpoints.load_checkpoint to load weights")
    if isinstance(cfg, ViTDescriptorConfig):
        return ViTDescriptor(cfg, arch)
    return RMACDescriptor(cfg, arch)
