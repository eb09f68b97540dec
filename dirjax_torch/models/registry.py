"""Model registry and factory (counterpart of ``dirjax/models/registry.py``):
every architecture name dirjax registers (``resnet{18,50,101,152}_rmac``,
``resnet{18,50,101,152}_fpn_rmac``, ``resnet101_fpn0_rmac`` and
``resnext101_32x4d_rmac``) resolves through a registry of factories
(:func:`register_model`) to a
:class:`~dirjax_torch.models.rmac.DescriptorConfig`, and :func:`create_model`
returns an :class:`~dirjax_torch.models.rmac.RMACDescriptor` with its
``arch`` name attached.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import numpy as np
import torch

from .resnet import RESNET_CONFIGS
from .rmac import DescriptorConfig, RMACDescriptor

__all__ = ["create_model", "model_config", "model_names", "model_size",
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


def model_config(arch: str, **kwargs) -> DescriptorConfig:
    """The config the factory registered under ``arch`` builds."""
    if arch not in _FACTORIES:
        raise NameError(f"unknown model architecture '{arch}'. Select one of: "
                        + ", ".join(model_names()))
    return _FACTORIES[arch](**kwargs)


def create_model(arch: str, pretrained: str = "", **kwargs) -> RMACDescriptor:
    """A randomly initialised descriptor model of ``arch``; load weights with
    :mod:`dirjax_torch.utils.checkpoints` (``pretrained`` is refused, as
    dirjax refuses it)."""
    cfg = model_config(arch, **kwargs)
    if pretrained:
        raise NotImplementedError(
            "use dirjax_torch.utils.checkpoints.load_checkpoint to load weights")
    return RMACDescriptor(cfg, arch)
