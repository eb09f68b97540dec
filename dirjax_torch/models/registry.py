"""Model registry and factory (counterpart of ``dirjax/models/registry.py``):
every architecture name dirjax registers (``resnet{18,50,101,152}_rmac``,
``resnet{18,50,101,152}_fpn_rmac``, ``resnet101_fpn0_rmac`` and
``resnext101_32x4d_rmac``) resolves to a
:class:`~dirjax_torch.models.rmac.DescriptorConfig`, and :func:`create_model`
returns an :class:`~dirjax_torch.models.rmac.RMACDescriptor` with its
``arch`` name attached.
"""

from __future__ import annotations

from .resnet import RESNET_CONFIGS
from .rmac import DescriptorConfig, RMACDescriptor

__all__ = ["create_model", "model_config", "model_names"]

# arch -> (backbone, fpn_mode)
_ARCHS = {}
for _bb in ("resnet18", "resnet50", "resnet101", "resnet152"):
    _ARCHS[f"{_bb}_rmac"] = (_bb, None)
    _ARCHS[f"{_bb}_fpn_rmac"] = (_bb, 1)
_ARCHS["resnet101_fpn0_rmac"] = ("resnet101", 0)
_ARCHS["resnext101_32x4d_rmac"] = ("resnext101_32x4d", None)


def model_names() -> list:
    return sorted(_ARCHS)


def model_config(arch: str, out_dim=None, norm_features=False, pooling="gem",
                 gemp=3, center_bias=0, dropout_p=None, without_fc=False,
                 **_ignored) -> DescriptorConfig:
    """The architecture's config; keyword names follow the reference's
    checkpoint ``model_options``, and unknown keys are ignored as there. The
    FPN heads' default ``out_dim`` is C4's plus C5's width
    (``dirjax/models/registry.py:65-67``), the plain heads' 2048."""
    if arch not in _ARCHS:
        raise NameError(f"unknown model architecture '{arch}'. Select one of: "
                        + ", ".join(model_names()))
    backbone, fpn_mode = _ARCHS[arch]
    bb = RESNET_CONFIGS[backbone]
    if out_dim is None:
        out_dim = bb.c4_channels + bb.out_channels if fpn_mode is not None else 2048
    return DescriptorConfig(
        backbone=bb, out_dim=out_dim, pooling=pooling, gemp=gemp,
        center_bias=center_bias, norm_features=norm_features,
        without_fc=without_fc, dropout_p=dropout_p, fpn_mode=fpn_mode)


def create_model(arch: str, **kwargs) -> RMACDescriptor:
    """A randomly initialised descriptor model of ``arch``; load weights with
    :mod:`dirjax_torch.utils.checkpoints`."""
    return RMACDescriptor(model_config(arch, **kwargs), arch)
