"""Model registry and factory (counterpart of ``dirjax/models/registry.py``):
the plain ``*_rmac`` architecture names resolve to a
:class:`~dirjax_torch.models.rmac.DescriptorConfig`, and :func:`create_model`
returns an :class:`~dirjax_torch.models.rmac.RMACDescriptor` with its
``arch`` name attached. FPN heads are not ported yet.
"""

from __future__ import annotations

from .resnet import RESNET_CONFIGS
from .rmac import DescriptorConfig, RMACDescriptor

__all__ = ["create_model", "model_config", "model_names"]

_ARCHS = {f"{bb}_rmac": bb for bb in RESNET_CONFIGS}


def model_names() -> list:
    return sorted(_ARCHS)


def model_config(arch: str, out_dim=None, norm_features=False, pooling="gem",
                 gemp=3, center_bias=0, dropout_p=None, without_fc=False,
                 **_ignored) -> DescriptorConfig:
    """The architecture's config; keyword names follow the reference's
    checkpoint ``model_options``, and unknown keys are ignored as there."""
    if arch not in _ARCHS:
        raise NameError(f"unknown model architecture '{arch}'. Select one of: "
                        + ", ".join(model_names()))
    return DescriptorConfig(
        backbone=RESNET_CONFIGS[_ARCHS[arch]],
        out_dim=2048 if out_dim is None else out_dim, pooling=pooling,
        gemp=gemp, center_bias=center_bias, norm_features=norm_features,
        without_fc=without_fc, dropout_p=dropout_p)


def create_model(arch: str, **kwargs) -> RMACDescriptor:
    """A randomly initialised descriptor model of ``arch``; load weights with
    :mod:`dirjax_torch.utils.checkpoints`."""
    return RMACDescriptor(model_config(arch, **kwargs), arch)
