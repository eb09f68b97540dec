"""Checkpoint I/O (counterpart of the jax-free parts of
``dirjax/utils/checkpoints.py``).

Two formats, both read into a :class:`Checkpoint` whose ``model`` holds the
weights:

* the reference's ``.pt`` schema (``state_dict``, ``model_options``,
  ``preprocess``, ``pca``), with PCA entries as plain dicts of arrays (or
  objects carrying sklearn's attribute names);
* dirjax's native ``.npz``: the flattened JAX parameter pytree plus JSON
  metadata. :func:`state_dict_from_jax_params` and
  :func:`jax_params_from_state_dict` convert between that pytree (HWIO
  convs, grouped ones included, (in, out) fc, the FPN heads' ``conv1x5``,
  ``conv3c4``, ``pool_p_x5`` and ``pool_p_c4``) and the port's state_dict
  (OIHW, (out, in), ``adpoolx5.p``/``adpoolc4.p``).

:func:`save_torch_checkpoint` writes the reference schema, and
:func:`load_tolerant` overlays a state_dict onto a fresh model where names
and shapes match (``dirjax/utils/checkpoints.py:160,334``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models import DescriptorConfig, RMACDescriptor, create_model, is_folded
from ..ops.binary import BinaryCodec
from ..ops.ivf import IVFArrays
from ..ops.whitening import PCAParams

__all__ = ["Checkpoint", "load_checkpoint", "load_native", "save_native",
           "load_torch_checkpoint", "save_torch_checkpoint", "load_state",
           "load_tolerant", "state_dict_from_jax_params",
           "jax_params_from_state_dict", "binary_codec_from_jax", "pq_from_jax",
           "ivf_arrays_from_jax"]


@dataclass
class Checkpoint:
    model: RMACDescriptor
    preprocess: dict
    pca: Dict[str, PCAParams] = field(default_factory=dict)
    extra: dict = field(default_factory=dict)  # epoch, iter, ...


def _block_names(cfg: DescriptorConfig):
    """(torch prefix, pytree path) of every block of the backbone."""
    nconv = 2 if cfg.backbone.block == "basic" else 3
    for s, nblocks in enumerate(cfg.backbone.layers):
        for b in range(nblocks):
            yield f"layer{s + 1}.{b}", (f"layer{s + 1}", b), nconv


def state_dict_from_jax_params(params: Dict[str, Any],
                               cfg: DescriptorConfig) -> Dict[str, np.ndarray]:
    """dirjax parameter pytree (numpy leaves) -> the port's state_dict."""
    sd: Dict[str, np.ndarray] = {}

    def conv(name, w):
        sd[name + ".weight"] = np.asarray(w, np.float32).transpose(3, 2, 0, 1)

    def bn(name, p):
        sd[name + ".weight"] = np.asarray(p["scale"], np.float32)
        sd[name + ".bias"] = np.asarray(p["bias"], np.float32)
        sd[name + ".running_mean"] = np.asarray(p["mean"], np.float32)
        sd[name + ".running_var"] = np.asarray(p["var"], np.float32)

    bb = params["backbone"]
    conv("conv1", bb["stem"]["conv"])
    bn("bn1", bb["stem"]["bn"])
    for pre, (layer, b), nconv in _block_names(cfg):
        block = bb[layer][b]
        for c in range(1, nconv + 1):
            conv(f"{pre}.conv{c}", block[f"conv{c}"])
            bn(f"{pre}.bn{c}", block[f"bn{c}"])
        if "downsample" in block:
            conv(f"{pre}.downsample.0", block["downsample"]["conv"])
            bn(f"{pre}.downsample.1", block["downsample"]["bn"])
    if cfg.fpn_mode is None:
        if cfg.pooling.startswith("gem"):
            sd["adpool.p"] = np.asarray(params.get("pool_p", cfg.gemp),
                                        np.float32).reshape(1)
    else:
        if cfg.pooling == "gem":
            for name in ("x5", "c4"):
                sd[f"adpool{name}.p"] = np.asarray(params.get(f"pool_p_{name}", cfg.gemp),
                                                   np.float32).reshape(1)
        if cfg.fpn_mode == 1:
            conv("conv1x5", params["conv1x5"])
            conv("conv3c4", params["conv3c4"])
    if not cfg.without_fc:
        sd["fc.weight"] = np.asarray(params["fc"]["kernel"], np.float32).T.copy()
        sd["fc.bias"] = np.asarray(params["fc"]["bias"], np.float32)
    return sd


def binary_codec_from_jax(mean, proj) -> BinaryCodec:
    """dirjax's binary codec (``mean (D,)``, ``proj (D, n_bits)``, numpy or
    array-likes) -> the port's :class:`~dirjax_torch.ops.binary.BinaryCodec`
    of fp32 host tensors (a :class:`~dirjax_torch.serving.BinaryIndex` moves
    its codec to its device)."""
    return BinaryCodec(mean=torch.from_numpy(np.array(mean, np.float32)),
                       proj=torch.from_numpy(np.array(proj, np.float32)))


def pq_from_jax(codebooks, rotation=None) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """dirjax's trained PQ state (``codebooks (m, ksub, D/m)``, an optional
    OPQ ``rotation (D, D)``, numpy or array-likes) -> the port's
    ``(rotation or None, codebooks)`` fp32 host tensors: the ``_trained``
    argument of :class:`~dirjax_torch.serving.PQIndex`."""
    rot = None if rotation is None else torch.from_numpy(np.array(rotation, np.float32))
    return rot, torch.from_numpy(np.array(codebooks, np.float32))


def ivf_arrays_from_jax(ivf) -> IVFArrays:
    """dirjax's ``IVFArrays`` (its six fields in order, numpy or
    array-likes) -> the port's :class:`~dirjax_torch.ops.ivf.IVFArrays` of
    host tensors, the same values and dtypes."""
    return IVFArrays(*(torch.from_numpy(np.array(a)) for a in ivf))


def jax_params_from_state_dict(sd: Dict[str, Any],
                               cfg: DescriptorConfig) -> Dict[str, Any]:
    """The port's state_dict -> dirjax parameter pytree (numpy leaves)."""
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                        np.float32) for k, v in sd.items()}

    def conv(name):
        return sd[name + ".weight"].transpose(2, 3, 1, 0)

    def bn(name):
        return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"],
                "mean": sd[name + ".running_mean"],
                "var": sd[name + ".running_var"]}

    backbone: Dict[str, Any] = {"stem": {"conv": conv("conv1"), "bn": bn("bn1")}}
    for pre, (layer, b), nconv in _block_names(cfg):
        block = {}
        for c in range(1, nconv + 1):
            block[f"conv{c}"] = conv(f"{pre}.conv{c}")
            block[f"bn{c}"] = bn(f"{pre}.bn{c}")
        if f"{pre}.downsample.0.weight" in sd:
            block["downsample"] = {"conv": conv(f"{pre}.downsample.0"),
                                   "bn": bn(f"{pre}.downsample.1")}
        backbone.setdefault(layer, []).append(block)
    params: Dict[str, Any] = {"backbone": backbone}
    if "adpool.p" in sd:
        params["pool_p"] = np.float32(sd["adpool.p"].reshape(()))
    for name in ("x5", "c4"):
        if f"adpool{name}.p" in sd:
            params[f"pool_p_{name}"] = np.float32(sd[f"adpool{name}.p"].reshape(()))
    if "conv1x5.weight" in sd:
        params["conv1x5"] = conv("conv1x5")
        params["conv3c4"] = conv("conv3c4")
    if "fc.weight" in sd:
        params["fc"] = {"kernel": sd["fc.weight"].T.copy(), "bias": sd["fc.bias"]}
    return params


def _incoming(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A state_dict as fp32 tensors, without a ``module.`` prefix or
    ``num_batches_tracked``."""
    sd = {k[7:] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    return {k: v.float() if torch.is_tensor(v) else torch.tensor(
                np.asarray(v), dtype=torch.float32)
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def load_state(model: RMACDescriptor, state_dict: Dict[str, Any]) -> RMACDescriptor:
    """Load reference-named weights strictly: a ``module.`` prefix and
    ``num_batches_tracked`` are dropped, and a plain GeM model whose
    checkpoint has no ``adpool.p`` keeps p = gemp (the reference's default).
    ResNeXt's grouped convs and the FPN heads' keys load as they are."""
    sd = _incoming(state_dict)
    if hasattr(model, "adpool") and "adpool.p" not in sd:
        sd["adpool.p"] = torch.full((1,), float(model.cfg.gemp))
    model.load_state_dict(sd, strict=True)
    return model


def load_tolerant(model: RMACDescriptor, state_dict: Dict[str, Any],
                  delete_fc: bool = False, verbose: bool = True) -> RMACDescriptor:
    """Tolerant loading (counterpart of ``dirjax/utils/checkpoints.py:160``,
    the reference's ``nets/__init__.py:67-96``): over ``model``'s own
    (freshly initialised) state_dict, take every entry of ``state_dict``
    whose name and shape match; keep the model's value for missing layers
    and shape mismatches, reporting both in dirjax's words; under
    ``delete_fc`` keep the fresh FC (fine-tuning to a new output dim).
    Loads into ``model`` and returns it."""
    incoming = _incoming(state_dict)
    merged = {}
    for name, init_val in model.state_dict().items():
        got = incoming.get(name)
        if delete_fc and name in ("fc.weight", "fc.bias"):
            got = None
        elif got is None:
            if verbose:
                print(f"Loading weights for {model.arch}: Missing layer {name}")
        elif tuple(got.shape) != tuple(init_val.shape):
            if verbose:
                print(f"Loading weights for {model.arch}: Bad shape for "
                      f"layer {name}, skipping")
            got = None
        merged[name] = init_val if got is None else got
    model.load_state_dict(merged, strict=True)
    return model


def _pca_from_object(pca) -> PCAParams:
    """A plain dict of arrays, or an object with sklearn's PCA attributes."""
    if isinstance(pca, dict):
        return PCAParams(mean=np.asarray(pca["mean"]),
                         components=np.asarray(pca["components"]),
                         variance=np.asarray(pca["variance"]),
                         whiten=bool(pca.get("whiten", True)))
    return PCAParams.from_sklearn(pca)


def load_torch_checkpoint(path: str) -> Checkpoint:
    """Read a reference-schema ``.pt`` checkpoint."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint found at '{path}'")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    options = dict(ckpt["model_options"])
    model = create_model(options.pop("arch"), **options)
    load_state(model, ckpt["state_dict"])
    pca = {name: _pca_from_object(p) for name, p in ckpt.get("pca", {}).items()}
    extra = {k: ckpt[k] for k in ("epoch", "iter", "current_iter") if k in ckpt}
    return Checkpoint(model=model, preprocess=ckpt.get("preprocess", model.cfg.preprocess),
                      pca=pca, extra=extra)


def save_torch_checkpoint(path: str, ckpt: Checkpoint) -> None:
    """Write a Checkpoint in the reference's ``.pt`` schema (counterpart of
    ``dirjax/utils/checkpoints.py:334``): ``state_dict`` (fp32 CPU tensors),
    ``model_options`` (arch and the head's options), ``preprocess``, and
    ``pca`` as plain dicts of arrays; numeric extras (epoch, iter) at the
    top level. :func:`load_torch_checkpoint` and dirjax's reader take it."""
    if is_folded(ckpt.model):
        raise ValueError("a folded model has no reference state_dict: save the "
                         "model before fold_batchnorm")
    sd = {k: v.detach().to("cpu", torch.float32).clone()
          for k, v in ckpt.model.state_dict().items()}
    payload = {
        "state_dict": sd,
        "model_options": {"arch": ckpt.model.arch,
                          **_config_options(ckpt.model.cfg)},
        "preprocess": ckpt.preprocess,
        "pca": {name: {"mean": np.asarray(p.mean),
                       "components": np.asarray(p.components),
                       "variance": np.asarray(p.variance),
                       "whiten": bool(p.whiten)}
                for name, p in ckpt.pca.items()},
        **{k: v for k, v in ckpt.extra.items() if isinstance(v, (int, float, str))},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        # only a contiguous 0..n-1 run of digit keys is a saved list
        if keys and all(k.isdigit() for k in keys) and \
                sorted(int(k) for k in keys) == list(range(len(keys))):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _config_options(cfg: DescriptorConfig) -> dict:
    return {"out_dim": cfg.out_dim, "pooling": cfg.pooling, "gemp": cfg.gemp,
            "center_bias": cfg.center_bias, "norm_features": cfg.norm_features,
            "without_fc": cfg.without_fc, "dropout_p": cfg.dropout_p}


def save_native(path: str, ckpt: Checkpoint) -> None:
    """Write dirjax's native ``.npz``: params pytree + pca arrays + JSON meta."""
    cfg = ckpt.model.cfg
    arrays = _flatten(jax_params_from_state_dict(ckpt.model.state_dict(), cfg),
                      "params/")
    for name, pca in ckpt.pca.items():
        arrays[f"pca/{name}/mean"] = np.asarray(pca.mean)
        arrays[f"pca/{name}/components"] = np.asarray(pca.components)
        arrays[f"pca/{name}/variance"] = np.asarray(pca.variance)
        arrays[f"pca/{name}/whiten"] = np.asarray(bool(pca.whiten))
    meta = {"arch": ckpt.model.arch, "model_options": _config_options(cfg),
            "preprocess": ckpt.preprocess,
            "extra": {k: v for k, v in ckpt.extra.items()
                      if isinstance(v, (int, float, str))}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_native(path: str) -> Checkpoint:
    """Read dirjax's native ``.npz``."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    params = _unflatten({k[len("params/"):]: v for k, v in arrays.items()
                         if k.startswith("params/")})
    # pca names are dict keys even when they look like list indices
    pca_fields: Dict[str, dict] = {}
    for k, v in arrays.items():
        if k.startswith("pca/"):
            name, fld = k[len("pca/"):].rsplit("/", 1)
            pca_fields.setdefault(name, {})[fld] = v
    pca = {name: PCAParams(mean=v["mean"], components=v["components"],
                           variance=v["variance"],
                           whiten=bool(v.get("whiten", True)))
           for name, v in pca_fields.items()}
    model = create_model(meta["arch"], **meta["model_options"])
    load_state(model, state_dict_from_jax_params(params, model.cfg))
    return Checkpoint(model=model, preprocess=meta["preprocess"], pca=pca,
                      extra=meta.get("extra", {}))


def load_checkpoint(path: str) -> Checkpoint:
    """Either format, told apart by content: a native archive carries a
    ``__meta__`` member (both formats are zip archives)."""
    try:
        with np.load(path, allow_pickle=False) as data:
            is_native = "__meta__" in data.files
    except (OSError, ValueError):
        is_native = False
    return load_native(path) if is_native else load_torch_checkpoint(path)
