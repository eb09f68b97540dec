"""A vision transformer configuration's weights, drawn from the seed on the
device.

The state dict has DINOv2's keys (``cls_token``, ``pos_embed``,
``register_tokens``, ``mask_token``, ``patch_embed.proj``,
``blocks.i.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2,
ls2.gamma}``, ``norm``) and the head's (``adpool.p``, ``fc``), so the
program loads it with ``load_state_dict`` and the plain reference reads the
same tensors. The ranges make every block count and the attention peaked,
where DINOv2's own initialisation (LayerScale 1e-5) would leave each block
nearly the identity:

- linear weights (the patch embedding's as a 588-wide one) N(0, 1/fan_in),
  the qkv projection's N(0, 4/fan_in), so the attention logits spread by
  about 4;
- their biases N(0, 0.02^2);
- LayerNorm gains U(0.8, 1.2), shifts N(0, 0.05^2);
- LayerScale gammas U(0.1, 0.5);
- the class, register and position tokens N(0, 0.5^2); the mask token 0;
- the head's FC uniform in +-1/sqrt(fan_in), its bias N(0, 0.01^2), GeM's p
  from the configuration.

Each kind of tensor is one draw from a ``torch.Generator`` on the device,
split afterwards.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# kinds of tensor: how each is drawn
LINEAR, BIAS, GAIN, SHIFT, GAMMA, TOKEN = "linear", "bias", "gain", "shift", "gamma", "token"
QKV_SCALE = 2.0


def layout(model: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, kind) of every backbone tensor, in DINOv2's order."""
    d, m, p = model["embed_dim"], model["mlp_dim"], model["patch_size"]
    out = [("cls_token", (1, 1, d), TOKEN),
           ("pos_embed", (1, 1 + model["pos_grid"] ** 2, d), TOKEN),
           ("register_tokens", (1, model["num_registers"], d), TOKEN),
           ("patch_embed.proj.weight", (d, 3, p, p), LINEAR),
           ("patch_embed.proj.bias", (d,), BIAS)]
    for i in range(model["depth"]):
        b = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            out += [(b + norm + ".weight", (d,), GAIN), (b + norm + ".bias", (d,), SHIFT)]
        for key, (o, k) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                            ("mlp.fc1", (m, d)), ("mlp.fc2", (d, m))):
            out += [(b + key + ".weight", (o, k), LINEAR), (b + key + ".bias", (o,), BIAS)]
        out += [(b + "ls1.gamma", (d,), GAMMA), (b + "ls2.gamma", (d,), GAMMA)]
    out += [("norm.weight", (d,), GAIN), ("norm.bias", (d,), SHIFT)]
    return out


def state_dict(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's fp32 weights from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    entries = layout(model)
    sd: Dict[str, torch.Tensor] = {}
    for kind in (LINEAR, BIAS, GAIN, SHIFT, GAMMA, TOKEN):
        mine = [(k, s) for k, s, c in entries if c == kind]
        total = sum(math.prod(s) for _, s in mine)
        if kind in (GAIN, GAMMA):
            flat = torch.rand(total, generator=g, device=device)
        else:
            flat = torch.randn(total, generator=g, device=device)
        at = 0
        for key, shape in mine:
            part = flat[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
            if kind == LINEAR:
                scale = (QKV_SCALE if "qkv" in key else 1.0) / math.prod(shape[1:]) ** 0.5
                sd[key] = part * scale
            elif kind == BIAS:
                sd[key] = part * 0.02
            elif kind == GAIN:
                sd[key] = part * 0.4 + 0.8
            elif kind == SHIFT:
                sd[key] = part * 0.05
            elif kind == GAMMA:
                sd[key] = part * 0.4 + 0.1
            else:
                sd[key] = part * 0.5
    d = model["embed_dim"]
    sd["mask_token"] = torch.zeros((1, d), device=device)
    fc_in, out = model["fc_in"], model["out_dim"]
    sd["adpool.p"] = torch.full((1,), float(model["gemp"]), device=device)
    sd["fc.weight"] = (torch.rand((out, fc_in), generator=g, device=device) * 2 - 1) * fc_in ** -0.5
    sd["fc.bias"] = torch.randn(out, generator=g, device=device) * 0.01
    return sd
