"""A configuration's weights, drawn from the seed on the device.

The state dict has the reference's keys (``conv1``, ``bn1``,
``layerS.B.convC``/``bnC``, ``downsample.0``/``.1``, ``adpool.p``, ``fc``),
so the program loads it with ``load_state_dict`` and the plain reference
reads the same tensors. Convolutions are He-normal (fan = k*k*cout), each BN
near identity with the last BN of a residual branch scaled down (so
activations stay bounded through 33 blocks, as in trained ResNets), the FC
uniform in +-1/sqrt(fan_in). Each kind of tensor is one draw from a
``torch.Generator`` on the device, split afterwards.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def layout(model: dict) -> Tuple[List[Tuple[str, tuple]], List[Tuple[str, int, bool]]]:
    """(convolutions as (key, shape), BNs as (prefix, channels, last of a
    residual branch)) of a bottleneck ResNet / ResNeXt, in the reference's
    order."""
    stem = model["stem_channels"]
    convs = [("conv1.weight", (stem, 3, 7, 7))]
    bns = [("bn1", stem, False)]
    cin = stem
    for s, (planes, blocks) in enumerate(zip(model["stage_planes"], model["layers"])):
        mid = int(planes * model["base_width"] / 64.0) * model["groups"]
        cout = planes * model["expansion"]
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            convs += [(f"{p}.conv1.weight", (mid, cin, 1, 1)),
                      (f"{p}.conv2.weight", (mid, mid // model["groups"], 3, 3)),
                      (f"{p}.conv3.weight", (cout, mid, 1, 1))]
            bns += [(f"{p}.bn1", mid, False), (f"{p}.bn2", mid, False),
                    (f"{p}.bn3", cout, True)]
            if b == 0 and (s > 0 or cin != cout):
                convs.append((f"{p}.downsample.0.weight", (cout, cin, 1, 1)))
                bns.append((f"{p}.downsample.1", cout, False))
            cin = cout
    return convs, bns


def state_dict(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's fp32 weights from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    convs, bns = layout(model)
    sd: Dict[str, torch.Tensor] = {}

    flat = torch.randn(sum(math.prod(s) for _, s in convs), generator=g, device=device)
    at = 0
    for key, shape in convs:
        n = math.prod(shape)
        sd[key] = (flat[at:at + n] * (2.0 / (shape[2] * shape[3] * shape[0])) ** 0.5
                   ).view(shape).clone()
        at += n

    total = sum(c for _, c, _ in bns)
    scale = torch.rand(total, generator=g, device=device)
    shift = torch.randn(total, generator=g, device=device) * 0.05
    mean = torch.randn(total, generator=g, device=device) * 0.05
    var = torch.rand(total, generator=g, device=device) * 0.4 + 0.8
    at = 0
    for prefix, c, last in bns:
        lo, hi = (0.1, 0.3) if last else (0.8, 1.2)
        sd[f"{prefix}.weight"] = scale[at:at + c] * (hi - lo) + lo
        sd[f"{prefix}.bias"] = shift[at:at + c].clone()
        sd[f"{prefix}.running_mean"] = mean[at:at + c].clone()
        sd[f"{prefix}.running_var"] = var[at:at + c].clone()
        at += c

    fc_in, out = model["fc_in"], model["out_dim"]
    sd["adpool.p"] = torch.full((1,), float(model["gemp"]), device=device)
    sd["fc.weight"] = (torch.rand((out, fc_in), generator=g, device=device) * 2 - 1) * fc_in ** -0.5
    sd["fc.bias"] = torch.randn(out, generator=g, device=device) * 0.01
    return sd
