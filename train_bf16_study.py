#!/usr/bin/env python3
"""How far a bf16 training gradient lies from the fp32 one, in dirjax and in
its PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python train_bf16_study.py --arch resnet101_rmac --size 96

Seeded random weights (``chip_smoke.random_state_dict``), one batch of 4
random images in two classes, the AP-loss train objective, BN frozen. For
each package it prints the loss in fp32 and bf16 and the cosine between the
flattened bf16 and fp32 gradients of every trained tensor, and for the port
also the cosine after a 1e-3 relative perturbation of the fp32 input (the
gradient's own sensitivity). ``chip_smoke.py``'s bf16 gradient bound rests
on these readings.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="resnet101_rmac")
    parser.add_argument("--size", type=int, default=96)
    parser.add_argument("--seed", type=int, default=30)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    import dirjax.train as JT
    from chip_smoke import loss_and_gradient, random_state_dict
    from dirjax.models import create_model as jcreate
    from dirjax.models.rmac import apply_descriptor
    from dirjax_torch import train as TT
    from dirjax_torch.models import create_model
    from dirjax_torch.utils.checkpoints import (jax_params_from_state_dict, load_state,
                                                state_dict_from_jax_params)

    model = create_model(args.arch)
    load_state(model, random_state_dict(model, args.seed))
    rng = np.random.default_rng(21)
    images = rng.standard_normal((4, args.size, args.size, 3)).astype(np.float32)
    labels = np.array([0, 0, 1, 1])
    cfg = TT.TrainConfig()
    port = {tag: loss_and_gradient(model, cfg, images, labels, dt)
            for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    noisy = images * (1 + 1e-3 * rng.standard_normal(images.shape).astype(np.float32))
    _, perturbed = loss_and_gradient(model, cfg, noisy, labels, torch.float32)

    names = [n for n, p in model.named_parameters() if p.requires_grad]
    jmodel = jcreate(args.arch)
    params = jax_params_from_state_dict(model.state_dict(), model.cfg)
    objective = JT.make_batch_objective(JT.TrainConfig())
    ref = {}
    for tag, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: objective(apply_descriptor(
            p, jnp.asarray(images), jmodel.config, dtype=dt, train=True),
            jnp.asarray(labels))))(params)
        sd = state_dict_from_jax_params(jax.tree.map(np.asarray, grads), model.cfg)
        ref[tag] = (float(loss), np.concatenate([sd[n].reshape(-1) for n in names]))

    out = {"arch": args.arch, "size": args.size, "batch": 4,
           "dirjax_loss": {t: ref[t][0] for t in ref},
           "port_loss": {t: port[t][0] for t in port},
           "dirjax_bf16_vs_fp32_grad_cosine": _cos(ref["bf16"][1], ref["fp32"][1]),
           "port_bf16_vs_fp32_grad_cosine": _cos(port["bf16"][1].numpy(),
                                                 port["fp32"][1].numpy()),
           "port_fp32_vs_dirjax_fp32_grad_cosine": _cos(port["fp32"][1].numpy(),
                                                        ref["fp32"][1]),
           "port_fp32_input_perturbed_1e-3_grad_cosine": _cos(perturbed.numpy(),
                                                              port["fp32"][1].numpy())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
