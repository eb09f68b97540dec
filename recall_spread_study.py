#!/usr/bin/env python3
"""How far the recall study's readings spread over its seeds, and where the
card and the CPU part, with the PyTorch port on an NVIDIA GPU.

    python3 recall_spread_study.py --out chiprun_out/recall_spread.json
    python3 recall_spread_study.py --parts precision,whitening --trained-seeds 0

Every stage runs through ``dirjax_torch.recall_study`` in this process, its
files in a temporary directory. The parts (``--parts``, all by default):

* ``flat``: src_is_top1 of the flat study (random weights, 16,384 scenes,
  256 query views) over weight seeds 7-11 on the study's scenes, and over
  scene shifts 1-4 (x 100,000) on its weights (seed 7);
* ``trained``: src_is_top1 of the trained study (400 fine-tune steps) for
  each of ``--trained-seeds`` (init seeds; one twice reads the card's run
  to run spread), each extracted on the study's scenes; a fine-tune whose
  loss went non-finite is recorded with its first such step instead;
* ``precision``: src_is_top1 of the flat study and of the seed-0 trained
  one with three convolutions: the port's bf16 (each output rounded to
  bf16 before its BN), dirjax's bf16 (inputs rounded to bf16, output left
  in fp32: an fp32 convolution of bf16-rounded operands, TF32 off) and fp32;
* ``fp32_train``: src_is_top1 of the trained study with an fp32 fine-tune
  (dirjax's is bf16) for each of ``--trained-seeds``;
* ``same_images``: the seed-0 checkpoint's descriptors of the study's first
  32 scenes and their 32 query views (rendered on the card) on the card and
  on the CPU: cosine and largest |difference|. ``extract --cpu`` would
  render other scenes: the CPU's and the card's generators differ;
* ``whitening``: the study's PCA of the first 4,096 trained rows fitted on
  the card and on the CPU: eigenvalues, and for each principal axis the
  |cosine| between the two fits;
* ``quantizers``: on the first 4,096 rows of the seed-0 trained file,
  recall@k of the tiers ``chip_smoke.py`` trains on both devices, over
  quantizer seeds 0-4 on the card and seed 0 with ``--cpu``.

``chip_smoke.py``'s RECALL_TRAINED_TOL rests on the last part. Prints one
JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

EXTRACT = ["--n-db", "16384", "--n-q", "256", "--batch", "32", "--size", "224"]
TRAIN = ["--steps", "400", "--batch", "16", "--views", "4", "--n-classes", "256",
         "--size", "224"]
PARTS = ("flat", "trained", "fp32_train", "precision", "same_images", "whitening",
         "quantizers")


def src_is_top1(descs: str, device) -> float:
    """The study's src_is_top1 of a descriptor file, without its gate."""
    from dirjax_torch import recall_study as RS
    from dirjax_torch.tuning import exact_ground_truth

    data = np.load(descs)
    _, whiten = RS.study_whitening(torch.from_numpy(data["db"]).to(device))
    db, q = (whiten(torch.from_numpy(data[k]).to(device)).cpu().numpy() for k in ("db", "q"))
    return float(np.mean(exact_ground_truth(q, db, 1)[:, 0] == data["src"][:len(q)]))


def recall_rows(res: dict) -> dict:
    return {(name, k): v for name, row in res["tiers"].items()
            for k, v in row.items() if k.startswith("recall@")}


def _dirjax_bf16_conv(x, conv, dtype):
    """dirjax's ``_conv`` at bf16: operands rounded to ``dtype``, products and
    sums in fp32, the output left in fp32."""
    y = F.conv2d(x.to(dtype).float(), conv.weight.to(dtype).float(), None, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y if conv.bias is None else y + conv.bias.float()[:, None, None]


@contextlib.contextmanager
def _convolutions(mode: str):
    """The extraction inside at the port's bf16 (``port_bf16``), with
    dirjax's bf16 convolution (``dirjax_bf16``), or at fp32 (``fp32``)."""
    from dirjax_torch import recall_study as RS
    from dirjax_torch.models import resnet

    conv, dtype = resnet._conv, RS.EXTRACT_DTYPE
    if mode == "dirjax_bf16":
        resnet._conv = _dirjax_bf16_conv
    elif mode == "fp32":
        RS.EXTRACT_DTYPE = torch.float32
    try:
        yield
    finally:
        resnet._conv, RS.EXTRACT_DTYPE = conv, dtype


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/recall_spread.json")
    parser.add_argument("--parts", default=",".join(PARTS))
    parser.add_argument("--trained-seeds", default="0,0,1,2,3,4")
    args = parser.parse_args(argv)
    parts = set(args.parts.split(","))
    if parts - set(PARTS):
        raise ValueError(f"unknown parts {sorted(parts - set(PARTS))}")
    if not torch.cuda.is_available():
        raise RuntimeError("this study runs on cuda, which is not available")
    from chip_smoke import RECALL_CHECK_ROWS, RECALL_CHECK_TIERS
    from dirjax_torch import recall_study as RS
    from dirjax_torch.utils.checkpoints import load_native

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    out = {"card": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory(prefix="recall_spread_") as work:
        def path(name):
            return os.path.join(work, name)

        if "flat" in parts:
            flat = {}
            for seed, shift in [(7, 0), (8, 0), (9, 0), (10, 0), (11, 0),
                                (7, 100_000), (7, 200_000), (7, 300_000), (7, 400_000)]:
                RS.main(["extract", *EXTRACT, "--seed", str(seed), "--scene-shift", str(shift),
                         "--out", path("flat.npz")])
                flat[f"weights{seed}_scenes{shift}"] = src_is_top1(path("flat.npz"), device)
                print(f"flat weights {seed} scenes +{shift}: src_is_top1 "
                      f"{flat[f'weights{seed}_scenes{shift}']}", flush=True)
            out["flat_src_is_top1"] = flat

        # the later parts read the seed-0 fine-tune (run 0)
        given = [int(s) for s in args.trained_seeds.split(",")]
        seeds = given if "trained" in parts else [0] if parts - {"flat", "fp32_train"} else []
        if seeds and seeds[0] != 0:
            raise ValueError("--trained-seeds must start with 0: the other parts read it")
        trained = {}
        for run, seed in enumerate(seeds):
            ckpt = path(f"ckpt{run}.npz")
            fit = RS.main(["train", *TRAIN, "--seed", str(seed), "--out", ckpt])
            reading = {"loss_first25": fit["loss_first25"], "loss_last25": fit["loss_last25"]}
            if np.isfinite(fit["losses"]).all():
                RS.main(["extract", *EXTRACT, "--checkpoint", ckpt, "--out",
                         path(f"t{run}.npz")])
                reading["src_is_top1"] = src_is_top1(path(f"t{run}.npz"), device)
            else:   # a fine-tune that diverged: its first non-finite step
                reading["first_nonfinite_step"] = int(np.flatnonzero(
                    ~np.isfinite(fit["losses"]))[0])
            trained[f"run{run}_seed{seed}"] = reading
            print(f"trained run {run} seed {seed}: {trained[f'run{run}_seed{seed}']}",
                  flush=True)
        if "trained" in parts:
            out["trained"] = trained

        if "fp32_train" in parts:
            fp32 = {}
            for seed in given:
                RS.TRAIN_DTYPE = torch.float32
                try:
                    fit = RS.main(["train", *TRAIN, "--seed", str(seed), "--out", path("f.npz")])
                finally:
                    RS.TRAIN_DTYPE = torch.bfloat16
                reading = {"loss_first25": fit["loss_first25"], "loss_last25": fit["loss_last25"]}
                if np.isfinite(fit["losses"]).all():
                    RS.main(["extract", *EXTRACT, "--checkpoint", path("f.npz"), "--out",
                             path("f_descs.npz")])
                    reading["src_is_top1"] = src_is_top1(path("f_descs.npz"), device)
                fp32[f"seed{seed}"] = reading
                print(f"fp32 fine-tune seed {seed}: {reading}", flush=True)
            out["fp32_train"] = fp32

        if "precision" in parts:
            reading = {}
            for study, extra in (("flat", ["--seed", "7"]),
                                 ("trained", ["--checkpoint", path("ckpt0.npz")])):
                for mode in ("port_bf16", "dirjax_bf16", "fp32"):
                    with _convolutions(mode):
                        RS.main(["extract", *EXTRACT, *extra, "--out", path("p.npz")])
                    reading[f"{study} {mode}"] = src_is_top1(path("p.npz"), device)
                    print(f"precision: {study} {mode}: src_is_top1 "
                          f"{reading[f'{study} {mode}']}", flush=True)
            out["precision_src_is_top1"] = reading

        if "same_images" in parts:
            models = {tag: load_native(path("ckpt0.npz")).model.to(dev).eval()
                      for tag, dev in (("card", device), ("cpu", torch.device("cpu")))}
            with torch.inference_mode():
                imgs = RS.db_scenes(0, 32, 224, 224, device)
                views = RS.query_views(0, imgs)
                got = {}
                for name, x in (("db", imgs), ("q", views)):
                    card = models["card"](x.permute(0, 3, 1, 2), dtype=torch.bfloat16).cpu()
                    cpu = models["cpu"](x.cpu().permute(0, 3, 1, 2), dtype=torch.bfloat16)
                    got[name] = {"min_cosine": float(F.cosine_similarity(card, cpu).min()),
                                 "max_abs_diff": float((card - cpu).abs().max())}
            out["same_images_card_vs_cpu"] = got
            print(f"same images, card vs CPU descriptors: {got}", flush=True)

        if "whitening" in parts:
            from dirjax_torch.ops.whitening import fit_pca_device

            rows = torch.from_numpy(np.load(path("t0.npz"))["db"][:RECALL_CHECK_ROWS])
            card, cpu = (fit_pca_device(rows.to(dev), device=dev)
                         for dev in (device, torch.device("cpu")))
            var = np.asarray(cpu.variance, np.float64)
            cos = np.abs((np.asarray(card.components, np.float64)
                          * np.asarray(cpu.components, np.float64)).sum(1))
            apart = np.flatnonzero(cos < 0.999)
            rel = var / var.max()
            out["whitening_card_vs_cpu"] = {
                "rows": RECALL_CHECK_ROWS,
                "max_rel_variance_diff": float(np.max(np.abs(
                    np.asarray(card.variance, np.float64) - var) / var.max())),
                "axes": len(cos), "axes_below_cos_0.999": int(len(apart)),
                "first_axis_apart": int(apart[0]) if len(apart) else None,
                "rel_variance_there": float(rel[apart[0]]) if len(apart) else None,
                "axes_above_dead_floor": int((rel > 1e-7).sum())}
            print(f"whitening card vs CPU: {out['whitening_card_vs_cpu']}", flush=True)

        if "quantizers" in parts:
            data = np.load(path("t0.npz"))
            np.savez(path("cut.npz"), db=data["db"][:RECALL_CHECK_ROWS], q=data["q"],
                     src=data["src"])
            graded = {}
            for tag, extra in [(f"card_seed{s}", ["--seed", str(s)]) for s in range(5)] + \
                    [("cpu_seed0", ["--cpu"])]:
                graded[tag] = recall_rows(RS.main(
                    ["evaluate", *extra, "--descs", path("cut.npz"), "--tiers",
                     RECALL_CHECK_TIERS, "--out", path(f"{tag}.json")]))
            runs = [graded[f"card_seed{s}"] for s in range(5)]
            spread = {key: max(r[key] for r in runs) - min(r[key] for r in runs)
                      for key in runs[0]}
            apart = {key: abs(graded["cpu_seed0"][key] - runs[0][key]) for key in runs[0]}
            by_k = {k: max(v for (_, kk), v in spread.items() if kk == k)
                    for k in ("recall@1", "recall@10", "recall@100")}
            apart_k = {k: max(v for (_, kk), v in apart.items() if kk == k) for k in by_k}
            out["quantizer_seeds"] = {
                "rows": RECALL_CHECK_ROWS, "tiers": RECALL_CHECK_TIERS,
                "recall": {tag: {f"{n} {k}": v for (n, k), v in r.items()}
                           for tag, r in graded.items()},
                "largest_seed_spread_by_k": by_k,
                "largest_card_vs_cpu_seed0_by_k": apart_k}
            print(f"quantizer seeds 0-4 on the card, largest spread by k {by_k}; seed 0 "
                  f"card vs --cpu, largest |difference| by k {apart_k}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
