"""Fit a checkpoint's PCA-whitening from a dataset's descriptors
(counterpart of ``dirjax/cli/fit_whitening.py``): extract and pool the
dataset's descriptors with the checkpoint, fit the PCA (sklearn's SVD on the
host, or with ``--device-fit`` the streamed covariance of
:func:`~dirjax_torch.ops.whitening.fit_pca_device` on the run's device),
store it under ``--name`` and write the checkpoint (``.pt`` reference
schema, else dirjax's ``.npz``), ready for ``test_dir --whiten <name>``.

Example:
    python -m dirjax_torch.fit_whitening --dataset Landmarks_clean \\
        --checkpoint runs/r101/checkpoint.npz --name Landmarks_clean \\
        --out runs/r101/whitened.npz --device-fit --gpu 0
"""

from __future__ import annotations

import argparse

import torch

from .common import add_model_args, load_extractor, setup_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Fit PCA whitening from a dataset and store it in a "
                    "checkpoint")
    add_model_args(parser, whitenp_default=0.25)
    parser.add_argument("--name", type=str, default="Landmarks_clean",
                        help="key under which the PCA is stored "
                             "(test_dir --whiten <name>)")
    parser.add_argument("--out", type=str, required=True,
                        help="output checkpoint (.npz native, .pt torch)")
    parser.add_argument("--max-images", type=int, default=0,
                        help="fit on at most this many images (0 = all)")
    parser.add_argument("--device-fit", action="store_true",
                        help="fit by the streamed covariance on the device "
                             "and an fp64 eigh on the host (ops.fit_pca_device) "
                             "instead of the host SVD")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = setup_device(args.gpu)

    from .. import datasets, ops
    from ..extraction import extract_image_features
    from ..utils.checkpoints import save_native, save_torch_checkpoint

    dataset = datasets.create(args.dataset)
    print("Whitening dataset:", dataset)
    if args.max_images and len(dataset) > args.max_images:
        from ..datasets.combinators import SubDataset

        step = max(1, len(dataset) // args.max_images)
        dataset = SubDataset(dataset,
                             list(range(0, len(dataset), step))[: args.max_images])

    ckpt, extractor, _ = load_extractor(args, device)

    trfs_list = [args.trfs] if isinstance(args.trfs, str) else list(args.trfs)
    chains = [extract_image_features(
        dataset, chain, extractor, batching=args.batching,
        batch_size=args.batch_size, threads=args.threads,
        processes=args.processes, desc=f"whiten[{chain or 'id'}]", progress=True)
        for chain in trfs_list]
    descs = ops.pool_descriptors([torch.from_numpy(d).to(device) for d in chains],
                                 args.pooling, args.gemp)

    print(f">> Fitting PCA on {tuple(descs.shape)} descriptors...")
    if args.device_fit:
        ckpt.pca[args.name] = ops.fit_pca_device(descs, device=device)
    else:
        ckpt.pca[args.name] = ops.fit_pca(descs.cpu().numpy())

    if args.out.endswith(".pt"):
        save_torch_checkpoint(args.out, ckpt)
    else:
        save_native(args.out, ckpt)
    print(f"saved {args.out} (pca keys: {sorted(ckpt.pca)})")
    return ckpt


if __name__ == "__main__":
    main()
