"""Kapture global-feature extraction CLI (counterpart of
``dirjax/cli/extract_kapture.py``): extracts global descriptors for every
image of a kapture dataset not extracted yet, and writes kapture's
per-image feature files.

Needs the optional ``kapture`` package and fails with dirjax's message
when it is absent.
"""

from __future__ import annotations

import argparse
import os

import torch

from .common import load_extractor, setup_device


def extract_kapture_global_features(kapture_root_path: str, extractor,
                                    global_features_type: str, trfs,
                                    pooling="mean", gemp=3, whiten=None,
                                    threads=8, processes=0, batch_size=8,
                                    batching="group"):
    try:
        import kapture
        from kapture.io.csv import (get_all_tar_handlers,
                                    get_feature_csv_fullpath,
                                    global_features_to_file, kapture_from_dir)
        from kapture.io.features import (get_global_features_fullpath,
                                         global_features_check_dir,
                                         image_global_features_to_file)
        from kapture.io.records import get_image_fullpath
    except ImportError as e:
        raise ImportError(
            "extract_kapture requires the 'kapture' package, which is not "
            "installed in this environment") from e

    from .. import ops
    from ..datasets import ImageList
    from ..extraction import extract_image_features

    print(f"loading {kapture_root_path}")
    with get_all_tar_handlers(kapture_root_path,
                              mode={kapture.Keypoints: "r",
                                    kapture.Descriptors: "r",
                                    kapture.GlobalFeatures: "a",
                                    kapture.Matches: "r"}) as tar_handlers:
        kdata = kapture_from_dir(kapture_root_path, None,
                                 skip_list=[kapture.Keypoints,
                                            kapture.Descriptors,
                                            kapture.Matches,
                                            kapture.Points3d,
                                            kapture.Observations],
                                 tar_handlers=tar_handlers)
        root = get_image_fullpath(kapture_root_path, image_filename=None)
        if kdata.records_camera is None:
            raise ValueError(f"{kapture_root_path} has no camera records")
        imgs = [name for _, _, name in kapture.flatten(kdata.records_camera)]
        if kdata.global_features is None:
            kdata.global_features = {}
        if global_features_type in kdata.global_features:
            done = kdata.global_features[global_features_type]
            imgs = [name for name in imgs if name not in done]
        if not imgs:
            print("All global features are already extracted")
            return

        dataset = ImageList(root=root, imgs=imgs)
        print(f"\nExtracting for {dataset}")

        trfs_list = [trfs] if isinstance(trfs, str) else list(trfs)
        descs = [extract_image_features(dataset, chain, extractor, desc="DB",
                                        threads=threads, processes=processes,
                                        batch_size=batch_size,
                                        batching=batching, progress=True)
                 for chain in trfs_list]
        bdescs = ops.pool_descriptors(
            [torch.from_numpy(d).to(extractor.device) for d in descs], pooling, gemp)
        if whiten is not None:
            wkw = {k: v for k, v in whiten.items() if k != "pca"}
            bdescs = ops.apply_whitening(bdescs, whiten["pca"], **wkw)
        bdescs = bdescs.cpu().numpy()

        print("writing extracted global features")
        os.umask(0o002)
        dtype, dsize = bdescs.dtype, bdescs.shape[1]
        if global_features_type not in kdata.global_features:
            kdata.global_features[global_features_type] = kapture.GlobalFeatures(
                "dirjax", dtype, dsize, "L2")
            cfg_path = get_feature_csv_fullpath(
                kapture.GlobalFeatures, global_features_type, kapture_root_path)
            global_features_to_file(cfg_path,
                                    kdata.global_features[global_features_type])
        else:
            gf = kdata.global_features[global_features_type]
            if gf.dtype != dtype or gf.dsize != dsize or gf.metric_type != "L2":
                raise ValueError(
                    f"existing {global_features_type} features are {gf.dtype} x "
                    f"{gf.dsize} ({gf.metric_type}), not {dtype} x {dsize} (L2)")
        for i in range(dataset.nimg):
            name = dataset.get_key(i)
            path = get_global_features_fullpath(
                global_features_type, kapture_root_path, name, tar_handlers)
            image_global_features_to_file(path, bdescs[i])
            kdata.global_features[global_features_type].add(name)

        if not global_features_check_dir(
                kdata.global_features[global_features_type],
                global_features_type, kapture_root_path, tar_handlers):
            print("extraction ended successfully but not all files were saved")
        else:
            print("Features extracted.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Extract kapture global features")
    parser.add_argument("--kapture-root", type=str, required=True,
                        help="path to kapture root directory")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--global-features-type", default=None,
                        help="defaults to the checkpoint basename")
    parser.add_argument("--trfs", type=str, default="", nargs="+")
    parser.add_argument("--pooling", type=str, default="gem")
    parser.add_argument("--gemp", type=int, default=3)
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--batching", type=str, default="group")
    parser.add_argument("--gpu", type=int, default=0, nargs="+",
                        help="CUDA device id; -1 selects the CPU")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--whiten", type=str, default=None)
    parser.add_argument("--whitenp", type=float, default=0.5)
    parser.add_argument("--whitenv", type=int, default=None)
    parser.add_argument("--whitenm", type=float, default=1.0)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = setup_device(args.gpu)
    if args.global_features_type is None:
        args.global_features_type = os.path.splitext(
            os.path.basename(args.checkpoint))[0]
        print(f"global_features_type set to {args.global_features_type}")
    _, extractor, whiten = load_extractor(args, device)
    extract_kapture_global_features(
        args.kapture_root, extractor, args.global_features_type, args.trfs,
        pooling=args.pooling, gemp=args.gemp, whiten=whiten,
        threads=args.threads, batch_size=args.batch_size,
        batching=args.batching)


if __name__ == "__main__":
    main()
