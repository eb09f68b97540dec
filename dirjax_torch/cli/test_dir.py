"""Benchmark evaluation CLI (counterpart of ``dirjax/cli/test_dir.py``): same
flags and the same `` * mAP-medium = 0.803098`` output.

Example:
    python -m dirjax_torch.test_dir --dataset RParis6K \
        --checkpoint Resnet101-AP-GeM.pt --whiten Landmarks_clean \
        --whitenp 0.25 --gpu 0
"""

from __future__ import annotations

import argparse
import json
import os

from .common import add_model_args, load_extractor, maybe_profile, setup_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate a model")
    add_model_args(parser, whitenp_default=0.25)
    parser.add_argument("--out-json", type=str, default="",
                        help="path to output json")
    parser.add_argument("--detailed", action="store_true",
                        help="return detailed evaluation")
    parser.add_argument("--save-feats", type=str, default="",
                        help="path to save descriptors")
    parser.add_argument("--load-feats", type=str, default="",
                        help="path to load descriptors from")
    parser.add_argument("--whiten", type=str, default="Landmarks_clean",
                        help="whitening PCA name ('' disables)")
    parser.add_argument("--aqe", type=int, nargs="+",
                        help="alpha-query-expansion: k alpha")
    parser.add_argument("--adba", type=int, nargs="+",
                        help="alpha-database-augmentation: k alpha")
    parser.add_argument("--tta", type=str, default="", choices=("", "flip"),
                        help="test-time augmentation: 'flip' adds a "
                             "horizontally-mirrored pass per transform chain")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = setup_device(args.gpu)

    from .. import datasets
    from ..extraction import eval_model

    datasets.download_dataset(args.dataset)  # no-op unless a known benchmark
    dataset = datasets.create(args.dataset)
    print("Test dataset:", dataset)

    ckpt, extractor, whiten = load_extractor(args, device)
    aqe = {"k": args.aqe[0], "alpha": args.aqe[1]} if args.aqe else None
    adba = {"k": args.adba[0], "alpha": args.adba[1]} if args.adba else None

    with maybe_profile(args.profile):
        res = eval_model(
            dataset, extractor, args.trfs, pooling=args.pooling,
            gemp=args.gemp, detailed=args.detailed, whiten=whiten, aqe=aqe,
            adba=adba, tta=args.tta or None, threads=args.threads,
            processes=args.processes, batch_size=args.batch_size,
            batching=args.batching, save_feats=args.save_feats,
            load_feats=args.load_feats, progress=True)
    print(" * " + "\n * ".join(f"{k} = {v:g}" for k, v in res.items()
                               if not isinstance(v, list)))

    if args.out_json:
        try:
            with open(args.out_json) as f:
                data = json.load(f)
        except IOError:
            data = {}
        data[args.dataset] = res
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            f.write(json.dumps(data, indent=1))
        print("saved to " + args.out_json)
    return res


if __name__ == "__main__":
    main()
