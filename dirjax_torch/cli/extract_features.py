"""Feature extraction CLI (counterpart of ``dirjax/cli/extract_features.py``):
extracts descriptors for a dataset (and its query db when present), pools
the transform chains, optionally whitens, and saves them as ``.npy``. The
reference's whitenp default here (0.5, not test_dir's 0.25) is kept.

Example:
    python -m dirjax_torch.extract_features --dataset "ImageList('list.txt')" \\
        --checkpoint Resnet101-AP-GeM.pt --output feats.npy --gpu 0
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from .common import add_model_args, load_extractor, setup_device


def extract_features(db, extractor, trfs, *, pooling="mean", gemp=3,
                     whiten=None, threads=8, processes=0, batch_size=8,
                     batching="group", output=None, progress=False):
    """Extract, pool and whiten descriptors on ``extractor.device`` and save
    them (``dirjax/cli/extract_features.py:20-66``)."""
    from .. import ops
    from ..extraction import extract_image_features

    print("\n>> Extracting features...")
    try:
        query_db = db.get_query_db()
    except NotImplementedError:
        query_db = None

    trfs_list = [trfs] if isinstance(trfs, str) else list(trfs)
    kw = dict(threads=threads, processes=processes, batch_size=batch_size,
              batching=batching, progress=progress)
    bl, ql = [], []
    for chain in trfs_list:
        bl.append(extract_image_features(db, chain, extractor, desc="DB", **kw))
        if query_db is not None:
            ql.append(bl[-1] if db is query_db else extract_image_features(
                query_db, chain, extractor, desc="query", **kw))

    def finish(descs):
        out = ops.pool_descriptors([torch.from_numpy(d).to(extractor.device) for d in descs],
                                   pooling, gemp)
        if whiten is not None:
            wkw = {k: v for k, v in whiten.items() if k != "pca"}
            out = ops.apply_whitening(out, whiten["pca"], **wkw)
        return out.cpu().numpy()

    bdescs = finish(bl)
    qdescs = None if query_db is None else finish(ql)

    os.makedirs(osp.dirname(osp.abspath(output)), exist_ok=True)
    if query_db is db or query_db is None:
        np.save(output, bdescs)
    else:
        stem, ext = osp.splitext(output)
        np.save(stem + ".qdescs" + ext, qdescs)
        np.save(stem + ".dbdescs" + ext, bdescs)
    print("Features extracted.")
    return bdescs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Extract features")
    add_model_args(parser, whitenp_default=0.5)
    parser.add_argument("--output", type=str, required=True,
                        help="path to output .npy")
    parser.add_argument("--whiten", type=str, default=None,
                        help="whitening PCA name")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = setup_device(args.gpu)

    from .. import datasets

    dataset = datasets.create(args.dataset)
    print("Dataset:", dataset)

    _, extractor, whiten = load_extractor(args, device)
    return extract_features(
        dataset, extractor, args.trfs, pooling=args.pooling, gemp=args.gemp,
        whiten=whiten, threads=args.threads, processes=args.processes,
        batch_size=args.batch_size, batching=args.batching,
        output=args.output, progress=True)


if __name__ == "__main__":
    main()
