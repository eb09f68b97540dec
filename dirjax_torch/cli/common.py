"""Shared CLI plumbing (counterpart of ``dirjax/cli/common.py``): device
selection, checkpoint loading, whitening arguments. ``--gpu -1`` selects
the CPU; any other value selects ``cuda:N`` and raises if CUDA is absent.
``--bf16`` runs the backbone in bf16.
"""

from __future__ import annotations

import argparse
import os
from contextlib import contextmanager

import torch


def add_model_args(parser: argparse.ArgumentParser, whitenp_default: float):
    parser.add_argument("--dataset", "-d", type=str, required=True,
                        help="dataset spec, e.g. RParis6K or ImageList('l.txt')")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="path to weights (.pt reference or .npz native)")
    parser.add_argument("--trfs", type=str, default="", nargs="+",
                        help="test transform chains (can be several)")
    parser.add_argument("--pooling", type=str, default="gem",
                        help="pooling scheme if several trf chains")
    parser.add_argument("--gemp", type=int, default=3, help="GeM pooling power")
    parser.add_argument("--threads", type=int, default=8,
                        help="number of loader threads")
    parser.add_argument("--processes", type=int, default=0,
                        help="decode in N worker processes (0 = threads only)")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="extraction batch size")
    parser.add_argument("--batching", type=str, default="group",
                        choices=("group", "bucket", "single"),
                        help="batch formation: exact same-shape groups, "
                             "padded+masked buckets, or one-by-one")
    parser.add_argument("--gpu", type=int, default=0, nargs="+",
                        help="CUDA device id; -1 selects the CPU")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 backbone compute (fast path)")
    parser.add_argument("--dbg", default=(), nargs="*", help="debugging options")
    parser.add_argument("--profile", type=str, default="",
                        help="write a torch.profiler chrome trace of the run "
                             "to this directory")
    parser.add_argument("--whitenp", type=float, default=whitenp_default,
                        help="whitening power")
    parser.add_argument("--whitenv", type=int, default=None,
                        help="number of whitening components")
    parser.add_argument("--whitenm", type=float, default=1.0,
                        help="whitening multiplier")


@contextmanager
def maybe_profile(profile_dir: str):
    """torch.profiler scope writing ``trace.json`` into ``profile_dir``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def setup_device(gpu) -> torch.device:
    """-1 -> CPU; N -> cuda:N, which must exist. Turns TF32 off for fp32
    convolutions and matmuls (the counterpart of dirjax's
    ``precision=HIGHEST``)."""
    g = (gpu if isinstance(gpu, (list, tuple)) else [gpu])[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if g < 0:
        print("Launching on >> CPU <<")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--gpu {g} asks for CUDA, which is not available "
                           "(use --gpu -1 for the CPU)")
    device = torch.device("cuda", g)
    print(f"Launching on {device} ({torch.cuda.get_device_name(device)})")
    return device


def load_extractor(args, device: torch.device):
    """Checkpoint -> (Checkpoint, FeatureExtractor, whiten dict or None)."""
    from ..extraction import FeatureExtractor
    from ..utils.checkpoints import load_checkpoint

    ckpt = load_checkpoint(args.checkpoint)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    # the checkpoint's own mean/std, not the architecture's
    extractor = FeatureExtractor(ckpt.model, device, dtype=dtype,
                                 preprocess=ckpt.preprocess)
    whiten = None
    whiten_name = getattr(args, "whiten", None)
    if whiten_name:
        if whiten_name not in ckpt.pca:
            raise KeyError(f"checkpoint has no whitening for {whiten_name!r}; "
                           f"available: {sorted(ckpt.pca)}")
        whiten = {"pca": ckpt.pca[whiten_name], "whitenp": args.whitenp,
                  "whitenv": args.whitenv, "whitenm": args.whitenm}
    return ckpt, extractor, whiten
