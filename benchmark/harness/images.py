"""Photo-like JPEG files drawn from the seed.

Each image is a sum of three octaves of smooth noise made on the device
(each ``[cell pixels, amplitude]`` of the mix's ``octaves``: colour
regions a few hundred pixels wide down to texture of a few pixels), with
faint grain, so its JPEG size and decode time are those of a photo rather
than of a flat or a white-noise image. The mix fixes the sizes, each taken
by an equal share of the files in an order drawn from the seed, and the
JPEG quality.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GEN_BATCH = 16
CHROMA = 0.4


def _octave(g, n: int, h: int, w: int, cell: int, amp: float, device) -> torch.Tensor:
    """Bicubic noise with control points ``cell`` pixels apart: a brightness
    field shared by the channels, and CHROMA of it again in each channel."""
    ch, cw = max(2, h // cell), max(2, w // cell)
    x = torch.randn((n, 4, ch, cw), generator=g, device=device) * amp
    x = x[:, :1] + CHROMA * x[:, 1:]
    return F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False)


def render(g, n: int, width: int, height: int, content: dict, device) -> torch.Tensor:
    """(n, height, width, 3) uint8 images."""
    x = torch.full((n, 3, height, width), 128.0, device=device)
    for cell, amp in content["octaves"]:
        x += _octave(g, n, height, width, int(cell), float(amp), device)
    x += torch.randn(x.shape, generator=g, device=device) * float(content["grain"])
    return x.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def write_jpegs(mix: dict, seed: int, out_dir: str, device) -> List[Tuple[str, int, int]]:
    """Write ``mix["files"]`` JPEGs under ``out_dir``; returns (path, width,
    height) per file, in the order the dataset cycles through them."""
    from PIL import Image

    files, sizes = int(mix["files"]), [tuple(s) for s in mix["sizes"]]
    if files % len(sizes):
        raise ValueError("files must divide evenly among the sizes")
    g = torch.Generator(device=device).manual_seed(seed)
    order = torch.randperm(files, generator=g, device=device).cpu().numpy() % len(sizes)
    out: List[Tuple[str, int, int]] = [None] * files
    jobs = []

    def save(i: int, pixels: np.ndarray, w: int, h: int) -> None:
        path = os.path.join(out_dir, f"img{i:05d}.jpg")
        Image.fromarray(pixels).save(path, quality=int(mix["jpeg_quality"]))
        out[i] = (path, w, h)

    with ThreadPoolExecutor(max_workers=int(mix.get("writer_threads", 8))) as pool:
        for s, (w, h) in enumerate(sizes):
            idx = np.flatnonzero(order == s)
            for start in range(0, len(idx), GEN_BATCH):
                part = idx[start:start + GEN_BATCH]
                pixels = render(g, len(part), w, h, mix["content"], device).cpu().numpy()
                jobs += [pool.submit(save, int(i), pixels[j], w, h)
                         for j, i in enumerate(part)]
        for job in jobs:
            job.result()
    return out
