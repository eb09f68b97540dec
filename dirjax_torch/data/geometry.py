"""Geometry bookkeeping for image transforms.

The port's own copy of ``dirjax/data/geometry.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Parity with reference ``dirtorch/utils/transforms_tools.py``: samples are
dicts carrying an image (or just its size via :class:`DummyImg`) plus
optional label geometry (bbox / polygons) that every geometric transform
updates through an affine 6-tuple or homography 8-tuple.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance

__all__ = [
    "DummyImg", "is_pil_image", "grab_img", "update_sample",
    "aff_translate", "aff_rotate", "aff_mul", "persp_mul",
    "rand_log_uniform", "adjust_brightness", "adjust_contrast",
    "adjust_saturation", "adjust_hue",
]


def is_pil_image(img) -> bool:
    return isinstance(img, Image.Image)


class DummyImg:
    """A size-only image stand-in: geometric transforms can be replayed on
    label geometry without decoding pixels (reference transforms_tools.py:9-39)."""

    def __init__(self, size):
        self.size = tuple(size)

    def resize(self, size, *args, **kwargs):
        return DummyImg(size)

    def expand(self, border):
        w, h = self.size
        if isinstance(border, int):
            return DummyImg((w + 2 * border, h + 2 * border))
        left, top, right, bottom = border
        return DummyImg((w + left + right, h + top + bottom))

    def crop(self, box):
        left, top, right, bottom = box
        return DummyImg((right - left, bottom - top))

    def transform(self, size, *args, **kwargs):
        return DummyImg(size)

    def transpose(self, *args):
        return DummyImg(self.size)

    def paste_into(self, size):
        return DummyImg(size)


def grab_img(sample):
    """Extract the image from a sample dict (or pass a bare image through)."""
    if isinstance(sample, dict):
        if "img" in sample:
            return sample["img"]
        return DummyImg(sample["imsize"])
    return sample


def _int_tuple(*args):
    return tuple(int(a) for a in args)


def update_sample(sample, img, aff=None, persp=None):
    """Store the transformed image back and push bbox/polygon geometry
    through the same transform (reference transforms_tools.py:59-97)."""
    if not isinstance(sample, dict):
        return img
    sample["img"] = img

    def apply_pt(pt):
        if aff is not None:
            return aff_mul(aff, pt)
        if persp is not None:
            return persp_mul(persp, pt)
        raise NotImplementedError()

    if "bbox" in sample:
        left, top, right, bottom = sample["bbox"]
        corners = [(left, top), (left, bottom), (right, bottom), (right, top)]
        pts = [apply_pt(p) for p in corners]
        xs = sorted(p[0] for p in pts)
        ys = sorted(p[1] for p in pts)
        sample["bbox"] = _int_tuple(
            np.mean(xs[:2]), np.mean(ys[:2]), np.mean(xs[2:]), np.mean(ys[2:]))

    if "polygons" in sample:
        sample["polygons"] = [
            (label, [_int_tuple(*apply_pt(p)) for p in pts])
            for label, pts in sample["polygons"]
        ]
    return sample


def aff_translate(tx, ty):
    return (1, 0, tx, 0, 1, ty)


def aff_rotate(angle):
    c, s = np.cos(angle), np.sin(angle)
    return (c, -s, 0, s, c, 0)


def aff_mul(aff, other):
    """Compose affines (6-tuples) or apply to a point (2-tuple).

    NB: composition order follows the reference (transforms_tools.py:115-132):
    ``aff_mul(a, b)`` = apply a first, then b."""
    A = np.array(aff + (0, 0, 1)).reshape(3, 3)
    if len(other) == 6:
        B = np.array(other + (0, 0, 1)).reshape(3, 3)
        return tuple((B @ A)[:2].ravel())
    if len(other) == 2:
        return tuple((np.array(other + (1,)) @ A.T).ravel()[:2])
    raise ValueError(f"bad input {other}")


def persp_mul(mat, other):
    """Compose homographies (8-tuples) or apply to a point (2-tuple)."""
    M = np.array(mat + (1,)).reshape(3, 3)
    if len(other) == 8:
        B = np.array(other + (1,)).reshape(3, 3)
        C = B @ M
        # re-normalize so the implicit trailing 1 of the 8-tuple encoding
        # holds: (B@M)[2,2] != 1 in general, and dropping it unnormalized
        # yields a DIFFERENT projective map (reference bug,
        # transforms_tools.py:135-146)
        return tuple((C / C[2, 2]).ravel()[:8])
    if len(other) == 2:
        pt = np.array(other + (1,)) @ M.T
        pt = pt / pt[2]
        return tuple(pt[:2])
    raise ValueError(f"bad input {other}")


def rand_log_uniform(a, b, rng=np.random):
    return float(np.exp(rng.uniform(np.log(a), np.log(b))))


def adjust_brightness(img, factor):
    return ImageEnhance.Brightness(img).enhance(factor)


def adjust_contrast(img, factor):
    return ImageEnhance.Contrast(img).enhance(factor)


def adjust_saturation(img, factor):
    return ImageEnhance.Color(img).enhance(factor)


def adjust_hue(img, hue_factor):
    """Cyclic shift of the HSV hue channel by hue_factor in [-0.5, 0.5]."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} is not in [-0.5, 0.5]")
    if img.mode in {"L", "1", "I", "F"}:
        return img
    h, s, v = img.convert("HSV").split()
    # cyclic uint8 shift; int(...) truncates toward zero like the
    # reference's np.uint8 cast, and % 256 handles negative factors (modern
    # numpy rejects out-of-range uint8 construction)
    np_h = np.array(h, dtype=np.uint8)
    np_h = ((np_h.astype(np.int16) + int(hue_factor * 255)) % 256).astype(np.uint8)
    return Image.merge("HSV", (Image.fromarray(np_h, "L"), s, v)).convert(img.mode)
