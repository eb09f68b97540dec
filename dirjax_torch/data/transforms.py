"""Host-side image transform library + CLI-compatible chain parser.

The port's own copy of ``dirjax/data/transforms.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Parity with reference ``dirtorch/utils/transforms.py``: the same transform
vocabulary (Identity, Pad, PadSquare, RandomBorder, Scale, RandomScale,
RandomCrop, CenterCrop, CropToBbox, RandomRotation, RandomFlip,
RandomTilting, ColorJitter, RandomErasing, ToArray, Normalize,
BBoxToPixelLabel) driven by the same CLI strings ("Scale(1050), RandomFlip()")
— but parsed with ``ast`` instead of ``eval`` (reference transforms.py:11-37),
and producing **NHWC float numpy arrays** ready for TPU device buffers
instead of CHW torch tensors.

All transforms consume/produce either a PIL image or a sample dict
``{'img': ..., 'bbox': ..., 'polygons': ...}``; geometric ones propagate
label geometry through affine/homography tuples via
:mod:`dirjax.data.geometry`.
"""

from __future__ import annotations

import ast
import random as _random
from math import ceil

import numpy as np
from PIL import Image, ImageOps

from . import geometry as G

__all__ = [
    "create", "Compose", "Identity", "Pad", "PadSquare", "RandomBorder",
    "Scale", "RandomScale", "RandomCrop", "CenterCrop", "CropToBbox",
    "RandomRotation", "RandomFlip", "RandomTilting", "StillTransform",
    "ColorJitter", "RandomErasing", "ToArray", "Normalize", "BBoxToPixelLabel",
]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample

    def __repr__(self):
        return "Compose(%s)" % ", ".join(repr(t) for t in self.transforms)


class Identity:
    """Does nothing."""

    def __call__(self, sample):
        return sample


def _norm_color(color):
    assert len(color) == 3
    if not all(isinstance(c, int) for c in color):
        color = tuple(int(255 * c) for c in color)
    return tuple(color)


class Pad:
    """Pad the *shortest* side up to ``size`` (centered); larger images are
    untouched (reference transforms.py:46-74). The paste offset is tracked in
    the affine (the reference drops it)."""

    def __init__(self, size, color=(127, 127, 127)):
        self.size = size
        self.color = _norm_color(color)

    def __call__(self, sample):
        img = G.grab_img(sample)
        w, h = img.size
        if w >= h:
            neww, newh = w, max(h, self.size)
        else:
            neww, newh = max(w, self.size), h
        ox, oy = (neww - w) // 2, (newh - h) // 2
        if (neww, newh) != img.size:
            if G.is_pil_image(img):
                canvas = Image.new("RGB", (neww, newh), self.color)
                canvas.paste(img, (ox, oy))
                img = canvas
            else:
                img = img.paste_into((neww, newh))
        return G.update_sample(sample, img, aff=(1, 0, ox, 0, 1, oy))


class PadSquare:
    """Pad (or crop) to ``size`` x ``size``; size=None pads to the largest
    dimension (reference transforms.py:76-105)."""

    def __init__(self, size=None, color=(127, 127, 127)):
        self.size = size
        self.color = _norm_color(color)

    def __call__(self, sample):
        img = G.grab_img(sample)
        w, h = img.size
        s = self.size or max(w, h)
        ox, oy = (s - w) // 2, (s - h) // 2
        if (s, s) != img.size:
            if G.is_pil_image(img):
                canvas = Image.new("RGB", (s, s), self.color)
                canvas.paste(img, (ox, oy))
                img = canvas
            else:
                img = img.paste_into((s, s))
        return G.update_sample(sample, img, aff=(1, 0, ox, 0, 1, oy))


class RandomBorder:
    """Expand with a random-width border (reference transforms.py:108-130)."""

    def __init__(self, min_size, max_size, color=(127, 127, 127)):
        assert isinstance(min_size, int) and min_size >= 0
        assert isinstance(max_size, int) and min_size <= max_size
        self.min_size = min_size
        self.max_size = max_size
        self.color = _norm_color(color)

    def __call__(self, sample):
        img = G.grab_img(sample)
        bh = _random.randint(self.min_size, self.max_size)
        bw = _random.randint(self.min_size, self.max_size)
        if G.is_pil_image(img):
            img = ImageOps.expand(img, border=(bw, bh, bw, bh), fill=self.color)
        else:
            img = img.expand((bw, bh, bw, bh))
        return G.update_sample(sample, img, aff=(1, 0, bw, 0, 1, bh))


class Scale:
    """Resize so the smallest (or largest) dimension equals ``size``.

    ``size``: int (short-side target), float (relative scale, ]0, 4]) or
    (w, h) tuple. PIL BILINEAR by default — must match the reference's
    resize semantics bit-for-bit for mAP parity (transforms.py:133-185).
    """

    def __init__(self, size, interpolation=Image.BILINEAR, largest=False,
                 can_upscale=True, can_downscale=True):
        assert isinstance(size, (int, float)) or len(size) == 2
        if isinstance(size, float):
            assert 0 < size <= 4, "bad float size, must be in ]0,4]"
        self.size = size
        self.interpolation = interpolation
        self.largest = largest
        self.can_upscale = can_upscale
        self.can_downscale = can_downscale

    def get_params(self, imsize):
        w, h = imsize
        if isinstance(self.size, int):
            def is_smaller(a, b):
                return (a >= b) if self.largest else (a <= b)
            if (is_smaller(w, h) and w == self.size) or \
               (is_smaller(h, w) and h == self.size):
                ow, oh = w, h
            elif is_smaller(w, h):
                ow = self.size
                oh = int(0.5 + self.size * h / w)
            else:
                oh = self.size
                ow = int(0.5 + self.size * w / h)
        elif isinstance(self.size, float):
            ow, oh = int(0.5 + self.size * w), int(0.5 + self.size * h)
        else:
            ow, oh = self.size
        return ow, oh

    def __call__(self, sample):
        img = G.grab_img(sample)
        w, h = img.size
        ow, oh = self.get_params(img.size)
        resized = False
        if (ow, oh) != img.size:
            a1, a2 = img.size, (ow, oh)
            if (self.can_upscale and min(a1) < min(a2)) or \
               (self.can_downscale and min(a1) > min(a2)):
                img = img.resize((ow, oh), self.interpolation)
                resized = True
        # record the affine only when pixels actually changed — the
        # reference records it unconditionally (transforms.py:180-185), so
        # a gate-skipped resize scales bboxes out of the untouched image
        aff = (ow / w, 0, 0, 0, oh / h, 0) if resized else (1, 0, 0, 0, 1, 0)
        return G.update_sample(sample, img, aff=aff)


class RandomScale(Scale):
    """Random short-side size in [min_size, max_size] with aspect-ratio
    jitter (reference transforms.py:188-243)."""

    def __init__(self, min_size, max_size, ar=1, can_upscale=False,
                 can_downscale=True, interpolation=Image.BILINEAR, largest=False):
        super().__init__(0, can_upscale=can_upscale, can_downscale=can_downscale,
                         interpolation=interpolation, largest=largest)
        assert isinstance(min_size, int) and min_size >= 1
        assert isinstance(max_size, int) and min_size <= max_size
        self.min_size = min_size
        self.max_size = max_size
        if isinstance(ar, (int, float)):
            ar = (min(1 / ar, ar), max(1 / ar, ar))
        assert 0.2 < ar[0] <= ar[1] < 5
        self.ar = ar

    def get_params(self, imsize):
        w, h = imsize
        size = max(min(int(0.5 + G.rand_log_uniform(self.min_size, self.max_size)),
                       self.max_size), self.min_size)
        ar = G.rand_log_uniform(*self.ar)
        if not self.largest:
            if w < h:
                ow = size
                oh = int(0.5 + size * h / w / ar)
                if oh < self.min_size:
                    ow, oh = int(0.5 + ow * self.min_size / oh), self.min_size
            else:
                oh = size
                ow = int(0.5 + size * w / h * ar)
                if ow < self.min_size:
                    ow, oh = self.min_size, int(0.5 + oh * self.min_size / ow)
        else:
            if w > h:
                ow = size
                oh = int(0.5 + size * h / w / ar)
            else:
                oh = size
                ow = int(0.5 + size * w / h * ar)
        return ow, oh


class RandomCrop:
    """Crop at a random location; optional zero padding first
    (reference transforms.py:246-298)."""

    def __init__(self, size, padding=0):
        self.size = (int(size), int(size)) if isinstance(size, int) else size
        self.padding = padding

    @staticmethod
    def get_params(img, output_size):
        w, h = img.size
        th, tw = output_size
        assert h >= th and w >= tw, \
            f"Image of {w}x{h} is too small for crop {tw}x{th}"
        y = np.random.randint(0, h - th) if h > th else 0
        x = np.random.randint(0, w - tw) if w > tw else 0
        return x, y, tw, th

    def __call__(self, sample):
        img = G.grab_img(sample)
        padl = padt = 0
        if self.padding > 0:
            if G.is_pil_image(img):
                img = ImageOps.expand(img, border=self.padding, fill=0)
            else:
                img = img.expand(self.padding)
            if isinstance(self.padding, int):
                padl = padt = self.padding
            else:
                padl, padt = self.padding[:2]
        i, j, tw, th = self.get_params(img, self.size)
        img = img.crop((i, j, i + tw, j + th))
        return G.update_sample(sample, img, aff=(1, 0, padl - i, 0, 1, padt - j))


class CenterCrop(RandomCrop):
    """Deterministic center crop (reference transforms.py:301-315)."""

    @staticmethod
    def get_params(img, output_size):
        w, h = img.size
        th, tw = output_size
        y = int(0.5 + (h - th) / 2.0)
        x = int(0.5 + (w - tw) / 2.0)
        return x, y, tw, th


class CropToBbox:
    """Crop around the sample's bbox with a proportional margin
    (reference transforms.py:319-356)."""

    def __init__(self, margin=0.5, min_size=0):
        self.margin = margin
        self.min_size = min_size

    def __call__(self, sample):
        img = G.grab_img(sample)
        w, h = img.size
        assert min(w, h) >= self.min_size
        x0, y0, x1, y1 = sample["bbox"]
        assert x0 < x1 and y0 < y1, "degenerate bbox"
        margin = int(0.5 + self.margin * min(x1 - x0, y1 - y0))
        i = max(0, x0 - margin)
        j = max(0, y0 - margin)
        cw = min(w, x1 + margin) - i
        ch = min(h, y1 + margin) - j
        if cw < self.min_size:
            i = max(0, i - (self.min_size - cw) // 2)
            cw = self.min_size
        if ch < self.min_size:
            j = max(0, j - (self.min_size - ch) // 2)
            ch = self.min_size
        img = img.crop((i, j, i + cw, j + ch))
        return G.update_sample(sample, img, aff=(1, 0, -i, 0, 1, -j))


class RandomRotation:
    """Rotate by a uniform random angle (reference transforms.py:360-386)."""

    def __init__(self, degrees, interpolation=Image.BILINEAR):
        self.degrees = degrees
        self.interpolation = interpolation

    def __call__(self, sample):
        img = G.grab_img(sample)
        w, h = img.size
        angle = np.random.uniform(-self.degrees, self.degrees)
        img = img.rotate(angle, resample=self.interpolation)
        w2, h2 = img.size
        aff = G.aff_translate(-w / 2, -h / 2)
        aff = G.aff_mul(aff, G.aff_rotate(-angle * np.pi / 180))
        aff = G.aff_mul(aff, G.aff_translate(w2 / 2, h2 / 2))
        return G.update_sample(sample, img, aff=aff)


class RandomFlip:
    """Horizontal flip with probability 1/2 (reference transforms.py:389-400)."""

    def __call__(self, sample):
        img = G.grab_img(sample)
        w, _h = img.size
        if np.random.rand() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            return G.update_sample(sample, img, aff=(-1, 0, w - 1, 0, 1, 0))
        return G.update_sample(sample, img, aff=(1, 0, 0, 0, 1, 0))


class RandomTilting:
    """Random perspective tilt (reference transforms.py:403-488)."""

    def __init__(self, magnitude, directions="all"):
        self.magnitude = magnitude
        self.directions = directions.lower().replace(",", " ").replace("-", " ")

    def __call__(self, sample):
        img = G.grab_img(sample)
        w, h = img.size
        x1, y1, x2, y2 = 0, 0, h, w
        original = [(y1, x1), (y2, x1), (y2, x2), (y1, x2)]
        skew = _random.randint(1, int(ceil(max(w, h) * self.magnitude)))

        if self.directions == "all":
            choices = [0, 1, 2, 3]
        else:
            names = ["left", "right", "up", "down"]
            choices = []
            for d in self.directions.split():
                if d not in names:
                    raise ValueError(f"Tilting direction {d} not recognized")
                choices.append(names.index(d))
        direction = _random.choice(choices)

        if direction == 0:
            new = [(y1, x1 - skew), (y2, x1), (y2, x2), (y1, x2 + skew)]
        elif direction == 1:
            new = [(y1, x1), (y2, x1 - skew), (y2, x2 + skew), (y1, x2)]
        elif direction == 2:
            new = [(y1 - skew, x1), (y2 + skew, x1), (y2, x2), (y1, x2)]
        else:
            new = [(y1, x1), (y2, x1), (y2 + skew, x2), (y1 - skew, x2)]

        rows = []
        for p1, p2 in zip(new, original):
            rows.append([p1[0], p1[1], 1, 0, 0, 0, -p2[0] * p1[0], -p2[0] * p1[1]])
            rows.append([0, 0, 0, p1[0], p1[1], 1, -p2[1] * p1[0], -p2[1] * p1[1]])
        A = np.asarray(rows, dtype=np.float64)
        B = np.array(original, dtype=np.float64).reshape(8)
        coeffs = np.linalg.pinv(A) @ B

        img = img.transform(img.size, Image.PERSPECTIVE, tuple(coeffs),
                            resample=Image.BICUBIC)
        inv = np.linalg.pinv(
            np.append(np.float32(coeffs), 1.0).reshape(3, 3)).ravel()[:8]
        return G.update_sample(sample, img, persp=tuple(inv))


class StillTransform:
    """Base for photometric transforms that keep geometry fixed."""

    def _transform(self, img):
        raise NotImplementedError()

    def __call__(self, sample):
        img = G.grab_img(sample)
        img = self._transform(img)
        return G.update_sample(sample, img, aff=(1, 0, 0, 0, 1, 0))


class ColorJitter(StillTransform):
    """Random brightness/contrast/saturation/hue in random order
    (reference transforms.py:509-557)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def _transform(self, img):
        if isinstance(img, G.DummyImg):
            return img
        ops = []
        if self.brightness > 0:
            f = np.random.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im, f=f: G.adjust_brightness(im, f))
        if self.contrast > 0:
            f = np.random.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im, f=f: G.adjust_contrast(im, f))
        if self.saturation > 0:
            f = np.random.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im, f=f: G.adjust_saturation(im, f))
        if self.hue > 0:
            f = np.random.uniform(-self.hue, self.hue)
            ops.append(lambda im, f=f: G.adjust_hue(im, f))
        np.random.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class RandomErasing(StillTransform):
    """Paste a random-noise rectangle over a random area
    (reference transforms.py:560-614)."""

    def __init__(self, area):
        self.area = area

    def _transform(self, img):
        if isinstance(img, G.DummyImg):
            return img
        w, h = img.size
        w_max, h_max = int(w * self.area), int(h * self.area)
        w_min, h_min = int(w * self.area / 2), int(h * self.area / 2)
        if not (w_min < w_max and h_min < h_max):
            return img
        ow = np.random.randint(w_min, w_max)
        oh = np.random.randint(h_min, h_max)
        bands = len(img.getbands())
        shape = (oh, ow) if bands == 1 else (oh, ow, bands)
        rect = Image.fromarray(np.uint8(np.random.rand(*shape) * 255))
        x = np.random.randint(0, w - ow)
        y = np.random.randint(0, h - oh)
        img = img.copy()
        img.paste(rect, (x, y))
        return img


class ToArray(StillTransform):
    """PIL -> numpy HWC: float32 in [0, 1] by default (the NHWC analog of
    torchvision ToTensor), or raw uint8 with ``dtype='uint8'`` for the
    normalize-on-device pipeline (4x fewer host->device bytes and ~100x less
    host CPU; the extractor applies (x/255 - mean)/std on device).

    NB: goes through uint8 + astype — ``np.asarray(img, dtype=float32)``
    takes PIL's per-pixel float converter and measured ~85x slower.
    """

    def __init__(self, dtype: str = "float32"):
        self.dtype = dtype

    def _transform(self, img):
        if isinstance(img, G.DummyImg):
            return img
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        if self.dtype == "uint8":
            return np.ascontiguousarray(arr)
        return arr.astype(np.float32) * np.float32(1.0 / 255.0)


class Normalize(StillTransform):
    """Channel-wise (x - mean) / std on an HWC float array (precomputed as
    one fused multiply-subtract)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self._inv_std = (1.0 / self.std).astype(np.float32)
        self._off = (self.mean / self.std).astype(np.float32)

    def _transform(self, img):
        if isinstance(img, G.DummyImg):
            return img
        return img * self._inv_std - self._off


class BBoxToPixelLabel:
    """Convert a bbox into per-pixel label maps at a downscaled resolution
    (reference transforms.py:627-699): dense class map plus either quantized
    'hough' bins or continuous 'regr' offsets for the bbox geometry."""

    def __init__(self, nclass, downsize, mode):
        self.nclass = nclass
        self.downsize = downsize
        self.mode = mode
        self.nbin = 5
        self.log_scale = 1.5
        self.ref_scale = 8.0

    def __call__(self, sample):
        assert isinstance(sample, dict)
        w, h = sample["img"].size if hasattr(sample["img"], "size") else \
            (sample["img"].shape[1], sample["img"].shape[0])
        ds = self.downsize
        assert w % ds == 0 and h % ds == 0
        x0, y0, x1, y1 = sample["bbox"]
        sample["bbox"] = np.int64(sample["bbox"])

        ll, rr = x0 / ds, (x1 - 1) / ds
        tt, bb = y0 / ds, (y1 - 1) / ds
        left = max(0, int(ll))
        right = min(w // ds, 1 + int(rr))
        top = max(0, int(tt))
        bottom = min(h // ds, 1 + int(bb))
        sample["bbox_downscaled"] = np.array((left, top, right, bottom), np.int64)

        W, H = w // ds, h // ds
        dense = np.full((H, W), self.nclass, dtype=np.int64)  # last = null class
        dense[top:bottom, left:right] = sample["label"]
        sample["pix_label"] = dense

        if self.mode == "hough":
            def topos(lo, pos, hi):
                return np.floor(self.nbin * (pos - lo) / (hi - lo))

            def tolog(size):
                size = max(size, 1e-8)
                return np.round(np.log(size / self.ref_scale)
                                / np.log(self.log_scale) + (self.nbin - 1) / 2)

            yc, xc = np.mgrid[0:H, 0:W]
            res = -np.ones((4, H, W), dtype=np.int64)
            res[0] = topos(ll, xc, rr)
            res[1] = topos(tt, yc, bb)
            res[2] = tolog(rr - ll)
            res[3] = tolog(bb - tt)
            sample["pix_bbox_hough"] = np.clip(res, 0, self.nbin - 1)
        elif self.mode == "regr":
            def topos(lo, pos, hi):
                return (pos - lo) / (hi - lo)

            def tolog(size):
                return np.log(max(size, 1) / self.ref_scale) / np.log(self.log_scale)

            yc, xc = np.float64(np.mgrid[0:H, 0:W]) + 0.5
            res = -np.ones((4, H, W), dtype=np.float32)
            res[0] = topos(ll, xc, rr)
            res[1] = topos(tt, yc, bb)
            res[2] = tolog(rr - ll)
            res[3] = tolog(bb - tt)
            sample["pix_bbox_regr"] = res
        else:
            raise NotImplementedError(self.mode)
        return sample


# --------------------------------------------------------------------------
# CLI chain parser
# --------------------------------------------------------------------------

_TRANSFORMS = {
    name: obj for name, obj in list(globals().items())
    if isinstance(obj, type) and name[0].isupper()
}
# interpolation constants usable inside chain strings
_CONSTANTS = {
    "BILINEAR": Image.BILINEAR, "BICUBIC": Image.BICUBIC,
    "NEAREST": Image.NEAREST, "LANCZOS": Image.LANCZOS,
    "ANTIALIAS": Image.LANCZOS,
}


def _build_call(node: ast.Call, variables: dict):
    if not isinstance(node.func, ast.Name) or node.func.id not in _TRANSFORMS:
        raise SyntaxError(f"unknown transform in chain: {ast.dump(node)}")

    def value(n):
        if isinstance(n, ast.Name):
            if n.id in variables:
                return variables[n.id]
            if n.id in _CONSTANTS:
                return _CONSTANTS[n.id]
            raise SyntaxError(f"unknown variable {n.id!r} in transform chain")
        if isinstance(n, (ast.Tuple, ast.List)):
            return tuple(value(e) for e in n.elts)
        return ast.literal_eval(n)

    args = [value(a) for a in node.args]
    kwargs = {kw.arg: value(kw.value) for kw in node.keywords}
    return _TRANSFORMS[node.func.id](*args, **kwargs)


def create(cmd_line: str, to_array: bool = False, **variables) -> Compose:
    """Build a transform chain from a reference-style CLI string.

    ``create("Scale(1050), RandomFlip()", to_array=True, mean=m, std=s)``
    appends ``ToArray(), Normalize(mean, std)`` when ``to_array`` and the
    chain doesn't already convert. Accepts ``ToTensor`` as an alias of
    ``ToArray`` for reference-CLI compatibility.
    """
    cmd_line = (cmd_line or "").strip()
    cmd_line = cmd_line.replace("ToTensor", "ToArray")
    if to_array:
        if not cmd_line:
            cmd_line = "ToArray(), Normalize(mean=mean, std=std)"
        elif "ToArray" not in cmd_line:
            cmd_line += ", ToArray(), Normalize(mean=mean, std=std)"

    if not cmd_line:
        return Compose([])
    try:
        tree = ast.parse(f"[{cmd_line}]", mode="eval").body
        transforms = [_build_call(el, variables) for el in tree.elts]
    except (SyntaxError, ValueError) as e:
        raise SyntaxError(
            f"Cannot interpret this transform list: {cmd_line}\nReason: {e}")
    return Compose(transforms)
