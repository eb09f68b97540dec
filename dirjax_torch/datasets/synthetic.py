"""Synthetic fixture datasets for tests and CPU-only end-to-end runs.

The port's own copy of ``dirjax/datasets/synthetic.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Generates a tiny on-disk benchmark in the exact Oxford-style pickle format
consumed by :class:`dirjax.datasets.generic.ImageListRelevants` — colored
geometric shapes where images of the same "landmark" share a shape+hue, so a
real descriptor model produces meaningful rankings. Supports both classic
('ok') and Revisited ('easy'/'hard') ground-truth flavors.

No counterpart exists in the reference (it has no tests, SURVEY.md §4); the
pickle schema mirrors ``dirtorch/datasets/generic.py:130-148``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .generic import ImageListRelevants, LabeledImages
from .registry import register


def _draw_instance(rng, cls: int, size=(64, 48), jitter=8, hue_period=1):
    """A small RGB image whose appearance is determined by cls, with
    instance-level jitter. ``hue_period`` > 1 makes runs of that many
    consecutive classes share a background hue so they differ only by
    shape — a harder fixture where raw color statistics can't separate
    classes (used by training-improves-retrieval tests)."""
    from PIL import Image, ImageDraw

    w, h = size
    base_hue = ((cls // hue_period) * 57) % 255
    bg = (int(base_hue), int(255 - base_hue), 128)
    img = Image.new("RGB", (w, h), bg)
    draw = ImageDraw.Draw(img)
    cx = w // 2 + int(rng.integers(-jitter, jitter + 1))
    cy = h // 2 + int(rng.integers(-jitter, jitter + 1))
    r = min(w, h) // 4 + int(rng.integers(-2, 3))
    fg = (255 - bg[0], 255 - bg[1], 255 - bg[2])
    shape = cls % 3
    if shape == 0:
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=fg)
    elif shape == 1:
        draw.rectangle([cx - r, cy - r, cx + r, cy + r], fill=fg)
    else:
        draw.polygon([(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)], fill=fg)
    noise = rng.integers(0, 20, size=(h, w, 3), dtype=np.uint8)
    arr = np.clip(np.asarray(img).astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def make_synthetic_benchmark(
    out_dir: str,
    n_classes: int = 3,
    per_class: int = 4,
    n_junk: int = 2,
    revisited: bool = True,
    image_size=(64, 48),
    seed: int = 0,
    hue_period: int = 1,
) -> str:
    """Write images + a gnd_synthetic.pkl into ``out_dir``; returns the
    pickle path. Query q for class c is a held-out instance of that class.

    ``image_size`` may be a LIST of (w, h) tuples: each image draws its
    size at random — the mixed-size regime of the real benchmarks
    (Oxford/Paris images span ~768-1024 px), where group batching falls
    back to many small same-shape groups and bucket batching pads onto
    shared canvases (the bucket-vs-group mAP drift study needs this)."""
    rng = np.random.default_rng(seed)
    jpg_dir = os.path.join(out_dir, "jpg")
    os.makedirs(jpg_dir, exist_ok=True)
    sizes = image_size if isinstance(image_size, list) else [image_size]

    def pick_size():
        return sizes[int(rng.integers(0, len(sizes)))]

    imlist, labels = [], []
    for cls in range(n_classes):
        for k in range(per_class):
            name = f"img_c{cls}_{k}"
            _draw_instance(rng, cls, pick_size(), hue_period=hue_period
                           ).save(os.path.join(jpg_dir, name + ".jpg"))
            imlist.append(name)
            labels.append(cls)
    # distractor/junk images: pure noise
    from PIL import Image

    junk_global = []
    for j in range(n_junk):
        name = f"junk_{j}"
        jw, jh = pick_size()
        arr = rng.integers(0, 255, size=(jh, jw, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(jpg_dir, name + ".jpg"))
        imlist.append(name)
        labels.append(-1)
        junk_global.append(len(imlist) - 1)

    qimlist, gnd = [], []
    labels_arr = np.asarray(labels)
    for cls in range(n_classes):
        qname = f"query_c{cls}"
        w, h = pick_size()
        _draw_instance(rng, cls, (w, h), hue_period=hue_period).save(
            os.path.join(jpg_dir, qname + ".jpg"))
        qimlist.append(qname)
        members = np.where(labels_arr == cls)[0].tolist()
        entry = {"bbx": (2, 2, w - 2, h - 2), "junk": list(junk_global)}
        if revisited:
            entry["easy"] = members[: max(1, len(members) // 2)]
            entry["hard"] = members[max(1, len(members) // 2):]
        else:
            entry["ok"] = members
        gnd.append(entry)

    gt_path = os.path.join(out_dir, "gnd_synthetic.pkl")
    with open(gt_path, "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd}, f)
    return gt_path


@register
class Synthetic(ImageListRelevants):
    """Synthetic Oxford-style benchmark materialized on first use.

    ``Synthetic('/tmp/dir')`` builds (or reuses) the fixture in that
    directory; with no argument it uses $DIRJAX_SYNTHETIC_ROOT or a
    deterministic temp path.
    """

    def __init__(self, root: str | None = None, revisited: bool = True, **kw):
        import tempfile

        root = root or os.environ.get(
            "DIRJAX_SYNTHETIC_ROOT",
            os.path.join(tempfile.gettempdir(), "dirjax_synthetic"),
        )
        flavor = "revisited" if revisited else "classic"
        root = os.path.join(root, flavor)
        gt_path = os.path.join(root, "gnd_synthetic.pkl")
        if not os.path.exists(gt_path):
            make_synthetic_benchmark(root, revisited=revisited, **kw)
        super().__init__(gt_path, root=root)


@register
class SyntheticLabels(LabeledImages):
    """Class-labeled training view over the synthetic benchmark's database
    images (the landmark id is encoded in the filename); the pure-noise
    distractors are excluded. The offline stand-in for Landmarks_clean in
    train -> eval end-to-end tests."""

    def __init__(self, root: str | None = None, revisited: bool = True, **kw):
        bench = Synthetic(root, revisited=revisited, **kw)
        imgs, labels = [], []
        for name in bench.imgs:
            stem = os.path.splitext(name)[0]
            if stem.startswith("img_c"):
                imgs.append(name)
                labels.append(stem.split("_")[1])  # 'c<cls>'
        super().__init__(imgs, labels, root=bench.root)
        self.img_dir = bench.img_dir
