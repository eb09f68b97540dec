"""Generic dataset types, dirjax-style.

The port's own copy of ``dirjax/datasets/generic.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

The reference spreads ten classes over ``dirtorch/datasets/generic.py``;
dirjax carries the same externally-fixed protocols with three building
blocks:

* :class:`ImageList` — a bare sequence of image paths,
* :class:`LabeledImages` — ONE class for every labeled-list flavor
  (txt rows, json maps, cluster maps, explicit arrays, optional separate
  query list). The reference's ``ImageListLabels`` / ``ImageListLabelsQ`` /
  ``ImagesAndLabels`` / ``ImageClusters`` / ``NullCluster`` survive as thin
  parsing subclasses so CLI specs and imports keep working,
* :class:`ImageListRelevants` — the Oxford/Paris pickle ground truth
  (Radenovic ``gnd_*.pkl`` schema) with the Revisited easy/medium/hard
  protocol expressed as one mode table instead of per-method if-chains.

Protocol contracts that are fixed by the outside world (and therefore look
like the reference by necessity): the pickle schema ``{imlist, qimlist,
gnd:[{bbx, junk, ok | easy+hard}]}``, the {-1, 0, +1} ground-truth vector
with 0 = junk, and the mode -> relevant/junk mapping of the Revisited
benchmark (reference generic.py:150-224).
"""

from __future__ import annotations

import json
import os.path as osp
import pickle
from typing import Optional

import numpy as np

from ..utils import evaluation as ev
from .base import Dataset, find_and_list_classes, find_relevants

__all__ = [
    "ImageList",
    "LabeledImages",
    "LabelledDataset",
    "ImageListLabels",
    "ImageListLabelsQ",
    "ImagesAndLabels",
    "ImageListRelevants",
    "ImageListROIs",
    "ImageClusters",
    "NullCluster",
]


class ImageList(Dataset):
    """A bare list of images: one path per row of a text file, or an
    explicit list via ``imgs=``. No labels, no queries."""

    def __init__(self, img_list_path: str = "", root: str = "", imgs=None):
        self.root = root
        if imgs is None:
            with open(img_list_path) as f:
                imgs = [line.strip() for line in f]
        self.imgs = [p for p in imgs if p]
        self.nimg = len(self.imgs)
        self.nclass = 0
        self.nquery = 0

    def get_key(self, i: int) -> str:
        return self.imgs[i]


# --------------------------------------------------------------------------
# labeled lists
# --------------------------------------------------------------------------

def _read_annotations(path: str):
    """(imgs, labels) from a '.txt' of "path label" rows or a '.json'
    {path: label} map."""
    ext = osp.splitext(path)[1]
    if ext == ".txt":
        with open(path) as f:
            rows = [line.split() for line in f if line.strip()]
        return [r[0] for r in rows], [r[1] for r in rows]
    if ext == ".json":
        with open(path) as f:
            data = json.load(f)
        return list(data.keys()), list(data.values())
    raise ValueError(f"unsupported annotation format: {path}")


class LabeledImages(Dataset):
    """Images with per-image class labels, optionally with a separate
    labeled query list.

    ``cls_idx``: pass a parent's label->index map to share a class space
    (the reference's ImagesAndLabels pattern); otherwise classes are
    derived from the labels (and query labels, if any).
    """

    def __init__(self, imgs, labels, root: Optional[str] = None,
                 cls_idx: Optional[dict] = None, qimgs=None, qlabels=None):
        self.root = root
        self.imgs = list(imgs)
        self.labels = list(labels)
        self.qimgs = list(qimgs) if qimgs is not None else None
        self.qlabels = list(qlabels) if qlabels is not None else None
        if cls_idx is not None:
            self.cls_idx = dict(cls_idx)
            index_to_class = {i: c for c, i in self.cls_idx.items()}
            self.classes = [index_to_class[i] for i in sorted(index_to_class)]
        else:
            self.find_classes()
        self.nclass = len(self.cls_idx)
        self.c_relevant_idx = find_relevants(self.labels)
        self.nimg = len(self.imgs)
        self.nquery = len(self.qimgs) if self.qimgs is not None else 0

    def find_classes(self, labels=None, **forced):
        """Derive classes/cls_idx from labels (+ query labels), honoring any
        forced name->index assignments."""
        if labels is None:
            labels = self.labels + (self.qlabels or [])
        self.classes, self.cls_idx = find_and_list_classes(labels,
                                                           cls_idx=forced)
        self.nclass = len(self.classes)
        self.c_relevant_idx = find_relevants(self.labels)

    def get_key(self, i: int) -> str:
        return self.imgs[i]

    def get_label(self, i: int, toint: bool = False):
        label = self.labels[i]
        return self.cls_idx[label] if toint else label

    def get_query_db(self):
        if self.qimgs is None:
            return self  # every image queries the rest (self is junk)
        # memoized: base.Dataset.get_query_groundtruth calls this per
        # query — rebuilding the query dataset each time is O(N) python
        if getattr(self, "_query_db", None) is None:
            self._query_db = LabeledImages(self.qimgs, self.qlabels,
                                           root=self.root,
                                           cls_idx=self.cls_idx)
        return self._query_db


#: reference-compatible alias (dirtorch generic.py:33-41)
LabelledDataset = LabeledImages


class ImageListLabels(LabeledImages):
    """Labels from a '.txt' ("path label" rows) or '.json' ({path: label})
    annotation file (reference generic.py:44-77)."""

    def __init__(self, img_list_path: str, root: Optional[str] = None):
        imgs, labels = _read_annotations(img_list_path)
        super().__init__(imgs, labels, root=root)


class ImageListLabelsQ(LabeledImages):
    """Labeled database + a separate labeled query list
    (reference generic.py:80-105)."""

    def __init__(self, img_list_path: str, query_list_path: str,
                 root: Optional[str] = None):
        imgs, labels = _read_annotations(img_list_path)
        qimgs, qlabels = _read_annotations(query_list_path)
        super().__init__(imgs, labels, root=root, qimgs=qimgs,
                         qlabels=qlabels)


class ImagesAndLabels(LabeledImages):
    """Explicit (imgs, labels) arrays sharing a parent's class map
    (reference generic.py:108-121)."""

    def __init__(self, imgs, labels, cls_idx, root: Optional[str] = None):
        super().__init__(imgs, labels, root=root, cls_idx=cls_idx)


class ImageClusters(LabeledImages):
    """Images labeled by a {img_path: cluster} json map (or an equivalent
    dict); ``keep`` selects which cluster values survive (default: non-null
    str/int clusters) — reference generic.py:257-293."""

    def __init__(self, json_path, root: Optional[str] = None, keep=None):
        if isinstance(json_path, dict):
            data = json_path
        else:
            with open(json_path) as f:
                data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(f"expected a {{img: cluster}} map in {json_path}")
        keep = keep if keep is not None else (lambda c: c is not None)
        pairs = [(img, cluster) for img, cluster in data.items()
                 if isinstance(cluster, (str, int, type(None)))
                 and keep(cluster)]
        super().__init__([p[0] for p in pairs], [p[1] for p in pairs],
                         root=root)


class NullCluster(ImageClusters):
    """Only the images whose cluster label is null (reference :296-299)."""

    def __init__(self, json_path, root: Optional[str] = None):
        super().__init__(json_path, root, keep=lambda c: c is None)


# --------------------------------------------------------------------------
# Oxford/Paris pickle ground truth
# --------------------------------------------------------------------------

# Revisited-protocol mode algebra: mode -> (positive lists, lists demoted to
# junk besides the pickle's own junk). "classic" is the single-'ok'-list
# flavor of the original Oxford/Paris ground truth.
_GT_MODES = {
    "classic": (("ok",), ()),
    "easy": (("easy",), ("hard",)),
    "medium": (("easy", "hard"), ()),
    "hard": (("hard",), ("easy",)),
}


class ImageListRelevants(Dataset):
    """Oxford-style ground truth from a Radenovic ``gnd_*.pkl`` pickle.

    The pickle holds ``imlist``/``qimlist`` plus one ``gnd`` entry per query
    with the query box ``bbx``, a ``junk`` list, and either an ``ok`` list
    (classic protocol) or ``easy``+``hard`` lists (Revisited protocol).
    Junk images' scores are removed before AP (never counted for or
    against). Exposes ``relevants`` (classic) or ``easy``/``hard``
    (Revisited) index lists, ``junk``, and per-query ROIs.
    """

    def __init__(self, gt_file: str, root: Optional[str] = None,
                 img_dir: str = "jpg", ext: str = ".jpg"):
        self.root = root
        self.img_dir = img_dir

        with open(gt_file, "rb") as f:
            gt = pickle.load(f)

        def named(entries):
            # pickle image names may or may not carry an extension
            return [n if osp.splitext(n)[1] else n + ext for n in entries]

        self.imgs = named(gt["imlist"])
        self.qimgs = named(gt["qimlist"])
        per_query = gt["gnd"]
        self.qroi = [tuple(g["bbx"]) for g in per_query]
        self.junk = [list(g["junk"]) for g in per_query]
        revisited = "easy" in per_query[0]
        self.relevants = (None if revisited
                          else [list(g["ok"]) for g in per_query])
        self.easy = ([list(g["easy"]) for g in per_query]
                     if revisited else None)
        self.hard = ([list(g["hard"]) for g in per_query]
                     if revisited else None)

        self.nimg = len(self.imgs)
        self.nquery = len(self.qimgs)

    # --- GT protocol ---------------------------------------------------
    def _gt_lists(self, q: int) -> dict:
        if self.relevants is not None:
            return {"ok": self.relevants[q], "junk": self.junk[q]}
        return {"easy": self.easy[q], "hard": self.hard[q],
                "junk": self.junk[q]}

    def get_relevants(self, q: int, mode: str = "classic"):
        pos_keys, _ = _GT_MODES[mode]
        lists = self._gt_lists(q)
        return [i for key in pos_keys for i in lists[key]]

    def get_junk(self, q: int, mode: str = "classic"):
        _, demoted = _GT_MODES[mode]
        lists = self._gt_lists(q)
        return lists["junk"] + [i for key in demoted for i in lists[key]]

    def get_query_groundtruth(self, query_idx: int, what: str = "AP",
                              mode: str = "classic"):
        """{-1, 0, +1} vector over the database: +1 relevant, 0 junk."""
        gt = np.full(self.nimg, -1, dtype=np.int8)
        gt[self.get_relevants(query_idx, mode)] = 1
        gt[self.get_junk(query_idx, mode)] = 0
        return gt

    def eval_query_AP(self, query_idx: int, scores: np.ndarray):
        """Revisited trapezoidal AP. Classic GT yields a scalar (a query
        with no positives scores 0); Revisited GT yields an
        easy/medium/hard dict."""
        if self.relevants is not None:
            gt = self.get_query_groundtruth(query_idx, "AP", "classic")
            return max(ev.ap_from_gt_scores(gt, scores), 0.0)
        return {mode: ev.ap_from_gt_scores(
                    self.get_query_groundtruth(query_idx, "AP", mode), scores)
                for mode in ("easy", "medium", "hard")}

    # --- keys / queries ------------------------------------------------
    def get_key(self, i: int) -> str:
        return self.imgs[i]

    def get_query_key(self, i: int) -> str:
        return self.qimgs[i]

    def get_query_filename(self, q: int, root: Optional[str] = None) -> str:
        return osp.join(root or self.root, self.img_dir,
                        self.get_query_key(q))

    def get_query_roi(self, q: int):
        return self.qroi[q]

    def get_query_db(self):
        return ImageListROIs(self.root, self.img_dir, self.qimgs, self.qroi)


class ImageListROIs(Dataset):
    """Images cropped to a per-image region of interest at load time — the
    query side of Oxford/Paris benchmarks (reference generic.py:227-250)."""

    def __init__(self, root, img_dir, imgs, rois):
        self.root = root
        self.img_dir = img_dir
        self.imgs = list(imgs)
        self.rois = list(rois)
        self.nimg = len(self.imgs)
        self.nclass = 0
        self.nquery = 0

    def get_key(self, i: int) -> str:
        return self.imgs[i]

    def get_roi(self, i: int):
        return self.rois[i]

    def get_image(self, img_idx: int, resize=None):
        from PIL import Image

        img = Image.open(self.get_filename(img_idx)).convert("RGB")
        img = img.crop(self.rois[img_idx])
        if resize:
            method = (Image.LANCZOS
                      if np.prod(resize) < np.prod(img.size)
                      else Image.BICUBIC)
            img = img.resize(resize, method)
        return img
