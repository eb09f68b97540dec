"""Dataset base class.

The port's own copy of ``dirjax/datasets/base.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

API parity with the reference ``dirtorch/datasets/dataset.py:8-116`` —
keys/filenames/images/labels, a query sub-database, ground-truth vectors in
{-1, 0, +1} (0 = junk), per-query AP and top-k evaluation — expressed as a
plain Python class hierarchy. Image decoding stays on the host (PIL);
nothing here touches JAX.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils import evaluation as ev


class Dataset:
    """Base class for an image-retrieval dataset.

    Attributes:
        root:    image directory root
        img_dir: sub-directory under root holding images
        nimg:    number of database images (== len(self))
        nclass:  number of label classes (0 when unlabeled)
        nquery:  number of query images
    """

    root: str = ""
    img_dir: str = ""
    nimg: int = 0
    nclass: int = 0
    nquery: int = 0
    ninstance: int = 0

    classes: list = []
    labels: list = []
    #: class name -> list of database image indices of that class
    c_relevant_idx: dict = {}

    def __len__(self) -> int:
        return self.nimg

    # --- identity -----------------------------------------------------
    def get_key(self, img_idx: int) -> str:
        raise NotImplementedError()

    def get_filename(self, img_idx: int, root: Optional[str] = None) -> str:
        return os.path.join(root or self.root, self.img_dir, self.get_key(img_idx))

    def key_to_index(self, key: str) -> int:
        cache = getattr(self, "_key_to_index", None)
        if cache is None:
            cache = {self.get_key(i): i for i in range(len(self))}
            self._key_to_index = cache
        return cache[key]

    # --- pixels -------------------------------------------------------
    def get_image(self, img_idx: int, resize=None):
        from PIL import Image

        img = Image.open(self.get_filename(img_idx)).convert("RGB")
        if resize:
            # shrink with a high-quality filter, enlarge with bicubic
            # (reference dataset.py:50-55)
            method = (
                Image.LANCZOS
                if np.prod(resize) < np.prod(img.size)
                else Image.BICUBIC
            )
            img = img.resize(resize, method)
        return img

    # --- labels -------------------------------------------------------
    def get_label(self, img_idx: int, toint: bool = False):
        raise NotImplementedError()

    def has_label(self) -> bool:
        try:
            self.get_label(0)
            return True
        except NotImplementedError:
            return False

    # --- queries & evaluation ----------------------------------------
    def get_query_db(self) -> "Dataset":
        raise NotImplementedError()

    def get_query_groundtruth(self, query_idx: int, what: str = "AP"):
        """Default GT for class-labeled datasets: positives are all DB images
        sharing the query's class; the query itself is junk when the query db
        is the dataset itself (reference dataset.py:70-81)."""
        query_db = self.get_query_db()
        assert self.nclass == query_db.nclass
        if what == "AP":
            gt = -np.ones(self.nimg, dtype=np.int8)
            # .get: a query class with no DB images yields an all-negative
            # GT (AP=-1, excluded from the mean) instead of a KeyError —
            # the reference's defaultdict(list) behavior
            gt[self.c_relevant_idx.get(query_db.get_label(query_idx), [])] = 1
            if query_db is self:
                gt[query_idx] = 0
            return gt
        if what == "label":
            return query_db.get_label(query_idx)
        raise ValueError(f"Unknown ground-truth type: {what}")

    def eval_query_AP(self, query_idx: int, scores: np.ndarray):
        """Classic (sklearn-convention) AP for one query; -1 when the query
        has no positives (reference dataset.py:83-92)."""
        gt = self.get_query_groundtruth(query_idx, "AP")
        assert gt.shape == scores.shape, f"scores should have shape {gt.shape}"
        keep = gt != 0
        if (gt[keep] > 0).sum() == 0:
            return -1.0
        return ev.average_precision_classic(gt[keep] > 0, scores[keep])

    def eval_query_top(self, query_idx: int, scores: np.ndarray,
                       k=(1, 5, 10, 20, 50, 100)) -> dict:
        """Top-k hit rate for one query (reference dataset.py:94-101)."""
        if not self.labels:
            raise NotImplementedError()
        q_label = self.get_query_groundtruth(query_idx, "label")
        correct = np.asarray([label == q_label for label in self.labels], dtype=bool)
        correct = correct[(-np.asarray(scores)).argsort()]
        return {kk: float(correct[:kk].any()) for kk in k if kk < len(correct)}

    # --- misc ---------------------------------------------------------
    def original(self) -> "Dataset":
        """Overloaded by derived/combinator datasets."""
        return self

    def __repr__(self) -> str:
        res = f"Dataset: {type(self).__name__}\n  {len(self)} images"
        if self.nclass:
            res += f", {self.nclass} classes"
        if self.ninstance:
            res += f", {self.ninstance} instances"
        try:
            res += f", {self.get_query_db().nimg} queries"
        except NotImplementedError:
            pass
        res += f"\n  root: {self.root}..."
        return res


def find_and_list_classes(labels, cls_idx: Optional[dict] = None):
    """Deduce class list + name->index map from per-image labels, honoring
    any forced indices in ``cls_idx`` (reference generic_func.py:8-43)."""
    assert not isinstance(labels, set), "labels must be ordered"
    cls_idx = dict(cls_idx) if cls_idx else {}

    uniq = set(labels)
    for forced in cls_idx:
        uniq.add(forced)
    n = len(uniq)

    index_to_class = {idx: cls for cls, idx in cls_idx.items()}
    free = sorted(set(range(n)) - set(cls_idx.values()), reverse=True)
    for cls in labels:
        if cls in cls_idx:
            continue
        idx = free.pop()
        cls_idx[cls] = idx
        index_to_class[idx] = cls

    assert min(index_to_class) == 0 and len(index_to_class) == max(index_to_class) + 1
    classes = [index_to_class[i] for i in range(len(index_to_class))]
    return classes, cls_idx


def find_relevants(labels) -> dict:
    """class name -> list of image indices with that label
    (reference generic_func.py:46-60)."""
    assert not isinstance(labels, set), "labels must be ordered"
    rel: dict = {}
    for i, label in enumerate(labels):
        rel.setdefault(label, []).append(i)
    return rel
