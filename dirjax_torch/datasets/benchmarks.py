"""Concrete benchmark datasets.

The port's own copy of ``dirjax/datasets/benchmarks.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Parity with reference ``dirtorch/datasets/{oxford,paris,landmarks,landmarks18}.py``:
Oxford5K/ROxford5K, Paris6K/RParis6K (pickle GT under $DB_ROOT), the
Landmarks-clean training sets, and the 13 Landmarks18 list variants.
``$DB_ROOT`` is resolved lazily at construction time.
"""

from __future__ import annotations

import os

from .generic import ImageList, ImageListLabels, ImageListRelevants
from .registry import db_root, register

__all__ = [
    "Oxford5K", "ROxford5K", "Paris6K", "RParis6K",
    "Landmarks_clean", "Landmarks_clean_val", "Landmarks_lite",
]


@register
class Oxford5K(ImageListRelevants):
    def __init__(self):
        root = os.path.join(db_root(), "oxford5k")
        super().__init__(os.path.join(root, "gnd_oxford5k.pkl"), root=root)


@register
class ROxford5K(ImageListRelevants):
    def __init__(self):
        root = os.path.join(db_root(), "oxford5k")
        super().__init__(os.path.join(root, "gnd_roxford5k.pkl"), root=root)


@register
class Paris6K(ImageListRelevants):
    def __init__(self):
        root = os.path.join(db_root(), "paris6k")
        super().__init__(os.path.join(root, "gnd_paris6k.pkl"), root=root)


@register
class RParis6K(ImageListRelevants):
    def __init__(self):
        root = os.path.join(db_root(), "paris6k")
        super().__init__(os.path.join(root, "gnd_rparis6k.pkl"), root=root)


def _landmarks(list_name):
    return (
        os.path.join(db_root(), "landmarks/annotations", list_name),
        os.path.join(db_root(), "landmarks/"),
    )


@register
class Landmarks_clean(ImageListLabels):
    def __init__(self):
        super().__init__(*_landmarks("annotation_clean_train.txt"))


@register
class Landmarks_clean_val(ImageListLabels):
    def __init__(self):
        super().__init__(*_landmarks("annotation_clean_val.txt"))


@register
class Landmarks_lite(ImageListLabels):
    def __init__(self):
        super().__init__(*_landmarks("extra_landmark_images.txt"))


def _lm18(list_name):
    return (
        os.path.join(db_root(), "landmarks18/lists", list_name),
        os.path.join(db_root(), "landmarks18/"),
    )


def _make_lm18(name, list_name, base):
    cls = type(name, (base,), {
        "__init__": lambda self, _l=list_name: base.__init__(self, *_lm18(_l))
    })
    register(cls)
    globals()[name] = cls
    __all__.append(name)
    return cls


# Labeled training variants (reference landmarks18.py:7-40)
for _name, _list in [
    ("Landmarks18_train", "train.txt"),
    ("Landmarks18", "train_all.txt"),
    ("Landmarks18_lite", "train_lite.txt"),
    ("Landmarks18_mid", "train_mid.txt"),
    ("Landmarks18_5K", "train_5K.txt"),
    ("Landmarks18_val", "val.txt"),
    ("Landmarks18_valdstr", "val_distractors.txt"),
]:
    _make_lm18(_name, _list, ImageListLabels)

# Unlabeled index/test lists (reference landmarks18.py:42-64)
for _name, _list in [
    ("Landmarks18_index", "index.txt"),
    ("Landmarks18_new_index", "index_new.txt"),
    ("Landmarks18_test", "test.txt"),
    ("Landmarks18_pca", "train_pca.txt"),
    ("Landmarks18_missing_index", "missing_index.txt"),
]:
    _make_lm18(_name, _list, ImageList)
