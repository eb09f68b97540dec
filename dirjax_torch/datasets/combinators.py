"""Dataset combinators: split, subsetting, concatenation, deployment, crops.

The port's own copy of ``dirjax/datasets/combinators.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Parity with reference ``dirtorch/datasets/dataset.py:122-573`` — with the
reference's dead dependencies repaired: the deploy cache uses a stdlib
thread pool instead of the missing ``nltools`` (dataset.py:386), and
:class:`CropDataset` fixes the reference's unbound-name bugs
(dataset.py:524-529).
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .base import Dataset

__all__ = [
    "split",
    "SubDataset",
    "CatDataset",
    "deploy",
    "DeployedDataset",
    "deploy_and_split",
    "CropDataset",
]


def _stable_hash(s: str) -> int:
    """Session-consistent string hash (md5), as the reference uses since
    Python's builtin hash() is salted per-process (dataset.py:145-147)."""
    return int(hashlib.md5(s.encode("ascii")).hexdigest(), 16)


def split(dataset, train_prop, val_prop=0, method="balanced"):
    """Split a labeled dataset into (train, test) or (train, val, test).

    ``balanced``: per-class proportional split, deterministically shuffled by
    key hash; guarantees >=1 training sample per class.
    ``hash``: assignment by key hash alone — stable under dataset edits but
    possibly uneven per class. (reference dataset.py:122-198)
    """
    assert 0 <= train_prop <= 1
    assert 0 <= val_prop < 1
    assert train_prop + val_prop <= 1

    train, val, test = [], [], []

    if method == "balanced":
        test_prop = 1 - train_prop - val_prop
        perclass = [[] for _ in range(dataset.nclass)]
        for i in range(len(dataset)):
            label = dataset.get_label(i, toint=True)
            perclass[label].append((_stable_hash(dataset.get_key(i)), i))
        for imgs in perclass:
            n = len(imgs)
            imgs.sort()
            idxs = [i for _, i in imgs]
            if idxs and train_prop > 0:
                train.append(idxs.pop())
            for _ in range(int(0.9999 + val_prop * n)):
                if idxs:
                    val.append(idxs.pop())
            for _ in range(int(0.9999 + test_prop * n)):
                if idxs:
                    test.append(idxs.pop())
            train += idxs
        train.sort()
        val.sort()
        test.sort()
    elif method == "hash":
        val_cut = train_prop + val_prop
        for i in range(len(dataset)):
            h = (_stable_hash(dataset.get_key(i)) % 100) / 100.0
            if h < train_prop:
                train.append(i)
            elif h < val_cut:
                val.append(i)
            else:
                test.append(i)
    else:
        raise ValueError(f"bad split method {method}")

    train, val, test = (SubDataset(dataset, s) for s in (train, val, test))
    return (train, test) if val_prop == 0 else (train, val, test)


class SubDataset(Dataset):
    """A view over a subset of another dataset's indices."""

    def __init__(self, dataset, indices):
        self.root = dataset.root
        self.img_dir = dataset.img_dir
        self.dataset = dataset
        self.indices = list(indices)
        self.nimg = len(self.indices)
        self.nclass = dataset.nclass
        self.labels = [dataset.get_label(i) for i in self.indices] if dataset.has_label() else []

    def get_key(self, i):
        return self.dataset.get_key(self.indices[i])

    def get_label(self, i, **kw):
        return self.dataset.get_label(self.indices[i], **kw)

    def original(self):
        return self.dataset.original()

    def __repr__(self):
        return (
            f"SubDataset({type(self.dataset).__name__})\n"
            f"  {len(self)}/{len(self.dataset)} images, {self.nclass} classes\n"
            f"  root: {os.path.join(self.root, self.img_dir)}..."
        )


class CatDataset(Dataset):
    """Concatenation of datasets that share the same class vocabulary.

    Keys are re-rooted below the datasets' common filesystem prefix so
    ``get_filename`` keeps working (reference dataset.py:241-311)."""

    def __init__(self, *datasets):
        assert len(datasets) >= 1
        self.datasets = datasets

        first = datasets[0]
        full_root = lambda db: osp.normpath(os.path.join(db.root or "", db.img_dir))
        self.root = full_root(first) + os.sep
        self.classes = first.classes
        self.nclass = first.nclass
        self.c_relevant_idx = {}
        self.labels = []

        offsets = [0]
        for db in datasets:
            assert db.nclass == self.nclass, "All datasets must share nclass"
            assert db.classes == self.classes, "All datasets must share classes"
            self.root = osp.commonprefix((self.root, full_root(db) + os.sep))
            assert self.root, "no common root between datasets"
            self.root = self.root[: self.root.rfind(os.sep)] + os.sep

            offset = sum(offsets)
            for label, rel in db.c_relevant_idx.items():
                self.c_relevant_idx.setdefault(label, []).extend(i + offset for i in rel)
            self.labels += list(db.labels)
            offsets.append(db.nimg)

        self.roots = [full_root(db)[len(self.root):] for db in datasets]
        self.offsets = np.cumsum(offsets)
        self.nimg = int(self.offsets[-1])

    def which(self, i):
        pos = int(np.searchsorted(self.offsets, i, side="right")) - 1
        assert i < self.nimg, f"Bad image index {i} >= {self.nimg}"
        return pos, i - int(self.offsets[pos])

    def get_key(self, i):
        b, j = self.which(i)
        return os.path.join(self.roots[b], self.datasets[b].get_key(j))

    def get_label(self, i, toint=False):
        b, j = self.which(i)
        return self.datasets[b].get_label(j, toint=toint)


def deploy(dataset, target_dir, transforms=None, redo=False, ext=None,
           threads=8, **save_kwargs):
    """Pre-transform every image of ``dataset`` into ``target_dir`` and
    return a :class:`DeployedDataset` reading from the cache.

    The cache manifest ``imsizes.json`` records original image sizes (needed
    to replay geometric transforms on labels) and is guarded with an
    exclusive flock so concurrent processes cooperate
    (reference dataset.py:316-400).
    """
    if not target_dir:
        return dataset
    from fcntl import LOCK_EX, LOCK_UN, flock

    from PIL import Image

    if transforms is not None:
        # bucket by a content-hash of the transform parameters
        def describe(trf):
            if hasattr(trf, "transforms"):  # a Compose-like chain
                return [describe(t) for t in trf.transforms]
            return {type(trf).__name__: {k: repr(v) for k, v in vars(trf).items()}}

        key = json.dumps(describe(transforms), sort_keys=True).encode()
        target_dir = os.path.join(target_dir, hashlib.md5(key).hexdigest())

    os.makedirs(target_dir, exist_ok=True)
    manifest_path = os.path.join(target_dir, "imsizes.json")
    # O_CREAT without O_TRUNC: a 'w+' open would clobber a concurrent
    # deployer's finished manifest BEFORE flock could be acquired (flock is
    # advisory and cannot protect the open itself). Not 'a+' either: O_APPEND
    # forces every write to EOF regardless of seek(0), so the rewrite below
    # would concatenate JSON documents instead of replacing the manifest.
    fd = os.open(manifest_path, os.O_RDWR | os.O_CREAT, 0o644)
    with os.fdopen(fd, "r+") as manifest:
        flock(manifest, LOCK_EX)
        manifest.seek(0)
        try:
            imsizes = {k: tuple(v) for k, v in json.load(manifest).items()}
        except (json.JSONDecodeError, ValueError):
            imsizes = {}

        def process(i):
            key = dataset.get_key(i)
            target = os.path.join(target_dir, key)
            if ext:
                target = osp.splitext(target)[0] + "." + ext
            if not redo and os.path.isfile(target) and key in imsizes:
                return 0
            img = Image.open(dataset.get_filename(i)).convert("RGB")
            imsizes[key] = img.size
            if transforms is not None:
                img = transforms(img)
            os.makedirs(osp.split(target)[0], exist_ok=True)
            img.save(target, **save_kwargs)
            return 1

        with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
            updated = sum(pool.map(process, range(len(dataset))))

        if updated:
            manifest.seek(0)
            json.dump({k: list(v) for k, v in imsizes.items()}, manifest)
            manifest.truncate()
        flock(manifest, LOCK_UN)

    return DeployedDataset(dataset, target_dir, imsizes, trfs=transforms, ext=ext)


class DeployedDataset(Dataset):
    """A dataset re-rooted onto a deploy cache, forwarding labels/GT to the
    original and replaying geometric transforms on label geometry via the
    recorded original image sizes (reference dataset.py:404-481)."""

    def __init__(self, dataset, root, imsizes=None, trfs=None, ext=None):
        self.dataset = dataset
        if not root.endswith(os.sep):
            root += os.sep
        self.root = root
        self.ext = ext
        if imsizes is None:
            with open(os.path.join(root, "imsizes.json")) as f:
                imsizes = {k: tuple(v) for k, v in json.load(f).items()}
        self.imsizes = imsizes
        self.trfs = trfs or (lambda x: x)
        assert len(self.imsizes) >= dataset.nimg

        self.nimg = dataset.nimg
        self.nclass = dataset.nclass
        self.labels = dataset.labels
        self.classes = dataset.classes
        self.c_relevant_idx = dataset.c_relevant_idx
        self.get_label = dataset.get_label
        self.get_query_groundtruth = dataset.get_query_groundtruth
        if hasattr(dataset, "eval_query_AP"):
            self.eval_query_AP = dataset.eval_query_AP
        if "query_db" + os.sep not in root:
            try:
                query_db = dataset.get_query_db()
                if query_db is not dataset:
                    self.query_db = deploy(
                        query_db, os.path.join(root, "query_db"),
                        transforms=trfs, ext=ext)
                    self.get_query_db = lambda: self.query_db
            except NotImplementedError:
                pass

    def __len__(self):
        return self.nimg

    def get_key(self, i):
        key = self.dataset.get_key(i)
        if self.ext:
            key = osp.splitext(key)[0] + "." + self.ext
        return key

    def original(self):
        return self.dataset

    def __repr__(self):
        return repr(self.dataset) + f"  deployed at {self.root}/...{self.ext or ''}"


def deploy_and_split(trainset, deploy_trf=None, deploy_dir="/dev/shm",
                     valset=None, split_val=0.0, img_ext="jpg",
                     img_quality=95, **_unused):
    """Deploy then split into train/val (reference dataset.py:485-509)."""
    traindb = deploy(trainset, deploy_dir, transforms=deploy_trf, ext=img_ext,
                     quality=img_quality)
    if valset:
        valdb = deploy(valset, deploy_dir, transforms=deploy_trf, ext=img_ext,
                       quality=img_quality)
    elif split_val > 0:
        traindb, valdb = split(traindb, train_prop=1 - split_val)
    else:
        valdb = None
    return traindb, valdb


class CropDataset(Dataset):
    """Rectified quadrilateral crops of another dataset's images.

    ``list_of_imgs_and_crops = [(img_idx, polygon), ...]`` where polygon is a
    4x2 array of corner points; each crop is homography-rectified to an
    axis-aligned rectangle (reference dataset.py:514-573, with its
    unbound-name bugs fixed)."""

    def __init__(self, dataset, list_of_imgs_and_crops):
        self.dataset = dataset
        self.root = dataset.root
        self.img_dir = dataset.img_dir
        self.imgs, self.crops = zip(*list_of_imgs_and_crops) if list_of_imgs_and_crops else ((), ())
        self.nimg = len(self.imgs)
        self.nclass = 0
        self.nquery = 0

    def get_key(self, i):
        return self.dataset.get_key(self.imgs[i])

    def get_filename(self, i, root=None):
        return self.dataset.get_filename(self.imgs[i], root=root)

    def get_image(self, i, resize=None):
        img = self.dataset.get_image(self.imgs[i])
        crops = self._rectify(img, [self.crops[i]])
        out = crops[0]
        if resize:
            out = out.resize(resize)
        return out

    @staticmethod
    def _rectify(img, polygons):
        import cv2
        from PIL import Image

        results = []
        arr = np.asarray(img)
        for poly in polygons:
            src = np.asarray(poly, dtype=np.float64).reshape(4, 2)
            # normalize corner order exactly as the reference does
            # (dataset.py:549-557): row 0 must have the larger column-1
            # value of rows {0,1}, row 2 the smaller of rows {2,3} — the
            # destination box below assumes it
            if src[0, 1] < src[1, 1]:
                src[[0, 1]] = src[[1, 0]]
            if src[2, 1] > src[3, 1]:
                src[[2, 3]] = src[[3, 2]]
            # build the axis-aligned destination box
            cy, cx = src[:, 0].mean(), src[:, 1].mean()
            w = abs(src[0, 1] - src[1, 1]) or 1.0
            h = abs(src[0, 0] - src[2, 0]) or 1.0
            dst = np.array(
                [
                    (cy - h / 2, cx + w / 2),
                    (cy - h / 2, cx - w / 2),
                    (cy + h / 2, cx - w / 2),
                    (cy + h / 2, cx + w / 2),
                ]
            )
            M, _ = cv2.findHomography(src, dst)
            warped = cv2.warpPerspective(arr, M, (arr.shape[1], arr.shape[0]))
            box = (
                int(dst[:, 0].min()), int(dst[:, 1].min()),
                int(dst[:, 0].max()), int(dst[:, 1].max()),
            )
            results.append(Image.fromarray(warped).crop(box))
        return results
