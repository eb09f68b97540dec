"""Benchmark dataset downloader.

The port's own copy of ``dirjax/datasets/downloader.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Fetches the Oxford/Paris image archives and the Revisited ground-truth
pickles into $DB_ROOT (reference ``dirtorch/datasets/downloader.py:6-52``),
using subprocess instead of shell string interpolation. ``file://`` URLs
are served by plain copy so the flatten/ground-truth logic is testable
without network access.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tarfile
from typing import Optional

from .registry import db_root

#: dataset -> (archive base URL, archive names, target directory name)
SOURCES = {
    "oxford5k": ("http://www.robots.ox.ac.uk/~vgg/data/oxbuildings",
                 ["oxbuild_images.tgz"], "oxford5k"),
    "roxford5k": ("http://www.robots.ox.ac.uk/~vgg/data/oxbuildings",
                  ["oxbuild_images.tgz"], "oxford5k"),
    "paris6k": ("http://www.robots.ox.ac.uk/~vgg/data/parisbuildings",
                ["paris_1.tgz", "paris_2.tgz"], "paris6k"),
    "rparis6k": ("http://www.robots.ox.ac.uk/~vgg/data/parisbuildings",
                 ["paris_1.tgz", "paris_2.tgz"], "paris6k"),
}

GND_BASE = "http://cmp.felk.cvut.cz/cnnimageretrieval/data/test"


def _fetch(url: str, dst: str) -> None:
    if url.startswith("file://"):
        shutil.copyfile(url[len("file://"):], dst)
    else:
        subprocess.run(["wget", "-q", url, "-O", dst], check=True)


def download_dataset(dataset: str, *, sources: Optional[dict] = None,
                     gnd_base: Optional[str] = None) -> None:
    """Download images + GT for a known benchmark; no-op for others or when
    already present. ``sources``/``gnd_base`` override the default URL
    table (tests point them at ``file://`` fixtures)."""
    dataset = dataset.lower()
    table = sources if sources is not None else SOURCES
    if dataset not in table:
        return

    root = db_root()
    os.makedirs(root, exist_ok=True)
    src_dir, archives, dir_name = table[dataset]

    jpg_dir = os.path.join(root, dir_name, "jpg")
    if not os.path.isdir(jpg_dir):
        print(f">> Dataset {dataset} directory missing; creating {jpg_dir}")
        os.makedirs(jpg_dir, exist_ok=True)
        for archive in archives:
            dst_file = os.path.join(jpg_dir, archive)
            print(f">> Downloading {archive}...")
            _fetch(f"{src_dir}/{archive}", dst_file)
            print(f">> Extracting {archive}...")
            tmp = os.path.join(jpg_dir, "tmp")
            os.makedirs(tmp, exist_ok=True)
            with tarfile.open(dst_file, "r:gz") as tar:
                try:
                    # path-traversal-safe extraction (py>=3.12, backported
                    # to 3.11.4/3.10.12); older patch releases lack the kw
                    tar.extractall(tmp, filter="data")
                except TypeError:
                    tar.extractall(tmp)  # noqa: S202 - trusted archives
            # flatten: images may sit inside subfolders
            for cur, _dirs, files in os.walk(tmp):
                for f in files:
                    shutil.move(os.path.join(cur, f), os.path.join(jpg_dir, f))
            shutil.rmtree(tmp)
            os.remove(dst_file)

    gnd_file = os.path.join(root, dir_name, f"gnd_{dataset}.pkl")
    if not os.path.exists(gnd_file):
        print(f">> Downloading {dataset} ground truth...")
        _fetch(f"{(gnd_base if gnd_base is not None else GND_BASE)}"
               f"/{dataset}/gnd_{dataset}.pkl", gnd_file)
