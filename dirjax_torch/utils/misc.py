"""Small filesystem/numeric helpers (the port's copy of
``dirjax/utils/misc.py``, which it mirrors; reference ``utils/convenient.py``
and ``utils/funcs.py`` parity; the reference's broken ProcessPool/ThreadPool,
convenient.py:57-65, is deliberately not replicated — use
concurrent.futures)."""

from __future__ import annotations

import os

import numpy as np

__all__ = ["mkdir", "touch", "assert_outpath", "sigmoid", "sigmoid_range"]


def mkdir(path: str, isfile: bool = False) -> None:
    """Create directories for ``path`` (the containing dir when isfile)."""
    directory = os.path.dirname(path) if isfile else path
    if directory:
        os.makedirs(directory, exist_ok=True)


def touch(path: str) -> None:
    mkdir(path, isfile=True)
    with open(path, "a"):
        os.utime(path, None)


def assert_outpath(path: str, ext: str | None = None) -> None:
    """Validate an output path before a long run (reference
    convenient.py:26-54 semantics): directory must exist or be creatable,
    extension must match."""
    if ext is not None:
        assert path.endswith(ext), f"output path {path!r} should end in {ext}"
    mkdir(path, isfile=True)
    assert not os.path.isdir(path), f"output path {path!r} is a directory"


def sigmoid(x, a: float = 1.0, b: float = 0.0):
    """1 / (1 + exp(a*(b-x))) (reference funcs.py:7-8 convention: centered
    at b with slope a)."""
    return 1.0 / (1.0 + np.exp(a * (b - np.asarray(x, dtype=np.float64))))


def sigmoid_range(x, at5: float, at95: float):
    """Sigmoid with sigmoid(at5)=0.05 and sigmoid(at95)=0.95
    (reference funcs.py:11-19)."""
    a = 6.0 / (at95 - at5)
    b = at5 + 3.0 / a
    return sigmoid(x, a, b)
