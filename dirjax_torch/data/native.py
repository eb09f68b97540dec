"""ctypes bindings for the native decode/resize pipeline (``_native/native.cpp``).

The port's own copy of ``dirjax/data/native.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Why native: the TPU extraction path sustains >400 img/s (bench.py) but PIL
holds the GIL for nearly all of its decode+resize work, so a single Python
process cannot feed it — the reference solves this with torch DataLoader
worker *processes* (dirtorch/utils/pytorch_loader.py:67-73), paying pickling
and startup costs. Here the decode/resize is a plain C call through ctypes,
which drops the GIL for the call's duration: an ordinary thread pool scales
across cores in-process.

The module is fully optional: :func:`available` is False when the toolchain
or codec headers are missing and every caller falls back to PIL. Parity with
PIL (bit-exact decode, bit-exact BILINEAR resize) is enforced by
``tests/test_native.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "probe", "decode", "resize_bilinear", "decode_file",
           "lib_path", "build"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_native", "native.cpp")
# built beside the CUDA kernels, in the package's gitignored build directory
_LIB = os.path.join(os.path.dirname(_DIR), "_build", "libdirjax_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    return _LIB


def build(force: bool = False) -> str:
    """Compile the shared library if missing or stale. Raises on failure.

    Concurrency-safe: each builder writes a unique temp file and atomically
    renames it into place (loader worker processes may all race to build)."""
    if (not force and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    import tempfile

    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(_LIB))
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared",
               "-std=c++17", _SRC, "-o", tmp, "-ljpeg", "-lpng"]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            build()
            lib = ctypes.CDLL(_LIB)
        except Exception:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.dj_probe.argtypes = [u8p, ctypes.c_size_t, ip, ip, ip]
        lib.dj_probe.restype = ctypes.c_int
        lib.dj_decode.argtypes = [u8p, ctypes.c_size_t, u8p,
                                  ctypes.c_int, ctypes.c_int]
        lib.dj_decode.restype = ctypes.c_int
        lib.dj_resize_bilinear.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, u8p, ctypes.c_int,
                                           ctypes.c_int]
        lib.dj_resize_bilinear.restype = ctypes.c_int
        lib.dj_decode_resize.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int,
                                         ctypes.c_int, u8p, ctypes.c_int,
                                         ctypes.c_int]
        lib.dj_decode_resize.restype = ctypes.c_int
        lib.dj_last_error.argtypes = []
        lib.dj_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _err(lib) -> str:
    return lib.dj_last_error().decode("utf-8", "replace")


def _as_u8p(buf) -> "ctypes.POINTER":
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


class Unsupported(Exception):
    """Input this pipeline does not handle (CMYK JPEG, exotic format):
    callers fall back to PIL."""


def probe(data: bytes) -> Tuple[int, int]:
    """(width, height) of an encoded JPEG/PNG. Raises Unsupported otherwise."""
    lib = _load()
    if lib is None:
        raise Unsupported("native pipeline unavailable")
    w = ctypes.c_int()
    h = ctypes.c_int()
    fmt = ctypes.c_int()
    rc = lib.dj_probe(_as_u8p(data), len(data), ctypes.byref(w),
                      ctypes.byref(h), ctypes.byref(fmt))
    if rc == -2:
        raise Unsupported(_err(lib))
    if rc != 0:
        raise ValueError(f"probe failed: {_err(lib)}")
    return w.value, h.value


def decode(data: bytes, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Encoded JPEG/PNG bytes -> RGB uint8 (H, W, 3).

    ``size=(w, h)`` fuses a PIL-exact BILINEAR resize into the call
    (equivalent to ``Image.open(...).convert("RGB").resize(size, BILINEAR)``).
    Raises :class:`Unsupported` for inputs the native path doesn't handle.
    """
    lib = _load()
    if lib is None:
        raise Unsupported("native pipeline unavailable")
    w, h = probe(data)
    ow, oh = size if size is not None else (w, h)
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.dj_decode_resize(_as_u8p(data), len(data), w, h,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              ow, oh)
    if rc == -2:
        raise Unsupported(_err(lib))
    if rc != 0:
        raise ValueError(f"decode failed: {_err(lib)}")
    return out


def resize_bilinear(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL-exact ``Image.resize((w, h), Image.BILINEAR)`` on a uint8 HWC array."""
    lib = _load()
    if lib is None:
        raise Unsupported("native pipeline unavailable")
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError("resize_bilinear expects uint8")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    ih, iw, c = arr.shape
    ow, oh = size
    out = np.empty((oh, ow, c), np.uint8)
    rc = lib.dj_resize_bilinear(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ih, iw, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), oh, ow)
    if rc != 0:
        raise ValueError(f"resize failed: {_err(lib)}")
    return out


def decode_file(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), size=size)


def plan_fast_path(transform):
    """If ``transform`` is a chain this pipeline can reproduce exactly —
    ``[Scale(BILINEAR)?] + ToArray + [Normalize?]`` (the benchmark-extraction
    chains) — return ``load(filename) -> img array`` that fuses
    decode+resize natively and never builds a PIL image. Return None for any
    other chain (augmentations, non-bilinear filters, crops): the caller
    keeps the PIL path.
    """
    from PIL import Image

    from . import transforms as T

    if isinstance(transform, T.Compose):
        ts = list(transform.transforms)
    elif transform is None:
        ts = []
    else:
        ts = [transform]
    ts = [t for t in ts if not isinstance(t, T.Identity)]
    scale = None
    i = 0
    # exact-type checks: subclasses (RandomScale, ...) change semantics
    if i < len(ts) and type(ts[i]) is T.Scale:
        if ts[i].interpolation != Image.BILINEAR or \
                not isinstance(ts[i].size, (int, float, tuple, list)):
            return None
        scale = ts[i]
        i += 1
    if i >= len(ts) or type(ts[i]) is not T.ToArray:
        return None
    toarr = ts[i]
    i += 1
    norm = None
    if i < len(ts) and type(ts[i]) is T.Normalize:
        norm = ts[i]
        i += 1
    if i != len(ts):
        return None
    if toarr.dtype not in ("uint8", "float32") or \
            (toarr.dtype == "uint8" and norm is not None):
        return None

    def load(filename: str) -> np.ndarray:
        with open(filename, "rb") as f:
            data = f.read()
        w, h = probe(data)
        size = None
        if scale is not None:
            ow, oh = scale.get_params((w, h))
            if (ow, oh) != (w, h) and (
                    (scale.can_upscale and min((w, h)) < min((ow, oh))) or
                    (scale.can_downscale and min((w, h)) > min((ow, oh)))):
                size = (ow, oh)
        arr = decode(data, size=size)
        if toarr.dtype == "uint8":
            return arr
        out = arr.astype(np.float32) * np.float32(1.0 / 255.0)
        if norm is not None:
            out = out * norm._inv_std - norm._off
        return out

    return load
