"""Build the port's CUDA sources (``dirjax_torch/csrc/*.cu``, with the headers
``csrc/*.cuh`` they include) into one shared library with ``nvcc`` at first
use, and load it with ctypes.

Each source compiles in its own ``nvcc`` process, all started together, and
one more links the objects. The library is written under
``dirjax_torch/_build/`` (listed in ``.gitignore``), named by a hash of the
sources, the headers and the flags, so an edited source or header builds
anew and an unchanged tree is reused. A missing ``nvcc`` or a failed compile raises
:class:`BuildError`; nothing here returns a stub.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, NamedTuple

__all__ = ["BuildError", "Build", "build", "find_nvcc", "library_path", "load_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class Build(NamedTuple):
    path: str            # the shared library
    command: List[str]   # the nvcc command lines, compiles then link ([] when reused)
    log: str             # nvcc's output (ptxas register/shared-memory report)
    seconds: float       # wall time of the compile (0 when reused)


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME/bin (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    search = os.pathsep.join(
        [os.environ.get("PATH", ""), os.path.join(cuda_home, "bin")])
    nvcc = shutil.which("nvcc", path=search)
    if nvcc is None:
        raise BuildError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
            "of dirjax_torch cannot be built")
    return nvcc


def library_path() -> str:
    """The library of the current ``csrc/*.cu`` and ``csrc/*.cuh`` and
    flags: its name hashes them all."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                       + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libdirjax_torch_{digest.hexdigest()[:16]}.so")


def build() -> Build:
    """Compile ``csrc/*.cu`` unless a library of the same sources and
    headers exists."""
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise BuildError(f"no CUDA sources under {CSRC_DIR}")
    lib = library_path()
    if os.path.exists(lib):
        return Build(lib, [], "", 0.0)

    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    start = time.perf_counter()
    try:
        objs = [os.path.join(work, f"{i}.o") for i in range(len(srcs))]
        logs = [os.path.join(work, f"{i}.log") for i in range(len(srcs))]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for obj, src in zip(objs, srcs)]
        procs = []
        for cmd, log in zip(cmds, logs):   # all compiles run at once
            with open(log, "w") as out:
                procs.append(subprocess.Popen(cmd, stdout=out,
                                              stderr=subprocess.STDOUT))
        codes = [p.wait() for p in procs]
        text = []
        for src, log, code in zip(srcs, logs, codes):
            with open(log) as f:
                text.append(f"== {os.path.basename(src)}\n{f.read()}")
            if code != 0:
                raise BuildError(f"nvcc failed on {src} ({code}):\n{text[-1]}")
        tmp = os.path.join(work, "lib.so")
        link = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    command = [" ".join(c) for c in cmds + [link]]
    return Build(lib, command, "\n".join(text), time.perf_counter() - start)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points' signatures."""
    lib = ctypes.CDLL(build().path)
    vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    signatures = {
        # x, x_is_bf16, mask, mask_kind, p, w, bias, pooled, counters, out,
        # batch, hw, c, d, eps, stream
        "dirjax_gem_head": [vp, i, vp, i, vp, vp, vp, vp, vp, vp, i, i, i, i, f, vp],
        # q, db, mode, nq, n, d, k, vals, idxs, stream
        "dirjax_fused_topk": [vp, vp, i, ll, ll, i, i, vp, vp, vp],
        # q, db, scales, mode, nq, n, d, blocks, out, stream
        "dirjax_finemax": [vp, vp, vp, i, ll, ll, i, ll, vp, vp],
        # q, db, bids, mode, nq, n, d, kf, out, stream
        "dirjax_gather_scores": [vp, vp, vp, i, ll, ll, i, ll, vp, vp],
        # q, db, asym, nq, n, words, blocks, out, stream
        "dirjax_bits_finemax": [vp, vp, i, ll, ll, i, ll, vp, vp],
        # q, db, bids, nq, n, words, kf, out, stream
        "dirjax_bits_gather_scores": [vp, vp, vp, ll, ll, i, ll, vp, vp],
        # luts, lut_bf16, codes, nq, n, m, ksub, block, out, stream
        "dirjax_adc_finemax": [vp, i, vp, ll, ll, i, i, ll, vp, vp],
        # luts, lut_bf16, codes, bids, nq, n, m, ksub, block, kf, out, stream
        "dirjax_adc_gather_scores": [vp, i, vp, vp, ll, ll, i, i, ll, ll, vp, vp],
        # x, x_fp32, w, wmap, scale, shift, residual, res_kind, relu, out, out_bf16,
        # batch, h, w, cin, cout, kh, kw, stride, pad, groups, ho, wo, stream
        "dirjax_conv_fused": [vp, i, vp, ctypes.c_char_p, vp, vp, vp, i, i, vp, i, i, i, i, i,
                              i, i, i, i, i, i, i, i, vp],
        # w, cin, cout, kh, kw, groups, map (128 bytes, filled)
        "dirjax_conv_weight_map": [vp, i, i, i, i, i, ctypes.c_char_p],
        # cin, cout, groups, kh, kw, stride -> the path (ops/conv.py::kernel_path)
        "dirjax_conv_path": [i, i, i, i, i, i],
        # z, batch_stride, y, branch, gamma, w, b, out, out_bf16, batch, rows, d, eps, stream
        "dirjax_residual_norm": [vp, ll, vp, i, vp, vp, vp, vp, i, i, i, i, f, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    return lib
