"""The ("data", "db") device mesh over ``torch.distributed`` (counterpart of
``dirjax/parallel/mesh.py``).

* axis ``"data"``: batch-parallel extraction and data-parallel training;
* axis ``"db"``: database-sharded ranking (each rank holds a row slice and
  the candidates merge with one all-gather) and the FC projection's
  tensor-parallel split in training.

On several hosts, put "db" within a host and "data" across hosts
(:func:`make_multihost_mesh`): extraction needs no traffic between ranks,
and ranking's all-gather stays on the host's NVLink.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["init_distributed", "make_mesh", "make_multihost_mesh", "multihost_layout",
           "mesh_device", "axis_size", "axis_rank"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device_type: str) -> str:
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return _BACKENDS[device_type]


def init_distributed(device_type: str = "cuda") -> None:
    """Initialise the default process group once per process: from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``...)
    when it is there, else a world of 1 over a ``FileStore`` in a temporary
    directory. NCCL for ``"cuda"`` (the rank's device becomes
    ``cuda:LOCAL_RANK``), gloo for ``"cpu"``. An existing group must use
    that backend: a ``"cuda"`` mesh never runs on gloo, nor the reverse."""
    backend = _backend(device_type)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a 'cuda' mesh needs CUDA, which is not available "
                               "(use device_type='cpu' for gloo on the CPU)")
        if not dist.is_nccl_available():
            raise RuntimeError("a 'cuda' mesh needs NCCL, which this torch lacks")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        have = dist.get_backend()
        if backend not in str(have):
            raise RuntimeError(f"the process group runs {have}; a {device_type!r} mesh "
                               f"needs {backend}")
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    store = os.path.join(tempfile.mkdtemp(prefix="dirjax_torch_pg_"), "store")
    dist.init_process_group(backend, store=dist.FileStore(store, 1), rank=0,
                            world_size=1)


def make_mesh(data: Optional[int] = None, db: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A 2D ("data", "db") mesh over every rank of the world, rank-major
    (rank = data_index * db + db_index). ``data`` defaults to world / db; a
    factorization that does not cover the world raises AssertionError, as
    dirjax's does. Initialises the process group first
    (:func:`init_distributed`)."""
    init_distributed(device_type)
    n = dist.get_world_size()
    if data is None:
        data = n // db
    if data * db != n:   # dirjax's AssertionError, raised under -O as well
        raise AssertionError(f"{data}x{db} != {n} devices")
    return init_device_mesh(device_type, (data, db), mesh_dim_names=("data", "db"))


def multihost_layout(devices: Sequence, db_per_host: int) -> np.ndarray:
    """(hosts, db_per_host) grid with each row holding one host's devices
    (grouped by ``process_index``, ordered by ``id``). Pure layout logic,
    unit-testable with fake device objects."""
    n = len(devices)
    if n % db_per_host:
        raise AssertionError(f"{n} devices not divisible by {db_per_host}")
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    arr = np.asarray(devices, dtype=object).reshape(n // db_per_host, db_per_host)
    for row in arr:  # each mesh row must stay within one host
        if len({d.process_index for d in row}) != 1:
            raise AssertionError("db_per_host does not evenly tile the per-host device groups")
    return arr


class _Rank:
    """A rank as :func:`multihost_layout` sees a device: its host
    (``process_index``) and its global rank (``id``)."""

    def __init__(self, process_index: int, rank: int):
        self.process_index, self.id = process_index, rank


def make_multihost_mesh(db_per_host: Optional[int] = None,
                        device_type: str = "cuda") -> DeviceMesh:
    """Mesh for several hosts: "data" across hosts, "db" within a host.
    Each rank's host is ``GROUP_RANK`` (torchrun's node rank; 0 without
    it), gathered from every rank. ``db_per_host`` defaults to
    ``LOCAL_WORLD_SIZE`` (1 without torchrun). On one host this is
    ``make_mesh(data=1, db=world)``."""
    init_distributed(device_type)
    if db_per_host is None:
        db_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, int(os.environ.get("GROUP_RANK", 0)))
    arr = multihost_layout([_Rank(h, r) for r, h in enumerate(hosts)], db_per_host)
    ranks = torch.tensor([[d.id for d in row] for row in arr], dtype=torch.int64)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "db"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (the current device, which
    :func:`init_distributed` set) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis``."""
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))
