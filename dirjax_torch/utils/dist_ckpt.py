"""Sharded, asynchronous training checkpoints on ``torch.distributed.checkpoint``
(counterpart of ``dirjax/utils/orbax_ckpt.py``, whose API it keeps).

The npz files of :mod:`dirjax_torch.utils.checkpoints` are the interop
format: every array gathered to one host, the loop blocked while writing.
This module is the scale path:

- sharded writes: each rank writes only the shards it owns (a
  :class:`~torch.distributed.tensor.DTensor` leaf, such as the tensor-parallel
  FC of a mesh run, is written once per shard; a plain tensor once);
- async saves (``async_save=True``): ``torch.distributed.checkpoint.async_save``
  copies the state to host memory and writes it behind the next epoch;
  :meth:`TrainCheckpointer.wait` blocks until every save is on disk;
- shard-placing restore: a DTensor template restores only this rank's
  shards, and a plain tensor the whole array, whichever layout wrote it;
- retention: the newest ``max_to_keep`` complete steps are kept.

A step is the directory ``<directory>/<step>``: the checkpoint files of
``torch.distributed.checkpoint`` (``.metadata`` last) and ``extra.json``
(epoch, best monitor, arch...). The format is torch's. ``fit`` calls it
``ckpt_format="orbax"`` after dirjax's option, but a directory written by
dirjax's orbax (``_CHECKPOINT_METADATA``) is refused by name: reading it
would need orbax and jax.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

__all__ = ["TrainCheckpointer", "is_checkpoint_dir"]

_DONE = ".metadata"          # written last by torch.distributed.checkpoint
_EXTRA = "extra.json"
_ORBAX = "_CHECKPOINT_METADATA"


def _steps(directory: str):
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isdir(os.path.join(directory, d)))


def is_checkpoint_dir(path: str) -> bool:
    """True if ``path`` is a directory of numbered steps (ours, or dirjax's
    orbax steps, which :class:`TrainCheckpointer` refuses)."""
    return os.path.isdir(path) and bool(_steps(path))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


class TrainCheckpointer:
    """Checkpoints of ``(params, opt_state, extra)`` under ``directory``.

    ``params`` and ``opt_state`` are flat dicts of tensors (DTensor leaves
    for sharded arrays); ``extra`` is JSON. Every rank constructs the
    checkpointer and calls :meth:`save` and :meth:`restore` alike. Under
    ``torch.distributed`` it coordinates on a gloo group of its own (made
    here, a collective call), so an async write never shares a group with
    the training's collectives; without a process group it runs alone."""

    def __init__(self, directory: str, *, max_to_keep: int = 2, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._pending = None
        self._group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        self._rank0 = not dist.is_initialized() or dist.get_rank() == 0
        if self._rank0:
            os.makedirs(self.directory, exist_ok=True)

    # --- write -----------------------------------------------------------

    def save(self, step: int, params: Dict[str, torch.Tensor],
             opt_state: Optional[Dict[str, torch.Tensor]] = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Save ``{"params", "opt_state"}`` and the JSON ``extra`` as step
        ``step``. With ``async_save`` the call returns once the state is
        copied to host memory; a later save or :meth:`wait` completes it."""
        self.wait()
        path = os.path.join(self.directory, str(int(step)))
        state = {"params": dict(params)}
        if opt_state is not None:
            state["opt_state"] = dict(opt_state)
        if self._rank0:
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.makedirs(path)
            with open(os.path.join(path, _EXTRA), "w") as f:
                json.dump(dict(extra or {}), f)
        self._barrier()
        if self.async_save:
            self._pending = dcp.async_save(state, checkpoint_id=path,
                                           process_group=self._group)
        else:
            dcp.save(state, checkpoint_id=path, process_group=self._group)
            self._prune()

    def wait(self) -> None:
        """Block until every queued save is on disk, then apply retention."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
            self._prune()

    def close(self) -> None:
        self.wait()

    def _barrier(self) -> None:
        if self._group is not None:
            dist.barrier(group=self._group)

    def _prune(self) -> None:
        self._barrier()
        if self._rank0:
            for step in self.all_steps()[:-self.max_to_keep or None]:
                shutil.rmtree(os.path.join(self.directory, str(step)))
        self._barrier()

    # --- read ------------------------------------------------------------

    def all_steps(self):
        """The complete steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        steps = _steps(self.directory)
        for s in steps:
            if os.path.exists(os.path.join(self.directory, str(s), _ORBAX)):
                raise ValueError(f"{self.directory} holds orbax checkpoints written by "
                                 "dirjax; dirjax_torch reads only its own "
                                 "torch.distributed.checkpoint steps (resume from "
                                 "dirjax's checkpoint.npz instead)")
        return [s for s in steps
                if os.path.exists(os.path.join(self.directory, str(s), _DONE))]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step(self, step: Optional[int]) -> str:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint steps under {self.directory}")
        return os.path.join(self.directory, str(int(step)))

    def read_extra(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Only the JSON ``extra`` of ``step`` (default: the latest)."""
        with open(os.path.join(self._step(step), _EXTRA)) as f:
            return json.load(f)

    def saved_shapes(self, step: Optional[int] = None) -> Dict[str, Tuple[torch.Size, torch.dtype]]:
        """``{"params.<key>" / "opt_state.<key>": (global shape, dtype)}`` of
        every tensor in ``step``: what a template must hold."""
        md = dcp.FileSystemReader(self._step(step)).read_metadata()
        return {k: (v.size, v.properties.dtype) for k, v in md.state_dict_metadata.items()
                if hasattr(v, "size")}

    def restore(self, params_template: Dict[str, torch.Tensor],
                opt_state_template: Optional[Dict[str, torch.Tensor]] = None,
                step: Optional[int] = None):
        """``(params, opt_state, extra)`` of ``step`` (default: the latest),
        in new tensors shaped as the templates: a DTensor leaf receives this
        rank's shards only."""
        path = self._step(step)
        state = {"params": _clone(params_template)}
        if opt_state_template is not None:
            state["opt_state"] = _clone(opt_state_template)
        dcp.load(state, checkpoint_id=path, process_group=self._group)
        return state["params"], state.get("opt_state"), self.read_extra(step)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
