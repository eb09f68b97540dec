"""Multi-device paths over ``torch.distributed`` (counterpart of
``dirjax/parallel/``): the ("data", "db") mesh, batch-sharded extraction and
database-sharded ranking. The sharded train step is
:func:`dirjax_torch.train.make_sharded_train_step`, and its checkpoints are
:mod:`dirjax_torch.utils.dist_ckpt`.

Execution model:

* One process per device, as ``torchrun`` (``python -m
  torch.distributed.run``) starts them; without its environment a process
  is a world of 1 (:func:`~.mesh.init_distributed`). NCCL on the card
  (``cuda:LOCAL_RANK``), gloo on the CPU; a ``"cuda"`` mesh without NCCL
  raises, and nothing goes quietly to gloo or to the CPU.
* dirjax's ``jax.sharding.Mesh`` is a
  :class:`~torch.distributed.device_mesh.DeviceMesh` with dimensions
  ``("data", "db")``, rank-major (:func:`~.mesh.make_mesh`).
* SPMD contract: every rank of a group calls each sharded function with the
  same arguments, in the same order, and gets the same global result.
  ``shard_database(db, mesh)`` takes the full matrix on every rank and keeps
  this rank's contiguous row slice; ``sharded_topk(...)`` returns the merged
  global ``(values, ids)`` on every rank; ``ShardedExtractor(images)`` takes
  the full batch and returns every descriptor.
* Sharding is by contiguous rank slices. dirjax's ``P``, ``NamedSharding``,
  ``data_sharding`` and ``replicated`` (``dirjax/parallel/mesh.py:83-90``)
  have no counterpart: a tensor is either this rank's slice or the same on
  every rank.
"""

from .extraction import ShardedExtractor  # noqa: F401
from .mesh import (axis_rank, axis_size, init_distributed, make_mesh,  # noqa: F401
                   make_multihost_mesh, mesh_device, multihost_layout)
from .ranking import (  # noqa: F401
    gather_rows,
    gather_shards,
    shard_codes,
    shard_codes_binary,
    shard_database,
    shard_database_quantized,
    shard_ivf,
    sharded_aqe,
    sharded_hamming_topk,
    sharded_ivf_topk,
    sharded_pq_topk,
    sharded_scores,
    sharded_topk,
)
