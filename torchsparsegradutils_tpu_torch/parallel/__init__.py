"""Sharded sparse ops and the flagship training step on
``torch.distributed``.

Port of ``torchsparsegradutils_tpu/parallel/``.  A JAX ``shard_map`` over
a mesh axis is one rank per shard of a process group: each entry point
takes ``group`` (the default group when None) in place of ``(mesh,
axis)``, raises ``ValueError`` when its layout's shard count is not the
group's size, and returns this rank's row slab of a row-sharded output.
Inputs that every rank holds (values, a replicated B, the training
parameters) get gradients summed over the group: the same on every rank,
and the gradient of the whole computation.  Tensors stay where they are
given: CUDA tensors under NCCL, CPU tensors under gloo.

* :mod:`.sharding`: row-sharded SpMM, B replicated (``shard_rows``,
  ``sharded_sparse_mm``, ``local_shard_spmm``);
* :mod:`.chunk_sharded`: the same with each slab on the chunk kernel K13
  (``build_sharded_chunk_plan``, ``sharded_chunk_spmm``);
* :mod:`.dia_sharded`: stencil operators with B row-sharded too and a
  halo exchange (``sharded_dia_spmm``; ``matvec_closures``, whose
  closures carry the group the Krylov solvers sum their reductions
  over);
* :mod:`.training`: the dp × tp SGD step of the sparse-precision
  Gaussian (``make_model``, ``init_params``, ``loss_fn``,
  ``make_train_step``).

Each op's per-rank body (``chunk_sharded.slab_spmm``,
``sharding.shard_spmm``, ``dia_sharded.ShardedDia.slab_spmm``, a train
step's ``local_loss``) is a function of tensors with no collectives, so
the bodies of every rank of a layout can run in one process.
"""

from .chunk_sharded import (ShardedChunkPlan, build_sharded_chunk_plan,
                            sharded_chunk_spmm)
from .dia_sharded import matvec_closures, sharded_dia_spmm
from .sharding import (RowShardedMatrix, local_shard_spmm, shard_rows,
                       sharded_sparse_mm)
from .training import init_params, loss_fn, make_model, make_train_step

__all__ = [
    "RowShardedMatrix",
    "local_shard_spmm",
    "shard_rows",
    "sharded_sparse_mm",
    "init_params",
    "loss_fn",
    "make_model",
    "make_train_step",
    "ShardedChunkPlan",
    "build_sharded_chunk_plan",
    "sharded_chunk_spmm",
    "sharded_dia_spmm",
    "matvec_closures",
]
