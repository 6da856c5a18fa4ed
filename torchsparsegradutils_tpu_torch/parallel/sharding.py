"""Row-block sharding of a sparse operator over a process group.

Port of ``torchsparsegradutils_tpu/parallel/sharding.py``.  Each rank
owns a contiguous slab of ``rows_per_shard`` rows (every shard padded to
one entry count with zero-valued entries at its local (0, 0)); the dense
operand is replicated; the output rows live where their matrix rows
live.  The forward needs no communication; the gradient of the
replicated B (``Aᵀ G``) and of the shard-stacked values are summed over
the group, where JAX's transpose of ``shard_map`` inserts a ``psum``.

* :class:`RowShardedMatrix`: the host-side partition, ``(n_shards,
  nnzs)`` local rows, columns, values and mask.
* :func:`local_shard_spmm`: one slab's SpMM through the package's
  ``sparse_mm``; the per-rank body, with no collectives.
* :func:`sharded_sparse_mm`: the entry point.

The JAX package builds each slab as a dynamic-pattern container from
traced index arrays; here every rank knows its slab's indices on the
host, so the slab is a static :class:`~..types.SparseCOO` in the JAX
entry order (its rows are then unsorted where the matrix's were, and
``sparse_mm`` takes the same branch as in JAX).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.spmm import sparse_mm
from ..types import SparseCOO, StaticArray, is_sparse
from ._collectives import Replicated, group_rank

__all__ = ["RowShardedMatrix", "local_shard_spmm", "shard_rows",
           "shard_spmm", "sharded_sparse_mm"]


def local_shard_spmm(local_rows, cols, data_local: torch.Tensor,
                     B: torch.Tensor, rps: int) -> torch.Tensor:
    """One row slab's SpMM, ``(rps, p)``, through ``sparse_mm``: the
    sparse gradient at the slab's entries and the slab's ``Aᵀ G``.

    Args:
      local_rows, cols: ``(nnz_local,)`` host index arrays (rows local
        to the slab, global columns), or their
        :class:`~..types.StaticArray`s, which a caller that runs the same
        slab again keeps, so the pattern is hashed and copied to the
        device once.
      data_local: ``(nnz_local,)`` values (padding entries must carry 0).
      B: dense ``(m, p)``.
      rps: rows per shard.
    """
    A_loc = SparseCOO(local_rows, cols, data_local, (rps, B.shape[0]))
    return sparse_mm(A_loc, B)


@dataclass
class RowShardedMatrix:
    """Row-block-sharded sparse matrix: shard i owns rows
    ``[i * rows_per_shard, (i + 1) * rows_per_shard)`` (zero-padded)."""

    local_rows: np.ndarray      # (S, nnzs) row index local to the shard
    cols: np.ndarray            # (S, nnzs) global column index
    data: torch.Tensor          # (S, nnzs) values (padding entries are 0)
    shape: Tuple[int, int]
    rows_per_shard: int
    n_shards: int
    mask: Optional[np.ndarray] = None   # (S, nnzs) False on padding
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    def shard_pattern(self, rank: int, device):
        """Shard ``rank``'s local rows and columns as StaticArrays and its
        mask as a tensor on ``device`` (None without a mask), made once."""
        key = (rank, torch.device(device))
        pat = self._cache.get(key)
        if pat is None:
            mask = (None if self.mask is None else
                    torch.from_numpy(self.mask[rank]).to(device))
            pat = self._cache[key] = (StaticArray(self.local_rows[rank]),
                                      StaticArray(self.cols[rank]), mask)
        return pat

    @property
    def padded_rows(self) -> int:
        return self.rows_per_shard * self.n_shards


def partition_rows(rows, cols, n: int, n_shards: int):
    """Host partition of a pattern's entries into ``n_shards`` row slabs
    of ``rps = ceil(n / n_shards)`` rows, each padded to the largest
    slab's entry count: ``(local_rows, cols, sel, mask, rps)``, the first
    four ``(n_shards, nnzs)``; ``sel`` is each slot's entry (0 on
    padding), ``mask`` False on padding, padding at local (0, 0)."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    rps = -(-n // n_shards)
    shard_of = rows // rps
    nnz_per = np.bincount(shard_of, minlength=n_shards)
    nnzs = max(int(nnz_per.max()), 1)
    local_rows = np.zeros((n_shards, nnzs), np.int32)
    g_cols = np.zeros((n_shards, nnzs), np.int32)
    sel = np.zeros((n_shards, nnzs), np.int64)
    mask = np.zeros((n_shards, nnzs), bool)
    order = np.argsort(shard_of, kind="stable")
    offs = np.zeros(n_shards + 1, np.int64)
    np.cumsum(nnz_per, out=offs[1:])
    for s in range(n_shards):
        idx = order[offs[s]:offs[s + 1]]
        k = len(idx)
        local_rows[s, :k] = rows[idx] - s * rps
        g_cols[s, :k] = cols[idx]
        sel[s, :k] = idx
        mask[s, :k] = True
    return local_rows, g_cols, sel, mask, rps


def shard_rows(A, n_shards: int) -> RowShardedMatrix:
    """Partition a 2-D sparse container into row blocks (host-side).

    Every shard is padded to the largest per-shard nnz with zero-valued
    entries at its local (0, 0), whose values take no gradient.
    """
    if not is_sparse(A) or A.ndim != 2:
        raise ValueError("shard_rows expects an unbatched 2-D sparse "
                         "container")
    n, m = A.shape
    local_rows, g_cols, sel, mask, rps = partition_rows(A.rows(), A.cols(),
                                                        n, n_shards)
    dev = A.values.device
    vals = A.values.index_select(0, torch.from_numpy(sel.reshape(-1)).to(
        dev)).view(sel.shape)
    data = torch.where(torch.from_numpy(mask).to(dev), vals, 0.0)
    return RowShardedMatrix(local_rows=local_rows, cols=g_cols, data=data,
                            shape=(n, m), rows_per_shard=rps,
                            n_shards=n_shards, mask=mask)


def shard_spmm(M: RowShardedMatrix, rank: int, data: torch.Tensor,
               B: torch.Tensor) -> torch.Tensor:
    """The per-rank body: shard ``rank``'s ``(rows_per_shard, p)`` slab
    from the ``(n_shards, nnzs)`` values ``data``, with no collectives.
    Padding entries are masked, so they carry no value and take no
    gradient."""
    rows, cols, mask = M.shard_pattern(rank, data.device)
    d = data[rank] if mask is None else torch.where(mask, data[rank], 0.0)
    return local_shard_spmm(rows, cols, d, B, M.rows_per_shard)


def sharded_sparse_mm(M: RowShardedMatrix, B: torch.Tensor, group=None,
                      out_padded: bool = False) -> torch.Tensor:
    """``A @ B`` with A row-sharded over the ranks of ``group`` (the
    default group when None; its size must be ``M.n_shards``, else
    ``ValueError``) and B replicated.

    Returns this rank's rows of the ``(n, p)`` output: rows ``[r * rps,
    min((r + 1) * rps, n))``, or the whole ``(rows_per_shard, p)`` slab
    with the padding rows if ``out_padded``.  The gradients of ``M.data``
    and ``B`` are summed over the group, so every rank gets the gradient
    of the whole product.
    """
    rank = group_rank(M.n_shards, group, "sharded_sparse_mm")
    data, B = Replicated.apply(group, M.data, B)
    out = shard_spmm(M, rank, data, B)
    if out_padded:
        return out
    rps = M.rows_per_shard
    return out[:max(0, min(rps, M.shape[0] - rank * rps))]
