"""Row-sharded SpMM with each shard's product on the chunk kernel (K13).

Port of ``torchsparsegradutils_tpu/parallel/chunk_sharded.py``.  Each
rank of a process group owns a contiguous slab of ``rows_per_shard =
ceil(n / S)`` rows of A (the last slab padded past n), B is replicated,
and the forward needs no communication: every rank computes its own
``(rows_per_shard, p)`` output slab.

The JAX package pads per-shard chunk tables (ranks, gather indices,
segment rows) to common shapes so that one ``shard_map`` program can run
on every device.  A rank here runs its own program, and the rows are
sorted, so a slab's entries are one contiguous range of the CSR arrays:
:func:`~..kernels.chunk_spmm.chunk_spmm_slab` (K13) reads the global
``indptr``, ``cols`` and values in place, and the plan keeps only the
shards' entry bounds.

Two parts, as for every sharded op of this package:

* :func:`slab_spmm`, the per-rank body: a differentiable function of
  tensors with no collectives (K13 forward; K7 for gradA at the slab's
  entries and K6 over the slab's transpose plan, on values reordered by
  K3, for the slab's ``Aᵀ G``);
* :func:`sharded_chunk_spmm`, the entry point, which sums the
  gradients of the replicated ``data`` and ``B`` over the group (JAX's
  ``psum``).  The slabs' entries are disjoint, so the data gradient's sum
  adds each entry's one term to zeros.

Example (two ranks of a gloo group, one process each)::

    plan = build_sharded_chunk_plan(A, 2)          # A: row-sorted SparseCSR
    out = sharded_chunk_spmm(plan, A.values, B)    # this rank's (rps, p)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.chunk_spmm import (ChunkPlan, ChunkSddmm, ChunkSpmm, _indptr,
                                  chunk_spmm_slab)
from ..types import is_sparse
from ._collectives import Replicated, group_rank

__all__ = ["ShardedChunkPlan", "build_sharded_chunk_plan",
           "sharded_chunk_spmm", "slab_spmm"]


@dataclass(eq=False)
class ShardedChunkPlan:
    """Row pointers and columns of a row-sorted pattern, and the entry
    range ``[bounds[s], bounds[s + 1])`` of each shard's row slab.

    ``entry_sel(s)``, ``gather_idx(s)`` and ``entry_rows(s)`` give the
    unpadded per-shard tables of the JAX plan: the slab's entries, their
    B rows and their local rows.
    """
    n: int
    m: int
    n_shards: int
    rows_per_shard: int
    nnz: int
    indptr: np.ndarray      # (n + 1,) int64
    cols: np.ndarray        # (nnz,) int64
    bounds: np.ndarray      # (n_shards + 1,) int64
    _slabs: dict = field(default_factory=dict, repr=False)
    _dev: dict = field(default_factory=dict, repr=False)

    def _range(self, s: int):
        return int(self.bounds[s]), int(self.bounds[s + 1])

    def entry_sel(self, s: int) -> np.ndarray:
        lo, hi = self._range(s)
        return np.arange(lo, hi, dtype=np.int64)

    def gather_idx(self, s: int) -> np.ndarray:
        lo, hi = self._range(s)
        return self.cols[lo:hi]

    def entry_rows(self, s: int) -> np.ndarray:
        lo, hi = self._range(s)
        rows = np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.indptr))
        return rows[lo:hi] - s * self.rows_per_shard

    def slab_plan(self, s: int) -> ChunkPlan:
        """The chunk plan of shard ``s``'s slab: ``rows_per_shard`` rows,
        its entries' local row pointers and columns (cached)."""
        plan = self._slabs.get(s)
        if plan is None:
            lo, hi = self._range(s)
            rps = self.rows_per_shard
            r0, r1 = min(s * rps, self.n), min((s + 1) * rps, self.n)
            ip = self.indptr[r0:r1 + 1] - lo
            ip = np.concatenate([ip, np.full(rps + 1 - len(ip), hi - lo)])
            plan = self._slabs[s] = ChunkPlan(rps, self.m, ip,
                                              self.cols[lo:hi])
        return plan

    def maps(self, device) -> dict:
        """``indptr`` and ``cols`` as int64 tensors on ``device``
        (cached)."""
        device = torch.device(device)
        d = self._dev.get(device)
        if d is None:
            d = self._dev[device] = {
                k: torch.from_numpy(getattr(self, k)).to(device)
                for k in ("indptr", "cols")}
        return d


def build_sharded_chunk_plan(A, n_shards: int) -> ShardedChunkPlan:
    """Host-side partition of a 2-D row-sorted container into
    ``n_shards`` contiguous row slabs of ``ceil(n / n_shards)`` rows."""
    if not is_sparse(A) or A.ndim != 2:
        raise ValueError("expected an unbatched 2-D sparse container")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    rows = A.rows().astype(np.int64)
    cols = A.cols().astype(np.int64)
    if len(rows) and not (np.diff(rows) >= 0).all():
        raise ValueError("entries must be sorted by row (CSR order)")
    n, m = A.shape
    rps = -(-n // n_shards)
    # shard boundaries in the entry stream (contiguous: rows sorted)
    bounds = np.searchsorted(rows, np.arange(n_shards + 1) * rps)
    return ShardedChunkPlan(n=n, m=m, n_shards=n_shards, rows_per_shard=rps,
                            nnz=len(rows), indptr=_indptr(rows, n),
                            cols=cols, bounds=bounds.astype(np.int64))


class _SlabChunkSpmm(torch.autograd.Function):
    """Shard ``rank``'s slab of ``A @ B``: K13 forward; backward gradA at
    the slab's entries (K7, zero elsewhere) and the slab's ``Aᵀ G`` (K6
    over its transpose plan)."""

    @staticmethod
    def forward(ctx, plan, rank, data, B):
        ctx.plan, ctx.rank = plan, rank
        ctx.save_for_backward(data, B)
        d = plan.maps(B.device)
        rps = plan.rows_per_shard
        return chunk_spmm_slab(d["indptr"], d["cols"], data.contiguous(),
                               B.contiguous(), rank * rps, rps)

    @staticmethod
    def backward(ctx, G):
        data, B = ctx.saved_tensors
        plan, rank = ctx.plan, ctx.rank
        lo, hi = plan._range(rank)
        d_data = d_B = None
        sp = plan.slab_plan(rank)
        if ctx.needs_input_grad[2]:
            d_data = F.pad(ChunkSddmm.apply(sp, G, B), (lo, plan.nnz - hi))
        if ctx.needs_input_grad[3]:
            d_B = ChunkSpmm.apply(sp.T, sp.to_T(data[lo:hi]), G)
        return None, None, d_data, d_B


def slab_spmm(plan: ShardedChunkPlan, rank: int, data: torch.Tensor,
              B: torch.Tensor) -> torch.Tensor:
    """The per-rank body: shard ``rank``'s ``(rows_per_shard, p)`` slab
    of ``A @ B``, with no collectives.  Differentiable; its data
    gradient is ``(nnz,)``, zero outside the slab's entries, and its B
    gradient the slab's share of ``Aᵀ G``."""
    return _SlabChunkSpmm.apply(plan, rank, data, B)


def sharded_chunk_spmm(plan: ShardedChunkPlan, data: torch.Tensor,
                       B: torch.Tensor, group=None) -> torch.Tensor:
    """``A @ B`` with A row-sharded over the ranks of ``group`` (the
    default group when None) and each slab's SpMM on K13.

    Args:
      plan: from :func:`build_sharded_chunk_plan` with ``n_shards`` equal
        to the group's size (``ValueError`` otherwise).
      data: A's ``(nnz,)`` values in CSR order, the same on every rank.
      B: dense ``(m, p)``, the same on every rank.

    Returns:
      This rank's ``(rows_per_shard, p)`` slab of the output (rows past n
      are 0).  The gradients of ``data`` and ``B`` are summed over the
      group, so every rank gets the gradient of the whole product.
    """
    rank = group_rank(plan.n_shards, group, "sharded_chunk_spmm")
    data, B = Replicated.apply(group, data, B)
    return slab_spmm(plan, rank, data, B)
