"""Fully sharded DIA SpMM: a stencil operator over a process group, with a
halo exchange between neighbouring ranks.

Port of ``torchsparsegradutils_tpu/parallel/dia_sharded.py``.
``sharded_sparse_mm`` replicates the dense operand.  For a
diagonal-structured pattern the column support of a row block is a
bounded window, so B can be row-sharded too: each rank owns matching row
slabs of A's value grid, of B and of the output, and the only
communication is a boundary strip of ``h`` rows with each of its two
neighbours (JAX's ``ppermute``, here ``torch.distributed`` point-to-point
sends and receives).  The backward sends the strips' gradients back to
the ranks that own those rows, which add them to their own.

The slab's product runs the package's DIA engine: the value grid's slab
comes from the K3 gather (only the slab's rows), and the product is K1
(:class:`~..kernels.dia.DiaSpmmCore`, whose backward runs K2 and K1) over
the ``(rows_per_shard + h_lo + h_hi)``-row window, the offsets shifted by
``h_lo``.  JAX's shifted-slice loop is this core's plain version.

Two parts, as for every sharded op of this package:

* :meth:`ShardedDia.slab_spmm`, the per-rank body (no collectives), and
  :meth:`ShardedDia.window`, which cuts a rank's window from a whole B;
* the ``f(data, B)`` that :func:`sharded_dia_spmm` returns, which
  exchanges the halo and sums the replicated ``data``'s gradient over
  the group.

``matvec_closures`` gives ``(mv, mv_t)`` over the same machinery, for a
distributed Krylov solve: the solvers of ``solvers/`` read the closures'
``group`` and sum every column reduction over it.

Example (on every rank of a group of S ranks)::

    f = sharded_dia_spmm(A)              # A: stencil SparseCSR
    y = f(A.values, B_slab)              # B_slab, y: (f.rows_per_shard, p)
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.dia import DiaGeometry, DiaSpmmCore, build_dia_plan
from ..kernels.window_gather import WindowGather
from ..types import is_sparse
from ._collectives import Replicated, exchange

__all__ = ["ShardedDia", "sharded_dia_spmm", "matvec_closures"]


def _plan_or_raise(A):
    if not is_sparse(A) or A.ndim != 2:
        raise ValueError("sharded_dia_spmm expects an unbatched 2-D sparse "
                         "container")
    n, m = A.shape
    if n != m:
        raise ValueError("sharded_dia_spmm expects a square operator "
                         f"(got {A.shape}); rectangular operators use "
                         "sharded_sparse_mm")
    plan = None
    if A.rows().ndim == 1:
        plan = build_dia_plan(A.row_sa(), A.col_sa(), n, m)
    if plan is None or plan.is_hybrid:
        raise ValueError(
            "sharded_dia_spmm: pattern is not pure-DIA (union of <=256 "
            "diagonals with no residual entries); use sharded_sparse_mm")
    return plan


def _geometry(plan, n_shards: int) -> Tuple[int, int, int]:
    n = plan.n
    rps = -(-n // n_shards)
    if rps % 8:
        rps = -(-rps // 8) * 8           # slabs of whole 8-row groups
    h_lo = max(0, -int(plan.offsets.min()))
    h_hi = max(0, int(plan.offsets.max()))
    if max(h_lo, h_hi) > rps:
        raise ValueError(
            f"sharded_dia_spmm: halo ({max(h_lo, h_hi)} rows) exceeds the "
            f"per-shard slab ({rps} rows); use fewer shards")
    return rps, h_lo, h_hi


class ShardedDia:
    """A pure-DIA square operator's layout over ``n_shards`` row slabs of
    ``rows_per_shard`` rows (``n_padded`` in all), with a halo of
    ``halo = (h_lo, h_hi)`` rows above and below each slab."""

    def __init__(self, A, n_shards: int):
        self.plan = plan = _plan_or_raise(A)
        self.n_shards = n_shards
        rps, h_lo, h_hi = _geometry(plan, n_shards)
        self.rows_per_shard, self.halo = rps, (h_lo, h_hi)
        self.n_padded = rps * n_shards
        # the window's geometry: slab rows over rps + h_lo + h_hi B rows
        self.geo = DiaGeometry(plan.offsets + h_lo, rps, rps + h_lo + h_hi)
        self._dev = {}

    def _maps(self, rank: int, device):
        """The K3 maps between A's values and shard ``rank``'s ``(rps, K)``
        grid slab (cached): the entry of each slab cell (-1 at holes and
        padding rows), and each entry's slab cell (-1 off the slab)."""
        key = (rank, torch.device(device))
        maps = self._dev.get(key)
        if maps is None:
            K, rps = self.plan.K, self.rows_per_shard
            lo = rank * rps * K
            src = np.full(rps * K, -1, np.int64)
            part = self.plan.src_of_grid[lo:lo + rps * K]
            src[:len(part)] = part
            pos = self.plan.pos
            inv = np.where((pos >= lo) & (pos < lo + rps * K), pos - lo, -1)
            maps = self._dev[key] = tuple(
                torch.from_numpy(a).to(device) for a in (src, inv))
        return maps

    def grid_slab(self, data: torch.Tensor, rank: int) -> torch.Tensor:
        """Shard ``rank``'s ``(rows_per_shard, K)`` slab of the value grid
        (differentiable; its data gradient is zero off the slab)."""
        src, inv = self._maps(rank, data.device)
        return WindowGather.apply(data, src, inv).view(self.rows_per_shard,
                                                       self.plan.K)

    def window(self, B: torch.Tensor, rank: int) -> torch.Tensor:
        """Shard ``rank``'s ``(rows_per_shard + h_lo + h_hi, p)`` window of
        a whole ``(n, p)`` or ``(n_padded, p)`` B, zero outside it: what
        the halo exchange assembles, for running the bodies of every rank
        in one process."""
        h_lo, h_hi = self.halo
        rps = self.rows_per_shard
        Bp = F.pad(B, (0, 0, h_lo, self.n_padded - B.shape[0] + h_hi))
        return Bp[rank * rps:(rank + 1) * rps + h_lo + h_hi]

    def slab_spmm(self, data: torch.Tensor, Bwin: torch.Tensor,
                  rank: int) -> torch.Tensor:
        """The per-rank body: shard ``rank``'s ``(rows_per_shard, p)``
        output slab from A's ``(nnz,)`` values and the rank's B window,
        with no collectives (K3, then K1; K2 and K1 in the backward)."""
        return DiaSpmmCore.apply(self.geo, self.grid_slab(data, rank), Bwin)


class _HaloExchange(torch.autograd.Function):
    """A rank's B slab -> its window: ``h_lo`` rows from the rank above
    (zeros on the first rank), the slab, ``h_hi`` rows from the rank
    below (zeros on the last).  Backward: the window's edge strips go back
    to their owners and are added to their rows."""

    @staticmethod
    def forward(ctx, group, rank, S, h_lo, h_hi, B):
        ctx.args = (group, rank, S, h_lo, h_hi)
        B = B.contiguous()
        rps, p = B.shape
        up, dn = B.new_zeros((h_lo, p)), B.new_zeros((h_hi, p))
        ops = []
        if h_lo and rank + 1 < S:
            ops.append((dist.isend, B[rps - h_lo:], rank + 1))
        if h_lo and rank > 0:
            ops.append((dist.irecv, up, rank - 1))
        if h_hi and rank > 0:
            ops.append((dist.isend, B[:h_hi], rank - 1))
        if h_hi and rank + 1 < S:
            ops.append((dist.irecv, dn, rank + 1))
        exchange(ops, group)
        return torch.cat([up, B, dn])

    @staticmethod
    def backward(ctx, g):
        group, rank, S, h_lo, h_hi = ctx.args
        g = g.contiguous()
        rps = g.shape[0] - h_lo - h_hi
        d_B = g[h_lo:h_lo + rps].clone()
        from_below = g.new_empty((h_lo, g.shape[1]))
        from_above = g.new_empty((h_hi, g.shape[1]))
        ops = []
        if h_lo and rank > 0:
            ops.append((dist.isend, g[:h_lo], rank - 1))
        if h_lo and rank + 1 < S:
            ops.append((dist.irecv, from_below, rank + 1))
        if h_hi and rank + 1 < S:
            ops.append((dist.isend, g[h_lo + rps:], rank + 1))
        if h_hi and rank > 0:
            ops.append((dist.irecv, from_above, rank - 1))
        exchange(ops, group)
        if h_lo and rank + 1 < S:
            d_B[rps - h_lo:] += from_below
        if h_hi and rank > 0:
            d_B[:h_hi] += from_above
        return None, None, None, None, None, d_B


def sharded_dia_spmm(A, group=None) -> Callable:
    """Build ``f(data, B) -> A @ B`` with A's value grid, B and the output
    row-sharded over the ranks of ``group`` (the default group when
    None).

    ``data``: A's ``(nnz,)`` values in CSR order, the same on every rank
    (its gradient is summed over the group).  ``B``: this rank's
    ``(f.rows_per_shard, p)`` slab of the ``(f.n_padded, p)`` operand
    (rows past n zero).  ``f`` returns this rank's ``(rows_per_shard,
    p)`` output slab.  Communication: a strip of ``h_lo`` rows to the
    rank below and one of ``h_hi`` rows to the rank above, and their
    gradients back in the backward.  ``f.rows_per_shard``, ``f.halo``,
    ``f.n_padded`` and ``f.layout`` (the :class:`ShardedDia`) describe the
    layout.
    """
    S = dist.get_world_size(group)
    layout = ShardedDia(A, S)
    h_lo, h_hi = layout.halo

    def f(data, B):
        rank = dist.get_rank(group)
        if B.shape[0] != layout.rows_per_shard:
            raise ValueError(f"sharded_dia_spmm: B must be this rank's "
                             f"({layout.rows_per_shard}, p) slab, got "
                             f"{tuple(B.shape)}")
        (data,) = Replicated.apply(group, data)
        Bwin = _HaloExchange.apply(group, rank, S, h_lo, h_hi, B)
        return layout.slab_spmm(data, Bwin, rank)

    f.rows_per_shard = layout.rows_per_shard
    f.halo = layout.halo
    f.n_padded = layout.n_padded
    f.layout = layout
    return f


def matvec_closures(A, group=None):
    """``(mv, mv_t)`` closures over :func:`sharded_dia_spmm` for A and Aᵀ,
    for a Krylov solver: a distributed solve for stencil systems.  The
    operator values are closed over; ``x`` is this rank's
    ``(rows_per_shard, p)`` (or ``(rows_per_shard,)``) slab.

    Each closure carries the group as ``mv.group`` (``group`` or the
    default group), and the layout as ``mv.rows_per_shard``,
    ``mv.n_padded`` and ``mv.layout``.  The solvers read ``mv.group`` and
    sum their column reductions over it, so JAX's call
    ``linear_cg(mv, rhs)`` is the same call here, with ``rhs`` this
    rank's slab (rows past n zero)::

        mv, mv_t = matvec_closures(A)
        x = linear_cg(mv, rhs_slab)          # this rank's slab of A⁻¹ rhs
        x, itn = lsmr(mv, rhs_slab, rmatvec=mv_t)
    """
    At = A.T
    f = sharded_dia_spmm(A, group)
    fT = sharded_dia_spmm(At, group)
    reduce_over = dist.group.WORLD if group is None else group

    def _wrap(g, M):
        def mv(x):
            squeeze = x.ndim == 1
            xm = x[:, None] if squeeze else x
            y = g(M.values, xm)
            return y[:, 0] if squeeze else y
        mv.group = reduce_over
        mv.rows_per_shard, mv.n_padded = g.rows_per_shard, g.n_padded
        mv.layout = g.layout
        return mv

    return _wrap(f, A), _wrap(fT, At)
