"""ELL-grid logsumexp: row LSE of a balanced sorted pattern as a dense
reduce over its padded row grid.

Port of ``torchsparsegradutils_tpu/kernels/grid_lse.py``.  The values go
once into a row-ELL grid ``(n, K)`` (``K`` the longest row), by the K3
gather (:mod:`.window_gather`) through the plan's ``src_of_grid`` map;
the row reduction is then a masked dense reduce over dim 1:

    out[r] = log(Σ_k valid[r, k] · exp(grid[r, k]))   (+ structural zeros)

in about ten PyTorch launches (:func:`masked_lse`).  The JAX package
reduces a ``(K, n)`` transpose with up to 64 unrolled ``where``/
``maximum`` steps for XLA's layout; eager PyTorch would pay some 4·K
launches for that, so the port keeps the semantics and not the loop.

The backward is ``d_grid = exp(grid - out[row]) · g[row]``, compacted to
``(nnz,)`` by the K3 gather over ``pos``.  The Functions' backwards are
plain differentiable PyTorch (the output is recomputed through
:func:`masked_lse` when a graph is being built), so second derivatives
work.

Gate: ``n·K <= GRID_MAX_EXPAND · nnz`` and rows in sorted order;
degree-skewed patterns take the chunk LSE (``kernels/chunk_lse.py``).

Example:
    >>> import numpy as np, torch
    >>> from torchsparsegradutils_tpu_torch.types import StaticArray
    >>> rows, cols = np.array([0, 0, 1]), np.array([0, 1, 1])
    >>> fn = grid_lse_fn(StaticArray(rows), StaticArray(cols), 2, 2, False)
    >>> out = fn(torch.tensor([0.0, 0.0, 1.0]))
    >>> [round(x, 4) for x in out.tolist()]
    [0.6931, 1.0]
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from . import _build
from .chunk_spmm import transpose_order
from .dia import grid_to_values, values_to_grid
from .window_gather import WindowGather, window_gather

__all__ = ["EllGridPlan", "build_ell_grid_plan", "masked_lse",
           "grid_lse_fn", "bidir_grid_fns", "GRID_MAX_EXPAND"]

GRID_MAX_EXPAND = 8.0
NEG_INF = float("-inf")


@dataclass(frozen=True, eq=False)
class EllGridPlan:
    """Row-ELL value-grid plan.  ``src_of_grid``, ``pos``, ``n`` and
    ``K`` carry the names of ``DiaPlan``'s, so ``dia.values_to_grid``
    and ``dia.grid_to_values`` apply unchanged.

    * ``counts`` (n,): entries per row;
    * ``src_of_grid`` (n*K,): entry feeding each grid cell, or -1;
    * ``pos`` (nnz,): grid cell of each entry (strictly increasing).
    """
    n: int
    m: int
    nnz: int
    K: int
    counts: np.ndarray
    src_of_grid: np.ndarray
    pos: np.ndarray
    _dev: dict = field(default_factory=dict, repr=False)

    def maps(self, device) -> dict:
        """``src_of_grid``, ``pos`` and ``counts`` as int64 tensors and
        ``valid`` as an (n, K) bool mask, on ``device`` (cached)."""
        device = torch.device(device)
        d = self._dev.get(device)
        if d is None:
            d = self._dev[device] = {
                k: torch.from_numpy(getattr(self, k)).to(device)
                for k in ("src_of_grid", "pos", "counts")}
            d["valid"] = (d["src_of_grid"] >= 0).view(self.n, self.K)
        return d


@lru_cache(maxsize=64)
def build_ell_grid_plan(rows_sa, cols_sa, n: int,
                        m: int) -> Optional[EllGridPlan]:
    """Row-ELL grid plan of a row-sorted 1-D pattern, or None: unsorted
    or empty patterns, and skewed ones whose grid would exceed
    ``GRID_MAX_EXPAND`` times nnz.  Cached on the pattern hash."""
    rows = rows_sa.arr
    if rows.ndim != 1 or len(rows) == 0:
        return None
    rows = rows.astype(np.int64)
    nnz = len(rows)
    if nnz > 1 and (np.diff(rows) < 0).any():
        return None
    counts = np.bincount(rows, minlength=n)
    K = max(int(counts.max()), 1)
    if n * K > GRID_MAX_EXPAND * nnz:
        return None
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = rows * K + (np.arange(nnz) - starts[rows])
    src_of_grid = np.full(n * K, -1, np.int64)
    src_of_grid[pos] = np.arange(nnz)
    return EllGridPlan(n=n, m=m, nnz=nnz, K=K, counts=counts,
                       src_of_grid=src_of_grid, pos=pos)


def masked_lse(X, valid, counts, width, include_zeros: bool):
    """Masked LSE over dim 1 of an ``(n, K)`` grid, in X's dtype.

    ``valid`` (n, K) bool marks stored entries, ``counts`` (n,) how many
    each row has, ``width`` the row length in the reduced direction.
    The JAX package's semantics: the max shift is detached; with
    ``include_zeros`` each of the ``width - count`` structural zeros adds
    ``exp(0)``; an empty group gives -inf; a +inf entry gives +inf.
    Differentiable (masked holes get no gradient).
    """
    Xm = X.masked_fill(~valid, NEG_INF)
    Mv = Xm.detach().amax(dim=1)
    if include_zeros:
        nz = (width - counts).to(X.dtype)
        M = torch.where(nz > 0, Mv.clamp_min(0.0), Mv)
    else:
        M = Mv
    Ms = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    S = torch.exp(Xm - Ms[:, None]).sum(dim=1)
    if include_zeros:
        S = S + torch.where(nz > 0, nz * torch.exp(-Ms),
                            torch.zeros_like(Ms))
    empty = S == 0
    out = torch.where(empty, NEG_INF,
                      Ms + torch.log(torch.where(empty, torch.ones_like(S),
                                                 S)))
    return torch.where(Mv == float("inf"), float("inf"), out)


def lse_grid_bwd(X, valid, out, g):
    """``d_grid = exp(grid - out[row]) · g[row]``, 0 at holes and where
    ``out`` is not finite; differentiable."""
    safe = torch.isfinite(out)
    oute = torch.where(safe, out, torch.zeros_like(out))
    ge = torch.where(safe, g, torch.zeros_like(g))
    return torch.exp(X.masked_fill(~valid, NEG_INF) - oute[:, None]) \
        * ge[:, None]


def _fill(plan: EllGridPlan, values):
    return values_to_grid(plan, values).to(_build.acc_dtype(values.dtype))


def _row_lse(plan: EllGridPlan, grid, include_zeros: bool):
    d = plan.maps(grid.device)
    return masked_lse(grid, d["valid"], d["counts"], plan.m, include_zeros)


def _row_lse_bwd(plan: EllGridPlan, values, out, g, include_zeros: bool):
    """d_values (in the plan's entry order, accumulation dtype) of one
    row LSE; ``out`` is recomputed through :func:`masked_lse` when a
    graph is being built, so the result is differentiable in values."""
    grid = _fill(plan, values)
    if torch.is_grad_enabled():
        out = _row_lse(plan, grid, include_zeros)
    d = plan.maps(values.device)
    return grid_to_values(plan, lse_grid_bwd(grid, d["valid"], out,
                                             g.to(grid.dtype)))


class GridLse(torch.autograd.Function):
    """Row LSE of ``values`` (in the plan's entry order) over an
    :class:`EllGridPlan`, returned in the accumulation dtype (float32
    for bfloat16)."""

    @staticmethod
    def forward(ctx, plan, include_zeros, values):
        out = _row_lse(plan, _fill(plan, values), include_zeros)
        ctx.plan, ctx.include_zeros = plan, include_zeros
        ctx.save_for_backward(values, out)
        return out

    @staticmethod
    def backward(ctx, g):
        values, out = ctx.saved_tensors
        return None, None, _row_lse_bwd(ctx.plan, values, out, g,
                                        ctx.include_zeros).to(values.dtype)


@lru_cache(maxsize=64)
def grid_lse_fn(rows_sa, cols_sa, n: int, m: int, include_zeros: bool):
    """Cached ``f(values) -> (n,)`` row LSE over the ELL grid, or None
    where the grid plan does not apply."""
    plan = build_ell_grid_plan(rows_sa, cols_sa, n, m)
    if plan is None:
        return None
    return lambda values: GridLse.apply(plan, include_zeros, values).to(
        values.dtype)


class BidirGridLse(torch.autograd.Function):
    """``(col_lse, row_lse)`` of one pattern from both ELL grids: the row
    grid filled from the values, the column grid from the values in
    (column, row) order, reached by one K3 gather.  Both in the
    accumulation dtype."""

    @staticmethod
    def forward(ctx, fns, values):
        plan_r, plan_c, perm, _, iz = fns
        vc = window_gather(values.contiguous(), perm.on(values.device))
        row = _row_lse(plan_r, _fill(plan_r, values), iz)
        col = _row_lse(plan_c, _fill(plan_c, vc), iz)
        ctx.fns = fns
        ctx.save_for_backward(values, col, row)
        return col, row

    @staticmethod
    def backward(ctx, g_col, g_row):
        values, col, row = ctx.saved_tensors
        plan_r, plan_c, perm, inv, iz = ctx.fns
        dev = values.device
        vc = WindowGather.apply(values, perm.on(dev), inv.on(dev))
        d_row = _row_lse_bwd(plan_r, values, row, g_row, iz)
        d_csc = _row_lse_bwd(plan_c, vc, col, g_col, iz)
        d_col = WindowGather.apply(d_csc, inv.on(dev), perm.on(dev))
        return None, (d_row + d_col).to(values.dtype)


@lru_cache(maxsize=64)
def bidir_grid_fns(rows_sa, cols_sa, n: int, m: int, include_zeros: bool):
    """Cached ``f(values) -> (col_lse, row_lse)`` from both ELL grids of
    one row-sorted pattern, or None when either grid is out of scope.
    The CSR→CSC value reorder is the K3 gather by the transpose chunk
    plan's ``perm`` (``ChunkPlan.to_T``).  The JAX package stacks both
    grids into one ``(Kmax, n + m)`` reduce when their K are close (a
    trade of TPU lane padding); the port reduces each grid on its own,
    with the same values."""
    plan_r = build_ell_grid_plan(rows_sa, cols_sa, n, m)
    if plan_r is None:
        return None
    rt, ct, perm, inv = transpose_order(rows_sa, cols_sa, n, m)
    plan_c = build_ell_grid_plan(rt, ct, m, n)
    if plan_c is None:
        return None
    fns = (plan_r, plan_c, perm, inv, include_zeros)

    def f(values):
        col, row = BidirGridLse.apply(fns, values)
        return col.to(values.dtype), row.to(values.dtype)

    return f
