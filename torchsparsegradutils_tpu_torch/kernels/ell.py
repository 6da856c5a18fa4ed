"""Row-ELL execution plans for SpMM and SDDMM (``backend="ell"``).

Port of ``torchsparsegradutils_tpu/kernels/ell.py``.  A pattern's
entries are padded per row to the widest row, K: ``out[i] =
Σ_k ev[i, k] · B[ec[i, k]]``.  The plan is host numpy, cached on the
content hash of the index arrays, and refused (None) for an empty
pattern and for one whose padded grid would hold more than
``ELL_MAX_EXPAND`` times its entries.  ``ELL_CHUNK_ELEMS`` caps the
gathered ``(n, Kc, p)`` block by cutting the K axis into chunks.

The plan's fields (``n``, ``m``, ``K``, ``cols``, ``flat_pos``,
``sorted_pos``) are the JAX package's, dtypes included.  The value
relayouts are the K3 gather (:class:`~.window_gather.WindowGather`):
values into the ``(n, K)`` grid by ``src`` (each cell's entry, -1 at
pads), where JAX scatters by ``flat_pos``, and the grid's SDDMM sums
back to entry order by ``flat_pos``, with ``src`` as each gather's
inverse.  The row gather of B and the contraction are PyTorch ops
(``index_select`` and ``bmm``), as JAX computes them outside any
Pallas kernel.

:class:`EllOperator` holds a pattern's row plan and column plan (the
plan of Aᵀ; either may be None) with its index tensors, and
:class:`EllSpmm` and :class:`EllSddmm` are the differentiable ops over
it, with the JAX package's ``backend="ell"`` routes: the forward is
``ell_spmm`` over the row plan, ``sddmm`` is ``ell_sddmm``; in
``A @ B``'s backward gradA is ``ell_sddmm(row plan, G, B)`` and gradB
``ell_spmm`` over the column plan.  A direction whose plan is None takes
the generic gather and ``index_add`` branch.  Each backward is built
of the same ops, so higher derivatives work.

Example:
    >>> import numpy as np
    >>> from torchsparsegradutils_tpu_torch.types import StaticArray
    >>> plan = build_ell_plan(StaticArray(np.array([0, 0, 1])),
    ...                       StaticArray(np.array([1, 2, 0])), 2, 3)
    >>> plan.K, plan.cols.tolist(), plan.flat_pos.tolist()
    (2, [[1, 2], [0, 0]], [0, 1, 2])
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .window_gather import WindowGather

__all__ = ["ELLPlan", "build_ell_plan", "ell_values", "ell_spmm",
           "ell_sddmm", "EllOperator", "EllSpmm", "EllSddmm",
           "ELL_MAX_EXPAND", "ELL_CHUNK_ELEMS"]

ELL_MAX_EXPAND = 8.0       # max allowed n*K / nnz padding ratio
ELL_CHUNK_ELEMS = 512 * 1024 * 1024  # cap gathered intermediate elements


@dataclass(frozen=True, eq=False)
class ELLPlan:
    n: int                  # number of (logical) rows
    m: int                  # number of columns (gather source rows)
    K: int                  # max row degree (padded width)
    cols: np.ndarray        # (n, K) int32 -> gather row in B (0 where pad)
    flat_pos: np.ndarray    # (nnz,) int32 -> position of entry e in (n*K,)
    sorted_pos: bool        # flat_pos strictly increasing (row-major
    #                         entry order)
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def nnz(self) -> int:
        return len(self.flat_pos)

    def maps(self, device) -> dict:
        """int64 tensors on ``device`` (cached): ``cols`` (n, K),
        ``flat_pos`` (nnz,) and ``src`` (n·K,), each cell's entry (-1 at
        pads), the inverse of ``flat_pos``."""
        device = torch.device(device)
        d = self._dev.get(device)
        if d is None:
            src = np.full(self.n * self.K, -1, np.int64)
            src[self.flat_pos] = np.arange(self.nnz, dtype=np.int64)
            d = self._dev[device] = {
                k: torch.from_numpy(a.astype(np.int64)).to(device)
                for k, a in (("cols", self.cols),
                             ("flat_pos", self.flat_pos), ("src", src))}
        return d


@lru_cache(maxsize=256)
def build_ell_plan(rows_sa, cols_sa, n: int, m: int) -> Optional[ELLPlan]:
    """Row-ELL plan of a 1-D pattern (any entry order), or None for an
    empty pattern and one whose padded grid breaks the skew guard
    ``n·K > ELL_MAX_EXPAND · nnz``.  Cached on the pattern's hash."""
    rows = rows_sa.arr.astype(np.int64)
    cols = cols_sa.arr.astype(np.int64)
    nnz = len(rows)
    if rows.ndim != 1 or nnz == 0:
        return None
    cnt = np.bincount(rows, minlength=n)
    K = max(int(cnt.max()), 1)
    if n * K > ELL_MAX_EXPAND * max(nnz, 1):
        return None
    order = np.argsort(rows, kind="stable")
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    slot = np.empty(nnz, np.int64)
    slot[order] = np.arange(nnz) - starts[rows[order]]
    ecols = np.zeros((n, K), np.int32)
    ecols[rows, slot] = cols
    flat_pos = (rows * K + slot).astype(np.int32)
    sorted_pos = bool(np.all(np.diff(flat_pos) > 0)) if nnz > 1 else True
    return ELLPlan(n=n, m=m, K=K, cols=ecols, flat_pos=flat_pos,
                   sorted_pos=sorted_pos)


def k_chunks(plan: ELLPlan, p: int):
    """The K axis cut so the gathered (n, Kc, p) block holds at most
    ``ELL_CHUNK_ELEMS`` elements."""
    per_slot = plan.n * p
    kc = max(1, min(plan.K, int(ELL_CHUNK_ELEMS // max(per_slot, 1))))
    return [(s, min(s + kc, plan.K)) for s in range(0, plan.K, kc)]


def ell_values(plan: ELLPlan, data: torch.Tensor) -> torch.Tensor:
    """(nnz,) values -> the (n, K) grid, 0 at pads: the K3 gather by
    ``src`` (differentiable; its backward gathers by ``flat_pos``)."""
    d = plan.maps(data.device)
    return WindowGather.apply(data, d["src"], d["flat_pos"]).view(
        plan.n, plan.K)


def _gathered(plan: ELLPlan, ec: torch.Tensor, B: torch.Tensor, s: int,
              e: int) -> torch.Tensor:
    """B's rows of the grid's columns s..e: (n, e - s, p)."""
    return B.index_select(0, ec[:, s:e].reshape(-1)).view(
        plan.n, e - s, B.shape[1])


def ell_spmm(plan: ELLPlan, data: torch.Tensor,
             B: torch.Tensor) -> torch.Tensor:
    """(n, p) = A @ B over the row plan: the value grid, then a gather
    of B's rows and a batched contraction a K-chunk."""
    ev = ell_values(plan, data)
    ec = plan.maps(B.device)["cols"]
    out = None
    for s, e in k_chunks(plan, B.shape[1]):
        c = torch.bmm(ev[:, None, s:e], _gathered(plan, ec, B, s, e))[:, 0]
        out = c if out is None else out + c
    return out


def ell_sddmm(plan: ELLPlan, X: torch.Tensor,
              Y: torch.Tensor) -> torch.Tensor:
    """(nnz,) values of X @ Yᵀ at the pattern, in its entry order: X
    streams row-aligned, Y's rows are gathered, and the (n, K) grid goes
    back to entry order by the K3 gather by ``flat_pos``."""
    d = plan.maps(X.device)
    pieces = [torch.bmm(_gathered(plan, d["cols"], Y, s, e),
                        X[:, :, None])[:, :, 0]
              for s, e in k_chunks(plan, X.shape[1])]
    grid = pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1)
    return WindowGather.apply(grid.reshape(-1), d["flat_pos"], d["src"])


class EllOperator:
    """A 2-D pattern's two ELL plans and index tensors: ``rp`` (rows,
    gathering columns) and ``cp`` (the plan of Aᵀ), either None where
    ``build_ell_plan`` refuses; ``T`` swaps the two."""

    def __init__(self, rp, cp, rows: torch.Tensor, cols: torch.Tensor,
                 n: int, m: int, transpose: "EllOperator" = None):
        self.rp, self.cp = rp, cp
        self.rows, self.cols, self.n, self.m = rows, cols, n, m
        self._T = transpose

    @classmethod
    def of(cls, A) -> "EllOperator":
        """The operator of a 2-D container with a 1-D pattern."""
        rs, cs = A.row_sa(), A.col_sa()
        n, m = A.mat_shape
        return cls(build_ell_plan(rs, cs, n, m), build_ell_plan(cs, rs, m, n),
                   A.rows_t(), A.cols_t(), n, m)

    @property
    def T(self) -> "EllOperator":
        if self._T is None:
            self._T = EllOperator(self.cp, self.rp, self.cols, self.rows,
                                  self.m, self.n, transpose=self)
        return self._T

    def spmm(self, values, B):
        """A @ B: ``ell_spmm`` over ``rp``, else the generic branch."""
        if self.rp is not None:
            return ell_spmm(self.rp, values, B)
        prod = values[:, None] * B.index_select(0, self.cols)
        out = torch.zeros((self.n, B.shape[1]), dtype=B.dtype,
                          device=B.device)
        return out.index_add(0, self.rows, prod)

    def sddmm(self, X, Y):
        """dot(X[row_e], Y[col_e]): ``ell_sddmm`` over ``rp``, else the
        generic branch."""
        if self.rp is not None:
            return ell_sddmm(self.rp, X, Y)
        return (X.index_select(0, self.rows)
                * Y.index_select(0, self.cols)).sum(-1)


class EllSpmm(torch.autograd.Function):
    """Differentiable ``A @ B`` over an :class:`EllOperator`.  Backward:
    ``d_values = EllSddmm(op, G, B)`` and ``d_B = EllSpmm(op.T, values,
    G)`` (the column plan's ``flat_pos`` indexes the same entries)."""

    @staticmethod
    def forward(ctx, op, values, B):
        ctx.op = op
        ctx.save_for_backward(values, B)
        return op.spmm(values, B.contiguous())

    @staticmethod
    def backward(ctx, G):
        values, B = ctx.saved_tensors
        op = ctx.op
        d_values = d_B = None
        if ctx.needs_input_grad[1]:
            d_values = EllSddmm.apply(op, G, B)
        if ctx.needs_input_grad[2]:
            d_B = EllSpmm.apply(op.T, values, G)
        return None, d_values, d_B


class EllSddmm(torch.autograd.Function):
    """Differentiable ``dot(X[row_e], Y[col_e])`` over an
    :class:`EllOperator`.  Backward: ``d_X = EllSpmm(op, ct, Y)`` and
    ``d_Y = EllSpmm(op.T, ct, X)``."""

    @staticmethod
    def forward(ctx, op, X, Y):
        ctx.op = op
        ctx.save_for_backward(X, Y)
        return op.sddmm(X.contiguous(), Y.contiguous())

    @staticmethod
    def backward(ctx, ct):
        X, Y = ctx.saved_tensors
        op = ctx.op
        d_X = d_Y = None
        if ctx.needs_input_grad[1]:
            d_X = EllSpmm.apply(op, ct, Y)
        if ctx.needs_input_grad[2]:
            d_Y = EllSpmm.apply(op.T, ct, X)
        return None, d_X, d_Y
