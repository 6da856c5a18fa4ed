"""Sparse log-sum-exp reductions, one direction or both.

Port of ``torchsparsegradutils_tpu/ops/logsumexp.py``:

* ``sparse_logsumexp(A, dim)``: logsumexp over ``dim`` of a 2-D or
  batched 3-D sparse matrix, with dense semantics (``include_zeros=True``:
  every absent entry is a zero) or support-mask semantics
  (``include_zeros=False``: absent entries are -inf, empty groups -inf).
* ``sparse_bidir_logsumexp(A)``: the column and the row reductions of one
  matrix together.

The gradient lands on ``A.values`` only.  Routes, per 2-D static pattern
(the JAX package's ``_chunked_lse`` and ``_bidir_fused_fn``):

* ``backend="auto"`` or ``"dia"``: the DIA grid LSE for a pure
  diagonal-structured pattern, on any device: a masked reduce over the
  ``(n, K)`` diagonal grid, the column direction over the grid shifted
  by ``DiaGeometry.shift``.
* ``"pallas"``, or ``"auto"`` with A on the card: the row-ELL grid LSE
  (``kernels/grid_lse.py``) for balanced sorted patterns, else the chunk
  LSE (``kernels/chunk_lse.py``: K10 forward, K11 backward) for
  degree-skewed ones; the column direction is the row LSE of the
  transpose, reached by the K3 gather.  On the CPU these run the
  kernels' plain versions.
* ``"xla"``, batched input, ``dim=[0, 1]``, a dynamic pattern
  (``pattern_static=False``, on every backend, as in the JAX package),
  and ``"auto"`` on the CPU for a pattern with no DIA plan: the segment
  path, ``scatter_reduce`` max and ``index_add`` sum with the shift
  detached, the structural zeros counted by ``index_add`` (no
  ``bincount``, whose length is a read of the device).

Unlike the JAX package, the DIA, grid and chunk routes also take float64
(the CUDA kernels sum in float64).  Patterns are assumed duplicate-free.

Example:
    >>> import numpy as np, torch
    >>> from torchsparsegradutils_tpu_torch import SparseCOO
    >>> A = SparseCOO(np.array([0, 0, 1]), np.array([0, 2, 1]),
    ...               torch.tensor([1.0, 2.0, 3.0]), (2, 3), device="cpu")
    >>> out = sparse_logsumexp(A, dim=1)
    >>> bool(torch.allclose(out, torch.logsumexp(A.todense(), dim=1)))
    True
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.chunk_lse import lse_fn, lse_fn_transposed
from ..kernels.dia import build_dia_plan, values_to_grid
from ..kernels.grid_lse import bidir_grid_fns, grid_lse_fn, masked_lse
from ..types import SparseCOO, SparseCSC, SparseCSR, is_sparse

__all__ = ["sparse_logsumexp", "sparse_bidir_logsumexp"]

NEG_INF = float("-inf")
_FLOATS = (torch.float32, torch.bfloat16, torch.float64)


def _scatter_logsumexp(values, seg, n_groups: int, n_zeros):
    """Stable LSE of flat ``values`` in ``n_groups`` groups ``seg``;
    ``n_zeros`` (n_groups,) structural zeros per group, or None.  Empty
    groups give -inf.  Sums in the accumulation dtype."""
    acc = _build.acc_dtype(values.dtype)
    v = values.to(acc)
    M = torch.full((n_groups,), NEG_INF, dtype=acc,
                   device=v.device).scatter_reduce(0, seg, v.detach(), "amax")
    if n_zeros is not None:
        has_zeros = n_zeros > 0
        M = torch.where(has_zeros, M.clamp_min(0.0), M)
    shift = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    S = torch.zeros(n_groups, dtype=acc, device=v.device).index_add(
        0, seg, torch.exp(v - shift[seg]))
    if n_zeros is not None:
        S = S + torch.where(has_zeros, n_zeros.to(acc) * torch.exp(-shift),
                            torch.zeros_like(S))
    empty = S == 0
    out = torch.where(empty, NEG_INF,
                      shift + torch.log(torch.where(empty, torch.ones_like(S),
                                                    S)))
    return out.to(values.dtype)


def _counts(seg: torch.Tensor, total: int) -> torch.Tensor:
    """Entries per group, on the device and with no sync."""
    return torch.zeros(total, dtype=torch.int64, device=seg.device
                       ).index_add_(0, seg, torch.ones_like(seg))


def _flat_indices(A):
    """(rows, cols, values, b): ``(b, nnz)`` each, b = 1 unbatched."""
    rows, cols, vals = A.rows_t(), A.cols_t(), A.values
    if A.ndim == 2:
        return rows[None], cols[None], vals[None], 1
    b = A.shape[0]
    if rows.ndim == 1:
        rows, cols = rows.expand(b, A.nnz), cols.expand(b, A.nnz)
    return rows, cols, vals, b


def _validate_dims(ndim: int, dim) -> list:
    dims_list = [dim] if isinstance(dim, int) else list(dim)
    if not dims_list:
        raise ValueError("sparse_logsumexp: dim must not be empty")
    for d in dims_list:
        if not -ndim <= d < ndim:
            raise IndexError(
                f"Dimension out of range (expected to be in range of "
                f"[{-ndim}, {ndim - 1}], but got {d})")
    normalised = [d % ndim for d in dims_list]
    if len(set(normalised)) != len(normalised):
        raise ValueError("sparse_logsumexp: dim contains a repeated dimension")
    return sorted(normalised)


def _check_backend(backend: str):
    if backend not in ("auto", "dia", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                         "'dia', 'pallas' or 'xla'")


def _dia_lse_gate(A, backend: str):
    """The DIA plan of the DIA LSE route (a pure DIA 2-D float pattern),
    or None out of scope."""
    if backend not in ("auto", "dia") or A.dtype not in _FLOATS:
        return None
    rs, cs = A.row_sa(), A.col_sa()
    if rs is None or rs.arr.ndim != 1:
        return None
    dia = build_dia_plan(rs, cs, *A.mat_shape)
    return None if dia is None or dia.is_hybrid else dia


def _dia_lse_plan(A, backend: str):
    """(plan, grid) of the DIA LSE, or None out of scope: filled once so
    that the bidirectional op feeds both directions from one grid."""
    dia = _dia_lse_gate(A, backend)
    return None if dia is None else (dia, values_to_grid(dia, A.values))


def _dia_valid(dia, device, over_cols: bool):
    """The DIA grid's (n, K) validity mask, or the transpose's (m, K),
    shifted like the values as a float grid (cached on the plan)."""
    d = dia.maps(device)
    key = "lse_valid_T" if over_cols else "lse_valid"
    if key not in d:
        valid = (d["src_of_grid"] >= 0).view(dia.n, dia.K)
        if over_cols:
            valid = dia.geo.shift(valid.to(torch.float32)) > 0
        d[key] = valid
    return d[key]


def _dia_lse(A, include_zeros: bool, over_cols: bool, backend: str,
             planned=None):
    """DIA route: the masked row reduce over the diagonal grid; the
    column direction over the shifted grid, with no value permutation.
    Gradients flow through the differentiable relayouts."""
    if planned is None:
        planned = _dia_lse_plan(A, backend)
    if planned is None:
        return None
    dia, grid = planned
    n, m = A.mat_shape
    if over_cols:
        grid, width = dia.geo.shift(grid), n
    else:
        width = m
    valid = _dia_valid(dia, grid.device, over_cols)
    out = masked_lse(grid.to(_build.acc_dtype(grid.dtype)), valid,
                     valid.sum(dim=1), width, include_zeros)
    return out.to(A.dtype)


def _fast_route_ok(A, backend: str) -> bool:
    """Whether the grid and chunk routes may run: ``"pallas"``, or
    ``"auto"`` with A on the card (the JAX package's ``on_tpu()``), for
    a 2-D float pattern shared by no batch."""
    if backend != "pallas" and not (backend == "auto"
                                    and A.device.type == "cuda"):
        return False
    return (A.ndim == 2 and A.dtype in _FLOATS and A.pattern_static
            and A.row_sa().arr.ndim == 1)


def _chunked_lse(A, include_zeros: bool, over_cols: bool, backend: str,
                 dia_planned=None):
    """One direction on the DIA, ELL-grid or chunk route; None where
    none applies (the segment path then runs)."""
    if backend == "xla":
        return None
    out = _dia_lse(A, include_zeros, over_cols, backend, planned=dia_planned)
    if out is not None or backend == "dia" or not _fast_route_ok(A, backend):
        return out
    rs, cs = A.row_sa(), A.col_sa()
    n, m = A.mat_shape
    if over_cols:
        res = lse_fn_transposed(rs, cs, n, m, include_zeros)
        if res is None:
            return None
        fn, reorder = res
        return fn(reorder(A.values))
    fn = grid_lse_fn(rs, cs, n, m, include_zeros) or lse_fn(
        rs, cs, n, m, include_zeros)
    return None if fn is None else fn(A.values)


def _bidir_fused_fn(A, include_zeros: bool, backend: str):
    """The fused bidirectional ELL-grid callable, or None out of scope."""
    if backend in ("xla", "dia") or not _fast_route_ok(A, backend):
        return None
    return bidir_grid_fns(A.row_sa(), A.col_sa(), *A.mat_shape,
                          include_zeros)


def _keep(out, red, batched: bool):
    """torch.logsumexp's keepdim shape for the reduced within-matrix
    dims ``red``."""
    if len(red) == 2:
        return out.reshape((-1, 1, 1) if batched else (1, 1))
    if batched:
        return out[:, None, :] if red == [0] else out[:, :, None]
    return out[None, :] if red == [0] else out[:, None]


def sparse_logsumexp(A: Union[SparseCOO, SparseCSR, SparseCSC],
                     dim: Union[int, Sequence[int]], keepdim: bool = False,
                     include_zeros: bool = True, backend: str = "auto"):
    """Log-sum-exp along ``dim`` of a sparse matrix, O(nnz) memory.

    Args:
      A: 2-D ``SparseCOO``/``SparseCSR``/``SparseCSC``, or batched 3-D
        COO/CSR (shared or per-element pattern).
      dim: 2-D input: 0, 1 or ``[0, 1]``; batched 3-D input: from
        {1, 2} (the batch axis cannot be reduced).
      keepdim: keep the reduced dims with size 1, as ``torch.logsumexp``.
      include_zeros: ``True`` treats absent entries as zeros (matches
        ``torch.logsumexp(A.todense())``); ``False`` as -inf.
      backend: ``"auto"`` | ``"dia"`` | ``"pallas"`` | ``"xla"``.

    Returns:
      A dense tensor in A's dtype, differentiable in ``A.values``.
    """
    _check_backend(backend)
    if isinstance(A, SparseCSC):
        # CSC is its transpose's CSR: reduce the swapped dims, then give
        # keepdim's axes A's orientation
        dims = _validate_dims(2, dim)
        swapped = [1 - d for d in dims]
        out = sparse_logsumexp(A.transpose_csr(),
                               swapped if len(swapped) > 1 else swapped[0],
                               include_zeros=include_zeros, backend=backend)
        return _keep(out, dims, False) if keepdim else out
    if not is_sparse(A):
        raise TypeError("sparse_logsumexp: input must be SparseCOO/SparseCSR")
    if A.ndim not in (2, 3):
        raise NotImplementedError(
            f"sparse_logsumexp supports 2-D or batched 3-D input, got "
            f"ndim={A.ndim}")
    dims = _validate_dims(A.ndim, dim)
    batched = A.ndim == 3
    if batched and 0 in dims:
        raise NotImplementedError(
            "Cannot reduce the batch dimension (0) of a batched 3-D sparse "
            "tensor")
    nrows, ncols = A.mat_shape
    red = [d - 1 for d in dims] if batched else dims  # within-matrix dims

    if not batched and len(red) == 1:
        out = _chunked_lse(A, include_zeros, over_cols=(red == [0]),
                           backend=backend)
        if out is not None:
            return _keep(out, red, False) if keepdim else out

    rows, cols, vals, b = _flat_indices(A)
    if red == [0]:        # over rows: one value per column
        seg_in, n_groups, width = cols, ncols, nrows
    elif red == [1]:      # over columns: one value per row
        seg_in, n_groups, width = rows, nrows, ncols
    else:                 # [0, 1]: one value per (batch) slice
        seg_in, n_groups, width = torch.zeros_like(rows), 1, nrows * ncols
    b_off = torch.arange(b, device=seg_in.device)[:, None] * n_groups
    seg = (seg_in + b_off).reshape(-1)
    total = b * n_groups
    n_zeros = width - _counts(seg, total) if include_zeros else None
    out = _scatter_logsumexp(vals.reshape(-1), seg, total, n_zeros).reshape(
        b, n_groups)
    if not batched:
        out = out[0]
        if len(red) == 2:
            out = out[0]  # scalar
    elif len(red) == 2:
        out = out[:, 0]
    return _keep(out, red, batched) if keepdim else out


def sparse_bidir_logsumexp(A: Union[SparseCOO, SparseCSR, SparseCSC],
                           keepdim: bool = False, include_zeros: bool = True,
                           output_layout: str = "tuple",
                           backend: str = "auto"):
    """Column- and row-wise log-sum-exp of one matrix together.

    Returns ``(col_lse, row_lse)``: the reduction over rows (one value
    per column) first, then over columns (one value per row).  With
    ``output_layout="padded"`` one dense ``(2, G)`` / ``(2, b, G)``
    tensor, ``G = max(n, m)``, padded with -inf.  ``"nested"`` raises:
    the JAX package has no ragged container either.

    2-D static patterns fill one DIA grid for both directions, or run
    both ELL grids with one CSR→CSC value reorder; otherwise each
    direction takes its own route, or both one stacked segment
    reduction.
    """
    _check_backend(backend)
    if isinstance(A, SparseCSC):
        res = sparse_bidir_logsumexp(A.transpose_csr(), keepdim=keepdim,
                                     include_zeros=include_zeros,
                                     output_layout=output_layout,
                                     backend=backend)
        if output_layout == "padded":
            return res.flip(0)       # (col, row) of Aᵀ == (row, col) of A
        c_t, r_t = res               # col-LSE of Aᵀ == row-LSE of A
        if keepdim:                  # keepdim's axes in A's orientation
            return r_t.reshape(1, -1), c_t.reshape(-1, 1)
        return r_t, c_t
    if not is_sparse(A):
        raise TypeError(
            "sparse_bidir_logsumexp: input must be SparseCOO/SparseCSR")
    if A.ndim not in (2, 3):
        raise NotImplementedError(
            f"sparse_bidir_logsumexp supports 2-D or batched 3-D input, got "
            f"ndim={A.ndim}")
    if output_layout == "nested":
        raise NotImplementedError(
            "output_layout='nested' has no JAX analogue (no ragged "
            "containers); use 'tuple' or 'padded'")
    if output_layout not in ("tuple", "padded"):
        raise ValueError(
            f"sparse_bidir_logsumexp: unknown output_layout "
            f"{output_layout!r}; expected 'tuple' or 'padded'")
    if keepdim and output_layout != "tuple":
        raise ValueError(
            "sparse_bidir_logsumexp: keepdim is only supported with "
            "output_layout='tuple'")

    batched = A.ndim == 3
    nrows, ncols = A.mat_shape
    G = max(nrows, ncols)

    if not batched:
        planned = _dia_lse_plan(A, backend)
        col_lse = row_lse = None
        if planned is None:
            fused = _bidir_fused_fn(A, include_zeros, backend)
            if fused is not None:
                col_lse, row_lse = fused(A.values)
        if row_lse is None:
            row_lse = _chunked_lse(A, include_zeros, over_cols=False,
                                   backend=backend, dia_planned=planned)
            col_lse = _chunked_lse(A, include_zeros, over_cols=True,
                                   backend=backend, dia_planned=planned) \
                if row_lse is not None else None
        if col_lse is not None:
            if output_layout == "padded":
                return torch.stack([
                    F.pad(col_lse, (0, G - ncols), value=NEG_INF),
                    F.pad(row_lse, (0, G - nrows), value=NEG_INF)])
            if keepdim:
                return col_lse[None, :], row_lse[:, None]
            return col_lse, row_lse

    rows, cols, vals, b = _flat_indices(A)
    # direction 0: col_lse (segment by column); 1: row_lse (by row)
    b_off = torch.arange(b, device=rows.device)[:, None] * G
    seg = torch.cat([(cols + b_off).reshape(-1),
                     (rows + b_off).reshape(-1) + b * G])
    total = 2 * b * G
    n_zeros = None
    if include_zeros:
        slot = torch.arange(b * G, device=rows.device) % G
        zero = torch.zeros_like(slot)
        width = torch.cat([torch.where(slot < ncols, nrows, zero),
                           torch.where(slot < nrows, ncols, zero)])
        n_zeros = width - _counts(seg, total)
    flat = vals.reshape(-1)
    padded = _scatter_logsumexp(torch.cat([flat, flat]), seg, total,
                                n_zeros).reshape(2, b, G)
    if output_layout == "padded":
        return padded if batched else padded[:, 0, :]
    col_lse, row_lse = padded[0, :, :ncols], padded[1, :, :nrows]
    if not batched:
        col_lse, row_lse = col_lse[0], row_lse[0]
    if keepdim:
        if batched:
            return col_lse[:, None, :], row_lse[:, :, None]
        return col_lse[None, :], row_lse[:, None]
    return col_lse, row_lse
