"""Sparse @ dense matmul with sparsity-preserving gradients, and SDDMM.

Port of ``torchsparsegradutils_tpu/ops/spmm.py``:

* ``sparse_mm(A, B)``: the gradient of ``A`` is an SDDMM taken only at
  A's stored entries, and lands on ``A.values``; the gradient of ``B`` is
  ``Aᵀ G``.  Nothing of the dense ``(n, m)`` shape is built.
* ``sddmm(A, X, Y)``: ``dot(X[i], Y[j])`` at A's pattern.

Dispatch, per 2-D pattern (the JAX package's ``_spmm_forward`` and
``_sddmm_values``):

* ``backend="auto"`` or ``"dia"``: the DIA engine (``kernels/dia.py``)
  when the pattern qualifies; ``"dia"`` raises when it does not.
* ``"pallas"``: the chunk engine (``kernels/chunk_spmm.py``) on any
  device; on the CPU its kernels' plain versions run.
* ``"auto"`` on CUDA tensors, for a pattern with no DIA plan: the chunk
  engine.  On the CPU ``"auto"`` keeps the generic branch, as the JAX
  package does off the TPU.
* ``"xla"``, and patterns with no plan (the chunk engine needs rows in
  sorted order, and a dynamic pattern, ``pattern_static=False``, has
  none): the JAX package's generic gather + segment-sum branch, in
  PyTorch ``index_select`` + ``index_add``, as one
  ``torch.autograd.Function`` each (the JAX package's ``_dyn_spmm`` and
  ``_dyn_sddmm``) with no host read.  ``"dia"``, ``"pallas"`` and
  ``"ell"`` need a plan and refuse a dynamic pattern.
* ``"ell"``: the ELL engine (``kernels/ell.py``), on every device: the
  forward over the row-ELL plan, ``sddmm`` the ELL SDDMM, and in the
  backward gradA the ELL SDDMM and gradB the column-ELL plan's SpMM.  A
  direction with no plan (an empty or skewed pattern) takes the generic
  branch there, and per-element batched patterns take it throughout,
  as in the JAX package.  The value relayouts run the K3 gather.

The JAX package gates the chunk engine at p >= 32 and f32/bf16, because
its kernels pad p to 128 lanes and compute in f32; the CUDA kernels pad
nothing and take f32, bf16 and f64, so ``"auto"`` routes every p and all
three dtypes to them (``ROADMAP.md`` section 3).

The gradients come from autograd through differentiable pieces: the DIA
and chunk engines' Functions (whose backwards call each other; ``Aᵀ G``
runs the chunk SpMM over the transpose plan at every p) and PyTorch's
gather and scatter.  Higher derivatives work.

Example:
    >>> import numpy as np, torch
    >>> from torchsparsegradutils_tpu_torch import SparseCOO, sparse_mm
    >>> A = SparseCOO(np.array([0, 0, 1]), np.array([0, 2, 1]),
    ...               torch.tensor([1.0, 2.0, 3.0], requires_grad=True),
    ...               (2, 3))
    >>> out = sparse_mm(A, torch.ones(3, 2))
    >>> out.sum().backward()
    >>> A.values.grad.shape    # gradient only at the 3 stored entries
    torch.Size([3])
"""

from __future__ import annotations

from typing import Union

import torch

from ..kernels.chunk_spmm import ChunkSddmm, ChunkSpmm, build_chunk_plan
from ..kernels.dia import (build_dia_plan, chunk_bwd_fused_arg, dia_sddmm,
                           dia_spmm)
from ..kernels.ell import EllOperator, EllSddmm, EllSpmm
from ..types import SparseCOO, SparseCSR, is_sparse, refuse_dynamic

__all__ = ["sparse_mm", "sddmm"]


def _check_backend(backend: str):
    if backend not in ("auto", "dia", "ell", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                         "'dia', 'ell', 'pallas' or 'xla'")


def _dia_plan(A, backend: str):
    """DIA plan of a 2-D pattern, or None; ``backend="dia"`` raises when
    the pattern does not qualify."""
    if backend not in ("auto", "dia"):
        return None
    rs, cs = A.row_sa(), A.col_sa()
    plan = None
    if rs is not None and rs.arr.ndim == 1:
        plan = build_dia_plan(rs, cs, *A.mat_shape)
    if plan is None and backend == "dia":
        raise ValueError(
            "backend='dia' requires a static 2-D diagonal-structured "
            "pattern (<=256 diagonal offsets covering >=70% of nnz); "
            "this pattern does not qualify — use backend='auto' for "
            "automatic dispatch")
    return plan


def _chunk_plan(A, backend: str):
    """Chunk row plan of a 2-D pattern when the chunk engine should run
    it (the JAX package's ``_pallas_ok``, ``_spmv_ok`` and
    ``_chunk_plan``), else None: on ``backend="pallas"``, or ``"auto"``
    with A on the card; None too for unsorted rows."""
    if not (backend == "pallas"
            or (backend == "auto" and A.device.type == "cuda")):
        return None
    rs = A.row_sa()
    if rs is None or rs.arr.ndim != 1:
        return None
    return build_chunk_plan(rs, A.col_sa(), *A.mat_shape)


def _fallback_spmm(n, rows, cols, values, B):
    """Generic A @ B: gather B rows, scale, segment-sum into rows."""
    prod = values[:, None] * B.index_select(0, cols)
    out = torch.zeros((n, B.shape[-1]), dtype=B.dtype, device=B.device)
    return out.index_add(0, rows, prod)


def _regathered(saved, src, idx):
    """A gather the forward kept, or under ``create_graph`` the gather
    taken again, so that a higher derivative reaches ``src``."""
    return src.index_select(0, idx) if torch.is_grad_enabled() else saved


class _GenericSpmm(torch.autograd.Function):
    """The generic ``A @ B`` over int64 ``rows`` and ``cols`` (the JAX
    package's ``_dyn_spmm``): gradA is the generic SDDMM at the pattern
    over the forward's gathered B rows, gradB the ``index_add``
    transpose; both take one gather of the cotangent's rows.  The
    backward is made of differentiable ops, so higher derivatives
    work."""

    @staticmethod
    def forward(ctx, values, B, rows, cols, n):
        B_cols = B.index_select(0, cols)
        ctx.save_for_backward(values, B, rows, cols,
                              B_cols if ctx.needs_input_grad[0] else None)
        return B.new_zeros((n, B.shape[-1])).index_add(
            0, rows, values[:, None] * B_cols)

    @staticmethod
    def backward(ctx, g):
        values, B, rows, cols, B_cols = ctx.saved_tensors
        g_rows = g.index_select(0, rows)
        d_values = d_B = None
        if ctx.needs_input_grad[0]:
            d_values = (g_rows * _regathered(B_cols, B, cols)).sum(-1)
        if ctx.needs_input_grad[1]:
            d_B = B.new_zeros(B.shape).index_add(0, cols,
                                                 values[:, None] * g_rows)
        return d_values, d_B, None, None, None


class _GenericSddmm(torch.autograd.Function):
    """The generic SDDMM over int64 ``rows`` and ``cols`` (the JAX
    package's ``_dyn_sddmm``): gradX and gradY are ``index_add`` SpMMs
    of the cotangent over the forward's gathered rows."""

    @staticmethod
    def forward(ctx, X, Y, rows, cols):
        X_rows, Y_cols = X.index_select(0, rows), Y.index_select(0, cols)
        ctx.save_for_backward(X, Y, rows, cols,
                              X_rows if ctx.needs_input_grad[1] else None,
                              Y_cols if ctx.needs_input_grad[0] else None)
        return (X_rows * Y_cols).sum(-1)

    @staticmethod
    def backward(ctx, g):
        X, Y, rows, cols, X_rows, Y_cols = ctx.saved_tensors
        d_X = d_Y = None
        if ctx.needs_input_grad[0]:
            d_X = X.new_zeros(X.shape).index_add(
                0, rows, g[:, None] * _regathered(Y_cols, Y, cols))
        if ctx.needs_input_grad[1]:
            d_Y = Y.new_zeros(Y.shape).index_add(
                0, cols, g[:, None] * _regathered(X_rows, X, rows))
        return d_X, d_Y, None, None


def _refuse_planned(A, backend: str):
    """A dynamic pattern has no plan: the backends that need one refuse
    it (``"dia"`` with the JAX package's own message)."""
    if A.pattern_static:
        return
    if backend == "dia":
        _dia_plan(A, backend)
    if backend in ("pallas", "ell"):
        refuse_dynamic(f"backend={backend!r}")


def _spmm_2d(backend, A, B, grad_precision="exact"):
    _refuse_planned(A, backend)
    if backend == "ell":
        return EllSpmm.apply(EllOperator.of(A), A.values, B)
    plan = _dia_plan(A, backend)
    fused = chunk_bwd_fused_arg(grad_precision)
    if plan is not None:
        return dia_spmm(plan, A.values, B, fused)
    cplan = _chunk_plan(A, backend)
    if cplan is not None:
        return ChunkSpmm.apply(cplan, A.values, B, fused)
    return _GenericSpmm.apply(A.values, B, A.rows_t(), A.cols_t(),
                              A.shape[-2])


def _sddmm_2d(backend, A, X, Y):
    _refuse_planned(A, backend)
    if backend == "ell":
        return EllSddmm.apply(EllOperator.of(A), X, Y)
    plan = _dia_plan(A, backend)
    if plan is not None:
        return dia_sddmm(plan, X, Y)
    cplan = _chunk_plan(A, backend)
    if cplan is not None:
        return ChunkSddmm.apply(cplan, X, Y)
    return _GenericSddmm.apply(X, Y, A.rows_t(), A.cols_t())


def _shared_elem(A):
    """2-D container over the shared pattern of a batched container."""
    if isinstance(A, SparseCOO):
        return SparseCOO(A.row, A.col, A.values[0], A.mat_shape,
                         pattern_static=A.pattern_static)
    return SparseCSR(A.indptr, A.indices, A.values[0], A.mat_shape,
                     pattern_static=A.pattern_static)


def _batch_index(A, idx: torch.Tensor, size: int) -> torch.Tensor:
    """Per-element (b, nnz) indices into the flattened (b * size) rows."""
    b = A.shape[0]
    off = torch.arange(b, device=idx.device)[:, None] * size
    return (idx + off).reshape(-1)


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _check_sparse_dense(A, B, op_name: str):
    if not is_sparse(A):
        raise TypeError(f"{op_name}: A must be SparseCOO or SparseCSR, "
                        f"got {type(A).__name__}")
    if is_sparse(B):
        raise TypeError(f"{op_name}: B must be a dense array, got sparse")
    if not isinstance(B, torch.Tensor):
        B = torch.as_tensor(B, device=A.device)
    if A.ndim not in (2, 3):
        raise ValueError(f"{op_name}: A must be 2-D or batched 3-D, "
                         f"got {A.ndim}-D")
    if A.dtype != B.dtype:
        raise ValueError(f"{op_name}: dtype mismatch, A is {_dt(A.dtype)} "
                         f"and B is {_dt(B.dtype)}")
    if A.device != B.device:
        raise ValueError(f"{op_name}: device mismatch, A is on {A.device} "
                         f"and B is on {B.device}")
    return B


def sparse_mm(A: Union[SparseCOO, SparseCSR], B, *, backend: str = "auto",
              grad_precision: str = "exact"):
    """Multiply a sparse matrix by a dense matrix: ``A @ B``.

    Args:
      A: ``(n, m)`` or batched ``(b, n, m)`` sparse container.  Its
        gradient lands on ``A.values``, at the stored entries only.
      B: dense ``(m, p)`` or ``(b, m, p)`` tensor on A's device; batch
        dims must match A's (one side may be unbatched and is broadcast).
      backend: ``"auto"`` | ``"dia"`` | ``"ell"`` (the ELL engine) |
        ``"pallas"`` (the chunk engine) | ``"xla"``.
      grad_precision: ``"exact"`` or ``"fast"``.  ``"fast"`` rounds the
        fused chunk backward's products ``values[e] · G[row_e]`` to
        bfloat16 before their column sum (under
        ``kernels/dia.py:SPMM_BWD = "fused"``, on the chunk path and a
        hybrid residual): gradB gains about 1e-3 relative error, gradA
        stays exact.  Every other path is exact under either.

    Returns:
      Dense ``(n, p)`` or ``(b, n, p)`` tensor.
    """
    B = _check_sparse_dense(A, B, "sparse_mm")
    if B.ndim not in (2, 3):
        raise ValueError(f"sparse_mm: B must be 2-D or batched 3-D, got "
                         f"{B.ndim}-D")
    if A.shape[-1] != B.shape[-2]:
        raise ValueError(f"sparse_mm: inner dims disagree, A has shape "
                         f"{A.shape} and B has shape {tuple(B.shape)}")
    if A.ndim == 3 and B.ndim == 3 and A.shape[0] != B.shape[0]:
        raise ValueError(f"sparse_mm: batch dims disagree, {A.shape[0]} vs "
                         f"{B.shape[0]}")
    _check_backend(backend)
    if grad_precision not in ("exact", "fast"):
        raise ValueError(f"sparse_mm: grad_precision must be 'exact' or "
                         f"'fast', got {grad_precision!r}")

    if A.ndim == 2 and B.ndim == 2:
        return _spmm_2d(backend, A, B, grad_precision)
    if A.ndim == 2:  # B batched
        return torch.stack([_spmm_2d(backend, A, b, grad_precision)
                            for b in B.unbind(0)])
    if A.pattern_static and not A.indices_batched():
        # shared pattern: one plan, loop the batch
        A0 = _shared_elem(A)
        return torch.stack([
            _spmm_2d(backend, A0.with_data(A.values[i]),
                     B if B.ndim == 2 else B[i], grad_precision)
            for i in range(A.shape[0])])
    # per-element or dynamic patterns: the generic branch over the
    # flattened batch
    _refuse_planned(A, backend)
    b, n, m = A.shape
    p = B.shape[-1]
    rows = _batch_index(A, A.rows_t(), n)
    if B.ndim == 2:
        cols, Bf = A.cols_t().expand(b, A.nnz).reshape(-1), B
    else:
        cols, Bf = _batch_index(A, A.cols_t(), m), B.reshape(b * m, p)
    return _GenericSpmm.apply(A.values.reshape(-1), Bf, rows, cols,
                              b * n).view(b, n, p)


def sddmm(A: Union[SparseCOO, SparseCSR], X, Y, *, backend: str = "auto"):
    """Sampled dense-dense matmul: ``X @ Yᵀ`` at A's pattern.

    Args:
      A: sparse container giving the pattern (its values are not used),
        shape ``(n, m)`` or ``(b, n, m)``.
      X: dense ``(n, k)`` or batched ``(b, n, k)``.
      Y: dense ``(m, k)`` or batched.

    Returns:
      A container with A's pattern and values
      ``v[e] = dot(X[row[e]], Y[col[e]])``, differentiable in X and Y.
    """
    if not is_sparse(A):
        raise TypeError("sddmm: A must be SparseCOO or SparseCSR")
    X = X if isinstance(X, torch.Tensor) else torch.as_tensor(
        X, device=A.device)
    Y = Y if isinstance(Y, torch.Tensor) else torch.as_tensor(
        Y, device=A.device)
    if X.ndim != Y.ndim or X.shape[-1] != Y.shape[-1]:
        raise ValueError(f"sddmm: X {tuple(X.shape)} and Y {tuple(Y.shape)} "
                         "must share ndim and trailing (contraction) dim")
    if X.shape[-2] != A.shape[-2] or Y.shape[-2] != A.shape[-1]:
        raise ValueError(f"sddmm: X {tuple(X.shape)} / Y {tuple(Y.shape)} "
                         f"do not match pattern shape {A.shape}")
    _check_backend(backend)
    if A.ndim == 2 and X.ndim == 2:
        return A.with_data(_sddmm_2d(backend, A, X, Y))
    if A.ndim == 2 and X.ndim == 3:
        raise ValueError("sddmm: batched X/Y with an unbatched pattern is "
                         "ambiguous; pass a batched pattern container")
    if A.ndim == 3:
        b, n, m = A.shape
        if X.ndim == 2:
            X = X.expand((b,) + tuple(X.shape))
            Y = Y.expand((b,) + tuple(Y.shape))
        if A.pattern_static and not A.indices_batched():
            A0 = _shared_elem(A)
            vals = torch.stack([_sddmm_2d(backend, A0, X[i], Y[i])
                                for i in range(b)])
        else:
            _refuse_planned(A, backend)
            k = X.shape[-1]
            vals = _GenericSddmm.apply(
                X.reshape(b * n, k), Y.reshape(b * m, k),
                _batch_index(A, A.rows_t(), n),
                _batch_index(A, A.cols_t(), m)).view(b, -1)
        return A.with_data(vals)
    raise ValueError(f"sddmm: unsupported ndim combination A={A.ndim}, "
                     f"X={X.ndim}")
