"""Pluggable-solver sparse linear solve with implicit-function-theorem
gradients.

Port of ``torchsparsegradutils_tpu/ops/solve.py``:

* forward: any ``solve(A, B, **kwargs) -> x`` callable, including ones
  that are not differentiable (the Krylov solvers of ``solvers``, which
  run under ``torch.no_grad()``); MINRES by default;
* backward (implicit function theorem): ``gradB = A⁻ᵀ G`` by calling
  ``sparse_generic_solve`` again with ``solve`` and ``transpose_solve``
  swapped, which makes a new differentiable node, so higher-order
  gradients work; and ``gradA[i, j] = −dot(gradB[i, :], x[j, :])``
  sampled at A's stored entries by :func:`~.spmm.sddmm`.

``transpose_solve(A, G, **kwargs)`` must solve ``Aᵀ Y = G`` (it gets A
untransposed).  The default MINRES assumes symmetry, so
``transpose_solve = solve``.  The JAX package caches one custom VJP per
solver pair and (hashable) kwargs; here the node is a
``torch.autograd.Function`` over ``A.values`` and ``B``, and kwargs may
be anything.

Example:
    >>> import torch
    >>> from torchsparsegradutils_tpu_torch import sparse_generic_solve
    >>> from torchsparsegradutils_tpu_torch.solvers import (
    ...     LinearCGSettings, linear_cg)
    >>> from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    ...     make_spd_sparse)
    >>> A = make_spd_sparse(16, 16 + 2 * 20, device="cpu")
    >>> b = torch.ones(16)
    >>> x = sparse_generic_solve(A, b, solve=linear_cg,
    ...                          settings=LinearCGSettings(max_iter=100))
    >>> bool(torch.allclose(A.todense() @ x, b, atol=1e-3))
    True
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from ..types import is_sparse
from .spmm import sddmm

__all__ = ["sparse_generic_solve"]


def _default_solver():
    from ..solvers import minres
    return minres


def _match_rank(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A solver's output at the rank of its right-hand side (a solver may
    return (n, 1) for a vector or (n,) for one column)."""
    if ndim == 1 and x.ndim == 2 and x.shape[1] == 1:
        return x[:, 0]
    if ndim == 2 and x.ndim == 1:
        return x[:, None]
    return x


class _GenericSolve(torch.autograd.Function):
    """``x = solve(A, B)`` over ``A.values`` and ``B``; the backward is
    built of differentiable ops (another ``sparse_generic_solve`` and
    ``sddmm``), so it can be differentiated again."""

    @staticmethod
    def forward(ctx, values, B, A, solve, transpose_solve, kwargs):
        x = solve(A.with_data(values), B, **kwargs)
        if x.dtype != values.dtype:
            x = x.to(values.dtype)
        x = _match_rank(x, B.ndim)
        ctx.A, ctx.kwargs = A, kwargs
        ctx.solve, ctx.transpose_solve = solve, transpose_solve
        ctx.save_for_backward(values, x)
        return x

    @staticmethod
    def backward(ctx, g):
        values, x = ctx.saved_tensors
        A = ctx.A.with_data(values)
        gradB = sparse_generic_solve(A, g.contiguous(),
                                     solve=ctx.transpose_solve,
                                     transpose_solve=ctx.solve, **ctx.kwargs)
        if gradB.dtype != values.dtype:
            gradB = gradB.to(values.dtype)
        # gradA[i,j] = -dot(gradB[i,:], x[j,:]) at A's stored entries
        gradB2 = gradB[:, None] if gradB.ndim == 1 else gradB
        x2 = x[:, None] if x.ndim == 1 else x
        gvals = -sddmm(A, gradB2, x2).values
        return gvals, gradB, None, None, None, None


def sparse_generic_solve(A, B, solve: Optional[Callable] = None,
                         transpose_solve: Optional[Callable] = None,
                         **kwargs):
    """Solve ``A x = B`` (square sparse A) with a pluggable solver and
    sparsity-preserving IFT gradients.

    Args:
      A: ``(n, n)`` sparse container; its gradient lands on ``A.values``.
      B: dense ``(n,)`` or ``(n, k)`` on A's device.
      solve: ``solve(A, B, **kwargs) -> x``; default MINRES.
      transpose_solve: solver for ``Aᵀ Y = G`` in the backward pass
        (receives A untransposed); defaults to ``solve``.
      **kwargs: forwarded to both solvers in forward and backward.

    Returns:
      ``x`` shaped like ``B``.
    """
    if not is_sparse(A):
        raise TypeError("sparse_generic_solve: A must be SparseCOO/SparseCSR")
    if is_sparse(B):
        raise TypeError("sparse_generic_solve: B must be a dense array")
    if not isinstance(B, torch.Tensor):
        B = torch.as_tensor(B, device=A.device)
    if A.ndim != 2:
        raise ValueError("sparse_generic_solve: A must be a 2-D matrix")
    if A.shape[0] != A.shape[1]:
        raise ValueError("sparse_generic_solve: A must be square")
    if B.ndim not in (1, 2):
        raise ValueError("sparse_generic_solve: B must be 1-D or 2-D")
    if B.shape[0] != A.shape[0]:
        raise ValueError(
            f"sparse_generic_solve: incompatible shapes, A {A.shape} vs "
            f"B {tuple(B.shape)}")
    if A.dtype != B.dtype:
        warnings.warn(
            f"sparse_generic_solve: A and B have different dtypes "
            f"(A={A.dtype}, B={B.dtype}); this may affect solver behaviour",
            UserWarning, stacklevel=2)

    if solve is None and transpose_solve is None:
        solve = transpose_solve = _default_solver()
    elif solve is None:
        solve = transpose_solve
    elif transpose_solve is None:
        transpose_solve = solve
    return _GenericSolve.apply(A.values, B, A, solve, transpose_solve,
                               kwargs)
