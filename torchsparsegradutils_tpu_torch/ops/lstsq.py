"""Sparse overdetermined least squares with sparsity-preserving gradients.

Port of ``torchsparsegradutils_tpu/ops/lstsq.py``:

* forward: a pluggable ``lstsq(A, B) -> x``; LSMR by default;
* backward: Golub & Pereyra (1973) eq. 4.12 for tall full-rank A (so
  ``A⁺A = I``): ``gradB = (Aᵀ)⁺ G`` and
  ``gradA = −gradB xᵀ − (Ax − B)(A⁺ gradB)ᵀ``, both rank-k terms sampled
  only at A's stored entries by :func:`~.spmm.sddmm`.

As in the JAX package the backward calls the raw solvers, so gradients
are first order only (the backward is ``once_differentiable``); use
``sparse_generic_solve`` for higher orders of a square system.

Example:
    >>> import numpy as np, torch
    >>> from torchsparsegradutils_tpu_torch import (SparseCOO,
    ...                                             sparse_generic_lstsq)
    >>> rows = np.array([0, 1, 2, 3, 3]); cols = np.array([0, 1, 0, 0, 1])
    >>> A = SparseCOO(rows, cols, torch.tensor([2.0, 1.0, 1.0, 0.5, 3.0]),
    ...               (4, 2))
    >>> b = torch.tensor([1.0, 2.0, 0.5, 1.5])
    >>> x = sparse_generic_lstsq(A, b)
    >>> ref = torch.linalg.lstsq(A.todense(), b[:, None]).solution[:, 0]
    >>> bool(torch.allclose(x, ref, atol=1e-4))
    True
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.autograd.function import once_differentiable

from ..types import is_sparse
from .solve import _match_rank
from .spmm import sddmm, sparse_mm

__all__ = ["sparse_generic_lstsq"]


def _default_lstsq(A, B, **kw):
    from ..solvers import lsmr
    return lsmr(A, B, **kw)[0]


def _default_transpose_lstsq(A, B, **kw):
    from ..solvers import lsmr
    return lsmr(A.T, B, **kw)[0]


def _cols(t: torch.Tensor) -> torch.Tensor:
    return t[:, None] if t.ndim == 1 else t


class _GenericLstsq(torch.autograd.Function):
    """``x = lstsq(A, B)`` over ``A.values`` and ``B``, with the
    Golub–Pereyra backward."""

    @staticmethod
    def forward(ctx, values, B, A, lstsq, transpose_lstsq, kwargs):
        x = _match_rank(lstsq(A.with_data(values), B, **kwargs), B.ndim)
        ctx.A, ctx.kwargs = A, kwargs
        ctx.lstsq, ctx.transpose_lstsq = lstsq, transpose_lstsq
        ctx.save_for_backward(values, B, x)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        values, B, x = ctx.saved_tensors
        A, kw = ctx.A.with_data(values), ctx.kwargs
        B2, x2 = _cols(B), _cols(x)
        gradB = _cols(ctx.transpose_lstsq(A, _cols(g).contiguous(), **kw))
        # term 1: -gradB x^T at the stored entries
        u1 = -sddmm(A, gradB, x2).values
        # term 2: (B - A x)(A^+ gradB)^T at the stored entries
        mresid = B2 - sparse_mm(A, x2)
        apgb = _cols(ctx.lstsq(A, gradB, **kw))
        u2 = sddmm(A, mresid, apgb).values
        d_B = gradB[:, 0] if g.ndim == 1 else gradB
        return u1 + u2, d_B, None, None, None, None


def sparse_generic_lstsq(A, B, lstsq: Optional[Callable] = None,
                         transpose_lstsq: Optional[Callable] = None,
                         **kwargs):
    """Solve ``min_x ‖A x − B‖₂²`` for tall full-column-rank sparse ``A``.

    Args:
      A: ``(m, n)`` sparse container with ``m >= n`` (full column rank
        assumed, not verified); its gradient lands on ``A.values``.
      B: dense ``(m,)`` or ``(m, k)`` on A's device.
      lstsq: ``lstsq(A, B) -> x``; default LSMR.
      transpose_lstsq: solver for the transpose problem ``(Aᵀ) Y = G``
        used in backward (receives A untransposed); default LSMR on
        ``Aᵀ``.
      **kwargs: forwarded to both solvers in forward and backward (e.g.
        ``settings=LSMRSettings(...)``).

    Returns:
      ``x`` of shape ``(n,)`` / ``(n, k)``.
    """
    if not is_sparse(A):
        raise TypeError("sparse_generic_lstsq: A must be SparseCOO/SparseCSR")
    if is_sparse(B):
        raise TypeError("sparse_generic_lstsq: B must be a dense array")
    if not isinstance(B, torch.Tensor):
        B = torch.as_tensor(B, device=A.device)
    if A.ndim != 2:
        raise ValueError("sparse_generic_lstsq: A must be a 2-D matrix")
    if A.shape[1] > A.shape[0]:
        raise ValueError(
            f"sparse_generic_lstsq: A should be a tall full-rank matrix, "
            f"got shape {A.shape}")
    if B.ndim not in (1, 2):
        raise ValueError("sparse_generic_lstsq: B must be 1-D or 2-D")
    if B.shape[0] != A.shape[0]:
        raise ValueError(
            f"sparse_generic_lstsq: incompatible shapes, A {A.shape} vs "
            f"B {tuple(B.shape)}")
    return _GenericLstsq.apply(
        A.values, B, A, lstsq if lstsq is not None else _default_lstsq,
        transpose_lstsq if transpose_lstsq is not None
        else _default_transpose_lstsq, kwargs)
