"""``torch.sparse`` tensors in and out of the port's containers, and the
``torch.sparse`` front end of ``sparse_mm`` and the sparse solve.

Port of ``torchsparsegradutils_tpu/interop/torch_bridge.py``.  There,
torch users call the JAX library with ``torch.sparse`` tensors and get
``∂L/∂A`` at A's stored entries, the original reference library's own
calling convention; two frameworks meet, so values travel through host
numpy.  Here the library is torch, so the bridge is a change of
container on the tensor's own device:

* ``from_torch_coo`` / ``from_torch_csr``: a 2-D ``torch.sparse_coo``
  (coalesced first) or ``torch.sparse_csr`` tensor -> ``SparseCOO`` /
  ``SparseCSR``.  The values stay on the tensor's device, in its
  autograd graph; the pattern is read to the host once (a container's
  pattern is host numpy, the key of the cached plans), and the tensor's
  own index tensors serve as the pattern's device copy.
* ``to_torch_coo`` / ``to_torch_csr``: back, on the container's device.
* ``sparse_mm_torch(A_t, B)`` and ``sparse_solve_torch(A_t, B, ...)``:
  ``sparse_mm`` and ``sparse_generic_solve`` on a ``torch.sparse`` A;
  the gradient lands on ``A_t.values()`` (the coalesced values of a COO
  tensor, the values of a CSR one) at the stored entries, and on B.
  These are the JAX package's ``sparse_mm_j4t`` and ``sparse_solve_j4t``.

The JAX package's dense converters ``t2j`` / ``j2t`` have no
counterpart: the port's dense arrays are torch tensors already.

Example:
    >>> import torch
    >>> from torchsparsegradutils_tpu_torch.interop import sparse_mm_torch
    >>> v = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    >>> A = torch.sparse_coo_tensor(torch.tensor([[0, 0, 1], [0, 2, 1]]),
    ...                             v, (2, 3))
    >>> sparse_mm_torch(A, torch.ones(3, 2)).sum().backward()
    >>> v.grad.tolist()            # ∂L/∂A at the 3 stored entries
    [2.0, 2.0, 2.0]
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.solve import sparse_generic_solve
from ..ops.spmm import sparse_mm
from ..types import SparseCOO, SparseCSR, is_sparse

__all__ = ["from_torch_coo", "from_torch_csr", "to_torch_coo",
           "to_torch_csr", "sparse_mm_torch", "sparse_solve_torch"]


def _check(tensor, layout, name: str):
    if not isinstance(tensor, torch.Tensor) or tensor.layout != layout:
        got = getattr(tensor, "layout", type(tensor).__name__)
        raise TypeError(f"{name}: expected a {layout} tensor, got {got}")
    if tensor.ndim != 2:
        raise ValueError(f"{name}: only 2-D torch sparse tensors are "
                         f"supported, got {tensor.ndim}-D")


def _with_device_indices(sa, t: torch.Tensor):
    """``sa`` with ``t`` (int64, on the values' device) as its device
    copy, so ``StaticArray.on`` uploads nothing."""
    sa._dev.setdefault(t.device, t.to(torch.int64).contiguous())
    return sa


def from_torch_coo(tensor, *, pattern_static: bool = True) -> SparseCOO:
    """2-D ``torch.sparse_coo`` tensor -> :class:`SparseCOO` (coalesced,
    row-major), its values ``tensor.coalesce().values()`` on the
    tensor's device, differentiable.  ``pattern_static=False`` keeps the
    indices of a coalesced tensor on its device as a dynamic pattern."""
    _check(tensor, torch.sparse_coo, "from_torch_coo")
    if not pattern_static:
        if not tensor.is_coalesced():
            raise ValueError(
                "from_torch_coo(pattern_static=False) needs a coalesced "
                "tensor: coalescing reads the pattern back to the host "
                "(call tensor.coalesce() first)")
        idx = tensor.indices()
        return SparseCOO(idx[0], idx[1], tensor.values(), tuple(tensor.shape),
                         pattern_static=False)
    t = tensor.coalesce()
    idx = t.indices()
    A = SparseCOO(idx[0], idx[1], t.values(), tuple(t.shape))
    _with_device_indices(A.row, idx[0])
    _with_device_indices(A.col, idx[1])
    return A


def from_torch_csr(tensor, *, pattern_static: bool = True) -> SparseCSR:
    """2-D ``torch.sparse_csr`` tensor -> :class:`SparseCSR`, its values
    ``tensor.values()`` on the tensor's device, differentiable.
    ``pattern_static=False`` keeps its device indices as a dynamic
    pattern."""
    _check(tensor, torch.sparse_csr, "from_torch_csr")
    if not pattern_static:
        return SparseCSR(tensor.crow_indices(), tensor.col_indices(),
                         tensor.values(), tuple(tensor.shape),
                         pattern_static=False)
    A = SparseCSR(tensor.crow_indices(), tensor.col_indices(),
                  tensor.values(), tuple(tensor.shape))
    _with_device_indices(A.indices, tensor.col_indices())
    return A


def _as_2d(A, name: str):
    if not is_sparse(A) or A.ndim != 2:
        raise TypeError(f"{name} expects an unbatched 2-D sparse container")
    return A


def to_torch_coo(A) -> torch.Tensor:
    """Container -> ``torch.sparse_coo`` tensor on its device (its
    entries in the container's order, differentiable in the values)."""
    _as_2d(A, "to_torch_coo")
    idx = torch.stack([A.rows_t(), A.cols_t()])
    return torch.sparse_coo_tensor(idx, A.values, A.shape)


def to_torch_csr(A) -> torch.Tensor:
    """Container -> ``torch.sparse_csr`` tensor on its device (a COO
    container is sorted to CSR first)."""
    _as_2d(A, "to_torch_csr")
    if not isinstance(A, SparseCSR):
        A = A.tocsr()
    return torch.sparse_csr_tensor(A.indptr_t(), A.cols_t(), A.values,
                                   A.shape)


def _from_torch(tensor, pattern_static: bool = True):
    if isinstance(tensor, torch.Tensor) and tensor.layout == torch.sparse_csr:
        return from_torch_csr(tensor, pattern_static=pattern_static)
    return from_torch_coo(tensor, pattern_static=pattern_static)


def sparse_mm_torch(A_t, B, *, pattern_static: bool = True, **kwargs):
    """``sparse_mm`` with a ``torch.sparse`` COO or CSR A: ``A_t @ B``,
    the gradient of A at its stored entries, on ``A_t.values()`` (the
    coalesced values of a COO tensor).  ``pattern_static`` goes to
    :func:`from_torch_coo` / :func:`from_torch_csr`, ``kwargs`` to
    ``sparse_mm`` (``backend``, ``grad_precision``)."""
    return sparse_mm(_from_torch(A_t, pattern_static), B, **kwargs)


def sparse_solve_torch(A_t, B, solve: Optional[Callable] = None,
                       transpose_solve: Optional[Callable] = None, **kwargs):
    """``sparse_generic_solve`` with a ``torch.sparse`` COO or CSR A:
    ``A_t x = B`` by ``solve`` (MINRES by default), with the implicit
    gradients, A's at its stored entries on ``A_t.values()``."""
    return sparse_generic_solve(_from_torch(A_t), B, solve=solve,
                                transpose_solve=transpose_solve, **kwargs)
