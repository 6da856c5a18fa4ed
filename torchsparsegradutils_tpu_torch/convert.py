"""Carry a sparse matrix between this package and plain arrays.

``from_arrays`` builds a container from numpy (or anything numpy can
read): a matrix exported from the JAX package with ``np.asarray`` on its
index and value arrays comes across unchanged, so both packages compute
on the same matrix.  ``to_arrays`` goes back.  ``params_from_arrays``
carries the flagship train parameters (``parallel/training.py``) the
same way.

Example:
    >>> import numpy as np
    >>> from torchsparsegradutils_tpu_torch import from_arrays, to_arrays
    >>> A = from_arrays("csr", np.array([0, 1, 2]), np.array([1, 0]),
    ...                 np.array([2.0, 3.0], np.float32), (2, 2),
    ...                 device="cpu")
    >>> to_arrays(A)[0], A.todense().tolist()
    ('csr', [[0.0, 2.0], [3.0, 0.0]])
"""

from __future__ import annotations

import numpy as np
import torch

from .types import SparseCOO, SparseCSC, SparseCSR

__all__ = ["from_arrays", "to_arrays", "params_from_arrays"]


def _tensor(arr) -> torch.Tensor:
    """A tensor of an array's values: float32, float64 and bfloat16 (as
    ``ml_dtypes`` arrays from JAX) keep their dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def from_arrays(layout: str, idx0, idx1, data, shape, *, device="cuda",
                pattern_static: bool = True):
    """Container from index and value arrays.

    Args:
      layout: ``"coo"`` (``idx0`` rows, ``idx1`` columns), ``"csr"``
        (``idx0`` row pointers, ``idx1`` column indices) or ``"csc"``
        (``idx0`` column pointers, ``idx1`` row indices; 2-D only).
      data: ``(*batch, nnz)`` values; float32, float64 or bfloat16 arrays
        keep their dtype.
      shape: ``(*batch, n, m)``.
      device: where the values go (and the indices of a dynamic
        pattern).
      pattern_static: False builds a dynamic container.
    """
    if not isinstance(data, torch.Tensor):
        data = _tensor(data)
    data = data.to(device)
    idx0, idx1 = np.asarray(idx0), np.asarray(idx1)
    kw = dict(pattern_static=pattern_static)
    if layout == "coo":
        return SparseCOO(idx0, idx1, data, shape, **kw)
    if layout == "csr":
        return SparseCSR(idx0, idx1, data, shape, **kw)
    if layout == "csc":
        return SparseCSC(idx0, idx1, data, shape, **kw)
    raise ValueError(f"from_arrays: unknown layout {layout!r}")


def to_arrays(A):
    """``(layout, idx0, idx1, data, shape)`` of a container, all numpy.

    The inverse of :func:`from_arrays`.  numpy has no bfloat16, so
    bfloat16 values come back as float32 (exactly).  A dynamic pattern
    is copied to the host, as the values are: the copy is what is asked.
    """
    vals = A.values.detach()
    if vals.dtype == torch.bfloat16:
        vals = vals.float()
    data = vals.cpu().numpy()
    if not A.pattern_static:
        if isinstance(A, SparseCOO):
            return "coo", A.row.cpu().numpy(), A.col.cpu().numpy(), data, \
                A.shape
        layout = "csr" if isinstance(A, SparseCSR) else "csc"
        return layout, A.indptr.cpu().numpy(), A.indices.cpu().numpy(), \
            data, A.shape
    if isinstance(A, SparseCOO):
        return "coo", A.rows(), A.cols(), data, A.shape
    if isinstance(A, SparseCSR):
        return "csr", A.indptr_np(), A.cols(), data, A.shape
    if isinstance(A, SparseCSC):
        return "csc", A.indptr.arr, A.indices.arr, data, A.shape
    raise TypeError(f"to_arrays: expected SparseCOO, SparseCSR or "
                    f"SparseCSC, got {type(A).__name__}")


def params_from_arrays(params, *, device="cuda") -> dict:
    """The flagship train parameters (``{"values", "log_diag", "loc"}``,
    e.g. the JAX package's ``init_params`` output through ``np.asarray``)
    as tensors on ``device``, dtypes kept."""
    missing = {"values", "log_diag", "loc"} - set(params)
    if missing:
        raise ValueError(f"params_from_arrays: missing {sorted(missing)}")
    return {k: _tensor(v).to(device) for k, v in params.items()}
