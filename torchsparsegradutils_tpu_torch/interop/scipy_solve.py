"""SciPy host solvers for ``sparse_generic_solve``, with the port's
implicit gradients.

Port of ``torchsparsegradutils_tpu/interop/scipy_solve.py`` (the
reference's CuPy/SciPy backend, ``sparse_solve_c4t``): a registry of
``scipy.sparse.linalg`` solvers ("cg", "cgs", "minres", "gmres",
"bicgstab", "lsmr", "spsolve"), the tolerance-name remap between
``tol`` and ``rtol``, one LU factorisation shared by the forward and the
backward's ``trans="T"`` solve, and a single-right-hand-side guard for
the iterative methods.

The host solve is the caller's explicit choice: A's values and B go to
the host in float64, SciPy solves there, and the result comes back in
B's dtype on B's device.  The gradients come from
``sparse_generic_solve``'s implicit-function-theorem backward, so the
host solver need not be differentiable, and gradA (an SDDMM at A's
pattern) runs on the card's kernels (K2 on a DIA pattern, K7 on a
row-sorted one) where A lies there.

Example:
    >>> import torch
    >>> from torchsparsegradutils_tpu_torch.interop import sparse_solve_scipy
    >>> from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    ...     make_spd_sparse)
    >>> A = make_spd_sparse(16, 48, device="cpu")
    >>> b = torch.ones(16)
    >>> x = sparse_solve_scipy(A, b)
    >>> bool(torch.allclose(A.todense() @ x, b, atol=1e-4))
    True
"""

from __future__ import annotations

import hashlib
import inspect
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

try:
    import scipy.sparse as _sps
    import scipy.sparse.linalg as _spl
    have_scipy = True
except ImportError:  # pragma: no cover
    have_scipy = False

from ..ops.solve import sparse_generic_solve
from ..types import is_sparse

__all__ = ["have_scipy", "sparse_solve_scipy", "scipy_solver"]

_ITERATIVE = {"cg", "cgs", "minres", "gmres", "bicgstab", "lsmr"}
_DIRECT = {"spsolve"}

# Host LU cache: the forward factorises A once and the backward reuses
# it with a transposed solve (the reference's ``factorized(A)`` and
# ``trans="T"``).  Keyed on (pattern, value bytes); a small FIFO.
_LU_CACHE: dict = {}
_LU_CACHE_MAX = 8


def _lu_for(pat_key, data64, M_csc):
    key = (pat_key, hashlib.sha1(data64.tobytes()).digest())
    lu = _LU_CACHE.get(key)
    if lu is None:
        lu = _spl.splu(M_csc)
        if len(_LU_CACHE) >= _LU_CACHE_MAX:
            _LU_CACHE.pop(next(iter(_LU_CACHE)))
        _LU_CACHE[key] = lu
    return lu


def _remap_tol_kwargs(fn: Callable, kwargs: dict) -> dict:
    """Tolerance keyword names adapted to the solver's signature; other
    keywords it does not take are dropped."""
    params = inspect.signature(fn).parameters
    out = dict(kwargs)
    if "tol" in out and "tol" not in params and "rtol" in params:
        out["rtol"] = out.pop("tol")
    if "rtol" in out and "rtol" not in params and "tol" in params:
        out["tol"] = out.pop("rtol")
    return {k: v for k, v in out.items() if k in params}


@lru_cache(maxsize=None)
def _scipy_solver_cached(method: str, transpose: bool, fkw: tuple):
    return _make_scipy_solver(method, transpose, dict(fkw))


def scipy_solver(method: str = "spsolve", transpose: bool = False,
                 **solver_kwargs) -> Callable:
    """A ``solve(A, B, **kw)`` running SciPy's ``method`` on the host,
    for ``sparse_generic_solve``'s ``solve=`` and ``transpose_solve=``
    (``transpose=True`` solves ``Aᵀ x = B``).  Cached, so equal
    arguments give one solver."""
    return _scipy_solver_cached(method, transpose,
                                tuple(sorted(solver_kwargs.items())))


def _make_scipy_solver(method: str, transpose: bool,
                       solver_kwargs: dict) -> Callable:
    if not have_scipy:
        raise ImportError("scipy is required for the scipy solver backend")
    if method not in _ITERATIVE | _DIRECT:
        raise ValueError(
            f"unknown scipy solver {method!r}; expected one of "
            f"{sorted(_ITERATIVE | _DIRECT)}")

    def solve(A, B, **kwargs):
        if not is_sparse(A):
            raise TypeError("scipy_solver expects a sparse container")
        rows, cols = A.rows(), A.cols()
        n = A.shape[0]
        was_vec = B.ndim == 1
        B2 = B[:, None] if was_vec else B
        if method in _ITERATIVE and B2.shape[1] != 1:
            raise ValueError(
                f"scipy iterative solver {method!r} supports a single RHS "
                "vector only (reference guard, cupy_sparse_solve.py:227-240)")
        data64 = A.values.detach().to(torch.float64).cpu().numpy()
        Bh = B2.detach().to(torch.float64).cpu().numpy()
        if method == "spsolve":
            # factorise the untransposed matrix, so that the forward and
            # the backward share one LU; the backward solves trans="T"
            M = _sps.csc_matrix((data64, (rows, cols)), shape=(n, n))
            lu = _lu_for((rows.tobytes(), cols.tobytes()), data64, M)
            x = np.asarray(lu.solve(Bh, trans="T" if transpose else "N"))
            x = x.reshape(Bh.shape)
        else:
            M = _sps.csr_matrix((data64, (rows, cols)), shape=(n, n))
            if transpose:
                M = M.T.tocsr()
            fn = getattr(_spl, method)
            kw = _remap_tol_kwargs(fn, {**solver_kwargs, **kwargs})
            x = fn(M, Bh[:, 0], **kw)[0][:, None]
        x = torch.from_numpy(x).to(device=B.device, dtype=B.dtype)
        return x[:, 0] if was_vec else x

    return solve


def sparse_solve_scipy(A, B, method: str = "spsolve", **kwargs):
    """``A x = B`` by a SciPy host solver, with the port's sparse
    implicit gradients (the reference's ``sparse_solve_c4t``); the
    backward's transpose solve runs the same method on ``Aᵀ`` (for
    ``spsolve``, the forward's LU with ``trans="T"``).  ``kwargs`` go to
    the SciPy solver."""
    return sparse_generic_solve(
        A, B,
        solve=scipy_solver(method, transpose=False, **kwargs),
        transpose_solve=scipy_solver(method, transpose=True, **kwargs))
