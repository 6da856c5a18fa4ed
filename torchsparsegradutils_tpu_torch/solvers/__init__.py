"""Krylov solvers of the port: CG, BiCGSTAB, MINRES and LSMR.

Port of ``torchsparsegradutils_tpu/solvers``.  Each solver takes a
sparse container, a dense matrix or a matvec closure, runs under
``torch.no_grad()`` in a loop whose convergence test stays on the
device (``common.while_loop``, read on the host every
``common.CHECK_EVERY`` iterations), and leaves gradients to
``sparse_generic_solve`` and ``sparse_generic_lstsq``.

Example:
    >>> import torch
    >>> from torchsparsegradutils_tpu_torch.solvers import (
    ...     LinearCGSettings, linear_cg)
    >>> from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    ...     make_spd_sparse)
    >>> A = make_spd_sparse(16, 16 + 2 * 20, device="cpu")
    >>> b = torch.ones(16)
    >>> x = linear_cg(A, b, settings=LinearCGSettings(max_iter=100))
    >>> bool(torch.allclose(A.todense() @ x, b, atol=1e-4))
    True
"""

from .bicgstab import BICGSTABSettings, bicgstab
from .cg import LinearCGSettings, linear_cg
from .common import SolveInfo
from .lsmr import LSMRSettings, lsmr
from .minres import MINRESSettings, minres

__all__ = [
    "BICGSTABSettings",
    "bicgstab",
    "LinearCGSettings",
    "linear_cg",
    "LSMRSettings",
    "lsmr",
    "MINRESSettings",
    "minres",
    "SolveInfo",
]
