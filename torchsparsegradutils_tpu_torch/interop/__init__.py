"""Interop of the port: ``torch.sparse`` tensors in and out, and SciPy
host solves with the port's implicit gradients.

Port of ``torchsparsegradutils_tpu/interop``:

* :mod:`.torch_bridge`: ``from_torch_coo`` / ``from_torch_csr`` and
  ``to_torch_coo`` / ``to_torch_csr``, and the ``torch.sparse`` front
  end ``sparse_mm_torch`` / ``sparse_solve_torch`` (the JAX package's
  ``sparse_mm_j4t`` / ``sparse_solve_j4t``), all on the tensors' device;
* :mod:`.scipy_solve`: ``have_scipy``, ``scipy_solver`` and
  ``sparse_solve_scipy``.

The JAX package's ``jax_sparse`` (BCOO/BCSR converters) has its
counterpart in the ``torch.sparse`` conversions, the port's framework's
own sparse tensors; ``cupy_bindings`` is not ported (no cupy on either
machine).
"""

from .scipy_solve import have_scipy, scipy_solver, sparse_solve_scipy
from .torch_bridge import (from_torch_coo, from_torch_csr, sparse_mm_torch,
                           sparse_solve_torch, to_torch_coo, to_torch_csr)

__all__ = ["have_scipy", "scipy_solver", "sparse_solve_scipy",
           "from_torch_coo", "from_torch_csr", "to_torch_coo",
           "to_torch_csr", "sparse_mm_torch", "sparse_solve_torch"]
