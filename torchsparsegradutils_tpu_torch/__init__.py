"""PyTorch port of torchsparsegradutils_tpu for NVIDIA Hopper GPUs.

Sparse containers whose gradients stay at the stored entries;
``sparse_mm`` / ``sddmm`` with their sparsity-preserving backward on two
engines: the DIA engine for diagonal-structured patterns, and the chunk
engine for general row-sorted patterns and a hybrid pattern's residual;
``sparse_triangular_solve`` (banded, level-scheduled, blocked and
dense algorithms) with the same kind of backward;
``sparse_logsumexp`` / ``sparse_bidir_logsumexp`` (DIA grid, row-ELL
grid and chunk routes); and ``sparse_generic_solve`` /
``sparse_generic_lstsq`` over the Krylov solvers of ``solvers`` (CG,
BiCGSTAB, MINRES, LSMR), with implicit gradients; ``segment_mm`` /
``gather_mm``; ``explain``, the route each op takes for a pattern.
``backend="ell"`` runs the ELL engine.  The subpackages ``parallel``
(row-sharded, chunk-sharded and halo-exchange SpMM, whose
``matvec_closures`` drive distributed Krylov solves, and the dp × tp
flagship train step on ``torch.distributed``), ``models``
(``PairwiseEncoder`` and the sparse multivariate normals), ``utils``
(structure helpers, generators, the samples' statistical checks),
``interop`` (``torch.sparse`` tensors in and out, SciPy host solves)
and ``examples`` build on them.  The SpMM, SDDMM, SpMV, value
relayout, banded triangular solve, row LSE and its backward, the fused
chunk backward and the row-slab SpMM run as hand-written CUDA kernels
(``csrc/``) on the card and as their plain PyTorch versions on the CPU.
The JAX package beside it is the reference this port is tested against;
the port imports none of it.
"""

from . import solvers
from .convert import from_arrays, params_from_arrays, to_arrays
from .kernels.dia import dia_coverage
from .kernels.explain import explain
from .ops.indexed_matmul import gather_mm, segment_mm
from .ops.logsumexp import sparse_bidir_logsumexp, sparse_logsumexp
from .ops.lstsq import sparse_generic_lstsq
from .ops.solve import sparse_generic_solve
from .ops.spmm import sddmm, sparse_mm
from .ops.triangular_solve import sparse_triangular_solve
from .types import SparseCOO, SparseCSC, SparseCSR
from .utils.random_sparse import make_spd_sparse, make_spd_stencil

__all__ = ["SparseCOO", "SparseCSR", "SparseCSC", "sparse_mm", "sddmm",
           "sparse_triangular_solve", "sparse_logsumexp",
           "sparse_bidir_logsumexp", "sparse_generic_solve",
           "sparse_generic_lstsq", "segment_mm", "gather_mm", "solvers", "make_spd_sparse",
           "make_spd_stencil", "dia_coverage", "explain", "from_arrays",
           "to_arrays", "params_from_arrays"]
