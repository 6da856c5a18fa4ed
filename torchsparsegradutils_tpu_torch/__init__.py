"""PyTorch port of torchsparsegradutils_tpu for NVIDIA Hopper GPUs.

Sparse containers whose gradients stay at the stored entries;
``sparse_mm`` / ``sddmm`` with their sparsity-preserving backward on two
engines: the DIA engine for diagonal-structured patterns, and the chunk
engine for general row-sorted patterns and a hybrid pattern's residual;
and ``sparse_triangular_solve`` (banded, level-scheduled, blocked and
dense algorithms) with the same kind of backward.  The SpMM, SDDMM,
SpMV, value relayout and banded triangular solve run as hand-written
CUDA kernels (``csrc/``) on the card and as their plain PyTorch versions
on the CPU.  The JAX package beside it is the reference this port is tested
against; the port imports none of it.
"""

from .convert import from_arrays, to_arrays
from .kernels.dia import dia_coverage
from .ops.spmm import sddmm, sparse_mm
from .ops.triangular_solve import sparse_triangular_solve
from .types import SparseCOO, SparseCSR

__all__ = ["SparseCOO", "SparseCSR", "sparse_mm", "sddmm",
           "sparse_triangular_solve", "dia_coverage", "from_arrays",
           "to_arrays"]
