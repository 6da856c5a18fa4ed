"""PyTorch port of torchsparsegradutils_tpu for NVIDIA Hopper GPUs.

Sparse containers whose gradients stay at the stored entries, and
``sparse_mm`` / ``sddmm`` with their sparsity-preserving backward on two
engines: the DIA engine for diagonal-structured patterns, and the chunk
engine for general row-sorted patterns and a hybrid pattern's residual.
Their SpMM, SDDMM, SpMV and value relayout run as hand-written CUDA
kernels (``csrc/``) on the card and as their plain PyTorch versions on
the CPU.  The JAX package beside it is the reference this port is tested
against; the port imports none of it.
"""

from .convert import from_arrays, to_arrays
from .kernels.dia import dia_coverage
from .ops.spmm import sddmm, sparse_mm
from .types import SparseCOO, SparseCSR

__all__ = ["SparseCOO", "SparseCSR", "sparse_mm", "sddmm", "dia_coverage",
           "from_arrays", "to_arrays"]
