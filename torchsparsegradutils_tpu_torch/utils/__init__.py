"""Utilities of the port: structure helpers, generators and the
statistical checks of samples (the JAX package's ``utils``)."""

from .dist_stats import cov_nagao_test, mean_hotelling_t2_test, \
    sample_mean_cov
from .random_sparse import make_spd_sparse, rand_sparse, rand_sparse_tri
from .structure import (
    coalesce,
    coo_to_csr,
    coo_to_csr_indices_values,
    csr_to_coo,
    csr_transpose,
    sparse_block_diag,
    sparse_block_diag_split,
    sparse_eye,
    sparse_stack,
)

# reference-named aliases (cai4cai/torchsparsegradutils API surface)
convert_coo_to_csr = coo_to_csr
convert_coo_to_csr_indices_values = coo_to_csr_indices_values
stack_csr = sparse_stack

__all__ = [
    "convert_coo_to_csr",
    "convert_coo_to_csr_indices_values",
    "stack_csr",
    "cov_nagao_test",
    "mean_hotelling_t2_test",
    "sample_mean_cov",
    "coalesce",
    "coo_to_csr",
    "coo_to_csr_indices_values",
    "csr_to_coo",
    "csr_transpose",
    "sparse_block_diag",
    "sparse_block_diag_split",
    "sparse_eye",
    "sparse_stack",
    "make_spd_sparse",
    "rand_sparse",
    "rand_sparse_tri",
]
