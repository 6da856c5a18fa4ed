"""Models of the PyTorch port: the pairwise neighbourhood encoders and
the sparse-factor multivariate normals (port of
``torchsparsegradutils_tpu/models/``)."""

from .distributions import (SparseMultivariateNormal,
                            SparseMultivariateNormalNative)
from .encoders import PairwiseEncoder, calc_pairwise_coo_indices_nd

__all__ = ["SparseMultivariateNormal", "SparseMultivariateNormalNative",
           "PairwiseEncoder", "calc_pairwise_coo_indices_nd"]
