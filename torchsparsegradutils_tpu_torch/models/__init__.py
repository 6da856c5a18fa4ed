"""Models of the PyTorch port: the pairwise neighbourhood encoders.

Port of ``torchsparsegradutils_tpu/models/``; its
``SparseMultivariateNormal`` is still to port (``ROADMAP.md``).
"""

from .encoders import PairwiseEncoder, calc_pairwise_coo_indices_nd

__all__ = ["PairwiseEncoder", "calc_pairwise_coo_indices_nd"]
