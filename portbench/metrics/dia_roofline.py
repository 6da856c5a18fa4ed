"""The DIA kernels' share of their roofline: K1 (``dia_spmm.cu``, A X and
Aᵀ G) and K2 (``dia_sddmm.cu``, gradA) over their device time."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, ("dia_spmm_kernel", "dia_sddmm_kernel"))
