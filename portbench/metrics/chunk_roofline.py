"""The chunk kernels' share of their roofline: K6 (``chunk_spmm.cu``),
K7 (``chunk_sddmm.cu``) and the K3 relayouts (``gather.cu``) over their
device time."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, ("chunk_spmm_kernel", "chunk_sddmm_kernel"),
                    ("gather_kernel",))
