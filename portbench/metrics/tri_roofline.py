"""The banded triangular kernel's share of its roofline: K9's solves
(``tri_dia.cu``: block walks, block inverses counted as part of them)
over their device time."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, ("tri_dia_kernel",), ("tri_dia_inv_kernel",))
