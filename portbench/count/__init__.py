"""Bytes and FLOPs that an op, or a kernel's function, needs, from shapes.

Each input is counted as read once and each output as written once,
whatever an implementation reads again; an index takes 4 bytes (int32
reaches every size here), and a pattern that the host plans once
(``indexed=False``) costs the device no index bytes.  The peaks are the
NVIDIA H100 SXM data sheet's (700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s
of float32 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
INDEX = 4
VALUE = {"float32": 4, "bfloat16": 2, "float64": 8}


def least_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes or FLOPs at peak."""
    return max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S)


def _index(n: int, nnz: int, indexed: bool) -> int:
    return (nnz + n + 1) * INDEX if indexed else 0


def spmm(n, m, nnz, p, vb=4, indexed=True):
    """Y (n, p) = A (n, m) X (m, p), A with nnz stored entries."""
    return nnz * vb + _index(n, nnz, indexed) + (m + n) * p * vb, \
        2 * nnz * p


def sddmm(n, m, nnz, p, vb=4, indexed=True):
    """out[e] = X[r_e] . Y[c_e] at nnz entries, X (n, p), Y (m, p)."""
    return (n + m) * p * vb + nnz * vb + _index(n, nnz, indexed), \
        2 * nnz * p


def trisolve(n, nnz, p, vb=4, indexed=False):
    """X = L^-1 B, L (n, n) triangular with nnz entries (n diagonal):
    an FMA a column for each off-diagonal entry, a division for each
    diagonal one."""
    return nnz * vb + _index(n, nnz, indexed) + 2 * n * p * vb, \
        (2 * (nnz - n) + n) * p


def gather(count, vb=4):
    """dst[i] = src[map[i]] for ``count`` values."""
    return count * (2 * vb + INDEX), 0


def step(shape: dict):
    """(bytes, FLOPs) of one forward and backward step of the cell's op,
    for values, B and the cotangent G: out, gradA at the entries and
    gradB, each written once; a dynamic pattern's indices read once."""
    n, m, nnz, p = shape["n"], shape["m"], shape["nnz"], shape["p"]
    vb = VALUE[shape["dtype"]]
    idx = _index(n, nnz, shape["pattern"] == "dynamic")
    if shape["op"] == "sparse_mm":
        # reads values, B (m, p), G (n, p); writes out (n, p), gradA, gradB
        return 2 * nnz * vb + idx + 2 * (n + m) * p * vb, 3 * 2 * nnz * p
    if shape["op"] == "sparse_triangular_solve":
        # X = L^-1 B, gradB = L^-T G, gradA = -(gradB X^T) at the entries
        _, solve_flops = trisolve(n, nnz, p)
        return 2 * nnz * vb + idx + 4 * n * p * vb, \
            2 * solve_flops + 2 * nnz * p
    raise ValueError(f"no count for op {shape['op']!r}")


# Kernel functions of the port by the name their CUDA kernel has in a
# trace: ("launch", need) counts the need once a launch, ("step", need)
# once a step (a function whose launches split its work, as K7's column
# slabs do); a need of (0, 0) marks a launch that is part of another
# function's work (K9's block inverses are part of its solve).
def _dia_spmm(s):
    return spmm(s["n"], s["m"], s["nnz"], s["p"], indexed=False)


def _dia_sddmm(s):
    return sddmm(s["n"], s["m"], s["nnz"], s["p"], indexed=False)


def _chunk_spmm(s):
    return spmm(s["n"], s["m"], s["nnz"], s["p"])


def _chunk_sddmm(s):
    return sddmm(s["n"], s["m"], s["nnz"], s["p"])


def _gather(s):
    return gather(s["nnz"])


def _tri(s):
    return trisolve(s["n"], s["nnz"], s["p"])


def _nothing(s):
    return 0, 0


KERNELS = {
    "dia_spmm_kernel": ("launch", _dia_spmm),        # K1: A X, Aᵀ G
    "dia_sddmm_kernel": ("launch", _dia_sddmm),      # K2: gradA
    "chunk_spmm_kernel": ("launch", _chunk_spmm),    # K6: A X, Aᵀ G
    "chunk_sddmm_kernel": ("step", _chunk_sddmm),    # K7: gradA, by slabs
    "gather_kernel": ("launch", _gather),            # K3: value relayouts
    "tri_dia_kernel": ("launch", _tri),              # K9: a block walk
    "tri_dia_inv_kernel": ("launch", _nothing),      # K9: block inverses
}
