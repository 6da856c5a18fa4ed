"""``out = A @ B`` and its backward at the stored entries, plainly:
gradA[e] = G[r_e] . B[c_e], gradB = Aᵀ G."""

from __future__ import annotations

import torch

BLOCK_BYTES = 1 << 30   # (entries, p) rows gathered at a time


def entry_blocks(nnz: int, p: int, itemsize: int):
    size = max(1, BLOCK_BYTES // max(1, p * itemsize))
    for s in range(0, nnz, size):
        yield slice(s, min(nnz, s + size))


def step(rows, cols, values, B, G, n):
    """(out, grad_values, grad_B) of ``A @ B``, A (n, B.shape[0]) holding
    ``values`` at (rows, cols), for the cotangent G (n, p)."""
    out = torch.zeros(n, B.shape[1], dtype=B.dtype, device=B.device)
    gv = torch.empty_like(values)
    gb = torch.zeros_like(B)
    for s in entry_blocks(values.numel(), B.shape[1], B.element_size()):
        r, c, v = rows[s], cols[s], values[s]
        Bc, Gr = B[c], G[r]
        out.index_add_(0, r, v[:, None] * Bc)
        gv[s] = (Gr * Bc).sum(1)
        gb.index_add_(0, c, v[:, None] * Gr)
    return out, gv, gb
