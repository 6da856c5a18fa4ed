"""``X = L⁻¹ B`` for a lower triangular L and its backward at the stored
entries: gradB = L⁻ᵀ G, gradA[e] = -(gradB[r_e] . X[c_e]).

L is cut into dense row blocks at least as wide as its band, so block i
reaches only blocks i and i - 1; each block is built when it is needed
and solved densely in turn (forward for X, backward for gradB), so at
most two blocks are held at a time."""

from __future__ import annotations

import torch

from .spmm import entry_blocks

MAX_BLOCK = 8192


class _Blocks:
    """Row blocks ``(r0, r1, c0, W)`` of L, W = L[r0:r1, c0:r1] dense."""

    def __init__(self, rows, cols, values, n):
        band = int((rows - cols).max()) + 1
        self.bs = bs = max(256, -(-band // 256) * 256)
        if bs > MAX_BLOCK:
            raise ValueError(f"reference trisolve: band {band} is wider "
                             f"than the {MAX_BLOCK}-row blocks it can hold")
        edges = torch.arange(0, n + bs, bs, device=rows.device).clamp_(max=n)
        self.bounds = torch.searchsorted(rows, edges).tolist()
        self.rows, self.cols, self.values, self.n = rows, cols, values, n

    def __len__(self):
        return len(self.bounds) - 1

    def __getitem__(self, i):
        bs = self.bs
        r0, r1 = i * bs, min(self.n, (i + 1) * bs)
        c0 = max(0, r0 - bs)
        e0, e1 = self.bounds[i], self.bounds[i + 1]
        W = torch.zeros(r1 - r0, r1 - c0, dtype=self.values.dtype,
                        device=self.values.device)
        W.index_put_((self.rows[e0:e1] - r0, self.cols[e0:e1] - c0),
                     self.values[e0:e1], accumulate=True)
        return r0, r1, c0, W


def step(rows, cols, values, B, G, n):
    """(X, grad_values, grad_B) of the lower solve ``L X = B``, L (n, n)
    holding ``values`` at (rows, cols), for the cotangent G (n, p)."""
    if bool((cols > rows).any()):
        raise ValueError("reference trisolve: L has entries above its "
                         "diagonal")
    blocks = _Blocks(rows, cols, values, n)
    X = torch.empty_like(B)
    for i in range(len(blocks)):
        r0, r1, c0, W = blocks[i]
        rhs = B[r0:r1]
        if r0 > c0:
            rhs = rhs - W[:, :r0 - c0] @ X[c0:r0]
        X[r0:r1] = torch.linalg.solve_triangular(W[:, r0 - c0:], rhs,
                                                 upper=False)
    gb = torch.empty_like(G)
    below = None           # block i + 1, built on the step before
    for i in range(len(blocks) - 1, -1, -1):
        r0, r1, c0, W = blocks[i]
        rhs = G[r0:r1]
        if below is not None:
            s0, s1, sc0, S = below
            rhs = rhs - S[:, r0 - sc0:s0 - sc0].T @ gb[s0:s1]
        gb[r0:r1] = torch.linalg.solve_triangular(W[:, r0 - c0:].T, rhs,
                                                  upper=True)
        below = (r0, r1, c0, W)
    del below
    gv = torch.empty_like(values)
    for s in entry_blocks(values.numel(), B.shape[1], B.element_size()):
        gv[s] = -(gb[rows[s]] * X[cols[s]]).sum(1)
    return X, gv, gb
