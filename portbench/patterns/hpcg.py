"""HPCG's matrix (src/GenerateProblem_ref.cpp of the HPCG reference
code): the 27-point stencil on an ``nx`` x ``ny`` x ``nz`` grid, row
``ix + nx * (iy + ny * iz)``, an entry for each of the 27 neighbours
(itself included) that lies inside the grid; the pattern takes no
randomness."""

from __future__ import annotations

import torch


def make(cfg: dict, gen: torch.Generator, device) -> tuple:
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    n = nx * ny * nz
    r = torch.arange(n, device=device, dtype=torch.int64)
    ix, iy, iz = r % nx, (r // nx) % ny, r // (nx * ny)
    offs, inside = [], []
    # (sz, sy, sx) in lexicographic order is ascending column offset, so
    # the entries come out row-major sorted
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                offs.append(sx + nx * (sy + ny * sz))
                inside.append((ix + sx >= 0) & (ix + sx < nx)
                              & (iy + sy >= 0) & (iy + sy < ny)
                              & (iz + sz >= 0) & (iz + sz < nz))
    inside = torch.stack(inside, 1)
    cols = r[:, None] + torch.tensor(offs, device=device)[None, :]
    return r[:, None].expand(n, 27)[inside], cols[inside]
