"""Banded (DIA) lower-triangular solve from the ``(n, K)`` value grid.

Port of ``torchsparsegradutils_tpu/kernels/dia_tri.py``.  For a lower
triangle given as diagonals (``offsets`` ascending, ``grid[r, k]`` the
entry at ``(r, r + off_k)``) it solves ``A x = B`` row block by row
block:

    x[r, :] = (B[r, :] - Σ_{off_k < 0} grid[r, k] · x[r + off_k, :])
              / grid[r, k₀]

Entries above the diagonal (positive offsets) are ignored, as dense
triangular solves ignore them; with ``unit`` the diagonal is 1 and the
offset-0 column is not read.  Upper-triangular and transposed solves
reduce to this lower core by flips and the grid shift
(``ops/triangular_solve.py``).

:func:`tri_dia_core` launches the hand-written CUDA kernel
``csrc/tri_dia.cu`` on CUDA tensors (substitution inside each block,
the off-block terms read back from the solved rows) and runs its plain
PyTorch version :func:`tri_dia_core_plain` on CPU tensors: the JAX
kernel's own arithmetic, 256-row blocks in order, each
``xb = Dinv_b · (B_b - Σ_k v[:, k] ⊙ x[r - d_k])`` with ``Dinv_b`` the
inverse of the block's lower triangle (:func:`_build_diag_inv`).  Both
sum in float32 for float32 and bfloat16 inputs and return the input
dtype; float64 runs in float64.

Example:
    >>> import numpy as np, torch
    >>> grid = torch.tensor([[0.0, 2.0], [1.0, 2.0], [1.0, 2.0]])
    >>> tri_dia_core(np.array([-1, 0]), grid, torch.ones(3, 1),
    ...              unit=False).flatten().tolist()
    [0.5, 0.25, 0.375]
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = ["tri_dia_core", "tri_dia_core_plain", "SPAN_CAP", "NB"]

SPAN_CAP = 8192      # widest band the JAX kernel's rolling window takes
NB = 256             # row-block size of the plain version (the JAX kernel's)
MAX_DIAGS = 256      # csrc/tsgu_common.cuh MAX_DIAGS
KERNEL_NBS = (256, 128, 64, 32)   # row blocks the CUDA kernel may take
KERNEL_TP = 4                     # csrc/tri_dia.cu TP
KERNEL_WIN = 3                    # csrc/tri_dia.cu WIN
SMEM_BUDGET = 40 * 1024           # dynamic shared memory of one CTA, bytes
_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _build_diag_inv(offsets, grid, n: int, nblk: int, nb: int, unit: bool,
                    acc: torch.dtype) -> torch.Tensor:
    """(nblk, nb, nb) inverses of the lower-triangular diagonal blocks."""
    n_pad = nblk * nb
    gp = F.pad(grid.to(acc), (0, 0, 0, n_pad - n))
    D = torch.zeros((nblk, nb, nb), dtype=acc, device=grid.device)
    for k, off in enumerate(int(o) for o in offsets):
        if off > 0 or -off >= nb or (unit and off == 0):
            continue
        # the block's diagonal `off` holds the values at (r, r + off)
        col = gp[:, k].view(nblk, nb)
        D.diagonal(off, 1, 2).add_(col[:, -off:])
    eye = torch.eye(nb, dtype=acc, device=grid.device)
    if unit:
        D += eye
    else:
        # unit diagonal for the padded rows of the last block
        D[-1].diagonal()[n - (nblk - 1) * nb:] += 1
    return torch.linalg.solve_triangular(D, eye.expand(nblk, nb, nb),
                                         upper=False)


def tri_dia_core_plain(offsets, grid: torch.Tensor, B: torch.Tensor, *,
                       unit: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`tri_dia_core` (its gates aside)."""
    offsets = np.asarray(offsets, np.int64)
    n, K = grid.shape
    p = B.shape[1]
    acc = _build.acc_dtype(B.dtype)
    span = int(-offsets.min()) if (offsets < 0).any() else 0
    nb = NB
    nblk = -(-n // nb)
    span_w = max(-(-span // nb) * nb, nb)
    n_pad = nblk * nb
    dev = B.device
    Dinv = _build_diag_inv(offsets, grid, n, nblk, nb, unit, acc)
    # row i of a block reads x[base + i - d_k] for i < d_k (the in-block
    # rest lives in Dinv); x_full keeps span_w zero rows in front, so the
    # index is never negative and masked slots read a zero row
    d = torch.from_numpy(np.maximum(0, -offsets)).to(dev)
    i_row = torch.arange(nb, device=dev)[:, None]
    mask = i_row < d[None, :]
    base = torch.arange(nblk, device=dev)[:, None, None] * nb
    idx = torch.where(mask, span_w + base + i_row - d[None, :], 0)
    v = F.pad(grid.to(acc), (0, 0, 0, n_pad - n)).view(nblk, nb, K) * mask
    Bp = F.pad(B.to(acc), (0, 0, 0, n_pad - n)).view(nblk, nb, p)
    x_full = torch.zeros((span_w + n_pad, p), dtype=acc, device=dev)
    for b in range(nblk):
        base = b * nb
        g = x_full.index_select(0, idx[b].view(-1)).view(nb, K, p)
        rhs = Bp[b] - torch.einsum("rk,rkp->rp", v[b], g)
        x_full[span_w + base:span_w + base + nb] = Dinv[b] @ rhs
    return x_full[span_w:span_w + n].to(B.dtype)


@lru_cache(maxsize=64)
def _kernel_meta(offsets: tuple, elem: int, device: torch.device):
    """``(meta, nk, nf, nr, kw, nb, nlate)`` of :func:`tri_dia_core`'s
    CUDA launch: meta holds the grid columns of the ``nk`` strictly-lower
    offsets (ascending, so d descending) and then their d; entries
    ``nf .. nf + nr - 1`` are the near ones beyond the kernel's register
    window (``KERNEL_WIN < d < nb``); ``kw[d - 1]`` is the column of
    offset -d for d in the window, or -1; ``nb`` is the largest row block
    whose shared memory (two staging buffers and the solved rows) fits
    ``SMEM_BUDGET``; rows below ``nlate`` of a block read some term from
    the block before."""
    ks = [k for k, off in enumerate(offsets) if off < 0]
    ds = [-offsets[k] for k in ks]
    for nb in KERNEL_NBS:
        nr = sum(1 for x in ds if KERNEL_WIN < x < nb)
        if elem * nb * (2 * (KERNEL_TP + KERNEL_WIN + 1 + nr)
                        + KERNEL_TP) <= SMEM_BUDGET:
            break
    nf = sum(1 for x in ds if x >= nb)
    kw = tuple(ks[ds.index(d)] if d in ds else -1
               for d in range(1, KERNEL_WIN + 1))
    late = [x for x in ds if KERNEL_WIN < x < 2 * nb]
    nlate = min(max(late), nb) if late else 0
    meta = torch.tensor(ks + ds, dtype=torch.int64, device=device)
    return meta, len(ks), nf, nr, kw, nb, nlate


def tri_dia_core(offsets, grid: torch.Tensor, B: torch.Tensor, *,
                 unit: bool) -> Optional[torch.Tensor]:
    """Solve lower-triangular ``A x = B``, A given as the ``(n, K)`` grid
    over ascending ``offsets`` (numpy or a list), B ``(n, p)`` of the
    grid's dtype.  Returns None where the JAX kernel does: for a band
    wider than ``SPAN_CAP``, and for dtypes the kernel does not take
    (float16 and others; float64 runs here, unlike on the TPU).

    CPU tensors take :func:`tri_dia_core_plain`; CUDA tensors launch
    ``csrc/tri_dia.cu`` and raise on what it does not take.
    """
    offsets = np.asarray(offsets, np.int64)
    span = int(-offsets.min()) if (offsets < 0).any() else 0
    if span > SPAN_CAP or B.dtype not in _DTYPES:
        return None
    if grid.device.type == "cpu" and B.device.type == "cpu":
        return tri_dia_core_plain(offsets, grid, B, unit=unit)
    suffix = _build.cuda_operands("tri_dia_core", (grid, B), ())
    if grid.ndim != 2 or B.ndim != 2 or grid.shape[0] != B.shape[0] \
            or grid.shape[1] != len(offsets):
        raise ValueError(f"tri_dia_core: needs grid (n, K), B (n, p) and K "
                         f"offsets, got {tuple(grid.shape)}, "
                         f"{tuple(B.shape)}, {len(offsets)}")
    (n, K), p = grid.shape, B.shape[1]
    if K > MAX_DIAGS:
        raise ValueError(f"tri_dia_core: takes K <= {MAX_DIAGS}, got {K}")
    out = torch.empty_like(B)
    if out.numel() == 0:
        return out
    acc = _build.acc_dtype(B.dtype)
    meta, nk, nf, nr, kw, nb, nlate = _kernel_meta(
        tuple(offsets.tolist()), acc.itemsize, B.device)
    hits = np.nonzero(offsets == 0)[0]
    k0 = int(hits[0]) if len(hits) else -1
    xw = out if acc == B.dtype else torch.empty((n, p), dtype=acc,
                                                device=B.device)
    _build.launch("tri_dia", f"tsgu_tri_dia_{suffix}", grid, B, meta, xw,
                  out, n, K, p, nk, nf, nr, k0, *kw, int(unit), nb, nlate)
    tri_dia_core.launches += 1
    return out


tri_dia_core.launches = 0
