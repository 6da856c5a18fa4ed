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

Both the kernel and its plain version run the JAX kernel's own
arithmetic: row blocks in order, each
``xb = Dinv_b · (B_b - Σ_k v[:, k] ⊙ x[r - d_k])`` with ``Dinv_b`` the
inverse of the block's lower triangle (:func:`_build_diag_inv`).
:func:`tri_dia_core` launches the hand-written CUDA kernels of
``csrc/tri_dia.cu`` on CUDA tensors: the block inverses, all blocks at
once (:func:`tri_dia_inv`), then a walk over blocks of ``KERNEL_NB``
rows, whose shared-memory plan the C launch picks; on CPU tensors it
runs its plain PyTorch version :func:`tri_dia_core_plain` (256-row
blocks, the JAX kernel's, unless ``nb`` says otherwise).  Both sum in
float32 for float32 and bfloat16 inputs and return the input dtype;
float64 runs in float64.

Example:
    >>> import numpy as np, torch
    >>> grid = torch.tensor([[0.0, 2.0], [1.0, 2.0], [1.0, 2.0]])
    >>> tri_dia_core(np.array([-1, 0]), grid, torch.ones(3, 1),
    ...              unit=False).flatten().tolist()
    [0.5, 0.25, 0.375]
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = ["tri_dia_core", "tri_dia_core_plain", "tri_dia_inv",
           "tri_dia_takes", "SPAN_CAP", "NB"]

SPAN_CAP = 8192      # widest band the JAX kernel's rolling window takes
NB = 256             # row-block size of the plain version (the JAX kernel's)
MAX_DIAGS = 256      # csrc/tsgu_common.cuh MAX_DIAGS
KERNEL_NB = 64       # csrc/tri_dia.cu NB: rows of a block of the walk
KERNEL_DS = 68       # csrc/tri_dia.cu DS: row stride of its block inverses
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
                       unit: bool, nb: int = NB) -> torch.Tensor:
    """Plain PyTorch version of :func:`tri_dia_core` (its gates aside),
    in row blocks of ``nb``."""
    offsets = np.asarray(offsets, np.int64)
    n, K = grid.shape
    p = B.shape[1]
    acc = _build.acc_dtype(B.dtype)
    span = int(-offsets.min()) if (offsets < 0).any() else 0
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


class KernelMeta(NamedTuple):
    """The offsets as ``csrc/tri_dia.cu`` reads them."""
    meta: torch.Tensor  # grid columns of the nk strictly-lower offsets
    #                     (offsets ascending, d descending), then their d
    nk: int
    ni: int             # of them with d >= KERNEL_NB: outside the inverses
    k0: int             # grid column of offset 0, -1 without one
    span: int           # the largest d, 0 without a lower offset


@lru_cache(maxsize=64)
def _kernel_meta(offsets: tuple, device: torch.device) -> KernelMeta:
    """:class:`KernelMeta` of ``offsets`` (ascending), its table on
    ``device``."""
    ks = [k for k, off in enumerate(offsets) if off < 0]
    ds = [-offsets[k] for k in ks]
    return KernelMeta(
        torch.tensor(ks + ds, dtype=torch.int64, device=device), len(ks),
        sum(1 for d in ds if d >= KERNEL_NB),
        offsets.index(0) if 0 in offsets else -1, max(ds, default=0))


def tri_dia_inv(offsets, grid: torch.Tensor, *, unit: bool) -> torch.Tensor:
    """The ``(nblk, KERNEL_NB, KERNEL_NB)`` inverses of the lower
    triangles of the ``KERNEL_NB``-row blocks of the matrix that ``grid``
    holds over ascending ``offsets``, in the sum dtype, zero above the
    diagonal.  CPU tensors take :func:`_build_diag_inv`; CUDA tensors
    launch ``csrc/tri_dia.cu``'s inverse build (one CTA a block), whose
    rows have a stride of ``KERNEL_DS`` (the result is a view)."""
    offsets = np.asarray(offsets, np.int64)
    n, nb = grid.shape[0], KERNEL_NB
    nblk = -(-n // nb)
    acc = _build.acc_dtype(grid.dtype)
    if grid.device.type == "cpu":
        return _build_diag_inv(offsets, grid, n, nblk, nb, unit, acc)
    suffix = _build.cuda_operands("tri_dia_inv", (grid,), ())
    km = _kernel_meta(tuple(offsets.tolist()), grid.device)
    # rows of stride KERNEL_DS, as the walk copies a block at once
    dinv = torch.empty((nblk, nb, KERNEL_DS), dtype=acc, device=grid.device)
    if dinv.numel() == 0:
        return dinv[..., :nb]
    _build.launch("tri_dia", f"tsgu_tri_dia_inv_{suffix}", grid, km.meta,
                  dinv, n, grid.shape[1], km.nk, km.ni, km.k0, int(unit))
    tri_dia_inv.launches += 1
    return dinv[..., :nb]


tri_dia_inv.launches = 0


def tri_dia_takes(offsets, dtype: torch.dtype) -> bool:
    """Whether :func:`tri_dia_core` solves over these (lower-form)
    offsets in this dtype: a band of at most ``SPAN_CAP`` rows, and
    float32, bfloat16 or float64."""
    offsets = np.asarray(offsets, np.int64)
    span = int(-offsets.min()) if (offsets < 0).any() else 0
    return span <= SPAN_CAP and dtype in _DTYPES


def tri_dia_core(offsets, grid: torch.Tensor, B: torch.Tensor, *,
                 unit: bool) -> Optional[torch.Tensor]:
    """Solve lower-triangular ``A x = B``, A given as the ``(n, K)`` grid
    over ascending ``offsets`` (numpy or a list), B ``(n, p)`` of the
    grid's dtype.  Returns None where the JAX kernel does: for a band
    wider than ``SPAN_CAP``, and for dtypes the kernel does not take
    (float16 and others; float64 runs here, unlike on the TPU).

    CPU tensors take :func:`tri_dia_core_plain`; CUDA tensors launch
    ``csrc/tri_dia.cu`` (the block inverses, :func:`tri_dia_inv`, then
    the block walk) and raise on what it does not take.
    """
    offsets = np.asarray(offsets, np.int64)
    if not tri_dia_takes(offsets, B.dtype):
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
    km = _kernel_meta(tuple(offsets.tolist()), B.device)
    if grid.data_ptr() % 16:
        grid = grid.clone()        # the walk copies its rows 16 bytes on
    dinv = tri_dia_inv(offsets, grid, unit=unit)
    xw = out if acc == B.dtype else torch.empty((n, p), dtype=acc,
                                                device=B.device)
    _build.launch("tri_dia", f"tsgu_tri_dia_{suffix}", grid, B, dinv,
                  km.meta, xw, out, n, K, p, km.nk, km.span)
    tri_dia_core.launches += 1
    return out


tri_dia_core.launches = 0
