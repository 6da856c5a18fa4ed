"""Row packs: the host plan of the kernels that finish whole CSR rows in
one block.

The chunk LSE kernels (K10 and K11, ``csrc/chunk_lse.cu``) and the chunk
SpMV (K8, ``csrc/chunk_spmv.cu``) walk tables of row packs, planned here
on the host (:func:`lse_packs`, :func:`pack_lanes`, :func:`pack_table`)
and cached with a chunk plan (:func:`plan_packs`): the rows, in order,
cut into packs of consecutive whole rows that hold at most ``T`` entries
and ``T / 2`` rows, a row of more than ``LONG_ROW`` entries a pack of its
own; ``T`` is ``PACK_ENTRIES`` (2,048) for K10 and K11 and
``chunk_spmm.SPMV_PACK`` (512) for K8, each table cached apart.  One
CUDA block takes one pack, stages its entries in shared memory in one
burst and finishes its rows there, lane groups of ``G`` threads a row; a
pack of one row is walked by the whole block (``csrc/row_packs.cuh``).

This module imports no kernel module, so both ``chunk_spmm`` and
``chunk_lse`` can import it.

Example:
    >>> pack_table(np.array([0, 3, 3, 303, 304, 305])).table.tolist()
    [[0, 0, 2], [2, 3, 5], [3, 303, 2], [5, 305, 0]]
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["LsePacks", "lse_packs", "pack_lanes", "pack_table",
           "plan_packs", "PACK_ENTRIES", "LONG_ROW"]

PACK_ENTRIES = 2048   # K10's and K11's T (their PACK): entries a pack holds
LONG_ROW = 256        # a longer row is a pack of its own


class LsePacks(NamedTuple):
    """A pack table on a device: ``table`` (npacks + 1, 3) int64, each
    pack's first row, first entry and log2 of its lane group, then
    ``(n, nnz, 0)``; ``n`` and ``nnz`` the rows and entries of the
    pattern it was cut for and ``T`` the pack size it was cut at, on the
    host."""
    table: torch.Tensor
    n: int
    nnz: int
    T: int = PACK_ENTRIES


def lse_packs(indptr, T: int = PACK_ENTRIES) -> np.ndarray:
    """First rows of the row packs of a CSR ``indptr``, then n:
    ``(npacks + 1,)`` int64.  The rows, in order, are cut into packs of
    consecutive whole rows, each holding at most ``T`` entries and
    ``T // 2`` rows (empty rows count against the rows only); a row of
    more than ``LONG_ROW`` entries is a pack of its own, walked by the
    whole block.  The kernels take ``T = PACK_ENTRIES`` only; another
    ``T`` plans for a scratch build of them (a probe).

    >>> lse_packs(np.array([0, 3, 3, 303, 304, 305]), 1024).tolist()
    [0, 2, 3, 5]
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    n = len(indptr) - 1
    long_rows = np.flatnonzero(np.diff(indptr) > min(LONG_ROW, T))
    starts, r, k = [0], 0, 0
    while r < n:
        while k < len(long_rows) and long_rows[k] < r:
            k += 1
        nxt = int(long_rows[k]) if k < len(long_rows) else n
        if nxt == r:
            r += 1
        else:
            fits = int(np.searchsorted(indptr, indptr[r] + T, "right")) - 1
            r = min(fits, nxt, r + T // 2)
        starts.append(r)
    return np.asarray(starts, dtype=np.int64)


def pack_lanes(indptr, starts) -> np.ndarray:
    """Lanes ``G`` that take one row of each pack, ``(npacks,)``: the
    least power of two of at least a quarter of the pack's mean row
    length, within [4, 32] (32 for a pack of one row, which the whole
    block walks).  A row of more than ``8 G`` entries in a pack of
    several is taken by a whole warp.

    >>> pack_lanes(np.array([0, 3, 3, 303, 304, 305]), [0, 2, 3, 5]).tolist()
    [4, 32, 4]
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    rows = np.diff(starts)
    ents = indptr[starts[1:]] - indptr[starts[:-1]]
    quarter = -(-ents // (4 * rows))              # ceil(mean / 4)
    lg = np.ceil(np.log2(np.maximum(quarter, 1))).astype(np.int64)
    lg = np.where(rows == 1, 5, np.clip(lg, 2, 5))
    return np.left_shift(1, lg)


def pack_table(indptr, device="cpu", T: int = PACK_ENTRIES) -> LsePacks:
    """The kernels' pack table of a CSR ``indptr`` (host numpy) on
    ``device``: :func:`lse_packs` at ``T`` (``PACK_ENTRIES`` for K10 and
    K11, ``chunk_spmm.SPMV_PACK`` for K8) and :func:`pack_lanes`."""
    indptr = np.asarray(indptr, dtype=np.int64)
    starts = lse_packs(indptr, T)
    table = np.zeros((len(starts), 3), dtype=np.int64)
    table[:, 0] = starts
    table[:, 1] = indptr[starts]
    table[:-1, 2] = np.log2(pack_lanes(indptr, starts)).astype(np.int64)
    return LsePacks(torch.from_numpy(table).to(device), len(indptr) - 1,
                    int(indptr[-1]), T)


_PLAN_PACKS = weakref.WeakKeyDictionary()


def plan_packs(plan, device, T: int = PACK_ENTRIES) -> LsePacks:
    """:func:`pack_table` of a chunk plan (a row plan or a transpose
    plan) on ``device`` at ``T``, cached with the plan per device and
    ``T``, as ``plan.maps`` caches its ``indptr``."""
    cache = _PLAN_PACKS.setdefault(plan, {})
    key = (torch.device(device), T)
    if key not in cache:
        cache[key] = pack_table(plan.indptr, key[0], T)
    return cache[key]


def _packs_for(name, indptr, values, packs: Optional[LsePacks],
               T: int = PACK_ENTRIES) -> LsePacks:
    """``packs``, checked against the shapes of ``indptr`` and
    ``values`` and the kernel's pack size ``T``, or the table built from
    a host copy of ``indptr`` when it is None.  The kernels index their
    per-row outputs and the entries by the table alone and stage a pack
    of at most ``T`` entries, so a table of another pattern, or cut at
    another size, must not reach them."""
    if packs is None:
        return pack_table(indptr.cpu().numpy(), indptr.device, T)
    t = packs.table
    if t.device != indptr.device or t.dtype != torch.int64 or t.ndim != 2 \
            or t.shape[1] != 3 or t.shape[0] < 2 or not t.is_contiguous():
        raise ValueError(f"{name}: packs must be a contiguous (npacks + 1, "
                         f"3) int64 table on {indptr.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    n, nnz = indptr.shape[0] - 1, values.numel()
    if (packs.n, packs.nnz) != (n, nnz):
        raise ValueError(f"{name}: packs were cut for {packs.n} rows and "
                         f"{packs.nnz} entries, got {n} and {nnz}")
    if packs.T != T:
        raise ValueError(f"{name}: packs were cut at {packs.T} entries a "
                         f"pack, the kernel stages {T}")
    return packs
