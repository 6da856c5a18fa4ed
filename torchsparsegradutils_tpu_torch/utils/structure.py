"""Sparse structure utilities: conversions, block diagonals, identity,
stacking.

Port of ``torchsparsegradutils_tpu/utils/structure.py``:

* :func:`coo_to_csr` / :func:`csr_to_coo`, and
  :func:`coo_to_csr_indices_values` (the CSR pattern and the permutation
  from COO order to CSR order);
* :func:`csr_transpose`;
* :func:`coalesce`: sum duplicate coordinates, sort row-major;
* :func:`sparse_block_diag` / :func:`sparse_block_diag_split`;
* :func:`sparse_eye`;
* :func:`sparse_stack` (the reference's ``stack_csr``, both layouts).

Static patterns are host numpy.  A dynamic pattern (``pattern_static=
False``) stays on its device, as the JAX package's traced branch does:
:func:`coo_to_csr` sorts the int64 key ``row * m + col`` with a stable
``torch.sort`` and builds ``indptr`` with ``torch.searchsorted``, with
no host read; ``coalesce``, ``coo_to_csr_indices_values``,
``sparse_block_diag_split`` and a per-element batched ``coo_to_csr``
raise the JAX package's refusal instead.  The value permutation of
:func:`coo_to_csr`, static or dynamic, runs through the gather kernel
(``kernels/window_gather.py``, ``csrc/gather.cu`` on the card), whose
backward is the same gather by the inverse permutation, not a
scatter-add.

Example:
    >>> import numpy as np, torch
    >>> from torchsparsegradutils_tpu_torch import SparseCOO
    >>> A = SparseCOO(np.array([1, 0, 1]), np.array([0, 1, 1]),
    ...               torch.tensor([1.0, 2.0, 3.0]), (2, 2))
    >>> C = coo_to_csr(A)
    >>> C.indptr_np().tolist(), C.values.tolist()
    ([0, 1, 3], [2.0, 1.0, 3.0])
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.window_gather import WindowGather
from ..types import (SparseCOO, SparseCSR, StaticArray, is_sparse,
                     refuse_dynamic)

__all__ = [
    "coo_to_csr",
    "coo_to_csr_indices_values",
    "csr_to_coo",
    "csr_transpose",
    "coalesce",
    "sparse_block_diag",
    "sparse_block_diag_split",
    "sparse_eye",
    "sparse_stack",
]


# --------------------------------------------------------------------------
# COO <-> CSR
# --------------------------------------------------------------------------

def _csr_of(row: np.ndarray, col: np.ndarray, n: int):
    """``(indptr, cols, perm)`` of one pattern: a stable row-major sort
    (the JAX package's ``native.lexsort_rowcol``)."""
    perm = np.lexsort((col, row))
    counts = np.bincount(row, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(row.dtype)
    return indptr, col[perm], perm


def coo_to_csr_indices_values(coo: SparseCOO):
    """``(indptr, col_indices, permutation)`` of a COO pattern, host numpy.

    The permutation maps the COO entry order to CSR order: ``values[...,
    perm]`` are the CSR values.  A per-element batched pattern gives one
    of each per element, stacked.  A dynamic pattern refuses, as in the
    JAX package.
    """
    row = coo.rows_np("coo_to_csr conversion")
    col = coo.cols_np("coo_to_csr conversion")
    n = coo.shape[-2]
    if row.ndim == 1:
        return _csr_of(row, col, n)
    parts = [_csr_of(r, c, n) for r, c in
             zip(row.reshape(-1, coo.nnz), col.reshape(-1, coo.nnz))]
    bshape = row.shape[:-1]
    return (np.stack([p[0] for p in parts]).reshape(bshape + (n + 1,)),
            np.stack([p[1] for p in parts]).reshape(bshape + (coo.nnz,)),
            np.stack([p[2] for p in parts]).reshape(bshape + (coo.nnz,)))


def _permute_values(values: torch.Tensor, perm) -> torch.Tensor:
    """``values[..., perm]``, ``perm`` host numpy or an int64 tensor on
    the values' device.  One-dimensional values and a shared permutation
    go through the gather kernel, whose backward is the gather by the
    inverse permutation (made on the device by a scatter for a tensor);
    batched ones through ``index_select`` / ``take_along_dim``."""
    dev = values.device
    if isinstance(perm, np.ndarray):
        if perm.ndim == 1:
            perm_sa = StaticArray(perm.astype(np.int64))
            if values.ndim == 1:
                inv = np.empty_like(perm_sa.arr)
                inv[perm_sa.arr] = np.arange(len(perm), dtype=np.int64)
                return WindowGather.apply(values, perm_sa.on(dev),
                                          StaticArray(inv).on(dev))
            return values.index_select(-1, perm_sa.on(dev))
        perm = torch.from_numpy(perm.astype(np.int64)).to(dev)
    if perm.ndim == 1:
        if values.ndim == 1:
            inv = torch.empty_like(perm).scatter_(
                0, perm, torch.arange(len(perm), device=dev))
            return WindowGather.apply(values, perm, inv)
        return values.index_select(-1, perm)
    return torch.take_along_dim(values, perm.expand(values.shape), -1)


def _sorted_order(row: torch.Tensor, col: torch.Tensor, m: int):
    """Stable row-major order of a device pattern along its last axis
    (the JAX package's ``lexsort((col, row))``), by the int64 key
    ``row * m + col``, which cannot overflow."""
    key = row.to(torch.int64) * m + col.to(torch.int64)
    return torch.sort(key, dim=-1, stable=True).indices


def sort_dynamic(coo: SparseCOO) -> SparseCOO:
    """``coo.sort_indices()`` of a dynamic pattern, on its device."""
    perm = _sorted_order(coo.row, coo.col, coo.shape[-1])
    take = (lambda t: t.index_select(0, perm)) if perm.ndim == 1 else \
        (lambda t: torch.take_along_dim(t, perm, -1))
    return SparseCOO(take(coo.row), take(coo.col),
                     _permute_values(coo.values, perm), coo.shape,
                     pattern_static=False, _skip_checks=True)


def _dynamic_coo_to_csr(coo: SparseCOO) -> SparseCSR:
    """The JAX package's traced ``coo_to_csr``: a stable sort of the
    pattern on its device, ``indptr`` by ``searchsorted`` over the sorted
    rows, the values through the gather kernel; no host read."""
    row, col = coo.row, coo.col
    if row.ndim != 1:
        raise ValueError("traced coo_to_csr supports unbatched patterns only")
    n = coo.shape[-2]
    perm = _sorted_order(row, col, coo.shape[-1])
    row_s = row.index_select(0, perm)
    bounds = torch.arange(n + 1, dtype=row.dtype, device=row.device)
    indptr = torch.searchsorted(row_s, bounds,
                                out_int32=row.dtype == torch.int32)
    return SparseCSR(indptr, col.index_select(0, perm),
                     _permute_values(coo.values, perm), coo.shape,
                     pattern_static=False, _skip_checks=True)


def coo_to_csr(coo: SparseCOO) -> SparseCSR:
    """Convert COO to CSR, the values permuted differentiably."""
    if not isinstance(coo, SparseCOO):
        raise TypeError(f"expected SparseCOO, got {type(coo)}")
    if not coo.pattern_static:
        return _dynamic_coo_to_csr(coo)
    indptr, col, perm = coo_to_csr_indices_values(coo)
    return SparseCSR(indptr, col, _permute_values(coo.values, perm),
                     coo.shape)


def csr_to_coo(csr: SparseCSR) -> SparseCOO:
    return csr.tocoo()


def csr_transpose(csr: SparseCSR) -> SparseCSR:
    """Transpose a CSR matrix (pattern work on the host; on the device
    for a dynamic pattern)."""
    return coo_to_csr(csr.tocoo().transpose())


def coalesce(coo: SparseCOO) -> SparseCOO:
    """Sum duplicate coordinates and sort row-major (a host pattern op).

    The deduplicated nnz becomes the new nnz; batched per-element
    patterns must deduplicate to equal nnz.  A dynamic pattern refuses,
    as in the JAX package (the new nnz is a read of the pattern).
    """
    row, col = coo.rows_np("coalesce"), coo.cols_np("coalesce")
    m = coo.shape[-1]
    if row.ndim == 1:
        keys = row.astype(np.int64) * m + col.astype(np.int64)
        uniq, inv = np.unique(keys, return_inverse=True)
        vals = coo.values
        seg = torch.from_numpy(inv.reshape(-1).astype(np.int64)).to(
            vals.device)
        new = vals.new_zeros(vals.shape[:-1] + (len(uniq),)).index_add(
            -1, seg, vals)
        return SparseCOO((uniq // m).astype(row.dtype),
                         (uniq % m).astype(col.dtype), new, coo.shape)
    outs = [coalesce(SparseCOO(r, c, d, coo.shape[-2:])) for r, c, d in
            zip(row.reshape(-1, coo.nnz), col.reshape(-1, coo.nnz),
                coo.values.reshape(-1, coo.nnz))]
    nnzs = {o.nnz for o in outs}
    if len(nnzs) != 1:
        raise ValueError(
            f"coalesce on batched per-element patterns produced unequal nnz "
            f"{sorted(nnzs)}; static shapes require equal nnz")
    nnz = nnzs.pop()
    bshape = row.shape[:-1]
    return SparseCOO(
        np.stack([o.rows() for o in outs]).reshape(bshape + (nnz,)),
        np.stack([o.cols() for o in outs]).reshape(bshape + (nnz,)),
        torch.stack([o.values for o in outs]).reshape(
            coo.batch_shape + (nnz,)), coo.shape)


# --------------------------------------------------------------------------
# block diagonal
# --------------------------------------------------------------------------

def _pattern(sp, static: bool, what: str):
    """A container's own index arrays: ``(row, col)`` or ``(indptr,
    indices)``; host numpy when ``static`` (a dynamic pattern refuses,
    naming ``what``), else tensors on the values' device."""
    if static:
        first = sp.rows_np(what) if sp.layout == "coo" else \
            sp.indptr_np(what)
        return first, sp.cols_np(what)
    if sp.pattern_static:
        return tuple(torch.from_numpy(np.array(a)).to(sp.device)
                     for a in _pattern(sp, True, what))
    if sp.layout == "coo":
        return sp.row, sp.col
    return sp.indptr, sp.indices


def _cat(parts):
    return torch.cat(parts) if isinstance(parts[0], torch.Tensor) else \
        np.concatenate(parts)


def _batch_slice(sp, i: int):
    """2-D slice i of a singly batched container."""
    first, second = _pattern(sp, sp.pattern_static, "batch slicing")
    if first.ndim > 1:
        first, second = first[i], second[i]
    cls = SparseCOO if sp.layout == "coo" else SparseCSR
    return cls(first, second, sp.values[i], sp.shape[-2:],
               pattern_static=sp.pattern_static)


def sparse_block_diag(*mats: Union[SparseCOO, SparseCSR]):
    """Assemble 2-D sparse matrices of one layout into one block-diagonal
    matrix; a single batched (3-D) container is taken as its slices."""
    if len(mats) == 1 and is_sparse(mats[0]) and mats[0].ndim == 3:
        src = mats[0]
        mats = tuple(_batch_slice(src, i) for i in range(src.shape[0]))
    if not mats:
        raise ValueError("sparse_block_diag requires at least one matrix")
    if not all(is_sparse(m) and m.ndim == 2 for m in mats):
        raise ValueError("all inputs must be 2-D sparse containers")
    layout = mats[0].layout
    if not all(m.layout == layout for m in mats):
        raise ValueError("all inputs must share a layout")
    static = mats[0].pattern_static
    shape = (sum(m.shape[0] for m in mats), sum(m.shape[1] for m in mats))
    values = torch.cat([m.values for m in mats])
    r_offs = np.cumsum([0] + [m.shape[0] for m in mats])
    c_offs = np.cumsum([0] + [m.shape[1] for m in mats])
    pats = [_pattern(m, static, "sparse_block_diag") for m in mats]
    if not static:
        r_offs, c_offs = r_offs.tolist(), c_offs.tolist()
    cols = _cat([p[1] + c for p, c in zip(pats, c_offs)])
    if layout == "coo":
        rows = _cat([p[0] + r for p, r in zip(pats, r_offs)])
        return SparseCOO(rows, cols, values, shape, pattern_static=static)
    # CSR: row pointers joined with cumulative nnz offsets
    nnz_offs = np.cumsum([0] + [m.nnz for m in mats])
    nnz_offs = nnz_offs if static else nnz_offs.tolist()
    indptr = _cat([pats[0][0][:1]]
                  + [p[0][1:] + o for p, o in zip(pats, nnz_offs)])
    return SparseCSR(indptr, cols, values, shape, pattern_static=static)


def sparse_block_diag_split(sp, *shapes: Tuple[int, int]):
    """Split a block-diagonal sparse matrix back into blocks (the inverse
    of :func:`sparse_block_diag`).  The block shapes must tile the
    diagonal; each block holds the entries that fall inside it.  A
    dynamic pattern refuses, as in the JAX package: each block's nnz is a
    read of the pattern."""
    if not shapes:
        raise ValueError("provide at least one block shape")
    if not sp.pattern_static:
        refuse_dynamic("sparse_block_diag_split")
    out = []
    r_off = c_off = 0
    if sp.layout == "coo":
        row, col = sp.rows(), sp.cols()
        for bn, bm in shapes:
            idx = np.nonzero((row >= r_off) & (row < r_off + bn)
                             & (col >= c_off) & (col < c_off + bm))[0]
            sel = StaticArray(idx.astype(np.int64)).on(sp.device)
            out.append(SparseCOO(row[idx] - r_off, col[idx] - c_off,
                                 sp.values.index_select(-1, sel), (bn, bm)))
            r_off += bn
            c_off += bm
        return tuple(out)
    ip, ix = sp.indptr_np(), sp.cols()
    for bn, bm in shapes:
        lo, hi = int(ip[r_off]), int(ip[r_off + bn])
        sub_ix = ix[lo:hi] - c_off
        if sub_ix.size and (sub_ix.min() < 0 or sub_ix.max() >= bm):
            raise ValueError("matrix has entries outside the diagonal blocks")
        out.append(SparseCSR(ip[r_off:r_off + bn + 1] - lo, sub_ix,
                             sp.values[..., lo:hi], (bn, bm)))
        r_off += bn
        c_off += bm
    return tuple(out)


# --------------------------------------------------------------------------
# constructors
# --------------------------------------------------------------------------

def sparse_eye(shape, *, layout: str = "coo", value_dtype=torch.float32,
               index_dtype=np.int32, device="cuda",
               pattern_static: bool = True):
    """Sparse identity, optionally batched: ``shape`` is ``(*batch, n,
    n)``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) < 2 or shape[-1] != shape[-2]:
        raise ValueError(f"sparse_eye requires a square trailing shape, got "
                         f"{shape}")
    n = shape[-1]
    idx = np.arange(n, dtype=np.dtype(index_dtype))
    values = torch.ones(shape[:-2] + (n,), dtype=value_dtype, device=device)
    if layout == "coo":
        return SparseCOO(idx, idx, values, shape,
                         pattern_static=pattern_static)
    if layout == "csr":
        return SparseCSR(np.arange(n + 1, dtype=np.dtype(index_dtype)), idx,
                         values, shape, pattern_static=pattern_static)
    raise ValueError(f"unknown layout {layout!r}")


def sparse_stack(mats: Sequence[Union[SparseCOO, SparseCSR]]):
    """Stack 2-D sparse matrices of equal layout, shape and nnz into one
    batched container; equal patterns stay one shared pattern.  Dynamic
    patterns are stacked on their device, one per element, and shared
    only where every matrix holds the same index tensors (comparing
    their contents would read them back)."""
    mats = list(mats)
    if not mats:
        raise ValueError("sparse_stack requires at least one matrix")
    layout, shape, nnz = mats[0].layout, mats[0].shape, mats[0].nnz
    if not all(m.layout == layout and m.shape == shape and m.nnz == nnz
               for m in mats):
        raise ValueError("all matrices must share layout, shape, and nnz")
    if any(m.ndim != 2 for m in mats):
        raise ValueError("sparse_stack stacks 2-D matrices")
    values = torch.stack([m.values for m in mats])
    new_shape = (len(mats),) + shape
    static = mats[0].pattern_static
    pats = [_pattern(m, static, "sparse_stack") for m in mats]
    if static:
        first = np.stack([p[0] for p in pats])
        cols = np.stack([p[1] for p in pats])
        if (first == first[0]).all() and (cols == cols[0]).all():
            first, cols = first[0], cols[0]
    elif all(p[0] is pats[0][0] and p[1] is pats[0][1] for p in pats):
        first, cols = pats[0]
    else:
        first = torch.stack([p[0] for p in pats])
        cols = torch.stack([p[1] for p in pats])
    cls = SparseCOO if layout == "coo" else SparseCSR
    return cls(first, cols, values, new_shape, pattern_static=static)
