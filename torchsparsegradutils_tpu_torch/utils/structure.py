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

Patterns are host numpy here, always (the JAX package's traced-pattern
branch has no counterpart).  The value permutation of
:func:`coo_to_csr` runs through the gather kernel
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
from ..types import SparseCOO, SparseCSR, StaticArray, is_sparse

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
    of each per element, stacked.
    """
    row, col = coo.rows(), coo.cols()
    n = coo.shape[-2]
    if row.ndim == 1:
        return _csr_of(row, col, n)
    parts = [_csr_of(r, c, n) for r, c in
             zip(row.reshape(-1, coo.nnz), col.reshape(-1, coo.nnz))]
    bshape = row.shape[:-1]
    return (np.stack([p[0] for p in parts]).reshape(bshape + (n + 1,)),
            np.stack([p[1] for p in parts]).reshape(bshape + (coo.nnz,)),
            np.stack([p[2] for p in parts]).reshape(bshape + (coo.nnz,)))


def _permute_values(values: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """``values[..., perm]``.  One-dimensional values and a shared
    permutation go through the gather kernel, whose backward is the
    gather by the inverse permutation; batched ones through
    ``index_select`` / ``take_along_dim``."""
    dev = values.device
    if perm.ndim == 1:
        perm_sa = StaticArray(perm.astype(np.int64))
        if values.ndim == 1:
            inv = np.empty_like(perm_sa.arr)
            inv[perm_sa.arr] = np.arange(len(perm), dtype=np.int64)
            return WindowGather.apply(values, perm_sa.on(dev),
                                      StaticArray(inv).on(dev))
        return values.index_select(-1, perm_sa.on(dev))
    idx = torch.from_numpy(perm.astype(np.int64)).to(dev)
    return torch.take_along_dim(values, idx.expand(values.shape), -1)


def coo_to_csr(coo: SparseCOO) -> SparseCSR:
    """Convert COO to CSR, the values permuted differentiably."""
    if not isinstance(coo, SparseCOO):
        raise TypeError(f"expected SparseCOO, got {type(coo)}")
    indptr, col, perm = coo_to_csr_indices_values(coo)
    return SparseCSR(indptr, col, _permute_values(coo.values, perm),
                     coo.shape)


def csr_to_coo(csr: SparseCSR) -> SparseCOO:
    return csr.tocoo()


def csr_transpose(csr: SparseCSR) -> SparseCSR:
    """Transpose a CSR matrix (pattern work on the host)."""
    return coo_to_csr(csr.tocoo().transpose())


def coalesce(coo: SparseCOO) -> SparseCOO:
    """Sum duplicate coordinates and sort row-major (a host pattern op).

    The deduplicated nnz becomes the new nnz; batched per-element
    patterns must deduplicate to equal nnz.
    """
    row, col = coo.rows(), coo.cols()
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

def _batch_slice(sp, i: int):
    """2-D slice i of a singly batched container."""
    values = sp.values[i]
    if sp.layout == "coo":
        r, c = sp.rows(), sp.cols()
        if r.ndim > 1:
            r, c = r[i], c[i]
        return SparseCOO(r, c, values, sp.shape[-2:])
    ip, ix = sp.indptr_np(), sp.cols()
    if ip.ndim > 1:
        ip, ix = ip[i], ix[i]
    return SparseCSR(ip, ix, values, sp.shape[-2:])


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
    shape = (sum(m.shape[0] for m in mats), sum(m.shape[1] for m in mats))
    values = torch.cat([m.values for m in mats])
    r_offs = np.cumsum([0] + [m.shape[0] for m in mats])
    c_offs = np.cumsum([0] + [m.shape[1] for m in mats])
    cols = np.concatenate([m.cols() + c for m, c in zip(mats, c_offs)])
    if layout == "coo":
        rows = np.concatenate([m.rows() + r for m, r in zip(mats, r_offs)])
        return SparseCOO(rows, cols, values, shape)
    # CSR: row pointers joined with cumulative nnz offsets
    nnz_offs = np.cumsum([0] + [m.nnz for m in mats])
    indptr = np.concatenate(
        [mats[0].indptr_np()[:1]]
        + [m.indptr_np()[1:] + o for m, o in zip(mats, nnz_offs)])
    return SparseCSR(indptr, cols, values, shape)


def sparse_block_diag_split(sp, *shapes: Tuple[int, int]):
    """Split a block-diagonal sparse matrix back into blocks (the inverse
    of :func:`sparse_block_diag`).  The block shapes must tile the
    diagonal; each block holds the entries that fall inside it."""
    if not shapes:
        raise ValueError("provide at least one block shape")
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
               index_dtype=np.int32, device="cuda"):
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
        return SparseCOO(idx, idx, values, shape)
    if layout == "csr":
        return SparseCSR(np.arange(n + 1, dtype=np.dtype(index_dtype)), idx,
                         values, shape)
    raise ValueError(f"unknown layout {layout!r}")


def sparse_stack(mats: Sequence[Union[SparseCOO, SparseCSR]]):
    """Stack 2-D sparse matrices of equal layout, shape and nnz into one
    batched container; equal patterns stay one shared pattern."""
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
    first = np.stack([m.rows() if layout == "coo" else m.indptr_np()
                      for m in mats])
    cols = np.stack([m.cols() for m in mats])
    if (first == first[0]).all() and (cols == cols[0]).all():
        first, cols = first[0], cols[0]
    if layout == "coo":
        return SparseCOO(first, cols, values, new_shape)
    return SparseCSR(first, cols, values, new_shape)
