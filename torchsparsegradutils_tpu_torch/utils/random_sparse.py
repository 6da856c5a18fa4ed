"""Random sparse matrices on diagonal-structured patterns.

Port of ``stencil_sparse`` and ``hybrid_sparse`` from
``torchsparsegradutils_tpu/utils/random_sparse.py``.  Patterns are built
on the host with numpy (vectorised, so the cfd2-scale stencil of
123,440 rows and 3M entries takes about a second); values are normal
draws from an explicit CPU ``torch.Generator``, then moved to
``device``.  The JAX package draws values from a JAX key, so the same
seed gives other values there: tests hand both packages one matrix
through ``convert.from_arrays``.

Example:
    >>> from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    ...     stencil_sparse)
    >>> A = stencil_sparse((6, 6), [-1, 0, 1], device="cpu")
    >>> A.nnz, A.layout
    (16, 'csr')
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import SparseCOO, SparseCSR

__all__ = ["stencil_sparse", "hybrid_sparse"]


def _stencil_pattern(n: int, m: int, offsets, nnz):
    offs = np.unique(np.asarray(offsets, np.int64))
    if len(offs) == 0:
        raise ValueError("stencil_sparse: offsets must be non-empty")
    if offs.min() <= -n or offs.max() >= m:
        raise ValueError("stencil_sparse: offsets exceed matrix bounds")
    rows, cols = [], []
    for d in offs:
        r = np.arange(max(0, -int(d)), min(n, m - int(d)), dtype=np.int64)
        rows.append(r)
        cols.append(r + int(d))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    full = len(rows)
    if nnz is not None:
        if not 0 < nnz <= full:
            raise ValueError(f"stencil_sparse: nnz={nnz} not in (0, {full}] "
                             f"for these offsets")
        if nnz < full:
            keep = np.sort(np.random.default_rng(0).choice(
                full, nnz, replace=False))
            rows, cols = rows[keep], cols[keep]
    order = np.lexsort((cols, rows))
    return rows[order], cols[order]


def _values(generator, nnz: int, dtype, device):
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.randn(nnz, generator=gen, dtype=draw).to(dtype).to(device)


def _container(layout, rows, cols, values, shape, index_dtype):
    """Container from row-major sorted ``rows``/``cols``."""
    idt = np.dtype(index_dtype)
    if layout == "coo":
        return SparseCOO(rows.astype(idt), cols.astype(idt), values, shape)
    if layout != "csr":
        raise ValueError(f"unknown layout {layout!r}")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=shape[0]))])
    return SparseCSR(indptr.astype(idt), cols.astype(idt), values, shape)


def stencil_sparse(shape, offsets, *, nnz: int = None, layout: str = "csr",
                   dtype=torch.float32, index_dtype=np.int32,
                   well_conditioned: bool = False, generator=None,
                   device="cuda"):
    """Random-valued matrix on a stencil (union-of-diagonals) pattern.

    Args:
      shape: ``(n, m)``.
      offsets: diagonal offsets (``col - row``), cut at the borders.
      nnz: thin the full stencil to exactly ``nnz`` entries (a fixed
        subsample).
      well_conditioned: make the matrix strictly diagonally dominant
        (needs offset 0).
      generator: CPU ``torch.Generator`` for the values (seed 0 if None).
      device: where the values go.
    """
    n, m = shape
    rows, cols = _stencil_pattern(n, m, offsets, nnz)
    on_diag = rows == cols
    if well_conditioned and not on_diag.any():
        raise ValueError("well_conditioned stencil needs offset 0")
    vals = _values(generator, len(rows), dtype, "cpu")
    if well_conditioned:
        d = torch.from_numpy(on_diag)
        off = torch.where(d, torch.zeros_like(vals), vals)
        rowsum = torch.zeros(n, dtype=vals.dtype).index_add(
            0, torch.from_numpy(rows), off.abs())
        vals = torch.where(d, rowsum[torch.from_numpy(rows)] + 1.0, off)
    return _container(layout, rows, cols, vals.to(device), (n, m),
                      index_dtype)


def _sample_unique_pairs(rng: np.random.Generator, n: int, m: int,
                         nnz: int):
    """``nnz`` distinct (i, j) pairs, uniform over the (n, m) matrix."""
    if nnz > n * m:
        raise ValueError(f"nnz={nnz} exceeds capacity {n * m} for shape "
                         f"({n}, {m})")
    keys = np.empty(0, np.int64)
    want = nnz
    while len(keys) < nnz:
        batch = max(1024, int(1.5 * want) + 16)
        cand = (rng.integers(0, n, batch, dtype=np.int64) * m
                + rng.integers(0, m, batch, dtype=np.int64))
        keys = np.unique(np.concatenate([keys, cand]))
        want = nnz - len(keys)
    keys = rng.permutation(keys)[:nnz]
    return keys // m, keys % m


def hybrid_sparse(shape, offsets, nnz: int, *, dia_coverage: float,
                  layout: str = "csr", dtype=torch.float32,
                  index_dtype=np.int32, generator=None, seed: int = 0,
                  device="cuda"):
    """Stencil-plus-residual matrix at a target DIA coverage.

    ``round(nnz * dia_coverage)`` entries lie on the stencil ``offsets``
    (thinned uniformly) and the rest are drawn uniformly off it, from a
    numpy generator seeded with ``seed``; the DIA planner keeps the
    stencil diagonals and sends the rest to the hybrid residual.
    ``dia_coverage(A)`` reports the coverage reached.
    """
    n, m = shape
    if not 0.0 < dia_coverage <= 1.0:
        raise ValueError(f"dia_coverage={dia_coverage} not in (0, 1]")
    nnz_s = int(round(nnz * dia_coverage))
    full = len(_stencil_pattern(n, m, offsets, None)[0])
    nnz_s = min(nnz_s, full)
    rows_s, cols_s = _stencil_pattern(n, m, offsets, nnz_s or None)
    nnz_r = nnz - len(rows_s)
    rng = np.random.default_rng(seed)
    rows, cols = rows_s, cols_s
    if nnz_r > 0:
        stencil_keys = rows_s * m + cols_s
        got = np.empty(0, np.int64)
        for _ in range(64):
            if len(got) >= nnz_r:
                break
            i, j = _sample_unique_pairs(rng, n, m,
                                        int((nnz_r - len(got)) * 1.2) + 16)
            k = i * m + j
            k = np.unique(k[~np.isin(k, stencil_keys)])
            got = np.concatenate([got, k[~np.isin(k, got)]])
        if len(got) < nnz_r:
            raise ValueError(f"hybrid_sparse: no room for {nnz_r} entries "
                             f"off the stencil in shape ({n}, {m})")
        got = got[rng.permutation(len(got))[:nnz_r]]
        rows = np.concatenate([rows_s, got // m])
        cols = np.concatenate([cols_s, got % m])
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
    vals = _values(generator, len(rows), dtype, device)
    return _container(layout, rows, cols, vals, (n, m), index_dtype)
