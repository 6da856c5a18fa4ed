"""Random sparse matrices: uniform, stencil and hybrid patterns.

Port of ``rand_sparse``, ``rand_sparse_tri``, ``stencil_sparse``,
``hybrid_sparse``, ``make_spd_sparse`` and ``make_spd_stencil`` from
``torchsparsegradutils_tpu/utils/random_sparse.py``.  Patterns are built
on the host with numpy from a seeded ``numpy.random.Generator``
(vectorised, so a cfd2-scale pattern of 123,440 rows and 3M entries
takes about a second), in row-major order; values are normal draws from
an explicit CPU ``torch.Generator``, then moved to ``device``.  Each
takes ``pattern_static``, as the JAX package's do: False builds the same
matrix as a dynamic container, its indices on ``device``.  The JAX
package draws from a JAX key, so the same seed gives other matrices
there: tests hand both packages one matrix through
``convert.from_arrays``.

Example:
    >>> from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    ...     rand_sparse, stencil_sparse)
    >>> A = stencil_sparse((6, 6), [-1, 0, 1], device="cpu")
    >>> A.nnz, A.layout
    (16, 'csr')
    >>> R = rand_sparse((3, 6, 5), 7, shared_pattern=True, device="cpu")
    >>> R.shape, R.values.shape, R.indices_batched()
    ((3, 6, 5), torch.Size([3, 7]), False)
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import SparseCOO, SparseCSR

__all__ = ["rand_sparse", "rand_sparse_tri", "stencil_sparse",
           "hybrid_sparse", "make_spd_sparse", "make_spd_stencil"]


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


def _container(layout, rows, cols, values, shape, index_dtype,
               pattern_static=True):
    """Container from row-major sorted ``rows``/``cols``, ``(nnz,)`` or
    one pattern per batch element, ``(*batch, nnz)``; with
    ``pattern_static=False`` the indices go to the values' device."""
    idt = np.dtype(index_dtype)
    if layout == "coo":
        return SparseCOO(rows.astype(idt), cols.astype(idt), values, shape,
                         pattern_static=pattern_static)
    if layout != "csr":
        raise ValueError(f"unknown layout {layout!r}")
    n = shape[-2]
    indptr = np.stack([np.concatenate([[0], np.cumsum(np.bincount(
        r, minlength=n))]) for r in rows.reshape(-1, rows.shape[-1])])
    indptr = indptr.reshape(rows.shape[:-1] + (n + 1,))
    return SparseCSR(indptr.astype(idt), cols.astype(idt), values, shape,
                     pattern_static=pattern_static)


def stencil_sparse(shape, offsets, *, nnz: int = None, layout: str = "csr",
                   dtype=torch.float32, index_dtype=np.int32,
                   well_conditioned: bool = False, generator=None,
                   device="cuda", pattern_static: bool = True):
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
        vals = _boost_diagonal(rows, cols, vals, n)
    return _container(layout, rows, cols, vals.to(device), (n, m),
                      index_dtype, pattern_static)


def _region_capacity(n: int, m: int, region: str) -> int:
    """Cells of the (n, m) matrix in ``region``: "all", "strict_tril"
    (i > j) or "strict_triu" (i < j)."""
    if region == "all":
        return n * m
    k = min(n, m)
    extra = max(0, n - m) * m if region == "strict_tril" \
        else max(0, m - n) * n
    return k * (k - 1) // 2 + extra


def _sample_unique_pairs(rng: np.random.Generator, n: int, m: int,
                         nnz: int, region: str = "all"):
    """``nnz`` distinct (i, j) pairs, uniform over the (n, m) matrix or
    over its strict lower or upper triangle (``region``)."""
    cap = _region_capacity(n, m, region)
    if nnz > cap:
        where = "" if region == "all" else f" of region {region!r}"
        raise ValueError(f"nnz={nnz} exceeds capacity {cap}{where} for "
                         f"shape ({n}, {m})")
    keys = np.empty(0, np.int64)
    want = nnz
    while len(keys) < nnz:
        batch = max(1024, int(1.5 * want) + 16)
        i = rng.integers(0, n, batch, dtype=np.int64)
        j = rng.integers(0, m, batch, dtype=np.int64)
        if region != "all":
            ok = i > j if region == "strict_tril" else i < j
            i, j = i[ok], j[ok]
        keys = np.unique(np.concatenate([keys, i * m + j]))
        want = nnz - len(keys)
    keys = rng.permutation(keys)[:nnz]
    return keys // m, keys % m


def _boost_diagonal(rows, cols, vals, n):
    """Diagonal entries set to 1 + Σ|off-diagonal| of their row (strict
    diagonal dominance), the JAX package's ``well_conditioned`` rule."""
    d = torch.from_numpy(rows == cols)
    r = torch.from_numpy(np.asarray(rows, np.int64))
    off = torch.where(d, torch.zeros_like(vals), vals)
    rowsum = torch.zeros(n, dtype=vals.dtype).index_add(0, r, off.abs())
    return torch.where(d, rowsum[r] + 1.0, off)


def _rand_pattern(rng, n: int, m: int, nnz: int, well_conditioned: bool):
    """Row-major ``(rows, cols)`` of ``nnz`` distinct uniform entries;
    with ``well_conditioned`` the full diagonal plus ``nnz - n`` others,
    padded back to ``nnz`` with entries at (0, 0) as the JAX package
    does (their values are set to 0)."""
    if not well_conditioned:
        rows, cols = _sample_unique_pairs(rng, n, m, nnz)
    else:
        if n != m:
            raise ValueError("well_conditioned requires a square matrix")
        if nnz < n:
            raise ValueError(f"well_conditioned requires nnz >= n ({n})")
        oi, oj = _sample_unique_pairs(rng, n, n, nnz - n)
        keep = oi != oj
        pad = nnz - n - int(keep.sum())
        rows = np.concatenate([np.arange(n), oi[keep], np.zeros(pad, int)])
        cols = np.concatenate([np.arange(n), oj[keep], np.zeros(pad, int)])
    order = np.lexsort((cols, rows))
    return rows[order].astype(np.int64), cols[order].astype(np.int64)


def rand_sparse(shape, nnz: int, *, layout: str = "coo", dtype=torch.float32,
                index_dtype=np.int32, well_conditioned: bool = False,
                shared_pattern: bool = False, generator=None, seed: int = 0,
                device="cuda", pattern_static: bool = True):
    """Random matrix with exactly ``nnz`` distinct entries, uniform over
    the shape, in row-major order.

    Args:
      shape: ``(n, m)`` or batched ``(*batch, n, m)``: one pattern per
        element unless ``shared_pattern``.
      well_conditioned: square matrices only; the full diagonal is among
        the ``nnz`` entries and set above its row's off-diagonal sum, so
        the matrix is comfortably invertible.
      generator: CPU ``torch.Generator`` for the values (seed 0 if None).
      seed: seed of the numpy generator that draws the patterns.
      device: where the values go.
    """
    *batch, n, m = (int(s) for s in shape)
    rng = np.random.default_rng(seed)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    bsz = int(np.prod(batch))                       # 1 when unbatched
    n_pats = 1 if shared_pattern else bsz
    pats = [_rand_pattern(rng, n, m, nnz, well_conditioned)
            for _ in range(n_pats)]
    vals = []
    for i in range(bsz):
        rows, cols = pats[i % n_pats]
        v = _values(gen, nnz, dtype, "cpu")
        if well_conditioned:
            v = _boost_diagonal(rows, cols, v, n)
            v[torch.from_numpy(np.nonzero((rows == 0) & (cols == 0))[0][1:])
              ] = 0
        vals.append(v)
    rows, cols = (np.stack(x).reshape(*batch, nnz) for x in zip(*pats)) \
        if n_pats > 1 else pats[0]
    values = torch.stack(vals).reshape(*batch, nnz).to(device)
    return _container(layout, rows, cols, values, (*batch, n, m),
                      index_dtype, pattern_static)


def _tri_pattern(rng, n: int, m: int, nnz: int, upper: bool, strict: bool):
    """Row-major ``(rows, cols)`` of a random triangle: ``nnz`` distinct
    strictly-triangular entries, or the full diagonal plus ``nnz - min(n,
    m)`` of them."""
    region = "strict_triu" if upper else "strict_tril"
    d = 0 if strict else min(n, m)
    if nnz < d:
        raise ValueError(
            f"non-strict triangular requires nnz >= diagonal length {d}")
    oi, oj = _sample_unique_pairs(rng, n, m, nnz - d, region)
    rows = np.concatenate([np.arange(d), oi]).astype(np.int64)
    cols = np.concatenate([np.arange(d), oj]).astype(np.int64)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order]


def rand_sparse_tri(shape, nnz: int, *, upper: bool = False,
                    strict: bool = False, layout: str = "coo",
                    dtype=torch.float32, index_dtype=np.int32,
                    well_conditioned: bool = True,
                    shared_pattern: bool = False, generator=None,
                    seed: int = 0, device="cuda",
                    pattern_static: bool = True):
    """Random triangular matrix with exactly ``nnz`` entries, row-major.

    Args:
      shape: ``(n, m)`` or batched ``(*batch, n, m)``: one pattern per
        element unless ``shared_pattern``.
      upper, strict: which triangle; a non-strict triangle always holds
        the full diagonal, and ``nnz - min(n, m)`` entries off it.
      well_conditioned: (non-strict) each diagonal entry is 1 + the sum of
        its row's off-diagonal magnitudes, so solves stay stable (the
        default, as solvers are the main consumer); else the diagonal is
        drawn like the rest.
      generator: CPU ``torch.Generator`` for the values (seed 0 if None).
      seed: seed of the numpy generator that draws the patterns.
      device: where the values go.
    """
    *batch, n, m = (int(s) for s in shape)
    rng = np.random.default_rng(seed)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    bsz = int(np.prod(batch))                       # 1 when unbatched
    n_pats = 1 if shared_pattern else bsz
    pats = [_tri_pattern(rng, n, m, nnz, upper, strict)
            for _ in range(n_pats)]
    vals = []
    for i in range(bsz):
        rows, cols = pats[i % n_pats]
        v = _values(gen, nnz, dtype, "cpu")
        if well_conditioned and not strict:
            v = _boost_diagonal(rows, cols, v, n)
        vals.append(v)
    rows, cols = (np.stack(x).reshape(*batch, nnz) for x in zip(*pats)) \
        if n_pats > 1 else pats[0]
    values = torch.stack(vals).reshape(*batch, nnz).to(device)
    return _container(layout, rows, cols, values, (*batch, n, m),
                      index_dtype, pattern_static)


def hybrid_sparse(shape, offsets, nnz: int, *, dia_coverage: float,
                  layout: str = "csr", dtype=torch.float32,
                  index_dtype=np.int32, generator=None, seed: int = 0,
                  device="cuda", pattern_static: bool = True):
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
    return _container(layout, rows, cols, vals, (n, m), index_dtype,
                      pattern_static)


def _spd_values(rows, cols, half, pair, n):
    """Values of a symmetric pattern: entry ``e`` off the diagonal takes
    ``half[pair[e]]`` (so a mirrored pair shares one value) and each
    diagonal entry ``1 + Σ|off-diagonal|`` of its row."""
    d = torch.from_numpy(rows == cols)
    r = torch.from_numpy(np.asarray(rows, np.int64))
    twin = half[torch.from_numpy(np.maximum(pair, 0))] if len(half) else \
        torch.zeros(len(rows), dtype=half.dtype)
    off = torch.where(d, torch.zeros((), dtype=half.dtype), twin)
    absrow = torch.zeros(n, dtype=half.dtype).index_add(0, r, off.abs())
    return torch.where(d, absrow[r] + 1.0, off)


def _mirror_pairs(rows, cols, n):
    """For row-major ``(rows, cols)`` of a symmetric pattern: the index,
    among the strictly upper entries in their order, of each entry's
    upper twin (its own index above the diagonal, its mirror's below;
    -1 on the diagonal)."""
    upper = cols > rows
    ukeys = rows[upper] * n + cols[upper]          # ascending: row-major
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    pair = np.searchsorted(ukeys, lo * n + hi)
    return np.where(rows == cols, -1, pair), int(upper.sum())


def make_spd_sparse(n: int, nnz: int, *, layout: str = "coo",
                    dtype=torch.float32, index_dtype=np.int32, seed: int = 0,
                    generator=None, device="cuda",
                    pattern_static: bool = True):
    """Random sparse symmetric positive-definite matrix, row-major.

    The JAX package's rule: off-diagonal entries come in mirrored
    (i, j) / (j, i) pairs with equal values (normal draws times 0.5), and
    ``diag[i] = 1 + Σ_j |A[i, j]|``, which makes the matrix SPD.
    ``nnz`` counts every stored entry: ``nnz >= n`` and ``nnz - n`` even.

    Args:
      seed: seed of the numpy generator that draws the pattern.
      generator: CPU ``torch.Generator`` for the values (seed 0 if None).
      device: where the values go.
    """
    if nnz < n:
        raise ValueError(f"make_spd_sparse requires nnz >= n, got {nnz} < {n}")
    if (nnz - n) % 2:
        raise ValueError("nnz - n must be even (mirrored off-diagonal pairs)")
    k_half = (nnz - n) // 2
    oi, oj = _sample_unique_pairs(np.random.default_rng(seed), n, n, k_half,
                                  "strict_tril")
    ar = np.arange(n, dtype=np.int64)
    rows = np.concatenate([ar, oi, oj])
    cols = np.concatenate([ar, oj, oi])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    half = _values(generator, k_half, dtype, "cpu") * 0.5
    # the lower draw t is the pair (oi[t], oj[t]); each entry's twin index
    pair = np.concatenate([np.full(n, -1), np.arange(k_half),
                           np.arange(k_half)])[order]
    vals = _spd_values(rows, cols, half, pair, n)
    return _container(layout, rows, cols, vals.to(device), (n, n),
                      index_dtype, pattern_static)


def make_spd_stencil(n: int, offsets, *, nnz: int = None,
                     layout: str = "csr", dtype=torch.float32,
                     index_dtype=np.int32, generator=None, device="cuda",
                     pattern_static: bool = True):
    """Symmetric positive-definite stencil matrix (cfd2-like), row-major.

    The offsets are symmetrised (±d and the main diagonal); mirrored
    entries share a value and ``diag = 1 + Σ|off|`` per row, as in the
    JAX package.  ``nnz`` thins the off-diagonal pairs to about that
    count with the JAX package's fixed draw
    (``np.random.default_rng(0)``), so both packages give the same
    pattern; the mirror is found by a sorted search, not per entry.

    Args:
      generator: CPU ``torch.Generator`` for the values (seed 0 if None).
      device: where the values go.
    """
    offs = np.unique(np.abs(np.asarray(offsets, np.int64)))
    offs = offs[offs > 0]
    full = np.concatenate([-offs[::-1], [0], offs])
    rows, cols = _stencil_pattern(n, n, full, None)
    if nnz is not None and nnz < len(rows):
        upper = np.where(cols > rows)[0]
        keep_pairs = max(0, (nnz - n) // 2)
        if keep_pairs < len(upper):
            sel = np.sort(np.random.default_rng(0).choice(
                upper, keep_pairs, replace=False))
            # keep the diagonal, the chosen upper entries and their
            # mirrors: an entry whose (min, max) key is a chosen one
            keep = rows == cols
            if keep_pairs:
                skeys = rows[sel] * n + cols[sel]      # ascending
                key = np.minimum(rows, cols) * n + np.maximum(rows, cols)
                pos = np.minimum(np.searchsorted(skeys, key), keep_pairs - 1)
                keep |= skeys[pos] == key
            rows, cols = rows[keep], cols[keep]
    pair, n_upper = _mirror_pairs(rows, cols, n)
    half = _values(generator, n_upper, dtype, "cpu") * 0.5
    vals = _spd_values(rows, cols, half, pair, n)
    return _container(layout, rows, cols, vals.to(device), (n, n),
                      index_dtype, pattern_static)
