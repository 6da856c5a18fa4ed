"""PyTorch port: the DIA engine held against the JAX package's.

Plans are compared field by field with the JAX ``build_dia_plan``.  The
engine's functions are compared with their JAX counterparts in float64,
where the JAX package runs its XLA branches (no Pallas); one float32 case
runs the JAX Pallas kernels in interpret mode, as ``tests/test_dia.py``
does.  Gradient formulas of the port's autograd Functions are checked
with ``gradcheck`` and ``gradgradcheck``.  Matrices come from the port's
numpy generators and inputs from numpy with a fixed seed; both packages
compute on the same arrays.
"""

import numpy as np
import pytest
import torch

from torchsparsegradutils_tpu import dia_coverage as jax_dia_coverage
from torchsparsegradutils_tpu.kernels import dia as jdia
from torchsparsegradutils_tpu.types import SparseCOO as JCOO
from torchsparsegradutils_tpu.types import SparseCSR as JCSR
from torchsparsegradutils_tpu_torch import (SparseCOO, dia_coverage,
                                            to_arrays)
from torchsparsegradutils_tpu_torch.kernels import dia
from torchsparsegradutils_tpu_torch.kernels.window_gather import (
    WindowGather, window_gather)
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    hybrid_sparse, stencil_sparse)

RNG = np.random.default_rng(0)


def jax_of(A):
    """The JAX container holding the same arrays as port container A."""
    lay, i0, i1, data, shape = to_arrays(A)
    return (JCOO if lay == "coo" else JCSR)(i0, i1, data, shape)


def plans(A):
    """(JAX plan, port plan, JAX container) of port container A."""
    Aj = jax_of(A)
    n, m = A.shape
    return (jdia.build_dia_plan(Aj.row_sa(), Aj.col_sa(), n, m),
            dia.build_dia_plan(A.row_sa(), A.col_sa(), n, m), Aj)


def _stray_hybrid(n=300, frac=0.05):
    """Stencil plus random stray entries (tests/test_dia.py's hybrid)."""
    base = stencil_sparse((n, n), [-9, -1, 0, 1, 9], device="cpu")
    rng = np.random.default_rng(5)
    k = int(base.nnz * frac)
    rows = np.concatenate([base.rows(), rng.integers(0, n, k)])
    cols = np.concatenate([base.cols(), rng.integers(0, n, k)])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    keep = np.ones(len(rows), bool)
    keep[1:] = (np.diff(rows) != 0) | (np.diff(cols) != 0)
    rows, cols = rows[keep], cols[keep]
    data = torch.from_numpy(RNG.standard_normal(len(rows))).float()
    return SparseCOO(rows.astype(np.int32), cols.astype(np.int32), data,
                     (n, n))


def _gen(fn, *args, **kw):
    return lambda: fn(*args, device="cpu", **kw)


PATTERNS = {
    "stencil": _gen(stencil_sparse, (257, 257), [-12, -1, 0, 1, 5]),
    "thinned": _gen(stencil_sparse, (257, 257), [-7, -1, 0, 1, 7],
                    nnz=900),
    "rect": _gen(stencil_sparse, (120, 200), [-3, 0, 2, 40]),
    "hybrid": _gen(hybrid_sparse, (400, 400), [0, 1, -1, 9, -9], 1600,
                   dia_coverage=0.8),
    "tall": _gen(hybrid_sparse, (200, 90), [-20, -1, 0, 1], 500,
                 dia_coverage=0.9, layout="coo"),
    "stray": _stray_hybrid,
    "extreme": _gen(stencil_sparse, (100, 100), [-99, 0, 99]),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_plan_matches_jax(name):
    A = PATTERNS[name]()
    pj, pt, Aj = plans(A)
    assert pj is not None and pt is not None
    assert pt.K == pj.K and pt.n == pj.n and pt.m == pj.m
    np.testing.assert_array_equal(pt.offsets, pj.offsets)
    np.testing.assert_array_equal(pt.pos, pj.pos)
    np.testing.assert_array_equal(pt.src_of_grid, pj.src_of_grid)
    assert pt.is_hybrid == pj.is_hybrid
    if pj.is_hybrid:
        for f in ("resid_sel", "resid_rows", "resid_cols"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    assert dia_coverage(A) == jax_dia_coverage(Aj)


def test_rejected_patterns_match_jax():
    n, nnz = 300, 2000
    keys = np.sort(RNG.choice(n * n, nnz, replace=False))
    R = SparseCOO(keys // n, keys % n, torch.ones(nnz), (n, n))
    pj, pt, Rj = plans(R)
    assert pj is None and pt is None
    assert dia_coverage(R) == jax_dia_coverage(Rj)
    # a COO transpose is not in row-major order: no plan in either
    S = stencil_sparse((50, 50), [-2, 0, 3], layout="coo", device="cpu")
    pj, pt, _ = plans(S.T)
    assert pj is None and pt is None


def test_grid_round_trips():
    A = PATTERNS["thinned"]()
    plan = dia.build_dia_plan(A.row_sa(), A.col_sa(), *A.shape)
    grid = dia.values_to_grid(plan, A.values)
    assert grid.shape == (plan.n, plan.K)
    assert int((grid != 0).sum()) == int((A.values != 0).sum())
    torch.testing.assert_close(dia.grid_to_values(plan, grid), A.values,
                               rtol=0, atol=0)
    H = PATTERNS["stray"]()
    hp = dia.build_dia_plan(H.row_sa(), H.col_sa(), *H.shape)
    v = H.values
    on_grid = dia.grid_to_values(hp, dia.values_to_grid(hp, v))
    resid = dia.resid_expand_values(hp, dia.resid_values(hp, v))
    torch.testing.assert_close(on_grid + resid, v, rtol=0, atol=0)
    assert bool(((on_grid == 0) | (resid == 0)).all())


def test_window_gather_and_its_inverse():
    src = torch.from_numpy(RNG.standard_normal(50))
    idx = torch.from_numpy(RNG.permutation(60) - 10)      # -10..49
    out = window_gather(src, idx)
    ok = idx >= 0
    torch.testing.assert_close(out[ok], src[idx[ok]], rtol=0, atol=0)
    assert bool((out[~ok] == 0).all())
    inv = torch.full((50,), -1, dtype=torch.int64)
    inv[idx[ok]] = torch.nonzero(ok)[:, 0]
    s = src.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: WindowGather.apply(x, idx, inv), (s,))
    assert torch.autograd.gradgradcheck(
        lambda x: WindowGather.apply(x, idx, inv) ** 2, (s,))


@pytest.mark.parametrize("shape,offsets", [((12, 12), [-5, -1, 0, 2]),
                                           ((9, 15), [-3, 0, 4, 10]),
                                           ((15, 8), [-11, -2, 0, 1])])
def test_core_functions_gradcheck(shape, offsets):
    n, m = shape
    geo = dia.DiaGeometry(np.array(offsets), n, m)
    K = len(offsets)
    grid, B, X = (torch.from_numpy(RNG.standard_normal(s)).requires_grad_()
                  for s in ((n, K), (m, 3), (n, 3)))
    for fn, args in ((dia.DiaSpmmCore.apply, (geo, grid, B)),
                     (dia.DiaSddmmCore.apply, (geo, X, B))):
        f = lambda a, b: fn(args[0], a, b)
        assert torch.autograd.gradcheck(f, args[1:])
        assert torch.autograd.gradgradcheck(f, args[1:])
    # the transpose geometry's shift inverts on the valid cells
    gt = geo.T.shift(geo.shift(grid))
    valid = dia.sddmm_core_plain(geo.offsets, torch.ones(n, 1),
                                 torch.ones(m, 1)) != 0
    torch.testing.assert_close(gt[valid], grid[valid], rtol=0, atol=0)
    assert geo.T.T is geo


CFD2_OFFSETS = sorted({0, 1, -1, 2, -2, 3, -3, 49, -49, 50, -50, 51, -51,
                       2401, -2401, 2449, -2449, 2450, -2450, 2451, -2451,
                       2499, -2499, 2500, -2500})      # bench.py:44-46


def _window_covers(offsets, rows, cap, count):
    # every k once, in ascending order; off_lo/off_hi its window's ends
    t = dia.window_table(offsets, rows, cap, count)
    ks = np.concatenate([np.arange(k, k + c) for k, c, _, _ in t])
    np.testing.assert_array_equal(ks, np.arange(len(offsets)))
    offs = np.asarray(offsets)
    np.testing.assert_array_equal(t[:, 2], offs[t[:, 0]])
    np.testing.assert_array_equal(t[:, 3], offs[t[:, 0] + t[:, 1] - 1])


def _window_cap(offsets, rows, cap, count):
    t = dia.window_table(offsets, rows, cap, count)
    assert ((t[:, 3] - t[:, 2]) <= cap).all() and (t[:, 1] <= count).all()
    assert len(t) > 1                                   # the caps split


def _window_cfd2(offsets, rows, cap, count):
    t = dia.DiaGeometry(np.array(offsets), 1000, 1000).windows(rows, cap,
                                                                count)
    np.testing.assert_array_equal(t, [[0, 6, -2500, -2401],
                                      [6, 13, -51, 51],
                                      [19, 6, 2401, 2500]])


def _window_isolated(offsets, rows, cap, count):
    t = dia.window_table(offsets, rows, cap, count)
    np.testing.assert_array_equal(t[:, 1], np.ones(len(offsets)))


def _window_mirror(offsets, rows, cap, count):
    geo = dia.DiaGeometry(np.array(offsets), 700, 900)
    t, tt = geo.windows(rows, cap, count), geo.T.windows(rows, cap, count)
    K = len(offsets)
    np.testing.assert_array_equal(
        tt[::-1], np.stack([K - t[:, 0] - t[:, 1], t[:, 1], -t[:, 3],
                            -t[:, 2]], 1))


def _window_runs(offsets, rows, cap, count):
    # the kernel's plan: the table, each window's first run, and runs of
    # consecutive offsets (k - k_first, off_k - off_lo, length) that
    # cover the window's offsets in order
    geo = dia.DiaGeometry(np.array(offsets), 500, 500)
    t = geo.windows(rows, cap, count)
    plan, W, NR, span, most = geo.windows_on(torch.device("cpu"), rows, cap,
                                             count)
    assert plan.dtype == torch.int64 and W == len(t)
    assert (span, most) == ((t[:, 3] - t[:, 2]).max(), t[:, 1].max())
    plan = plan.numpy()
    np.testing.assert_array_equal(plan[:4 * W].reshape(W, 4), t)
    first, runs = plan[4 * W:5 * W + 1], plan[5 * W + 1:].reshape(NR, 3)
    offs = np.asarray(offsets)
    for w, (kf, cnt, lo, _) in enumerate(t):
        got = [lo + d + i for kk, d, L in runs[first[w]:first[w + 1]]
               for i in range(L)]
        np.testing.assert_array_equal(got, offs[kf:kf + cnt])
        assert all(np.diff(offs[kf + kk:kf + kk + L]).tolist() == [1] * (L - 1)
                   for kk, _, L in runs[first[w]:first[w + 1]])


@pytest.mark.parametrize("check,offsets,rows,cap,count", [
    (_window_covers, CFD2_OFFSETS, 64, 128, 32),
    (_window_covers, list(range(-128, 128)), 128, 192, 31),
    (_window_covers, [-900, -7, -6, 0, 30, 31, 400], 32, 40, 2),
    (_window_cap, list(range(-128, 128)), 128, 100, 32),
    (_window_cap, list(range(0, 400, 3)), 64, 200, 16),
    (_window_cfd2, CFD2_OFFSETS, 64, 128, 32),
    (_window_cfd2, CFD2_OFFSETS, 128, 192, 31),
    (_window_isolated, [-5000, -1000, 0, 700, 3000], 128, 192, 31),
    (_window_isolated, [-3, 0, 3], 2, 192, 31),
    (_window_mirror, CFD2_OFFSETS, 64, 128, 32),
    (_window_mirror, [-400, -60, -1, 0, 2, 90, 300], 128, 192, 31),
    (_window_runs, CFD2_OFFSETS, 128, 192, 31),
    (_window_runs, [-40, -39, -38, -1, 0, 1, 2, 30, 60, 61], 16, 200, 4),
], ids=["covers-cfd2", "covers-run256", "covers-small", "cap-span",
        "cap-count", "cfd2-64rows", "cfd2-128rows", "isolated",
        "isolated-narrow-tile", "mirror-cfd2", "mirror-uneven", "runs-cfd2",
        "runs-split"])
def test_window_table(check, offsets, rows, cap, count):
    """K1's window table: each k once and in order, within the cap, the
    cfd2 stencil in three windows of 6, 13 and 6 offsets, isolated
    offsets one window each, the transpose's table the mirror of the
    forward's (where no cap splits a window), and the runs the kernel
    reads."""
    check(offsets, rows, cap, count)


def test_cores_match_dense():
    n, m, p = 40, 31, 5
    offs = np.array([-9, -1, 0, 3, 30])
    grid = torch.from_numpy(RNG.standard_normal((n, len(offs))))
    B = torch.from_numpy(RNG.standard_normal((m, p)))
    X = torch.from_numpy(RNG.standard_normal((n, p)))
    P = X @ B.T
    dense = torch.zeros(n, m, dtype=torch.float64)
    want = torch.zeros(n, len(offs), dtype=torch.float64)
    for k, o in enumerate(offs):
        for r in range(max(0, -o), min(n, m - o)):
            dense[r, r + o] = grid[r, k]
            want[r, k] = P[r, r + o]
    geo = dia.DiaGeometry(offs, n, m)
    tol = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dia.spmm_core(geo.offsets_on("cpu"), grid, B),
                               dense @ B, **tol)
    torch.testing.assert_close(dia.sddmm_core(geo.offsets_on("cpu"), X, B),
                               want, **tol)
    torch.testing.assert_close(
        dia.spmm_core(geo.T.offsets_on("cpu"), geo.shift(grid), X),
        dense.T @ X, **tol)


def test_engine_matches_jax_f64(enable_x64):
    # float64: the JAX package runs its XLA branches, exactly comparable;
    # a rectangular hybrid covers the transposed geometry and the residual
    A = PATTERNS["tall"]().astype(torch.float64)
    pj, pt, Aj = plans(A)
    assert pt.is_hybrid
    n, m = A.shape
    np.testing.assert_array_equal(
        dia.values_to_grid(pt, A.values).numpy(),
        np.asarray(jdia.values_to_grid(pj, Aj.data)))
    B = RNG.standard_normal((m, 3))
    G = RNG.standard_normal((n, 3))
    X = RNG.standard_normal((n, 4))
    Y = RNG.standard_normal((m, 4))
    t = torch.from_numpy
    v, tol = A.values, dict(rtol=1e-10, atol=1e-10)
    out = dia.dia_spmm(pt, v, t(B))
    np.testing.assert_allclose(out.numpy(), jdia.dia_spmm(pj, Aj.data, B),
                               **tol)
    np.testing.assert_allclose(dia.dia_sddmm(pt, t(X), t(Y)).numpy(),
                               jdia.dia_sddmm(pj, X, Y), **tol)
    d_v, d_B = dia.dia_bwd_pair(pt, v, t(B), t(G))
    for got, want in zip((d_v, d_B), jdia.dia_bwd_pair(pj, Aj.data, B, G)):
        np.testing.assert_allclose(got.numpy(), want, **tol)
    # the transpose and the hoisted matvecs are the same computations
    torch.testing.assert_close(dia.dia_spmm_transpose(pt, v, t(G)), d_B,
                               rtol=0, atol=0)
    torch.testing.assert_close(dia.prepared_matvec(pt, v, False)(t(B)), out,
                               rtol=0, atol=0)
    torch.testing.assert_close(dia.prepared_matvec(pt, v, True)(t(G)), d_B,
                               rtol=0, atol=0)


def test_engine_matches_jax_pallas_f32():
    # float32 at p = 16: the JAX side runs its Pallas window-gather and
    # DIA SpMM kernels in interpret mode
    A = stencil_sparse((96, 96), [-9, -1, 0, 1, 9], device="cpu")
    pj, pt, Aj = plans(A)
    B = RNG.standard_normal((96, 16)).astype(np.float32)
    np.testing.assert_allclose(
        dia.dia_spmm(pt, A.values, torch.from_numpy(B)).numpy(),
        jdia.dia_spmm(pj, Aj.data, B), rtol=1e-5, atol=1e-6)
