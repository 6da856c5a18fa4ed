"""PyTorch port: the ELL engine (``backend="ell"``) held against the JAX
package's.

Both packages get the same numpy patterns and inputs (fixed seeds): a
random row-sorted pattern, the same entries shuffled (unsorted rows), a
stencil, a hybrid at 85 % DIA coverage, an empty pattern, a skewed one
whose row plan the ``ELL_MAX_EXPAND`` guard refuses (its column plan
stays), and batched containers (a shared pattern, and a pattern per
element, which take the generic branch in both).  The plans' fields
must equal JAX ``build_ell_plan``'s exactly; ``sparse_mm`` and ``sddmm``
values and both gradients must match JAX ``backend="ell"`` within
float32 ``rtol=1e-5, atol=1e-6`` (float64 ``1e-10``); ``gradcheck`` and
``gradgradcheck`` run in float64 on small patterns.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.kernels.ell import build_ell_plan as jax_plan
from torchsparsegradutils_tpu_torch import SparseCOO, sddmm, sparse_mm
from torchsparsegradutils_tpu_torch.kernels import ell
from torchsparsegradutils_tpu_torch.kernels import window_gather as wg
from torchsparsegradutils_tpu_torch.kernels.ell import build_ell_plan

F32 = dict(rtol=1e-5, atol=1e-6)
F64 = dict(rtol=1e-10, atol=1e-10)
N, M, P = 48, 40, 5


def _random(seed, nnz=300, shuffle=False):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(N * M, nnz, replace=False))
    rows, cols = keys // M, keys % M
    if shuffle:
        perm = rng.permutation(nnz)
        rows, cols = rows[perm], cols[perm]
    return rows, cols


def _stencil(offsets=(-5, -1, 0, 1, 5)):
    rows, cols = [], []
    for r in range(N):
        for o in offsets:
            if 0 <= r + o < M:
                rows.append(r)
                cols.append(r + o)
    return np.array(rows), np.array(cols)


def _hybrid(seed):
    """The stencil with 15 % of its entry count added at random."""
    rs, cs = _stencil()
    rng = np.random.default_rng(seed)
    extra = rng.choice(N * M, 2 * len(rs) // 10, replace=False)
    keys = np.union1d(rs * M + cs, extra)
    return keys // M, keys % M


def _skewed():
    """A hub row of 38 entries, one entry in each other row: n·K breaks
    the row guard; the columns (degree at most 2) keep their plan."""
    rows = np.concatenate([np.zeros(38, np.int64), np.arange(1, N)])
    cols = np.concatenate([np.arange(38), np.arange(1, N) % M])
    return rows, cols


PATTERNS = {
    "random": _random(1),
    "unsorted": _random(2, shuffle=True),
    "stencil": _stencil(),
    "hybrid85": _hybrid(3),
    "empty": (np.zeros(0, np.int64), np.zeros(0, np.int64)),
    "skewed": _skewed(),
}


def _np(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pair(rows, cols, vals, shape):
    """The port's and JAX's COO containers on the same arrays."""
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    return (SparseCOO(rows, cols, torch.from_numpy(vals), shape),
            tj.SparseCOO(rows, cols, jnp.asarray(vals), shape))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol)


def _port_mm(A, B, G, backend="ell"):
    v = A.values.detach().clone().requires_grad_(True)
    b = torch.from_numpy(B).requires_grad_(True)
    out = sparse_mm(A.with_data(v), b, backend=backend)
    gv, gb = torch.autograd.grad(out, (v, b), torch.from_numpy(G))
    return out, gv, gb


def _jax_mm(J, B, G):
    out, vjp = jax.vjp(lambda d, b: tj.sparse_mm(J.with_data(d), b,
                                                 backend="ell"),
                       J.data, jnp.asarray(B))
    return (out, *vjp(jnp.asarray(G)))


def _port_sddmm(A, X, Y, C):
    x = torch.from_numpy(X).requires_grad_(True)
    y = torch.from_numpy(Y).requires_grad_(True)
    vals = sddmm(A, x, y, backend="ell").values
    return (vals, *torch.autograd.grad(vals, (x, y), torch.from_numpy(C)))


def _jax_sddmm(J, X, Y, C):
    out, vjp = jax.vjp(lambda x, y: tj.sddmm(J, x, y, backend="ell").data,
                       jnp.asarray(X), jnp.asarray(Y))
    return (out, *vjp(jnp.asarray(C)))


def _check(name, dtype, tol):
    rows, cols = PATTERNS[name]
    A, J = _pair(rows, cols, _np(len(rows), 4, dtype), (N, M))
    for got, ref in zip(_port_mm(A, _np((M, P), 5, dtype),
                                 _np((N, P), 6, dtype)),
                        _jax_mm(J, _np((M, P), 5, dtype),
                                _np((N, P), 6, dtype))):
        _close(got, ref, tol)
    X, Y, C = (_np((N, P), 7, dtype), _np((M, P), 8, dtype),
               _np(len(rows), 9, dtype))
    for got, ref in zip(_port_sddmm(A, X, Y, C), _jax_sddmm(J, X, Y, C)):
        _close(got, ref, tol)


@pytest.mark.parametrize("name", list(PATTERNS))
def test_plan_fields_equal_jax(name):
    rows, cols = PATTERNS[name]
    A, J = _pair(rows, cols, _np(len(rows), 4, np.float32), (N, M))
    for port_args, jax_args in (
            ((A.row_sa(), A.col_sa(), N, M), (J.row_sa(), J.col_sa(), N, M)),
            ((A.col_sa(), A.row_sa(), M, N), (J.col_sa(), J.row_sa(), M, N))):
        got, ref = build_ell_plan(*port_args), jax_plan(*jax_args)
        assert (got is None) == (ref is None)
        if ref is None:
            continue
        assert (got.n, got.m, got.K, got.sorted_pos) == (
            ref.n, ref.m, ref.K, ref.sorted_pos)
        for field in ("cols", "flat_pos"):
            a, b = getattr(got, field), getattr(ref, field)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_guards_refuse_what_jax_refuses():
    """The empty pattern has no plan; the skewed one no row plan but a
    column plan; every other pattern both."""
    for name, (rows, cols) in PATTERNS.items():
        A, _ = _pair(rows, cols, _np(len(rows), 4, np.float32), (N, M))
        op = ell.EllOperator.of(A)
        assert (op.rp is None, op.cp is None) == {
            "empty": (True, True), "skewed": (True, False)}.get(
                name, (False, False)), name


@pytest.mark.parametrize("name", list(PATTERNS))
def test_float32_matches_jax(name):
    _check(name, np.float32, F32)


@pytest.mark.parametrize("name", ["unsorted", "skewed"])
def test_float64_matches_jax(enable_x64, name):
    _check(name, np.float64, F64)


def test_k_chunks_give_the_same_values(monkeypatch):
    """``ELL_CHUNK_ELEMS`` small enough for one column a chunk: the same
    values and gradients as one chunk."""
    rows, cols = PATTERNS["random"]
    A, _ = _pair(rows, cols, _np(len(rows), 4, np.float32), (N, M))
    B, G = _np((M, P), 5, np.float32), _np((N, P), 6, np.float32)
    whole = _port_mm(A, B, G)
    plan = build_ell_plan(A.row_sa(), A.col_sa(), N, M)
    monkeypatch.setattr(ell, "ELL_CHUNK_ELEMS", N * P)
    assert len(ell.k_chunks(plan, P)) == plan.K > 1
    for got, ref in zip(_port_mm(A, B, G), whole):
        torch.testing.assert_close(got, ref, **F32)


def test_relayouts_are_the_window_gather(monkeypatch):
    """The value grids and the SDDMM's way back to entry order are K3
    (its plain version on the CPU): the forward's grid, then gradA's way
    back and gradB's grid over the column plan."""
    calls = []
    real = wg.window_gather

    def spy(src, idx):
        calls.append(len(idx))
        return real(src, idx)
    monkeypatch.setattr(wg, "window_gather", spy)
    rows, cols = PATTERNS["random"]
    A, _ = _pair(rows, cols, _np(len(rows), 4, np.float32), (N, M))
    plan = build_ell_plan(A.row_sa(), A.col_sa(), N, M)
    _port_mm(A, _np((M, P), 5, np.float32), _np((N, P), 6, np.float32))
    # the forward's grid (n K), gradA's way back (nnz), gradB's grid
    # over the column plan (m K_T)
    assert calls[:2] == [N * plan.K, len(rows)] and len(calls) == 3


@pytest.mark.parametrize("shared", [True, False])
def test_batched_matches_jax(shared):
    b = 3
    rows, cols = PATTERNS["random"]
    if shared:
        r, c = rows, cols
    else:
        r2, c2 = PATTERNS["unsorted"]
        r = np.stack([rows, r2, rows[::-1]])
        c = np.stack([cols, c2, cols[::-1]])
    vals = _np((b, len(rows)), 4, np.float32)
    A, J = _pair(r, c, vals, (b, N, M))
    B, G = _np((b, M, P), 5, np.float32), _np((b, N, P), 6, np.float32)
    for got, ref in zip(_port_mm(A, B, G), _jax_mm(J, B, G)):
        _close(got, ref, F32)


@functools.lru_cache(maxsize=None)
def _small64(name):
    rows, cols = {"random": _random(10, nnz=60),
                  "skewed": _skewed()}[name]
    rng = np.random.default_rng(11)
    return SparseCOO(rows, cols, torch.from_numpy(rng.standard_normal(
        len(rows))), (N, M))


@pytest.mark.parametrize("name", ["random", "skewed"])
def test_gradcheck_and_gradgradcheck(name):
    A = _small64(name)
    v = A.values.clone().requires_grad_(True)
    B = torch.randn(M, 2, dtype=torch.float64, requires_grad=True)
    X = torch.randn(N, 2, dtype=torch.float64, requires_grad=True)

    def mm(v_, b_):
        return sparse_mm(A.with_data(v_), b_, backend="ell")

    def sd(x_, y_):
        return sddmm(A, x_, y_, backend="ell").values
    assert torch.autograd.gradcheck(mm, (v, B))
    assert torch.autograd.gradgradcheck(mm, (v, B))
    assert torch.autograd.gradcheck(sd, (X, B))
    assert torch.autograd.gradgradcheck(sd, (X, B))
