"""PyTorch port: the dynamic-pattern mode (``pattern_static=False``) held
against the JAX package's.

A dynamic container of the port behaves as the JAX package's does under
``jax.jit``, where its indices are traced.  Each JAX reference is
therefore jitted with the indices as arguments, and cached; per-element
batched patterns run JAX eagerly on a dynamic container, since JAX's
per-element ``sparse_mm`` does not trace (its row count reaches a
``custom_vjp`` as an argument).  Inputs are numpy draws from fixed seeds,
handed to both packages.  Tolerances: ``rtol=1e-5, atol=1e-6`` in
float32; the solves (triangular, ``sparse_generic_solve``,
``sparse_generic_lstsq``) run in float64 at ``rtol=1e-10, atol=1e-12``.

Groups:

* the ops, values and gradients: ``sparse_mm`` and ``sddmm`` (COO and
  CSR, 2-D, batched with a shared and with per-element patterns), both
  LSE ops (each ``dim``, ``keepdim``, ``include_zeros``), the triangular
  solve's dense fallback (``upper``, ``transpose``, the warning at
  n = 2,049, the ``"dia"`` message), ``sparse_generic_solve`` and
  ``sparse_generic_lstsq``;
* the containers and helpers: ``tocsr``, ``.T`` and ``csr_transpose``,
  the generators and structure helpers keeping the mode, ``explain``'s
  report, ``from_torch_*(pattern_static=False)``;
* the refusals, with the JAX package's messages;
* no host read: ``Tensor.numpy``, ``.item``, ``.tolist`` and the
  implicit conversions raise inside the ops of the first group (the
  solvers' counted convergence reads aside).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu import solvers as jsolvers
from torchsparsegradutils_tpu import utils as ju
from torchsparsegradutils_tpu_torch import (SparseCSR, explain,
                                            from_arrays, sddmm,
                                            sparse_bidir_logsumexp,
                                            sparse_generic_lstsq,
                                            sparse_generic_solve,
                                            sparse_logsumexp, sparse_mm,
                                            sparse_triangular_solve,
                                            to_arrays)
from torchsparsegradutils_tpu_torch import solvers as psolvers
from torchsparsegradutils_tpu_torch import utils as pu
from torchsparsegradutils_tpu_torch.utils import random_sparse as prs
from torchsparsegradutils_tpu_torch.interop import (from_torch_coo,
                                                    from_torch_csr,
                                                    sparse_mm_torch)
from torchsparsegradutils_tpu_torch.solvers import common as scommon

N, M, NNZ, P, B = 12, 9, 30, 3, 2
TOL = dict(rtol=1e-5, atol=1e-6)
TOL64 = dict(rtol=1e-10, atol=1e-12)
BATCHES = ["2d", "shared", "per-element"]


def _sorted_pattern(rng, n, m, nnz):
    flat = np.sort(rng.choice(n * m, nnz, replace=False))
    return (flat // m).astype(np.int32), (flat % m).astype(np.int32)


def _indptr(rows, n):
    return np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))]
                          ).astype(rows.dtype)


def _case(layout, batch, seed=0, n=N, m=M, nnz=NNZ):
    """``(idx0, idx1, values, shape)`` of a row-major random pattern:
    COO rows and columns or CSR pointers and columns, unbatched, shared
    by a batch of ``B`` or one per element."""
    rng = np.random.default_rng(seed)
    pats = [_sorted_pattern(rng, n, m, nnz)
            for _ in range(B if batch == "per-element" else 1)]
    first = [r if layout == "coo" else _indptr(r, n) for r, _ in pats]
    idx0, idx1 = np.stack(first), np.stack([c for _, c in pats])
    if batch != "per-element":
        idx0, idx1 = idx0[0], idx1[0]
    lead = () if batch == "2d" else (B,)
    vals = rng.standard_normal(lead + (nnz,)).astype(np.float32)
    return idx0, idx1, vals, lead + (n, m)


def _jax_make(layout, shape):
    cls = tj.SparseCOO if layout == "coo" else tj.SparseCSR
    return lambda i0, i1, d: cls(i0, i1, d, shape, pattern_static=False)


def _port(layout, i0, i1, vals, shape, dtype=None):
    A = from_arrays(layout, i0, i1, vals, shape, device="cpu",
                    pattern_static=False)
    return A if dtype is None else A.astype(dtype)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol)


def _jax_ref(fn, batch):
    """``fn`` jitted with the indices as arguments, or eager for
    per-element patterns."""
    return fn if batch == "per-element" else jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _jax_mm(layout, shape, batch):
    make = _jax_make(layout, shape)

    def f(i0, i1, d, Bm, G):
        out, vjp = jax.vjp(lambda d_, b_: tj.sparse_mm(make(i0, i1, d_), b_),
                           d, Bm)
        return (out,) + vjp(G)
    return _jax_ref(f, batch)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_sparse_mm_matches_jax(layout, batch):
    i0, i1, vals, shape = _case(layout, batch)
    rng = np.random.default_rng(1)
    lead = shape[:-2]
    Bm = rng.standard_normal(lead + (M, P)).astype(np.float32)
    G = rng.standard_normal(lead + (N, P)).astype(np.float32)
    ref = _jax_mm(layout, shape, batch)(i0, i1, vals, Bm, G)
    A = _port(layout, i0, i1, vals, shape)
    v = A.values.clone().requires_grad_(True)
    b = torch.from_numpy(Bm).requires_grad_(True)
    out = sparse_mm(A.with_data(v), b)
    got = (out,) + torch.autograd.grad(out, (v, b), torch.from_numpy(G))
    for g, r in zip(got, ref):
        _close(g, r)


@functools.lru_cache(maxsize=None)
def _jax_sddmm(layout, shape, batch):
    make = _jax_make(layout, shape)

    def f(i0, i1, d, X, Y, G):
        out, vjp = jax.vjp(lambda x, y: tj.sddmm(make(i0, i1, d), x, y).data,
                           X, Y)
        return (out,) + vjp(G)
    return _jax_ref(f, batch)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_sddmm_matches_jax(layout, batch):
    i0, i1, vals, shape = _case(layout, batch, seed=2)
    rng = np.random.default_rng(3)
    lead = shape[:-2]
    X = rng.standard_normal(lead + (N, P)).astype(np.float32)
    Y = rng.standard_normal(lead + (M, P)).astype(np.float32)
    G = rng.standard_normal(vals.shape).astype(np.float32)
    ref = _jax_sddmm(layout, shape, batch)(i0, i1, vals, X, Y, G)
    A = _port(layout, i0, i1, vals, shape)
    x = torch.from_numpy(X).requires_grad_(True)
    y = torch.from_numpy(Y).requires_grad_(True)
    out = sddmm(A, x, y)
    assert not out.pattern_static
    got = (out.values,) + torch.autograd.grad(out.values, (x, y),
                                              torch.from_numpy(G))
    for g, r in zip(got, ref):
        _close(g, r)


@functools.lru_cache(maxsize=None)
def _jax_lse(layout, shape, dim, keepdim, include_zeros):
    make = _jax_make(layout, shape)

    def f(i0, i1, d, G):
        out, vjp = jax.vjp(lambda d_: tj.sparse_logsumexp(
            make(i0, i1, d_), dim, keepdim=keepdim,
            include_zeros=include_zeros), d)
        return out, vjp(G)[0]
    return jax.jit(f)


LSE_CASES = [("coo", "2d", 0, False, True), ("csr", "2d", 1, True, True),
             ("coo", "2d", (0, 1), False, True),
             ("csr", "2d", 0, True, False), ("coo", "2d", 1, False, False),
             ("csr", "2d", (0, 1), True, False),
             ("coo", "shared", 2, True, True),
             ("csr", "per-element", 1, False, False)]


@pytest.mark.parametrize("layout,batch,dim,keepdim,include_zeros",
                         LSE_CASES)
def test_logsumexp_matches_jax(layout, batch, dim, keepdim, include_zeros):
    i0, i1, vals, shape = _case(layout, batch, seed=4)
    ref_out = _jax_lse(layout, shape, dim, keepdim, include_zeros)
    A = _port(layout, i0, i1, vals, shape)
    v = A.values.clone().requires_grad_(True)
    dim_t = list(dim) if isinstance(dim, tuple) else dim
    out = sparse_logsumexp(A.with_data(v), dim_t, keepdim=keepdim,
                           include_zeros=include_zeros)
    G = np.random.default_rng(5).standard_normal(out.shape).astype(
        np.float32)
    # an empty row or column is -inf without include_zeros: no cotangent
    G = np.where(np.isfinite(out.detach().numpy()), G, 0).astype(np.float32)
    r_out, r_grad = ref_out(i0, i1, vals, G)
    _close(out, r_out)
    _close(torch.autograd.grad(out, v, torch.from_numpy(G))[0], r_grad)


@functools.lru_cache(maxsize=None)
def _jax_bidir(layout, shape, include_zeros, output_layout):
    make = _jax_make(layout, shape)

    def f(i0, i1, d, G):
        out, vjp = jax.vjp(lambda d_: jnp.concatenate([
            o.reshape(-1) for o in jax.tree_util.tree_leaves(
                tj.sparse_bidir_logsumexp(make(i0, i1, d_),
                                          include_zeros=include_zeros,
                                          output_layout=output_layout))]), d)
        return out, vjp(G)[0]
    return jax.jit(f)


@pytest.mark.parametrize("layout,include_zeros,output_layout",
                         [("coo", True, "tuple"), ("csr", False, "tuple"),
                          ("csr", True, "padded")])
def test_bidir_logsumexp_matches_jax(layout, include_zeros, output_layout):
    i0, i1, vals, shape = _case(layout, "2d", seed=6)
    A = _port(layout, i0, i1, vals, shape)
    v = A.values.clone().requires_grad_(True)
    res = sparse_bidir_logsumexp(A.with_data(v), include_zeros=include_zeros,
                                 output_layout=output_layout)
    out = torch.cat([o.reshape(-1) for o in
                     (res if isinstance(res, tuple) else (res,))])
    G = np.random.default_rng(7).standard_normal(out.shape)
    G = np.where(np.isfinite(out.detach().numpy()), G, 0).astype(np.float32)
    r_out, r_grad = _jax_bidir(layout, shape, include_zeros,
                               output_layout)(i0, i1, vals, G)
    _close(out, r_out)
    _close(torch.autograd.grad(out, v, torch.from_numpy(G))[0], r_grad)


# ---- the solves, in float64 ------------------------------------------------

def _tri_case(n, upper, seed, layout="coo"):
    """A well-conditioned random triangle of ``n`` rows, float64."""
    rng = np.random.default_rng(seed)
    r, c = np.tril_indices(n, -1)
    keep = np.sort(rng.choice(len(r), min(len(r), 3 * n), replace=False))
    r = np.concatenate([r[keep], np.arange(n)])
    c = np.concatenate([c[keep], np.arange(n)])
    if upper:
        r, c = c, r
    order = np.lexsort((c, r))
    r, c = r[order].astype(np.int32), c[order].astype(np.int32)
    v = 0.3 * rng.standard_normal(len(r))
    v[r == c] = 2.0 + rng.random(n)
    first = r if layout == "coo" else _indptr(r, n)
    return first, c, v, (n, n)


@functools.lru_cache(maxsize=None)
def _jax_tri(layout, shape, upper, transpose, unit, algorithm):
    make = _jax_make(layout, shape)

    def f(i0, i1, d, b, G):
        out, vjp = jax.vjp(lambda d_, b_: tj.sparse_triangular_solve(
            make(i0, i1, d_), b_, upper=upper, transpose=transpose,
            unitriangular=unit, algorithm=algorithm), d, b)
        return (out,) + vjp(G)
    return jax.jit(f)


@pytest.mark.parametrize(
    "layout,upper,transpose,unit,algorithm",
    [("coo", False, False, False, "auto"), ("csr", False, True, False,
                                             "wave"),
     ("csr", True, False, False, "block"), ("coo", True, True, False,
                                             "dense"),
     ("csr", False, False, True, "auto")])
def test_triangular_solve_dense_fallback_matches_jax(
        enable_x64, layout, upper, transpose, unit, algorithm):
    i0, i1, vals, shape = _tri_case(20, upper, 8, layout)
    if unit:       # a unit triangle stores no diagonal entry
        A0 = from_arrays(layout, i0, i1, vals, shape, device="cpu")
        keep = A0.rows() != A0.cols()
        r, c, vals = A0.rows()[keep], A0.cols()[keep], vals[keep]
        i0, i1 = (r if layout == "coo" else _indptr(r, 20)), c
    rng = np.random.default_rng(9)
    b = rng.standard_normal((20, 2))
    G = rng.standard_normal((20, 2))
    ref = _jax_tri(layout, shape, upper, transpose, unit, algorithm)(
        i0, i1, vals, b, G)
    A = _port(layout, i0, i1, vals, shape)
    v = A.values.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    x = sparse_triangular_solve(A.with_data(v), bt, upper=upper,
                                transpose=transpose, unitriangular=unit,
                                algorithm=algorithm)
    got = (x,) + torch.autograd.grad(x, (v, bt), torch.from_numpy(G))
    for g, r_ in zip(got, ref):
        _close(g, r_, TOL64)


def test_triangular_solve_warning_and_dia_message_match_jax(enable_x64):
    i0, i1, vals, shape = _tri_case(2049, False, 10)
    b = np.random.default_rng(11).standard_normal((2049, 1))
    make = _jax_make("coo", shape)
    with pytest.warns(UserWarning) as jw:
        ref = jax.jit(lambda r, c, d, b_: tj.sparse_triangular_solve(
            make(r, c, d), b_, upper=False))(i0, i1, vals, b)
    A = _port("coo", i0, i1, vals, shape)
    with pytest.warns(UserWarning) as pw:
        x = sparse_triangular_solve(A, torch.from_numpy(b), upper=False)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    _close(x, ref, TOL64)
    small = _tri_case(20, False, 12)
    with pytest.raises(ValueError) as je:
        jax.jit(lambda r, c, d: tj.sparse_triangular_solve(
            _jax_make("coo", small[3])(r, c, d), jnp.ones((20, 1)),
            upper=False, algorithm="dia"))(*small[:3])
    with pytest.raises(ValueError) as pe:
        sparse_triangular_solve(_port("coo", *small), torch.ones(20, 1,
                                                                 dtype=torch.float64),
                                upper=False, algorithm="dia")
    assert str(pe.value) == str(je.value)


def _spd_case(n, seed, layout):
    """A random symmetric diagonally dominant matrix, float64."""
    rng = np.random.default_rng(seed)
    r, c = np.tril_indices(n, -1)
    keep = rng.choice(len(r), 2 * n, replace=False)
    r, c = r[keep], c[keep]
    half = 0.5 * rng.standard_normal(len(r))
    rows = np.concatenate([np.arange(n), r, c])
    cols = np.concatenate([np.arange(n), c, r])
    vals = np.concatenate([np.zeros(n), half, half])
    diag = np.zeros(n)
    np.add.at(diag, rows[n:], np.abs(vals[n:]))
    vals[:n] = 1.0 + diag
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order].astype(np.int32), cols[order].astype(
        np.int32), vals[order]
    first = rows if layout == "coo" else _indptr(rows, n)
    return first, cols, vals, (n, n)


CG = dict(max_iter=200, rtol=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_solve(layout, shape):
    make = _jax_make(layout, shape)
    st = jsolvers.LinearCGSettings(**CG)

    def f(i0, i1, d, b):
        def loss(d_, b_):
            x = tj.sparse_generic_solve(make(i0, i1, d_), b_,
                                        solve=jsolvers.linear_cg,
                                        settings=st)
            return (x ** 2).sum(), x
        (_, x), g = jax.value_and_grad(loss, (0, 1), has_aux=True)(d, b)
        return (x,) + g
    return jax.jit(f)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_generic_solve_matches_jax(enable_x64, layout):
    i0, i1, vals, shape = _spd_case(24, 13, layout)
    b = np.random.default_rng(14).standard_normal(24)
    ref = _jax_solve(layout, shape)(i0, i1, vals, b)
    A = _port(layout, i0, i1, vals, shape)
    assert scommon.matvec_route(A) == ("xla", None)
    v = A.values.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    x = sparse_generic_solve(A.with_data(v), bt, solve=psolvers.linear_cg,
                             settings=psolvers.LinearCGSettings(**CG))
    got = (x,) + torch.autograd.grad((x ** 2).sum(), (v, bt))
    for g, r in zip(got, ref):
        _close(g, r, TOL64)


@functools.lru_cache(maxsize=None)
def _jax_lstsq(layout, shape):
    make = _jax_make(layout, shape)

    def f(i0, i1, d, b):
        def loss(d_, b_):
            x = tj.sparse_generic_lstsq(make(i0, i1, d_), b_)
            return (x ** 2).sum(), x
        (_, x), g = jax.value_and_grad(loss, (0, 1), has_aux=True)(d, b)
        return (x,) + g
    return jax.jit(f)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_generic_lstsq_matches_jax(enable_x64, layout):
    rng = np.random.default_rng(15)
    n, m = 30, 8
    r = np.repeat(np.arange(n), 3)
    c = np.concatenate([np.sort(rng.choice(m, 3, replace=False))
                        for _ in range(n)])
    r, c = r.astype(np.int32), c.astype(np.int32)
    vals = rng.standard_normal(len(r))
    first = r if layout == "coo" else _indptr(r, n)
    b = rng.standard_normal(n)
    ref = _jax_lstsq(layout, (n, m))(first, c, vals, b)
    A = _port(layout, first, c, vals, (n, m))
    v = A.values.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    x = sparse_generic_lstsq(A.with_data(v), bt)
    got = (x,) + torch.autograd.grad((x ** 2).sum(), (v, bt))
    for g, r_ in zip(got, ref):
        _close(g, r_, dict(rtol=1e-8, atol=1e-10))


# ---- containers and helpers ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_convert(kind, shape):
    make = _jax_make("csr" if kind == "csr.T" else "coo", shape)

    def f(i0, i1, d, w):
        def conv(d_):
            A = make(i0, i1, d_)
            C = A.T if kind == "csr.T" else (
                ju.coo_to_csr(A) if kind == "tocsr" else A.T)
            return C
        C = conv(d)
        first = C.indptr_arr() if C.layout == "csr" else C.rows()
        g = jax.grad(lambda d_: (conv(d_).data * w).sum())(d)
        return first, C.cols(), C.data, g
    return jax.jit(f)


@pytest.mark.parametrize("kind", ["tocsr", "coo.T", "csr.T"])
def test_conversions_match_jax(kind):
    rng = np.random.default_rng(16)
    flat = rng.choice(N * M, NNZ, replace=False)      # unsorted, unique
    r, c = (flat // M).astype(np.int32), (flat % M).astype(np.int32)
    if kind == "csr.T":
        order = np.lexsort((c, r))
        r, c = r[order], c[order]
        i0 = _indptr(r, N)
    else:
        i0 = r
    vals = rng.standard_normal(NNZ).astype(np.float32)
    w = rng.standard_normal(NNZ).astype(np.float32)
    ref = _jax_convert(kind, (N, M))(i0, c, vals, w)
    A = _port("csr" if kind == "csr.T" else "coo", i0, c, vals, (N, M))
    v = A.values.clone().requires_grad_(True)
    A = A.with_data(v)
    C = A.tocsr() if kind == "tocsr" else A.T
    assert not C.pattern_static
    first = C.indptr if C.layout == "csr" else C.row
    second = C.indices if C.layout == "csr" else C.col
    np.testing.assert_array_equal(first.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(second.numpy(), np.asarray(ref[1]))
    _close(C.values, ref[2])
    _close(torch.autograd.grad((C.values * torch.from_numpy(w)).sum(), v)[0],
           ref[3])
    if kind == "csr.T":
        D = pu.csr_transpose(A)
        assert torch.equal(D.indptr, C.indptr) and torch.equal(
            D.values, C.values)
        assert torch.equal(pu.csr_to_coo(A).row, A.rows_t().to(torch.int32))


GENERATORS = {
    "rand_sparse": lambda **k: prs.rand_sparse((10, 8), 20, **k),
    "rand_sparse_tri": lambda **k: prs.rand_sparse_tri((10, 10), 25, **k),
    "make_spd_sparse": lambda **k: prs.make_spd_sparse(10, 30, **k),
    "stencil_sparse": lambda **k: prs.stencil_sparse((10, 10), [-2, 0, 1],
                                                     **k),
    "hybrid_sparse": lambda **k: prs.hybrid_sparse(
        (12, 12), [-1, 0, 1], 40, dia_coverage=0.75, **k),
    "make_spd_stencil": lambda **k: prs.make_spd_stencil(12, [1, 3], **k)}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_keep_the_mode(name):
    S = GENERATORS[name](device="cpu")
    D = GENERATORS[name](device="cpu", pattern_static=False)
    assert S.pattern_static and not D.pattern_static
    assert D.row_sa() is None and D.col_sa() is None
    for a, b in zip(to_arrays(D), to_arrays(S)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "pattern=dynamic" in repr(D)


HELPERS = {
    "block_diag_coo": lambda A: pu.sparse_block_diag(A, A.T),
    "block_diag_csr": lambda A: pu.sparse_block_diag(A.tocsr(), A.tocsr()),
    "stack": lambda A: pu.sparse_stack([A, A]),
    "stack_csr": lambda A: pu.sparse_stack([A.tocsr(), A.T.tocsr()]),
    "eye": lambda A: pu.sparse_eye((3, 4, 4), layout="csr", device="cpu",
                                   pattern_static=A.pattern_static),
    "csr_to_coo": lambda A: pu.csr_to_coo(A.tocsr()),
    "fromdense": lambda A: SparseCSR.fromdense(
        A.todense(), device="cpu", pattern_static=A.pattern_static)}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_structure_helpers_keep_the_mode(name):
    i0, i1, vals, shape = _case("coo", "2d", seed=17, n=9)
    S = from_arrays("coo", i0, i1, vals, (9, 9), device="cpu")
    D = _port("coo", i0, i1, vals, (9, 9))
    out_s, out_d = HELPERS[name](S), HELPERS[name](D)
    assert out_s.pattern_static and not out_d.pattern_static
    assert out_d.shape == out_s.shape
    np.testing.assert_array_equal(out_d.todense().numpy(),
                                  out_s.todense().numpy())


@pytest.mark.parametrize("pattern", ["random", "stencil"])
def test_explain_matches_jax(pattern):
    if pattern == "stencil":
        S = prs.stencil_sparse((16, 16), [-3, 0, 1], device="cpu")
        i0, i1, vals, shape = to_arrays(S)[1:]
        layout = "csr"
    else:
        layout = "coo"
        i0, i1, vals, shape = _case(layout, "2d", seed=18)
    ref = tj.explain(_jax_make(layout, shape)(i0, i1, vals))
    rep = explain(_port(layout, i0, i1, vals, shape))
    assert rep["pattern"] == ref["pattern"]
    assert set(rep) == set(ref)
    for op in ("sparse_mm", "sddmm", "sparse_logsumexp", "matvec"):
        assert rep[op] == {**ref[op], "kernels": []}


def test_from_torch_keeps_device_indices():
    i0, i1, vals, shape = _case("csr", "2d", seed=19)
    v = torch.from_numpy(vals).requires_grad_(True)
    crow = torch.from_numpy(i0.astype(np.int64))
    col = torch.from_numpy(i1.astype(np.int64))
    t_csr = torch.sparse_csr_tensor(crow, col, v, shape)
    A = from_torch_csr(t_csr, pattern_static=False)
    assert not A.pattern_static
    assert A.indptr.data_ptr() == t_csr.crow_indices().data_ptr()
    t_coo = t_csr.to_sparse_coo().coalesce()
    C = from_torch_coo(t_coo, pattern_static=False)
    assert C.row.data_ptr() == t_coo.indices()[0].data_ptr()
    Bm = torch.randn(M, P, generator=torch.Generator().manual_seed(0))
    got = []
    for static in (True, False):
        out = sparse_mm_torch(torch.sparse_csr_tensor(crow, col, v, shape),
                              Bm, pattern_static=static)
        got.append((out, torch.autograd.grad(out.sum(), v)[0]))
    for a, b in zip(*got):
        _close(b, a.detach().numpy())
    uncoalesced = torch.sparse_coo_tensor(torch.tensor([[1, 0], [0, 1]]),
                                          torch.ones(2), (2, 2))
    with pytest.raises(ValueError, match="coalesced"):
        from_torch_coo(uncoalesced, pattern_static=False)


# ---- refusals ----------------------------------------------------------------

def _per_element_coo(make_jax):
    r, c, d, shape = _case("coo", "per-element", seed=20)
    if make_jax:
        return tj.SparseCOO(r, c, d, shape, pattern_static=False)
    return _port("coo", r, c, d, shape)


REFUSALS = {
    "coalesce": (lambda A: ju.coalesce(A).data, lambda A: pu.coalesce(A)),
    "rows": (lambda A: A.rows_np(), lambda A: A.rows()),
    "block_diag_split": (
        lambda A: ju.sparse_block_diag_split(A, (6, 4), (6, 5))[0].data,
        lambda A: pu.sparse_block_diag_split(A, (6, 4), (6, 5))),
    "dia_backend": (lambda A: tj.sparse_mm(A, jnp.ones((M, 1)),
                                           backend="dia"),
                    lambda A: sparse_mm(A, torch.ones(M, 1),
                                        backend="dia")),
}


@pytest.mark.parametrize("name", sorted(REFUSALS) + ["per_element_tocsr"])
def test_refusals_raise_the_jax_message(name):
    if name == "per_element_tocsr":
        with pytest.raises(ValueError) as je:
            jax.jit(lambda: ju.coo_to_csr(_per_element_coo(True)).data)()
        with pytest.raises(ValueError) as pe:
            _per_element_coo(False).tocsr()
        assert str(pe.value) == str(je.value)
        return
    jfn, pfn = REFUSALS[name]
    i0, i1, vals, shape = _case("coo", "2d", seed=21)
    make = _jax_make("coo", shape)
    with pytest.raises(ValueError) as je:
        jax.jit(lambda r, c, d: jfn(make(r, c, d)))(i0, i1, vals)
    with pytest.raises(ValueError) as pe:
        pfn(_port("coo", i0, i1, vals, shape))
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("backend", ["pallas", "ell"])
def test_planned_backends_refuse_a_dynamic_pattern(backend):
    A = _port("coo", *_case("coo", "2d", seed=22))
    for call in (lambda: sparse_mm(A, torch.ones(M, 2), backend=backend),
                 lambda: sddmm(A, torch.ones(N, 2), torch.ones(M, 2),
                               backend=backend)):
        with pytest.raises(ValueError, match="requires a concrete"):
            call()


# ---- no host read --------------------------------------------------------------

@pytest.fixture
def no_host_read(monkeypatch):
    """Make every host read of a tensor raise, and count the solvers'
    own convergence reads (``host_read``), which may read."""
    reads = []
    names = ("numpy", "item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")
    real = {name: getattr(torch.Tensor, name) for name in names}

    def refuse(self, *a, **k):
        raise AssertionError("host read of a tensor")

    def guard(on):
        for name in names:
            setattr(torch.Tensor, name, refuse if on else real[name])
    for name in names:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    host_read = scommon.host_read

    def counted(t):
        reads.append(t.shape)
        guard(False)
        try:
            return host_read(t)
        finally:
            guard(True)
    counted.reads = 0
    monkeypatch.setattr(scommon, "host_read", counted)
    return reads


def _no_read_ops():
    i0, i1, vals, shape = _case("csr", "2d", seed=23)
    A = _port("csr", i0, i1, vals, shape)
    C = _port("coo", *_case("coo", "per-element", seed=24))
    t = _tri_case(16, False, 25)
    T = _port("coo", *t, dtype=torch.float32)
    Bm, X, Y = torch.ones(M, P), torch.ones(N, P), torch.ones(M, P)
    v = A.values.clone().requires_grad_(True)
    Av = A.with_data(v)
    return {
        "sparse_mm": lambda: torch.autograd.grad(
            sparse_mm(Av, Bm).sum(), v),
        "sparse_mm_batched": lambda: sparse_mm(C, torch.ones(B, M, P)),
        "sddmm": lambda: sddmm(A, X.requires_grad_(True), Y).values,
        "logsumexp": lambda: torch.autograd.grad(
            sparse_logsumexp(Av, 0).sum(), v),
        "bidir_logsumexp": lambda: sparse_bidir_logsumexp(Av),
        "tocsr_T": lambda: (A.tocoo().tocsr().values, A.T.values),
        "triangular": lambda: sparse_triangular_solve(
            T, torch.ones(16, 2), upper=False, transpose=True)}


@pytest.mark.parametrize("op", ["sparse_mm", "sparse_mm_batched", "sddmm",
                                "logsumexp", "bidir_logsumexp", "tocsr_T",
                                "triangular"])
def test_ops_read_nothing_back(no_host_read, op):
    ops = _no_read_ops()
    ops[op]()
    assert not no_host_read


def test_solves_read_only_their_convergence_flags(no_host_read):
    i0, i1, vals, shape = _spd_case(16, 26, "csr")
    A = _port("csr", i0, i1, vals, shape, dtype=torch.float32)
    v = A.values.clone().requires_grad_(True)
    x = sparse_generic_solve(A.with_data(v), torch.ones(16),
                             solve=psolvers.linear_cg,
                             settings=psolvers.LinearCGSettings(max_iter=50))
    torch.autograd.grad((x ** 2).sum(), v)
    assert no_host_read     # the flags, every CHECK_EVERY iterations
