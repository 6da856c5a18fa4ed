"""PyTorch port: ``sparse_logsumexp`` and ``sparse_bidir_logsumexp`` held
against the JAX package's.

The ELL grid plan is compared with the JAX ``build_ell_grid_plan`` field
by field; the chunk LSE's plain versions (K10, K11) with the JAX Pallas
``lse_fn`` and its VJP, run in interpret mode on the CPU as
``tests/test_pallas_kernels.py`` runs them; the public ops with the JAX
ops for COO, CSR and CSC, every ``dim``, ``keepdim``, both
``include_zeros``, batched shared and per-element patterns, the bidir
layouts and every error.  On a DIA pattern, a balanced random one and a
degree-skewed one, the route the port takes under each backend is the
one the JAX package takes, and gives its result.  Inputs are numpy
arrays from fixed seeds, handed to both packages.

Tolerances, those of ``tests/test_logsumexp.py`` and
``tests/test_pallas_kernels.py``: float32 values ``rtol=1e-5,
atol=1e-6``, gradients against ``jax.grad`` ``1e-4/1e-6``; bfloat16
``2e-2``; float64 values, first and second derivatives ``1e-10`` against
the JAX ``backend="xla"`` path (the JAX grid and chunk routes take no
float64, the port's do).
"""

import hashlib
import re

import jax
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.kernels import chunk_lse as jcl
from torchsparsegradutils_tpu.kernels import dia as jdia
from torchsparsegradutils_tpu.kernels import grid_lse as jgl
from torchsparsegradutils_tpu.ops import logsumexp as jops
from torchsparsegradutils_tpu.types import StaticArray as JStatic
from torchsparsegradutils_tpu_torch import (SparseCOO, SparseCSC,
                                            sparse_bidir_logsumexp,
                                            sparse_logsumexp, to_arrays)
from torchsparsegradutils_tpu_torch.kernels import chunk_lse as pcl
from torchsparsegradutils_tpu_torch.kernels import grid_lse as pgl
from torchsparsegradutils_tpu_torch.kernels import row_packs
from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
    build_chunk_plan)
from torchsparsegradutils_tpu_torch.ops import logsumexp as pops
from torchsparsegradutils_tpu_torch.types import StaticArray
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    stencil_sparse)
from torch_lse_patterns import lse_pattern, pack_edge_pattern

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD32 = dict(rtol=1e-4, atol=1e-6)
F64 = dict(rtol=1e-10, atol=1e-10)
BF16 = dict(rtol=2e-2, atol=2e-2)
RNG = np.random.default_rng(41)


def uniform(n, m, nnz, seed):
    """Row-major (rows, cols) of ``nnz`` distinct uniform entries."""
    keys = np.sort(np.random.default_rng(seed).choice(n * m, nnz, False))
    return keys // m, keys % m


def skewed():
    """The skew pattern of ``tests/test_pallas_kernels.py``: row 0 holds
    60 of 70 entries, (40, 64); n·K = 2,400 > 8·nnz."""
    rows = np.concatenate([np.zeros(60, np.int64), np.arange(1, 11)])
    cols = np.concatenate([np.arange(60), np.arange(10)])
    return rows, cols, (40, 64)


def with_infs():
    """Empty rows and columns, a +inf, a -inf and an all -inf row."""
    rows = np.array([0, 0, 1, 3, 3, 5])
    cols = np.array([0, 2, 2, 1, 4, 0])
    vals = np.array([np.inf, 1.0, -np.inf, -np.inf, -np.inf, 0.5],
                    np.float32)
    return rows, cols, vals, (6, 5)


def make(rows, cols, shape, layout="coo", vals=None, dtype=np.float32):
    """(port container on the CPU, JAX COO or CSR container) of one
    matrix; a port CSC container keeps its values in (column, row)
    order, ``csc_order(rows, cols)`` of the JAX container's."""
    if vals is None:
        vals = RNG.standard_normal(rows.shape).astype(dtype)
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    A = SparseCOO(rows, cols, torch.from_numpy(np.array(vals)), shape)
    J = tj.SparseCOO(rows, cols, vals, shape)
    if layout == "csr":
        A = A.tocsr()
        J = tj.SparseCSR(A.indptr_np(), A.cols(), vals, shape)
    if layout == "csc":
        order = csc_order(rows, cols)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(
            cols, minlength=shape[1]))]).astype(np.int32)
        A = SparseCSC(indptr, rows[order], torch.from_numpy(vals[order]),
                      shape)
    return A, J


def csc_order(rows, cols):
    return np.lexsort((rows, cols))


def check(got, want, tol=F32):
    """Values equal where finite, the same infinities elsewhere."""
    g = np.asarray(got.detach().float() if got.dtype == torch.bfloat16
                   else got.detach())
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    fin = np.isfinite(w)
    np.testing.assert_array_equal(g[~fin], w[~fin])
    np.testing.assert_allclose(g[fin], w[fin], **tol)


def jax_bidir(J, include_zeros=True, backend="xla"):
    """The JAX package's ``(2, [b,] G)`` padded bidirectional LSE of J, a
    random cotangent and the gradient of J's values for it, in one
    jitted call: the references of both directions."""
    def f(d):
        return tj.sparse_bidir_logsumexp(
            J.with_data(d), include_zeros=include_zeros,
            output_layout="padded", backend=backend)

    b = J.shape[:-2]
    ct = RNG.standard_normal((2, *b, max(J.shape[-2:]))).astype(J.data.dtype)
    out, grad = jax.jit(lambda d, c: (f(d), jax.vjp(f, d)[1](c)[0]))(
        J.data, ct)
    return np.asarray(out), ct, np.asarray(grad)


def lse_np(x, axis):
    """numpy logsumexp of JAX results (-inf where all are -inf)."""
    m = np.max(x, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0)
    with np.errstate(divide="ignore"):
        return np.log(np.exp(x - m).sum(axis=axis)) + np.squeeze(m, axis)


def port_vjp(A, fn, cts, create_graph=False):
    """``(outputs, d values, values)``: the vector-Jacobian product of
    ``fn`` at A's values for the cotangents ``cts``."""
    v = A.values.detach().clone().requires_grad_(True)
    outs = fn(A.with_data(v))
    outs = outs if isinstance(outs, tuple) else (outs,)
    (g,) = torch.autograd.grad(outs, v, [torch.as_tensor(c, dtype=o.dtype)
                                         for o, c in zip(outs, cts)],
                               create_graph=create_graph)
    return outs, g, v


@pytest.fixture(autouse=True)
def jax_xla_relayouts(monkeypatch):
    """The JAX DIA and ELL grid relayouts take their own XLA gather
    branch (``kernels/dia.py:_use_pallas_grid``) in place of the
    window-gather Pallas kernel, which costs seconds a call in interpret
    mode; that kernel (K3) is held against the port's gather in
    ``tests/test_torch_dia.py``."""
    monkeypatch.setattr(jdia, "_use_pallas_grid", lambda dtype: False)


@pytest.fixture
def routes(monkeypatch):
    """The routes each package took, recorded by spies on their route
    functions: ``{"port": set, "jax": set}``."""
    seen = {"port": set(), "jax": set()}

    def spy(mod, name, who, label, when=lambda out: True):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if when(out):
                seen[who].add(label)
            return out
        monkeypatch.setattr(mod, name, wrapped)

    made = lambda out: out is not None
    spy(pops, "_dia_lse", "port", "dia", made)
    spy(pgl, "_row_lse", "port", "grid")
    spy(pcl, "lse_rows_plain", "port", "chunk")
    spy(pops, "_scatter_logsumexp", "port", "segment")
    spy(jops, "_dia_lse", "jax", "dia", made)
    spy(jgl, "_grid_row_lse", "jax", "grid")
    spy(jgl, "masked_lse_kn", "jax", "grid-or-dia")
    spy(jcl, "_lse_partials", "jax", "chunk")
    spy(jops, "_scatter_logsumexp", "jax", "segment")
    return seen


def jax_routes(seen):
    r = set(seen["jax"])
    if "grid-or-dia" in r:          # the fused bidir grid reduce
        r.discard("grid-or-dia")
        if "dia" not in r:
            r.add("grid")
    return r


# --------------------------------------------------------------------------
# (a) the ELL grid plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_ell_grid_plan_matches_jax(kind):
    if kind == "skewed":
        rows, cols, (n, m) = skewed()
    else:
        (n, m), (rows, cols) = (30, 22), uniform(30, 22, 160, 1)
    jp = jgl.build_ell_grid_plan(JStatic(rows), JStatic(cols), n, m)
    pp = pgl.build_ell_grid_plan(StaticArray(rows), StaticArray(cols), n, m)
    if kind == "skewed":
        assert jp is None and pp is None       # the gate refuses both
        return
    assert (pp.n, pp.m, pp.nnz, pp.K) == (jp.n, jp.m, jp.nnz, jp.K)
    for f in ("counts", "src_of_grid", "pos"):
        np.testing.assert_array_equal(getattr(pp, f), getattr(jp, f))
    assert pp is pgl.build_ell_grid_plan(StaticArray(rows.copy()),
                                         StaticArray(cols.copy()), n, m)
    unsorted = RNG.permutation(len(rows))
    assert pgl.build_ell_grid_plan(StaticArray(rows[unsorted]),
                                   StaticArray(cols[unsorted]), n, m) is None


# --------------------------------------------------------------------------
# (b) K10/K11 plain versions against the JAX Pallas chunk LSE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["skewed", "infs"])
def test_chunk_lse_plain_matches_jax_pallas(kind):
    if kind == "skewed":
        rows, cols, (n, m) = skewed()
        vals = RNG.standard_normal(len(rows)).astype(np.float32)
    else:
        rows, cols, vals, (n, m) = with_infs()
    g = RNG.standard_normal(n).astype(np.float32)
    jfns = [jcl.lse_fn(JStatic(rows), JStatic(cols), n, m, iz)
            for iz in (False, True)]
    if kind == "skewed":
        wants = jax.jit(lambda x, c: [(f(x), jax.vjp(f, x)[1](c)[0])
                                      for f in jfns])(vals, g)
    else:
        # The JAX Pallas backward zeroes every entry of a chunk in which
        # some row's output is not finite (0 · inf in its one-hot matvec;
        # ROADMAP.md section 3), so here the JAX segment path's VJP is
        # the gradients' reference; an entry of a row whose output is not
        # finite gets 0, the JAX kernel's own rule, where that path gives
        # nan.
        J = tj.SparseCOO(rows, cols, vals, (n, m))
        fs = [lambda x, iz=iz: tj.sparse_logsumexp(
            J.with_data(x), 1, include_zeros=iz, backend="xla")
            for iz in (False, True)]
        wants = jax.jit(lambda x, c: [
            (jf(x), jax.vjp(f, x)[1](c)[0]) for jf, f in zip(jfns, fs)])(
            vals, g)
    plan = build_chunk_plan(StaticArray(rows), StaticArray(cols), n, m)
    d = plan.maps("cpu")
    v, gt = torch.from_numpy(vals), torch.from_numpy(g)
    for iz, (want, want_d) in zip((False, True), wants):
        out = pcl.lse_rows_plain(d["indptr"], v, m, iz)
        check(out, want)
        grad = pcl.lse_rows_bwd_plain(d["indptr"], v, out, gt).numpy()
        want_d = np.asarray(want_d)
        fin = np.isfinite(np.asarray(want))[rows]
        assert (grad[~fin] == 0).all()
        np.testing.assert_allclose(grad[fin], want_d[fin], **GRAD32)
        # the wrappers take the plain versions on the CPU, as the Function
        x = v.clone().requires_grad_(True)
        got = pcl.ChunkLse.apply(plan, m, iz, x)
        torch.testing.assert_close(got, out, rtol=0, atol=0)
        torch.testing.assert_close(torch.autograd.grad(got, x, gt)[0],
                                   torch.from_numpy(grad), rtol=0, atol=0)


# --------------------------------------------------------------------------
# (c) the public ops against JAX
# --------------------------------------------------------------------------

def sparse_case():
    """(12, 30), 40 entries, rows 4 and 7 empty, no DIA plan: the
    segment path in both packages on the CPU."""
    rows, cols = uniform(12, 30, 48, 2)
    keep = (rows != 4) & (rows != 7)
    return rows[keep], cols[keep], (12, 30)


@pytest.mark.parametrize("include_zeros", [True, False])
def test_logsumexp_matches_jax(include_zeros):
    rows, cols, (n, m) = sparse_case()
    _, J = make(rows, cols, (n, m))
    want, ct, want_d = jax_bidir(J, include_zeros)
    col, row = want[0, :m], want[1, :n]
    total = lse_np(row, 0)
    iz = dict(include_zeros=include_zeros)
    for layout in ("coo", "csr", "csc"):
        A, _ = make(rows, cols, (n, m), layout, vals=np.asarray(J.data))
        for dim, w in ((0, col), (1, row), (-1, row), (-2, col),
                       ([0, 1], total), ((1, 0), total)):
            check(sparse_logsumexp(A, dim, **iz), w)
            red = sorted(d % 2 for d in ([dim] if isinstance(dim, int)
                                         else dim))
            kshape = [1 if d in red else s for d, s in enumerate((n, m))]
            check(sparse_logsumexp(A, dim, keepdim=True, **iz),
                  np.reshape(w, kshape))
        # gradients: dim 0 and dim 1 with the bidir cotangents, and bidir
        order = csc_order(rows, cols) if layout == "csc" else slice(None)
        for fn in (lambda M: (sparse_logsumexp(M, 0, **iz),
                              sparse_logsumexp(M, 1, **iz)),
                   lambda M: sparse_bidir_logsumexp(M, **iz)):
            _, g, _ = port_vjp(A, fn, (ct[0, :m], ct[1, :n]))
            np.testing.assert_allclose(g.numpy(), want_d[order], **GRAD32)
        check(sparse_bidir_logsumexp(A, output_layout="padded", **iz), want)
        c, r = sparse_bidir_logsumexp(A, keepdim=True, **iz)
        check(c, col[None, :])
        check(r, row[:, None])


@pytest.mark.parametrize("shared", [True, False])
def test_logsumexp_batched_matches_jax(shared):
    b, n, m, nnz = 3, 8, 6, 15
    pats = [uniform(n, m, nnz, 10 + (0 if shared else i)) for i in range(b)]
    rows = np.stack([p[0] for p in pats]).astype(np.int32)
    cols = np.stack([p[1] for p in pats]).astype(np.int32)
    if shared:
        rows, cols = rows[0], cols[0]
    vals = RNG.standard_normal((b, nnz)).astype(np.float32)
    iz = dict(include_zeros=shared)         # both semantics, one each
    for layout in ("coo", "csr"):
        A = SparseCOO(rows, cols, torch.from_numpy(vals), (b, n, m))
        if layout == "csr":
            A = A.tocsr()
        assert A.indices_batched() != shared
        if layout == "coo":
            lay, i0, i1, data, shape = to_arrays(A)
            want, ct, want_d = jax_bidir(tj.SparseCOO(i0, i1, data, shape),
                                         **iz)
            col, row = want[0, :, :m], want[1, :, :n]
        for dim, w in ((1, col), (2, row), ([1, 2], lse_np(row, 1))):
            check(sparse_logsumexp(A, dim, **iz), w)
        check(sparse_logsumexp(A, 1, keepdim=True, **iz), col[:, None, :])
        check(sparse_logsumexp(A, 2, keepdim=True, **iz), row[:, :, None])
        check(sparse_logsumexp(A, [1, 2], keepdim=True, **iz),
              lse_np(row, 1)[:, None, None])
        check(sparse_bidir_logsumexp(A, output_layout="padded", **iz), want)
        c, r = sparse_bidir_logsumexp(A, keepdim=True, **iz)
        check(c, col[:, None, :])
        check(r, row[:, :, None])
        _, g, _ = port_vjp(A, lambda M: (sparse_logsumexp(M, 1, **iz),
                                         sparse_logsumexp(M, 2, **iz)),
                           (ct[0, :, :m], ct[1, :, :n]))
        np.testing.assert_allclose(g.numpy(), want_d, **GRAD32)
        with pytest.raises(NotImplementedError, match="batch dimension"):
            sparse_logsumexp(A, 0)


def test_errors_match_jax():
    rows, cols, shape = sparse_case()
    A, J = make(rows, cols, shape)
    cases = [
        (lambda M: sparse_bidir_logsumexp(M, output_layout="nested"),
         lambda M: tj.sparse_bidir_logsumexp(M, output_layout="nested")),
        (lambda M: sparse_bidir_logsumexp(M, output_layout="ragged"),
         lambda M: tj.sparse_bidir_logsumexp(M, output_layout="ragged")),
        (lambda M: sparse_bidir_logsumexp(M, keepdim=True,
                                          output_layout="padded"),
         lambda M: tj.sparse_bidir_logsumexp(M, keepdim=True,
                                             output_layout="padded")),
        (lambda M: sparse_logsumexp(M, 2), lambda M: tj.sparse_logsumexp(
            M, 2)),
        (lambda M: sparse_logsumexp(M, [0, 0]),
         lambda M: tj.sparse_logsumexp(M, [0, 0])),
        (lambda M: sparse_logsumexp(M, []), lambda M: tj.sparse_logsumexp(
            M, [])),
    ]
    for port_call, jax_call in cases:
        with pytest.raises(Exception) as want:
            jax_call(J)
        with pytest.raises(type(want.value),
                           match=re.escape(str(want.value))):
            port_call(A)
    B4 = SparseCOO(rows, cols, torch.ones(1, 1, len(rows)), (1, 1) + shape)
    with pytest.raises(NotImplementedError, match="ndim=4"):
        sparse_logsumexp(B4, 2)
    with pytest.raises(NotImplementedError, match="ndim=4"):
        sparse_bidir_logsumexp(B4)
    dense = torch.zeros(3, 3)
    with pytest.raises(TypeError, match="SparseCOO/SparseCSR"):
        sparse_logsumexp(dense, 0)
    with pytest.raises(TypeError, match="SparseCOO/SparseCSR"):
        sparse_bidir_logsumexp(dense)
    with pytest.raises(ValueError, match="unknown backend"):
        sparse_logsumexp(A, 0, backend="ell")


# --------------------------------------------------------------------------
# (d) routes: the port takes the JAX package's and gives its result
# --------------------------------------------------------------------------

PATTERNS = {
    "dia": lambda: (lambda S: (S.rows().astype(np.int64),
                               S.cols().astype(np.int64), (40, 40)))(
        stencil_sparse((40, 40), [-3, 0, 2], device="cpu")),
    "random": lambda: (*uniform(30, 22, 120, 5), (30, 22)),
    "skewed": skewed,
}
ROUTES = {   # (pattern, backend) -> routes of (dim 1, dim 0)
    ("dia", "dia"): ({"dia"}, {"dia"}),
    ("random", "pallas"): ({"grid"}, {"grid"}),
    ("skewed", "pallas"): ({"chunk"}, {"grid"}),
    ("random", "dia"): ({"segment"}, {"segment"}),
}


@pytest.mark.parametrize("kind,backend", list(ROUTES))
def test_routes_match_jax(kind, backend, routes):
    rows, cols, (n, m) = PATTERNS[kind]()
    A, J = make(rows, cols, (n, m), "csr")
    iz = dict(include_zeros=kind != "random")
    want, ct, want_d = jax_bidir(J, backend=backend, **iz)
    for dim, expect, w in zip((1, 0), ROUTES[kind, backend],
                              (want[1, :n], want[0, :m])):
        routes["port"].clear()
        check(sparse_logsumexp(A, dim, backend=backend, **iz), w)
        assert routes["port"] == expect
    both = ROUTES[kind, backend][0] | ROUTES[kind, backend][1]
    assert jax_routes(routes) == both
    routes["port"].clear()
    outs, g, _ = port_vjp(A, lambda M: sparse_bidir_logsumexp(
        M, backend=backend, **iz), (ct[0, :m], ct[1, :n]))
    check(outs[0], want[0, :m])
    check(outs[1], want[1, :n])
    np.testing.assert_allclose(g.numpy(), want_d, **GRAD32)
    assert routes["port"] == both


def test_single_direction_routes_match_jax_on_the_skewed_pattern(routes):
    rows, cols, (n, m) = PATTERNS["skewed"]()
    A, J = make(rows, cols, (n, m), "csr")
    for dim, expect in ((1, {"chunk"}), (0, {"grid"})):
        routes["port"].clear()
        routes["jax"].clear()
        check(sparse_logsumexp(A, dim, backend="pallas"),
              jax.jit(lambda d, dim=dim: tj.sparse_logsumexp(
                  J.with_data(d), dim, backend="pallas"))(J.data))
        assert routes["port"] == jax_routes(routes) == expect


def test_auto_takes_dia_on_the_cpu_and_segment_otherwise(routes):
    rows, cols, shape = PATTERNS["dia"]()
    A, _ = make(rows, cols, shape, "csr")
    sparse_logsumexp(A, 1)
    sparse_bidir_logsumexp(A)
    assert routes["port"] == {"dia"}
    routes["port"].clear()
    rows, cols, shape = PATTERNS["random"]()
    A, _ = make(rows, cols, shape, "csr")
    sparse_logsumexp(A, 0)
    sparse_bidir_logsumexp(A)
    assert routes["port"] == {"segment"}
    assert not pops._fast_route_ok(A, "auto")
    assert pops._fast_route_ok(A, "pallas")


def test_inf_values_on_each_route():
    rows, cols, vals, (n, m) = with_infs()
    A, J = make(rows, cols, (n, m), "csr", vals=vals)
    for iz in (True, False):
        want = jax_bidir(J, iz)[0]
        for backend in ("pallas", "xla"):
            for dim, w in ((0, want[0, :m]), (1, want[1, :n])):
                check(sparse_logsumexp(A, dim, include_zeros=iz,
                                       backend=backend), w)
    out = sparse_logsumexp(A, 1, include_zeros=False, backend="pallas")
    assert out[0] == float("inf") and out[1] == float("-inf")


# --------------------------------------------------------------------------
# (e) dtypes, second order, gradcheck
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,backend", [("dia", "auto"),
                                          ("random", "pallas"),
                                          ("skewed", "pallas")])
def test_float64_first_and_second_order_match_jax(kind, backend,
                                                  enable_x64):
    rows, cols, (n, m) = PATTERNS[kind]()
    A, J = make(rows, cols, (n, m), "csr", dtype=np.float64)

    def f(d):
        return tj.sparse_bidir_logsumexp(J.with_data(d), backend="xla",
                                         output_layout="padded")

    ctn = RNG.standard_normal((2, max(n, m)))
    grad = lambda d: jax.vjp(f, d)[1](ctn)[0]
    want, want_g, hess = jax.jit(lambda d: (f(d), grad(d), jax.grad(
        lambda x: (grad(x) ** 2).sum())(d)))(J.data)
    want = np.asarray(want)
    outs, g, v = port_vjp(A, lambda M: (sparse_logsumexp(M, 0,
                                                         backend=backend),
                                        sparse_logsumexp(M, 1,
                                                         backend=backend)),
                          (ctn[0, :m], ctn[1, :n]), create_graph=True)
    check(outs[0], want[0, :m], F64)
    check(outs[1], want[1, :n], F64)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(want_g),
                               **F64)
    (h,) = torch.autograd.grad((g ** 2).sum(), v)
    np.testing.assert_allclose(h.numpy(), np.asarray(hess), **F64)


def test_bfloat16_on_each_route():
    for kind, backend in (("dia", "auto"), ("random", "pallas"),
                          ("skewed", "pallas")):
        rows, cols, (n, m) = PATTERNS[kind]()
        A, J = make(rows, cols, (n, m), "csr")
        Ab = A.astype(torch.bfloat16)
        want = jax_bidir(J.with_data(Ab.values.float().numpy()))[0]
        for b in (backend, "xla"):
            for dim, w in ((0, want[0, :m]), (1, want[1, :n])):
                out = sparse_logsumexp(Ab, dim, backend=b)
                assert out.dtype == torch.bfloat16
                check(out, w, BF16)


@pytest.mark.parametrize("kind", ["random", "skewed"])
def test_gradcheck_grid_and_chunk_routes(kind):
    rows, cols, shape = PATTERNS[kind]()
    keep = rows < 12                                  # small, no empty row
    rows, cols, shape = rows[keep], cols[keep], (12, shape[1])
    A, _ = make(rows, cols, shape, "csr", dtype=np.float64)
    v = A.values.clone().requires_grad_(True)
    for fn in (lambda x: sparse_logsumexp(A.with_data(x), 1,
                                          backend="pallas"),
               lambda x: sparse_logsumexp(A.with_data(x), 0,
                                          backend="pallas"),
               lambda x: sparse_bidir_logsumexp(A.with_data(x),
                                                backend="pallas")):
        assert torch.autograd.gradcheck(fn, (v,))
        assert torch.autograd.gradgradcheck(fn, (v,))


def test_wrappers_refuse_non_cpu_tensors():
    idx = torch.zeros(3, dtype=torch.int64, device="meta")
    v = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        pcl.lse_rows(idx, v, 4, True)
    with pytest.raises(ValueError, match="CUDA device"):
        pcl.lse_rows_bwd(idx, v, torch.empty(2, device="meta"),
                         torch.empty(2, device="meta"))


# --------------------------------------------------------------------------
# (d) the row-pack plan that K10 and K11 walk on the card
# --------------------------------------------------------------------------

def _hub_indptr():
    """3,000 rows: a hub of 1,250 entries every 100th row, 20,000 uniform
    entries over the rest (the lse-skewed shape, cut down)."""
    rng = np.random.default_rng(8)
    counts = np.bincount(rng.integers(0, 3000, 20_000), minlength=3000)
    counts[::100] = 1250
    return np.concatenate([[0], np.cumsum(counts)])


def _pack_cases():
    return {"skewed": _hub_indptr(),
            "awkward": lse_pattern()[0].indptr,
            "edges": pack_edge_pattern()[2],
            "n_much_larger": np.array([0] * 40_000 + [1, 3] + [3] * 9_000),
            "no_entries": np.zeros(5_001, np.int64)}


@pytest.mark.parametrize("T", [1024, pcl.PACK_ENTRIES, 4096])
@pytest.mark.parametrize("kind", ["skewed", "awkward", "edges",
                                  "n_much_larger", "no_entries"])
def test_lse_packs_cover_every_row_once_within_the_pack_size(kind, T):
    indptr = _pack_cases()[kind]
    n = len(indptr) - 1
    starts = pcl.lse_packs(indptr, T)
    # every row exactly once, in order: strictly increasing from 0 to n
    assert starts.dtype == np.int64 and starts[0] == 0 and starts[-1] == n
    assert (np.diff(starts) > 0).all()
    rows = np.diff(starts)
    ents = indptr[starts[1:]] - indptr[starts[:-1]]
    lens = np.diff(indptr)
    several = rows > 1
    # a pack of several rows fits the staging; a longer row is alone
    assert (ents[several] <= T).all() and (rows[several] <= T // 2).all()
    alone = np.zeros(n, bool)
    alone[starts[:-1][~several]] = True
    assert alone[lens > pcl.LONG_ROW].all()
    # greedy: the next row would not have fitted a pack of several
    nxt = starts[1:-1][several[:-1]]
    over = (indptr[np.minimum(nxt + 1, n)] - indptr[starts[:-2][several[:-1]]]
            > T) | (nxt - starts[:-2][several[:-1]] >= T // 2) \
        | (lens[nxt] > pcl.LONG_ROW)
    assert over.all()
    G = pcl.pack_lanes(indptr, starts)
    assert G.shape == rows.shape
    assert np.isin(G, [4, 8, 16, 32]).all() and (G[~several] == 32).all()


def test_pack_lanes_follow_the_mean_row_length():
    # packs of 1, 4, 13, 25, 100 and 200 entries a row
    for per_row, want in ((1, 4), (4, 4), (13, 4), (25, 8), (100, 32),
                          (200, 32)):
        indptr = np.arange(0, per_row * 10 + 1, per_row)
        assert pcl.pack_lanes(indptr, [0, 10]).tolist() == [want]


def test_pack_edge_pattern_reaches_every_lane_group():
    # the card's pack edge test runs every path of the pack loop through
    # the plan's own choices: lane groups of 4, 8, 16 and 32 in packs of
    # several rows, a warp's row (longer than 8 G) in packs of G < 32,
    # packs of one row of one chunk and of several, and packs of empty
    # rows only
    _, _, indptr, _ = pack_edge_pattern()
    starts = pcl.lse_packs(indptr)
    G = pcl.pack_lanes(indptr, starts)
    rows = np.diff(starts)
    ents = indptr[starts[1:]] - indptr[starts[:-1]]
    several = rows > 1
    assert set(G[several].tolist()) == {4, 8, 16, 32}
    lens = np.diff(indptr)
    warp_G = {int(G[k]) for k in np.flatnonzero(several & (G < 32))
              if (lens[starts[k]:starts[k + 1]] > 8 * G[k]).any()}
    assert {4, 8, 16} <= warp_G
    alone = ents[~several]
    assert (alone <= pcl.PACK_ENTRIES).any()
    assert (alone > 2 * pcl.PACK_ENTRIES).any()
    assert ((ents == 0) & several).sum() >= 2


def test_pack_table_and_its_cache():
    indptr = _hub_indptr()
    pk = pcl.pack_table(indptr)
    starts = pcl.lse_packs(indptr)
    t = pk.table.numpy()
    assert (pk.n, pk.nnz) == (3000, indptr[-1])
    assert t.shape == (len(starts), 3)
    np.testing.assert_array_equal(t[:, 0], starts)
    np.testing.assert_array_equal(t[:, 1], indptr[starts])
    np.testing.assert_array_equal(
        1 << t[:-1, 2], pcl.pack_lanes(indptr, starts))
    assert t[-1].tolist() == [3000, indptr[-1], 0]
    rows = np.repeat(np.arange(3000), np.diff(indptr))
    plan = build_chunk_plan(StaticArray(rows), StaticArray(rows % 50), 3000,
                            50)
    a = pcl.plan_packs(plan, "cpu")
    assert pcl.plan_packs(plan, "cpu") is a
    assert torch.equal(a.table, pk.table) and (a.n, a.nnz) == (pk.n, pk.nnz)


def test_wrappers_refuse_a_pack_table_of_another_pattern():
    # checked on the host before a launch: the kernels index out and d
    # by the table alone
    ip = torch.tensor([0, 1, 3])
    v = torch.ones(3)
    own = pcl.pack_table(ip.numpy())
    built = pcl._packs_for("lse_rows", ip, v, None)
    assert torch.equal(built.table, own.table) and built[1:] == own[1:]
    assert pcl._packs_for("lse_rows", ip, v, own) is own
    for other in ([0, 1, 2, 3], [0, 1, 2], [0, 3]):
        with pytest.raises(ValueError, match="packs were cut for"):
            pcl._packs_for("lse_rows", ip, v, pcl.pack_table(np.array(other)))
    with pytest.raises(ValueError, match="packs must be"):
        pcl._packs_for("lse_rows", ip, v,
                       pcl.pack_table(ip.numpy())._replace(
                           table=torch.zeros(2, 3, dtype=torch.int32)))


def test_row_packs_and_chunk_lse_export_the_same_objects():
    # the planner lives in kernels/row_packs.py, which K8 shares; K10's
    # and K11's module re-exports it unchanged
    for name in row_packs.__all__ + ["_packs_for"]:
        assert getattr(pcl, name) is getattr(row_packs, name), name
    assert set(row_packs.__all__) - {"PACK_ENTRIES", "LONG_ROW"} \
        <= set(pcl.__all__)


def test_pack_table_is_the_table_cut_before_the_planner_moved():
    # the tables K10 and K11 read did not change with the move: a literal
    # one (empty-row runs, rows of 300, 257 and 256 entries, a pack cut at
    # T / 2 rows) and digests of two patterns' tables, taken before it
    lens = [3, 0, 0, 300, 1, 0, 257, 256, 2, 2] + [0] * 1030 + [5, 40]
    indptr = np.concatenate([[0], np.cumsum(lens)])
    assert pcl.pack_table(indptr).table.tolist() == [
        [0, 0, 2], [3, 3, 5], [4, 303, 2], [6, 304, 5], [7, 561, 2],
        [1031, 821, 2], [1042, 866, 0]]
    for ip, lines, digest in (
            (pack_edge_pattern()[2], 43, "7db11aff727cea40392f8c2e5ab46014"
             "ed7bff1ec042726ab0025885117f1ac1"),
            (lse_pattern()[0].indptr, 14, "7318381c8e08a13246e7baa983bad15c"
             "d7b0fabb38b48c4704734b7ff3bf231d")):
        t = pcl.pack_table(ip).table.numpy()
        assert t.shape == (lines, 3)
        assert hashlib.sha256(t.tobytes()).hexdigest() == digest
