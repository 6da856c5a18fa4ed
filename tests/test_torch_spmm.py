"""PyTorch port: ``sparse_mm`` and ``sddmm`` held against the JAX package.

Every case hands one matrix and one set of numpy inputs (fixed seeds) to
both packages.  The JAX reference is its ``backend="xla"`` path, the
plain gather + segment-sum branch that ``tests/test_dia.py`` also holds
its DIA path against; ``tests/test_torch_dia.py`` compares the engines
themselves, including once against the JAX Pallas kernels in interpret
mode.  The port runs its default ``backend="auto"``: the DIA engine for
stencil and hybrid patterns, the generic branch for random ones.

Tolerances: float32 ``rtol=1e-5, atol=1e-6`` on outputs; gradients,
whose sums run in another order in the two packages, at ``1e-5 / 1e-5``
as ``tests/test_dia.py`` holds its DIA gradients against XLA; second
derivatives at ``1e-4 / 1e-5``, as ``tests/test_dia.py`` loosens them;
float64 at 1e-10.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu_torch import (SparseCOO, SparseCSR,
                                            dia_coverage, sddmm, sparse_mm,
                                            to_arrays)
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    hybrid_sparse, stencil_sparse)

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD32 = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-10)
RNG = np.random.default_rng(11)


def jax_of(A):
    """The JAX container holding the same arrays as port container A."""
    lay, i0, i1, data, shape = to_arrays(A)
    return (tj.SparseCOO if lay == "coo" else tj.SparseCSR)(i0, i1, data,
                                                             shape)


def random_sparse(shape, nnz, layout, seed=0, dtype=torch.float32):
    """Uniform random pattern in row-major order (no DIA structure)."""
    n, m = shape
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(n * m, nnz, replace=False))
    rows, cols = keys // m, keys % m
    vals = torch.from_numpy(rng.standard_normal(nnz)).to(dtype)
    if layout == "coo":
        return SparseCOO(rows.astype(np.int32), cols.astype(np.int32), vals,
                         shape)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return SparseCSR(indptr.astype(np.int32), cols.astype(np.int32), vals,
                     shape)


def make(kind, layout, dtype=torch.float32):
    gen = torch.Generator().manual_seed(5)
    kw = dict(layout=layout, dtype=dtype, generator=gen, device="cpu")
    if kind == "stencil":
        return stencil_sparse((128, 128), [-12, -1, 0, 1, 5, 12], **kw)
    if kind == "hybrid":
        return hybrid_sparse((128, 128), [-9, -1, 0, 1, 9], 700,
                             dia_coverage=0.85, **kw)
    if kind == "rect":
        return stencil_sparse((120, 200), [-3, 0, 2, 40], **kw)
    if kind == "tall":
        return hybrid_sparse((200, 90), [-20, -1, 0, 1], 500,
                             dia_coverage=0.9, **kw)
    return random_sparse((128, 128), 600, layout, dtype=dtype)


def port_fwd_bwd(A, B, G, backend="auto"):
    v = A.values.detach().clone().requires_grad_(True)
    b = torch.from_numpy(B).requires_grad_(True)
    out = sparse_mm(A.with_data(v), b, backend=backend)
    gv, gb = torch.autograd.grad(out, (v, b), torch.from_numpy(G))
    return out.detach().numpy(), gv.numpy(), gb.numpy()


def jax_fwd_bwd(Aj, B, G):
    out, vjp = jax.vjp(
        lambda d, b: tj.sparse_mm(Aj.with_data(d), b, backend="xla"),
        Aj.data, jnp.asarray(B))
    gd, gb = vjp(jnp.asarray(G))
    return np.asarray(out), np.asarray(gd), np.asarray(gb)


@pytest.mark.parametrize("kind,layout,p", [
    ("stencil", "csr", 1), ("stencil", "csr", 3), ("stencil", "coo", 16),
    ("stencil", "csr", 64), ("hybrid", "csr", 3), ("hybrid", "coo", 16),
    ("random", "csr", 3), ("random", "coo", 16), ("rect", "csr", 3),
    ("tall", "coo", 3)])
def test_sparse_mm_fwd_and_grads_match_jax(kind, layout, p):
    A = make(kind, layout)
    assert dia_coverage(A)["qualifies"] == (kind != "random")
    n, m = A.shape
    B = RNG.standard_normal((m, p)).astype(np.float32)
    G = RNG.standard_normal((n, p)).astype(np.float32)
    got = port_fwd_bwd(A, B, G)
    for g, w, tol in zip(got, jax_fwd_bwd(jax_of(A), B, G),
                         (F32, GRAD32, GRAD32)):
        np.testing.assert_allclose(g, w, **tol)
    # the port's generic branch agrees with its DIA engine
    for g, x, tol in zip(got, port_fwd_bwd(A, B, G, backend="xla"),
                         (F32, GRAD32, GRAD32)):
        np.testing.assert_allclose(g, x, **tol)


def test_sparse_mm_batched_matches_jax():
    A = make("stencil", "csr")
    b, (n, m) = 2, A.shape
    vals = torch.stack([A.values, -2 * A.values])
    Ab = SparseCSR(A.indptr, A.indices, vals, (b, n, m))     # shared
    Rb = SparseCOO(np.stack([make("random", "coo").rows(),
                             random_sparse((n, m), 600, "coo", 1).rows()]),
                   np.stack([make("random", "coo").cols(),
                             random_sparse((n, m), 600, "coo", 1).cols()]),
                   torch.from_numpy(RNG.standard_normal((b, 600))).float(),
                   (b, n, m))                               # per element
    B = RNG.standard_normal((b, m, 4)).astype(np.float32)
    G = RNG.standard_normal((b, n, 4)).astype(np.float32)
    for C in (Ab, Rb):
        got = port_fwd_bwd(C, B, G)
        for g, w, tol in zip(got, jax_fwd_bwd(jax_of(C), B, G),
                             (F32, GRAD32, GRAD32)):
            np.testing.assert_allclose(g, w, **tol)
    # unbatched A against a batched B, and a batched A against one B
    out = sparse_mm(A, torch.from_numpy(B)).numpy()
    want = tj.sparse_mm(jax_of(A), jnp.asarray(B), backend="xla")
    np.testing.assert_allclose(out, want, **F32)
    out = sparse_mm(Rb, torch.from_numpy(B[0])).numpy()
    want = tj.sparse_mm(jax_of(Rb), jnp.asarray(B[0]), backend="xla")
    np.testing.assert_allclose(out, want, **F32)


@pytest.mark.parametrize("kind", ["stencil", "hybrid", "random"])
def test_sddmm_fwd_and_grads_match_jax(kind):
    A = make(kind, "csr")
    n, m = A.shape
    X = RNG.standard_normal((n, 6)).astype(np.float32)
    Y = RNG.standard_normal((m, 6)).astype(np.float32)
    C = RNG.standard_normal(A.nnz).astype(np.float32)
    x = torch.from_numpy(X).requires_grad_(True)
    y = torch.from_numpy(Y).requires_grad_(True)
    vals = sddmm(A, x, y).values
    gx, gy = torch.autograd.grad(vals, (x, y), torch.from_numpy(C))
    Aj = jax_of(A)
    want, vjp = jax.vjp(lambda a, b: tj.sddmm(Aj, a, b, backend="xla").data,
                        jnp.asarray(X), jnp.asarray(Y))
    wants = (want, *vjp(jnp.asarray(C)))
    for g, w, tol in zip((vals.detach(), gx, gy), wants,
                         (F32, GRAD32, GRAD32)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_sddmm_batched_matches_jax():
    A = make("hybrid", "coo")
    b, (n, m) = 2, A.shape
    Ab = SparseCOO(A.row, A.col, torch.stack([A.values] * b), (b, n, m))
    X = RNG.standard_normal((b, n, 5)).astype(np.float32)
    Y = RNG.standard_normal((b, m, 5)).astype(np.float32)
    Rb = SparseCOO(np.stack([A.rows(), A.rows()[::-1].copy()]),
                   np.stack([A.cols(), A.cols()]), Ab.values, (b, n, m))
    for C in (Ab, Rb):
        got = sddmm(C, torch.from_numpy(X), torch.from_numpy(Y)).values
        want = tj.sddmm(jax_of(C), X, Y, backend="xla").data
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    got = sddmm(Ab, torch.from_numpy(X[0]), torch.from_numpy(Y[0])).values
    want = tj.sddmm(jax_of(Ab), X[0], Y[0], backend="xla").data
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("kind", ["stencil", "hybrid"])
def test_second_order_matches_jax(kind):
    A = make(kind, "csr")
    n, m = A.shape
    B = RNG.standard_normal((m, 4)).astype(np.float32)

    v = A.values.detach().clone().requires_grad_(True)
    b = torch.from_numpy(B).requires_grad_(True)
    loss = (sparse_mm(A.with_data(v), b) ** 2).sum()
    gv, gb = torch.autograd.grad(loss, (v, b), create_graph=True)
    hv, hb = torch.autograd.grad(gv.sum() + gb.sum(), (v, b))

    Aj = jax_of(A)

    def f(d, bb):
        return (tj.sparse_mm(Aj.with_data(d), bb, backend="xla") ** 2).sum()

    def g(d, bb):
        gd, gbb = jax.grad(f, argnums=(0, 1))(d, bb)
        return gd.sum() + gbb.sum()

    wv, wb = jax.grad(g, argnums=(0, 1))(Aj.data, jnp.asarray(B))
    np.testing.assert_allclose(hv.numpy(), wv, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hb.numpy(), wb, rtol=1e-4, atol=1e-5)


def test_float64_matches_jax(enable_x64):
    for kind in ("stencil", "hybrid"):
        A = make(kind, "csr", dtype=torch.float64)
        n, m = A.shape
        B = RNG.standard_normal((m, 3))
        G = RNG.standard_normal((n, 3))
        got = port_fwd_bwd(A, B, G)
        assert got[0].dtype == np.float64
        for g, w in zip(got, jax_fwd_bwd(jax_of(A), B, G)):
            np.testing.assert_allclose(g, w, **F64)


def test_bfloat16_forward_and_grad():
    A32 = make("stencil", "csr")
    A = A32.astype(torch.bfloat16)
    B = torch.from_numpy(RNG.standard_normal((128, 8)).astype(np.float32))
    out = sparse_mm(A, B.bfloat16())
    assert out.dtype == torch.bfloat16
    # the same bf16-rounded operands, multiplied in float32
    ref = A.todense().float() @ B.bfloat16().float()
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    v = A.values.clone().requires_grad_(True)
    sparse_mm(A.with_data(v), B.bfloat16()).float().sum().backward()
    assert v.grad.dtype == torch.bfloat16 and v.grad.shape == (A.nnz,)


def _A():
    return random_sparse((6, 5), 10, "coo")


@pytest.mark.parametrize("call,exc,msg", [
    (lambda: sparse_mm(torch.ones(3, 3), torch.ones(3, 2)), TypeError,
     "sparse_mm: A must be SparseCOO or SparseCSR, got Tensor"),
    (lambda: sparse_mm(_A(), random_sparse((5, 4), 6, "coo")), TypeError,
     "sparse_mm: B must be a dense array, got sparse"),
    (lambda: sparse_mm(_A(), torch.ones(4, 2)), ValueError,
     "sparse_mm: inner dims disagree, A has shape (6, 5) and B has shape "
     "(4, 2)"),
    (lambda: sparse_mm(_A(), torch.ones(5, 2, dtype=torch.int32)),
     ValueError, "sparse_mm: dtype mismatch, A is float32 and B is int32"),
    (lambda: sparse_mm(_A(), torch.ones(1, 1, 5, 2)), ValueError,
     "sparse_mm: B must be 2-D or batched 3-D, got 4-D"),
    (lambda: sddmm(_A(), torch.ones(6, 3), torch.ones(5, 4)), ValueError,
     "sddmm: X (6, 3) and Y (5, 4) must share ndim and trailing "
     "(contraction) dim"),
    (lambda: sddmm(_A(), torch.ones(7, 3), torch.ones(5, 3)), ValueError,
     "sddmm: X (7, 3) / Y (5, 3) do not match pattern shape (6, 5)"),
    (lambda: sddmm(torch.ones(6, 5), torch.ones(6, 3), torch.ones(5, 3)),
     TypeError, "sddmm: A must be SparseCOO or SparseCSR"),
    (lambda: sddmm(_A(), torch.ones(2, 6, 3), torch.ones(2, 5, 3)),
     ValueError, "sddmm: batched X/Y with an unbatched pattern is "
     "ambiguous"),
])
def test_error_contracts(call, exc, msg):
    with pytest.raises(exc, match=re.escape(msg)):
        call()


def test_backend_contracts():
    R = random_sparse((64, 64), 512, "csr")
    dia_msg = re.escape("backend='dia' requires a static 2-D "
                        "diagonal-structured pattern")
    with pytest.raises(ValueError, match=dia_msg):
        sparse_mm(R, torch.ones(64, 4), backend="dia")
    with pytest.raises(ValueError, match=dia_msg):
        sddmm(R, torch.ones(64, 4), torch.ones(64, 4), backend="dia")
    S = stencil_sparse((64, 64), (-1, 0, 1), device="cpu")
    assert sparse_mm(S, torch.ones(64, 4), backend="dia").shape == (64, 4)
    # "pallas" forces the chunk engine (its plain versions on the CPU)
    torch.testing.assert_close(sparse_mm(S, torch.ones(64, 4),
                                         backend="pallas"),
                               sparse_mm(S, torch.ones(64, 4)))
    # "ell" runs the ELL engine, on any pattern: the same values
    X = torch.from_numpy(RNG.standard_normal((64, 4)).astype(np.float32))
    for M in (S, R):
        torch.testing.assert_close(sparse_mm(M, X, backend="ell"),
                                   sparse_mm(M, X, backend="xla"), **F32)
        torch.testing.assert_close(sddmm(M, X, X, backend="ell").values,
                                   sddmm(M, X, X, backend="xla").values,
                                   **F32)
    with pytest.raises(ValueError, match="unknown backend"):
        sparse_mm(S, torch.ones(64, 4), backend="cuda")
    with pytest.raises(ValueError, match="grad_precision"):
        sparse_mm(S, torch.ones(64, 4), grad_precision="half")
    fast = sparse_mm(S, torch.ones(64, 4), grad_precision="fast")
    torch.testing.assert_close(fast, sparse_mm(S, torch.ones(64, 4)))
