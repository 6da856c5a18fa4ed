"""PyTorch port: ``interop`` held against the JAX package's.

The ``torch.sparse`` front end takes the same torch tensors as JAX's
``sparse_mm_j4t`` / ``sparse_solve_j4t`` (the inputs are made from
numpy with fixed seeds), and ``sparse_solve_scipy`` the same matrices as
JAX's.  Tolerances: ``sparse_mm_torch`` float32 ``rtol=1e-5,
atol=1e-6``; the solves as ``tests/test_interop.py`` states them
against a dense solve (``rtol=1e-2, atol=1e-3``; gradients ``5e-2 /
5e-3``), and between the packages ``rtol=1e-4, atol=1e-5`` (the same
algorithm in float32 on both sides; ``spsolve`` in float64 on the host
in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.interop import scipy_solve as jss
from torchsparsegradutils_tpu.interop import torch_bridge as jtb
from torchsparsegradutils_tpu_torch import SparseCOO, SparseCSR
from torchsparsegradutils_tpu_torch.interop import (
    from_torch_coo, from_torch_csr, scipy_solver, sparse_mm_torch,
    sparse_solve_scipy, sparse_solve_torch, to_torch_coo, to_torch_csr)
from torchsparsegradutils_tpu_torch.solvers import LinearCGSettings, linear_cg
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    make_spd_sparse)

F32 = dict(rtol=1e-5, atol=1e-6)
PKG = dict(rtol=1e-4, atol=1e-5)
N = 16


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _coo(seed, n=N, m=N, nnz=40, duplicates=0):
    """A torch COO tensor of a random pattern, ``duplicates`` of its
    entries repeated (uncoalesced), its values a leaf."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(n * m, nnz, replace=False)
    keys = np.concatenate([keys, keys[:duplicates]])
    idx = torch.from_numpy(np.stack([keys // m, keys % m]))
    vals = torch.from_numpy(_np(len(keys), seed + 1)).requires_grad_(True)
    return torch.sparse_coo_tensor(idx, vals, (n, m)), vals


def _spd(seed=0):
    """An SPD matrix as a port container and a torch COO tensor."""
    A = make_spd_sparse(N, 3 * N, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    idx = torch.stack([A.rows_t(), A.cols_t()])
    return A, idx


def test_round_trips_both_layouts():
    t, _ = _coo(0)
    A = from_torch_coo(t)
    J = jtb.t2j_coo(t)
    assert isinstance(A, SparseCOO) and A.shape == J.shape
    assert np.array_equal(A.rows(), np.asarray(J.rows()))
    assert np.array_equal(A.cols(), np.asarray(J.cols()))
    np.testing.assert_array_equal(A.values.detach().numpy(),
                                  np.asarray(J.data))
    dense = t.detach().to_dense()
    torch.testing.assert_close(A.todense().detach(), dense)
    torch.testing.assert_close(to_torch_coo(A).to_dense().detach(), dense)
    c = t.detach().to_sparse_csr()
    C = from_torch_csr(c)
    Jc = jtb.t2j_csr(c)
    assert isinstance(C, SparseCSR)
    assert np.array_equal(C.indptr_np(), np.asarray(Jc.indptr_arr()))
    torch.testing.assert_close(C.todense(), dense)
    back = to_torch_csr(C)
    assert back.layout == torch.sparse_csr
    torch.testing.assert_close(back.to_dense(), dense)
    # a COO container goes to CSR sorted
    torch.testing.assert_close(to_torch_csr(A).to_dense().detach(), dense)
    # the tensor's index tensors serve as the pattern's device copy
    assert C.cols_t().data_ptr() == c.col_indices().data_ptr()


def test_refusals():
    t, _ = _coo(0)
    with pytest.raises(TypeError, match="sparse_csr"):
        from_torch_csr(t)
    with pytest.raises(TypeError, match="sparse_coo"):
        from_torch_coo(torch.ones(3, 3))
    with pytest.raises(ValueError, match="2-D"):
        from_torch_coo(torch.ones(2, 3, 3).to_sparse())
    with pytest.raises(TypeError, match="2-D sparse container"):
        to_torch_coo(torch.ones(3, 3))


@pytest.mark.parametrize("layout,duplicates", [("coo", 0), ("coo", 5),
                                               ("csr", 0)])
def test_sparse_mm_torch_matches_j4t(layout, duplicates):
    grads = []
    for fn in (sparse_mm_torch, jtb.sparse_mm_j4t):
        t, vals = _coo(3, m=12, duplicates=duplicates)
        if layout == "csr":
            c = t.detach().coalesce().to_sparse_csr()
            vals = c.values().clone().requires_grad_(True)
            t = torch.sparse_csr_tensor(c.crow_indices(), c.col_indices(),
                                        vals, c.shape)
        B = torch.from_numpy(_np((12, 3), 4)).requires_grad_(True)
        y = fn(t, B)
        (y * torch.from_numpy(_np((N, 3), 5))).sum().backward()
        grads.append((y.detach(), vals.grad, B.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, **F32)


def _dense_solve(A, B, **kw):
    return torch.linalg.solve(A.todense(), B)


def _jax_dense_solve(A, B, **kw):
    return jnp.linalg.solve(A.todense(), B)


def test_sparse_solve_torch_matches_j4t():
    """The front end against JAX's with a dense solver on both sides (the
    Krylov solvers are held to JAX in ``tests/test_torch_solvers.py``):
    the solution, and the gradients on the tensor's values and on b."""
    A, idx = _spd()
    out = []
    for fn, solve in ((sparse_solve_torch, _dense_solve),
                      (jtb.sparse_solve_j4t, _jax_dense_solve)):
        vals = A.values.detach().clone().requires_grad_(True)
        t = torch.sparse_coo_tensor(idx, vals, (N, N))
        b = torch.from_numpy(_np(N, 6)).requires_grad_(True)
        x = fn(t, b, solve=solve)
        (x * torch.from_numpy(_np(N, 7))).sum().backward()
        out.append((x.detach(), vals.grad, b.grad))
    for got, jref in zip(*out):
        torch.testing.assert_close(got, jref, **PKG)


def test_sparse_solve_torch_is_the_generic_solve():
    """With the port's CG: bitwise ``sparse_generic_solve`` on the
    converted container, and within a dense solve's tolerance."""
    from torchsparsegradutils_tpu_torch import sparse_generic_solve
    A, idx = _spd()
    st = LinearCGSettings(max_iter=400, rtol=1e-7)
    b = torch.from_numpy(_np(N, 6))
    out = []
    for front in (True, False):
        vals = A.values.detach().clone().requires_grad_(True)
        t = torch.sparse_coo_tensor(idx, vals, (N, N))
        x = (sparse_solve_torch(t, b, solve=linear_cg, settings=st) if front
             else sparse_generic_solve(from_torch_coo(t), b,
                                       solve=linear_cg, settings=st))
        (x * torch.from_numpy(_np(N, 7))).sum().backward()
        out.append((x.detach(), vals.grad))
    assert all(torch.equal(a, b_) for a, b_ in zip(*out))
    ref = torch.linalg.solve(A.todense().double(), b.double())
    torch.testing.assert_close(out[0][0].double(), ref, rtol=1e-2, atol=1e-3)


def _jax_spd(A):
    return tj.SparseCOO(A.rows(), A.cols(), jnp.asarray(A.values.numpy()),
                        A.shape)


@pytest.mark.parametrize("method", ["spsolve", "cg"])
def test_sparse_solve_scipy_matches_jax(method):
    import jax
    A, _ = _spd()
    J = _jax_spd(A)
    b = _np(N, 6)
    v = A.values.clone().requires_grad_(True)
    x = sparse_solve_scipy(A.with_data(v), torch.from_numpy(b),
                           method=method)
    (x ** 2).sum().backward()
    jx, vjp = jax.vjp(lambda d: jss.sparse_solve_scipy(
        J.with_data(d), jnp.asarray(b), method=method), J.data)
    (jg,) = vjp(2 * jx)
    torch.testing.assert_close(x.detach(), torch.from_numpy(np.asarray(jx)),
                               **PKG)
    torch.testing.assert_close(v.grad, torch.from_numpy(np.asarray(jg)),
                               **PKG)
    # against a dense solve, at tests/test_interop.py's tolerances
    Ad = A.todense().double().requires_grad_(True)
    ((torch.linalg.solve(Ad, torch.from_numpy(b).double()) ** 2).sum()
     ).backward()
    torch.testing.assert_close(x.detach().double(), torch.linalg.solve(
        A.todense().double(), torch.from_numpy(b).double()),
        rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(v.grad.double(),
                               Ad.grad[A.rows_t(), A.cols_t()],
                               rtol=5e-2, atol=5e-3)


def test_scipy_multirhs_direct_and_guards():
    A, _ = _spd()
    B = _np((N, 3), 9)
    x = sparse_solve_scipy(A, torch.from_numpy(B), method="spsolve")
    jx = jss.sparse_solve_scipy(_jax_spd(A), jnp.asarray(B),
                                method="spsolve")
    torch.testing.assert_close(x, torch.from_numpy(np.asarray(jx)), **PKG)
    with pytest.raises(ValueError, match="unknown scipy solver"):
        scipy_solver("qmr_bogus")
    with pytest.raises(ValueError, match="single RHS"):
        scipy_solver("cg")(A, torch.ones(N, 2))
    with pytest.raises(TypeError, match="sparse container"):
        scipy_solver("cg")(torch.ones(N, N), torch.ones(N))
    # cached: equal arguments give one solver, as in JAX
    assert scipy_solver("cg", rtol=1e-8) is scipy_solver("cg", rtol=1e-8)
