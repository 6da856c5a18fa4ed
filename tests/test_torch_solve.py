"""PyTorch port: ``sparse_generic_solve`` and ``sparse_generic_lstsq``
held against the JAX package.

Float64 cases hand one JAX-built matrix (carried over with
``convert.from_arrays``) and one set of numpy inputs to both packages
and compare the solution within 1e-9 and the gradients, including a
Hessian-vector product through the implicit backward, within 1e-8
(relative to the largest entry); each JAX reference is one jitted
``value_and_grad``.  Float32 cases hold the port against a dense solve
at the JAX tests' own tolerances (``tests/test_solve.py``,
``tests/test_lstsq.py``).
"""

import functools
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu import solvers as js
from torchsparsegradutils_tpu_torch import (SparseCOO, sparse_generic_lstsq,
                                            sparse_generic_solve)
from torchsparsegradutils_tpu_torch import solvers as ps
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    make_spd_sparse, rand_sparse)
from torchsparsegradutils_tpu_torch.ops import spmm as pspmm
from torch_solver_cases import (N, ROUTES, SQUARE, TALL, close,
                                jax_mismatch_message, rhs, route_case, spd,
                                square, tall, to_port)

M, NL = TALL
CG = dict(max_iter=400, rtol=1e-10, mean_residual=False)
LSMR_TIGHT = dict(max_iter=800, atol=1e-10, btol=1e-10)


def port_grads(fn, A, B, G):
    """x = fn(A(v), b) and d(sum(x * G)) / d(v, b) in the port."""
    v = A.values.detach().clone().requires_grad_(True)
    b = torch.from_numpy(B).requires_grad_(True)
    x = fn(A.with_data(v), b)
    gv, gb = torch.autograd.grad((x * torch.from_numpy(G)).sum(), (v, b))
    return x, gv, gb


def jax_grads(fn, Aj, B, G):
    def loss(d, b):
        x = fn(Aj.with_data(d), b)
        return (x * G).sum(), x
    (_, x), (gv, gb) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(Aj.data, jnp.asarray(B))
    return x, gv, gb


@pytest.mark.parametrize("layout,solver,k", [("coo", "cg", 3),
                                             ("csr", "minres", 3),
                                             ("csr", "cg", None)])
def test_generic_solve_matches_jax(enable_x64, layout, solver, k):
    Aj = spd(layout)
    A = to_port(Aj)
    shape = (N,) if k is None else (N, k)
    B, G = rhs(shape, 1), rhs(shape, 2)
    if solver == "cg":
        jkw = dict(solve=js.linear_cg, settings=js.LinearCGSettings(**CG))
        pkw = dict(solve=ps.linear_cg, settings=ps.LinearCGSettings(**CG))
    else:                                   # the default, MINRES
        st = dict(max_iter=400, rtol=1e-10)
        jkw = dict(settings=js.MINRESSettings(**st))
        pkw = dict(settings=ps.MINRESSettings(**st))
    ref = jax_grads(functools.partial(tj.sparse_generic_solve, **jkw), Aj, B,
                    G)
    got = port_grads(functools.partial(sparse_generic_solve, **pkw), A, B, G)
    for name, g, r in zip(("x", "gradA", "gradB"), got, ref):
        close(g, r, 1e-9 if name == "x" else 1e-8)


def test_generic_solve_nonsymmetric_bicgstab_matches_jax(enable_x64):
    Aj = square("csr")
    A = to_port(Aj)
    B, G = rhs((SQUARE[0],), 1), rhs((SQUARE[0],), 2)
    st = dict(max_iter=800, rtol=1e-11)

    def kw(lib):
        return dict(solve=lambda M, r, **k: lib.bicgstab(M, r, **k),
                    transpose_solve=lambda M, r, **k: lib.bicgstab(M.T, r,
                                                                   **k),
                    settings=lib.BICGSTABSettings(**st))
    ref = jax_grads(functools.partial(tj.sparse_generic_solve, **kw(js)),
                    Aj, B, G)
    got = port_grads(functools.partial(sparse_generic_solve, **kw(ps)),
                     A, B, G)
    for name, g, r in zip(("x", "gradA", "gradB"), got, ref):
        close(g, r, 1e-9 if name == "x" else 1e-8)


HVP_N = 8
HVP_ROWS = np.concatenate([np.arange(HVP_N), np.arange(HVP_N - 1),
                           np.arange(1, HVP_N)])
HVP_COLS = np.concatenate([np.arange(HVP_N), np.arange(1, HVP_N),
                           np.arange(HVP_N - 1)])


@functools.lru_cache(maxsize=None)
def jax_hvp():
    """JAX's gradient and Hessian-vector product of the tridiagonal
    case (on COO; the CSR layout changes no value)."""
    n, b = HVP_N, jnp.asarray(rhs((HVP_N,), 3))

    def loss(th):
        d = jnp.concatenate([2.0 + th ** 2, -jnp.ones(2 * (n - 1))])
        A = tj.SparseCOO(HVP_ROWS, HVP_COLS, d, (n, n))
        x = tj.sparse_generic_solve(A, b, solve=js.linear_cg,
                                    settings=js.LinearCGSettings(**CG))
        return (x ** 2).sum()

    def both(th):
        g = jax.grad(loss)(th)
        return g, jax.grad(lambda u: jax.grad(loss)(u) @ jnp.ones(n))(th)
    return jax.jit(both)(jnp.linspace(0.5, 1.5, n))


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_hessian_vector_product_matches_jax(enable_x64, layout):
    """theta -> tridiagonal SPD matrix -> solve: gradient and
    Hessian-vector product through the implicit backward
    (``tests/test_solve.py:134``), against JAX's."""
    n, rows, cols = HVP_N, HVP_ROWS, HVP_COLS
    b = rhs((n,), 3)
    theta = np.linspace(0.5, 1.5, n)
    v = np.ones(n)
    g_ref, hvp_ref = jax_hvp()

    th = torch.from_numpy(theta).requires_grad_(True)
    d = torch.cat([2.0 + th ** 2, -torch.ones(2 * (n - 1),
                                              dtype=torch.float64)])
    A = SparseCOO(rows, cols, d, (n, n))
    A = A if layout == "coo" else A.tocsr()
    x = sparse_generic_solve(A, torch.from_numpy(b), solve=ps.linear_cg,
                             settings=ps.LinearCGSettings(**CG))
    (g,) = torch.autograd.grad((x ** 2).sum(), th, create_graph=True)
    (hvp,) = torch.autograd.grad(g @ torch.from_numpy(v), th)
    close(g, g_ref, 1e-8)
    close(hvp, hvp_ref, 1e-8)


@pytest.mark.parametrize("layout,k,tight", [("coo", 2, True),
                                            ("csr", None, False)])
def test_generic_lstsq_matches_jax(enable_x64, layout, k, tight):
    Aj = tall(layout)
    A = to_port(Aj)
    B = rhs((M,) if k is None else (M, k), 1)
    G = rhs((NL,) if k is None else (NL, k), 2)
    jkw, pkw = {}, {}
    if tight:
        jkw["settings"] = js.LSMRSettings(**LSMR_TIGHT)
        pkw["settings"] = ps.LSMRSettings(**LSMR_TIGHT)
    ref = jax_grads(functools.partial(tj.sparse_generic_lstsq, **jkw), Aj, B,
                    G)
    got = port_grads(functools.partial(sparse_generic_lstsq, **pkw), A, B, G)
    for name, g, r in zip(("x", "gradA", "gradB"), got, ref):
        close(g, r, 1e-9 if name == "x" else 1e-8)


# --------------------------------------------------------------------------
# float32 against a dense solve, at the JAX tests' own tolerances
# --------------------------------------------------------------------------

def test_float32_gradients_match_dense():
    A = make_spd_sparse(N, N + 2 * N, layout="csr", device="cpu")
    g = torch.Generator().manual_seed(4)
    B, G = torch.randn(N, 3, generator=g), torch.randn(N, 3, generator=g)
    x, gv, gb = port_grads(functools.partial(
        sparse_generic_solve, solve=ps.linear_cg,
        settings=ps.LinearCGSettings(max_iter=100, rtol=1e-6,
                                     mean_residual=False)),
        A, B.numpy(), G.numpy())
    Ad = A.todense().requires_grad_(True)
    b = B.clone().requires_grad_(True)
    xd = torch.linalg.solve(Ad, b)
    gAd, gbd = torch.autograd.grad((xd * G).sum(), (Ad, b))
    torch.testing.assert_close(x, xd, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(gv, gAd[A.rows_t(), A.cols_t()], rtol=1e-2,
                               atol=1e-3)
    torch.testing.assert_close(gb, gbd, rtol=1e-2, atol=1e-3)

    T = rand_sparse((M, NL), 80, layout="coo", device="cpu")
    Bt, Gt = torch.randn(M, 2, generator=g), torch.randn(NL, 2, generator=g)
    x, gv, gb = port_grads(functools.partial(
        sparse_generic_lstsq, settings=ps.LSMRSettings(max_iter=100)), T,
        Bt.numpy(), Gt.numpy())
    Td = T.todense().requires_grad_(True)
    b = Bt.clone().requires_grad_(True)
    xd = torch.linalg.pinv(Td) @ b
    gTd, gbd = torch.autograd.grad((xd * Gt).sum(), (Td, b))
    torch.testing.assert_close(x, xd, rtol=5e-2, atol=5e-3)
    torch.testing.assert_close(gv, gTd[T.rows_t(), T.cols_t()], rtol=5e-2,
                               atol=5e-3)
    torch.testing.assert_close(gb, gbd, rtol=5e-2, atol=5e-3)


# --------------------------------------------------------------------------
# validation and warnings, against the JAX package's
# --------------------------------------------------------------------------

def _errors(op_port, op_jax, A, Aj, cases):
    for make in cases:
        with pytest.raises(Exception) as ref:
            op_jax(*make(Aj, jnp))
        with pytest.raises(type(ref.value)) as got:
            op_port(*make(A, torch))
        assert str(got.value) == str(ref.value)


def _coo(shape, nnz):
    """The same random COO matrix in both packages (numpy, no JAX
    generator to compile)."""
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(shape[0] * shape[1], nnz, replace=False))
    r, c = keys // shape[1], keys % shape[1]
    v = rng.standard_normal(nnz).astype(np.float32)
    return tj.SparseCOO(r, c, jnp.asarray(v), shape), SparseCOO(
        r, c, torch.from_numpy(v), shape)


def test_validation_matches_jax():
    Aj, A = _coo((N, N), 3 * N)
    wide = _coo((4, 6), 5)[0]
    _errors(sparse_generic_solve, tj.sparse_generic_solve, A, Aj, [
        lambda A, lib: (lib.eye(N), lib.ones(N)),
        lambda A, lib: (A, A),
        lambda A, lib: ((wide, jnp.ones(4)) if lib is jnp
                        else (to_port(wide), torch.ones(4))),
        lambda A, lib: (A, lib.ones((N, 2, 2))),
        lambda A, lib: (A, lib.ones(N + 1)),
    ])
    tall_j, tall_p = _coo((M, NL), 80)
    _errors(sparse_generic_lstsq, tj.sparse_generic_lstsq, tall_p, tall_j, [
        lambda A, lib: (lib.eye(N), lib.ones(N)),
        lambda A, lib: (A, A),
        lambda A, lib: (A.T, lib.ones(NL)),
        lambda A, lib: (A, lib.ones((M, 2, 2))),
        lambda A, lib: (A, lib.ones(M + 1)),
    ])


def test_dtype_and_nonconvergence_warnings():
    A = make_spd_sparse(N, N + 2 * N, device="cpu")
    with pytest.warns(UserWarning, match="different dtypes"):
        try:
            sparse_generic_solve(A, torch.ones(N, dtype=torch.float64))
        except Exception:  # noqa: BLE001 - the solver may refuse the mix
            pass
    with pytest.warns(UserWarning, match="minres: did not converge after "
                                         "2 iterations"):
        x = sparse_generic_solve(A, torch.ones(N),
                                 settings=ps.MINRESSettings(max_iter=2,
                                                            rtol=1e-12))
    assert torch.isfinite(x).all()


# --------------------------------------------------------------------------
# a right-hand side of width 0, and a float64 A with a float32 B
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sparse_generic_solve",
                                "sparse_generic_lstsq"])
def test_width_zero_rhs_matches_jax(enable_x64, op):
    Aj = spd()
    ref = getattr(tj, op)(Aj, jnp.zeros((N, 0)))
    b = torch.zeros((N, 0), dtype=torch.float64, requires_grad=True)
    got = {"sparse_generic_solve": sparse_generic_solve,
           "sparse_generic_lstsq": sparse_generic_lstsq}[op](to_port(Aj), b)
    assert tuple(got.shape) == ref.shape == (N, 0)
    assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)
    (gb,) = torch.autograd.grad(got.sum(), b)
    assert gb.shape == (N, 0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("op", ["sparse_generic_solve",
                                "sparse_generic_lstsq"])
def test_dtype_mismatch_raises_jax_message(enable_x64, monkeypatch, route,
                                           op):
    if route == "chunk":
        chunk = pspmm._chunk_plan
        monkeypatch.setattr(pspmm, "_chunk_plan",
                            lambda A, backend: chunk(A, "pallas"))
    A = to_port(route_case(route))
    with warnings.catch_warnings():     # JAX's "different dtypes" warning
        warnings.simplefilter("ignore")
        msg = jax_mismatch_message(getattr(tj, op))
    fn = {"sparse_generic_solve": sparse_generic_solve,
          "sparse_generic_lstsq": sparse_generic_lstsq}[op]
    with pytest.raises(ValueError, match=f"^{re.escape(msg)}$"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn(A, torch.ones((A.shape[0], 2), dtype=torch.float32))


def test_conductivity_example_operator_and_gradient():
    """``examples/fit_conductivity_poisson.py``'s port: the same pattern
    and operator values as the JAX example's at a field θ, and the loss
    gradient of the implicit solve against a dense solve's (the
    example's CG at rtol 1e-8, float32; the JAX solver tests' 1e-2 /
    1e-3)."""
    import examples.fit_conductivity_poisson as jex
    from torchsparsegradutils_tpu_torch.examples import (
        fit_conductivity_poisson as ex)
    for name in ("ROWS", "COLS", "INDPTR", "IS_DIAG"):
        assert np.array_equal(getattr(ex, name), getattr(jex, name))
    theta = torch.from_numpy(np.random.default_rng(3).standard_normal(
        ex.N).astype(np.float32) * 0.3)
    np.testing.assert_allclose(
        ex.operator(theta).values.numpy(),
        np.asarray(jex.operator(jnp.asarray(theta.numpy())).data),
        rtol=1e-6, atol=1e-6)
    f = torch.from_numpy(np.random.default_rng(4).standard_normal(
        ex.N).astype(np.float32))
    y_obs = ex.solve(ex.theta_true("cpu"), f).detach()
    t = theta.clone().requires_grad_(True)
    ex.loss_fn(t, f, y_obs).backward()
    td = theta.double().clone().requires_grad_(True)
    Ad = ex.operator(td).todense()
    (((torch.linalg.solve(Ad, f.double()) - y_obs.double()) ** 2).sum()
     * 1e2).backward()
    torch.testing.assert_close(t.grad.double(), td.grad, rtol=1e-2,
                               atol=1e-3)
