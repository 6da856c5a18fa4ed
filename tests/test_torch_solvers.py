"""PyTorch port: the Krylov solvers held against the JAX package.

Every float64 case hands one matrix, built by the JAX package's
generators and carried over with ``convert.from_arrays(...,
device="cpu")``, and one set of numpy inputs to both packages; each JAX
reference is jitted once.  Tolerances (float64): x within 1e-9 relative
to its largest entry, iteration counts and converged masks equal, the
final residual norms within 1e-5 relative or 1e-9 absolute (a converged
norm of 1e-10 is rounding noise; the right-hand sides have norms of
about 5).  The float32 cases hold the port against a dense
solve at the JAX tests' own tolerances (``tests/test_solvers.py``).

Routes: sparse containers run the generic branch on the CPU unless their
pattern is DIA; ``chunk_route`` forces the chunk engine's plain versions
the way the other port tests do (``ops.spmm._chunk_plan`` read as
``backend="pallas"``).
"""

import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsparsegradutils_tpu import solvers as js
from torchsparsegradutils_tpu.utils import random_sparse as jrs
from torchsparsegradutils_tpu_torch import solvers as ps
from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
from torchsparsegradutils_tpu_torch.kernels import dia
from torchsparsegradutils_tpu_torch.ops import spmm as pspmm
from torchsparsegradutils_tpu_torch.solvers import common
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    make_spd_sparse, make_spd_stencil, rand_sparse)
from torch_solver_cases import (KEY, N, ROUTES, SQUARE, TALL, close,
                                jax_mismatch_message, rhs, route_case, spd,
                                square, stencil, t, tall, to_port)

F64 = 1e-9
TIGHT = dict(max_iter=400, atol=1e-10, btol=1e-10)


def same_info(got, ref):
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(got.residual.numpy(),
                               np.asarray(ref.residual), rtol=1e-5,
                               atol=1e-9)


# --------------------------------------------------------------------------
# solvers, float64, against JAX
# --------------------------------------------------------------------------

def jacobi(d):
    return lambda r: r / (d[:, None] if r.ndim == 2 else d)


CG_CASES = {
    "vector": dict(b=(N,)),
    "multi_rhs": dict(b=(N, 4)),
    "preconditioner": dict(b=(N,), precond=True),
    "x0": dict(b=(N,), x0=True),
    "zero_rhs_max_residual": dict(b=(N, 3), zero_col=1,
                                  settings=dict(mean_residual=False)),
    "n_tridiag": dict(b=(N, 3), n_tridiag=2,
                      settings=dict(max_iter=60, rtol=1e-8)),
}


CG_ST = dict(max_iter=200, rtol=1e-10)


@functools.lru_cache(maxsize=None)
def jax_cg(case):
    """JAX's CG on ``spd()`` for a plain case, shared with the chunk route's
    test (the layout changes no value)."""
    return jax.jit(functools.partial(
        js.linear_cg, settings=js.LinearCGSettings(**CG_ST),
        diagnostics=True))(spd(), jnp.asarray(rhs(CG_CASES[case]["b"])))


@functools.lru_cache(maxsize=None)
def jax_lsmr_tall():
    return jax.jit(functools.partial(
        js.lsmr, settings=js.LSMRSettings(**TIGHT)))(
            tall(), jnp.asarray(rhs((TALL[0],))))


@pytest.mark.parametrize("case", list(CG_CASES))
def test_cg_matches_jax(enable_x64, case):
    c = CG_CASES[case]
    Aj = spd()
    A = to_port(Aj)
    b = rhs(c["b"])
    if "zero_col" in c:
        b[:, c["zero_col"]] = 0.0
    kw = dict(CG_ST, **c.get("settings", {}))
    jkw = dict(settings=js.LinearCGSettings(**kw), diagnostics=True,
               n_tridiag=c.get("n_tridiag", 0))
    pkw = dict(settings=ps.LinearCGSettings(**kw), diagnostics=True,
               n_tridiag=c.get("n_tridiag", 0))
    d = np.diag(np.asarray(Aj.todense()))
    if c.get("precond"):
        jkw["preconditioner"] = jacobi(jnp.asarray(d))
        pkw["preconditioner"] = jacobi(t(d))
    if c.get("x0"):
        x0 = rhs(c["b"], 7)
        jkw["x0"], pkw["x0"] = jnp.asarray(x0), t(x0)
    ref = jax_cg(case) if case in ("vector", "multi_rhs") else jax.jit(
        functools.partial(js.linear_cg, **jkw))(Aj, jnp.asarray(b))
    got = ps.linear_cg(A, t(b), **pkw)
    close(got[0], ref[0], F64)
    same_info(got[-1], ref[-1])
    if c.get("n_tridiag"):
        for g, r in zip(got[1][:2], ref[1][:2]):
            close(g, r, F64)
        assert int(got[1][2]) == int(ref[1][2])


MINRES_CASES = {
    "spd": dict(b=(N,)),
    "indefinite": dict(b=(N,), dense_shift=-2.5),
    "shifts": dict(b=(N, 3), shifts=[0.0, 0.5, 1.0]),
}


@pytest.mark.parametrize("case", list(MINRES_CASES))
def test_minres_matches_jax(enable_x64, case):
    c = MINRES_CASES[case]
    Aj = spd()
    A = to_port(Aj)
    if "dense_shift" in c:      # symmetric indefinite, as a dense matrix
        Aj = Aj.todense() + c["dense_shift"] * jnp.eye(N)
        A = t(Aj)
    b = rhs(c["b"])
    st = dict(max_iter=300, rtol=1e-10)
    jkw = dict(settings=js.MINRESSettings(**st), diagnostics=True)
    pkw = dict(settings=ps.MINRESSettings(**st), diagnostics=True)
    if "shifts" in c:
        jkw["shifts"] = jnp.asarray(c["shifts"])
        pkw["shifts"] = c["shifts"]
    ref = jax.jit(functools.partial(js.minres, **jkw))(Aj, jnp.asarray(b))
    got = ps.minres(A, t(b), **pkw)
    close(got[0], ref[0], F64)
    same_info(got[1], ref[1])


@pytest.mark.parametrize("case", ["nonsymmetric", "preconditioner",
                                  "multi_rhs"])
def test_bicgstab_matches_jax(enable_x64, case):
    Aj = square()
    A = to_port(Aj)
    b = rhs((SQUARE[0], 3) if case == "multi_rhs" else (SQUARE[0],))
    st = dict(max_iter=400, rtol=1e-10)
    jkw = dict(settings=js.BICGSTABSettings(**st), diagnostics=True)
    pkw = dict(settings=ps.BICGSTABSettings(**st), diagnostics=True)
    if case == "preconditioner":
        d = np.diag(np.asarray(Aj.todense()))
        jkw["preconditioner"] = jacobi(jnp.asarray(d))
        pkw["preconditioner"] = jacobi(t(d))
    ref = jax.jit(functools.partial(js.bicgstab, **jkw))(Aj, jnp.asarray(b))
    got = ps.bicgstab(A, t(b), **pkw)
    close(got[0], ref[0], F64)
    same_info(got[1], ref[1])


LSMR_CASES = {
    # square: the SPD matrix, which LSMR solves in fewer steps than its
    # N rows (on ``square()`` it takes more than its 24: past that point
    # the Golub-Kahan vectors lose orthogonality and rounding differences
    # between the packages grow to 1e-8)
    "square": dict(A=spd, b=(N,)),
    "tall": dict(A=tall, b=(TALL[0],)),
    "tall_multi_rhs": dict(A=tall, b=(TALL[0], 3)),
    "damped": dict(A=tall, b=(TALL[0],), settings=dict(max_iter=600,
                                                       damp=0.7)),
    "callable": dict(A=tall, b=(TALL[0],), closure=True),
}


@pytest.mark.parametrize("case", list(LSMR_CASES))
def test_lsmr_matches_jax(enable_x64, case):
    c = LSMR_CASES[case]
    Aj = c["A"]()
    A = to_port(Aj)
    b = rhs(c["b"])
    st = dict(TIGHT, **c.get("settings", {}))
    jkw = dict(settings=js.LSMRSettings(**st))
    pkw = dict(settings=ps.LSMRSettings(**st))
    if c.get("closure"):
        Ad, Ap = Aj.todense(), A.todense()
        ref = jax.jit(lambda b: js.lsmr(lambda v: Ad @ v, b,
                                        rmatvec=lambda v: Ad.T @ v,
                                        **jkw))(jnp.asarray(b))
        got = ps.lsmr(lambda v: Ap @ v, t(b), rmatvec=lambda v: Ap.T @ v,
                      **pkw)
    else:
        ref = jax_lsmr_tall() if case == "tall" else jax.jit(
            functools.partial(js.lsmr, **jkw))(Aj, jnp.asarray(b))
        got = ps.lsmr(A, t(b), **pkw)
    close(got[0], ref[0], F64)
    assert int(got[1]) == int(ref[1]) > 0


def test_lsmr_complex_dense_matches_jax(enable_x64):
    rng = np.random.default_rng(3)
    n, m = 40, 24
    Ar = rng.normal(size=(n, m)) + 1j * rng.normal(size=(n, m))
    b = rng.normal(size=n) + 1j * rng.normal(size=n)
    st = dict(TIGHT, damp=0.3)
    Aj = jnp.asarray(Ar)
    ref = jax.jit(lambda b: js.lsmr(Aj, b, rmatvec=lambda y: Aj.conj().T @ y,
                                    settings=js.LSMRSettings(**st)))(
        jnp.asarray(b))
    A = t(Ar)
    got = ps.lsmr(A, t(b), rmatvec=lambda y: A.conj().T @ y,
                  settings=ps.LSMRSettings(**st))
    close(got[0], ref[0], F64)
    assert int(got[1]) == int(ref[1])
    # the port's default adjoint of a complex dense matrix is Aᴴ
    again = ps.lsmr(A, t(b), settings=ps.LSMRSettings(**st))
    assert torch.equal(again[0], got[0])


def test_lsmr_callable_requires_rmatvec():
    with pytest.raises(ValueError, match="transpose closure") as port:
        ps.lsmr(lambda v: v, torch.ones(4))
    with pytest.raises(ValueError, match="transpose closure") as ref:
        js.lsmr(lambda v: v, jnp.ones(4))
    assert str(port.value) == str(ref.value)


# --------------------------------------------------------------------------
# routes: DIA and the chunk engine's plain versions
# --------------------------------------------------------------------------

@pytest.fixture
def plain_calls(monkeypatch):
    """Count the chunk and DIA kernels' plain versions called by their
    wrappers."""
    calls = {}
    for mod, name in ((cs, "chunk_spmv_plain"), (cs, "chunk_spmm_plain"),
                      (dia, "spmm_core_plain")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.fixture
def chunk_route(monkeypatch):
    route = pspmm._chunk_plan
    monkeypatch.setattr(pspmm, "_chunk_plan",
                        lambda A, backend: route(A, "pallas"))


@pytest.mark.parametrize("solver", ["cg", "minres", "lsmr"])
def test_dia_route_matches_jax(enable_x64, plain_calls, solver):
    Aj = stencil()
    A = to_port(Aj)
    assert pspmm._dia_plan(A, "auto") is not None
    b = rhs((64, 2))
    if solver == "lsmr":
        ref = jax.jit(functools.partial(
            js.lsmr, settings=js.LSMRSettings(**TIGHT)))(Aj, jnp.asarray(b))
        got = ps.lsmr(A, t(b), settings=ps.LSMRSettings(**TIGHT))
        assert int(got[1]) == int(ref[1])
    else:
        jf, pf = ((js.linear_cg, ps.linear_cg) if solver == "cg"
                  else (js.minres, ps.minres))
        st = dict(max_iter=200, rtol=1e-10)
        jset = (js.LinearCGSettings if solver == "cg" else
                js.MINRESSettings)(**st)
        pset = (ps.LinearCGSettings if solver == "cg" else
                ps.MINRESSettings)(**st)
        ref = jax.jit(functools.partial(jf, settings=jset, diagnostics=True))(
            Aj, jnp.asarray(b))
        got = pf(A, t(b), settings=pset, diagnostics=True)
        same_info(got[1], ref[1])
    close(got[0], ref[0], F64)
    assert plain_calls["spmm_core_plain"] > 0


@pytest.mark.parametrize("case", ["cg_vector", "cg_multi_rhs", "lsmr_tall"])
def test_chunk_route_matches_jax(enable_x64, chunk_route, plain_calls, case):
    if case == "lsmr_tall":
        ref = jax_lsmr_tall()
        got = ps.lsmr(to_port(tall("csr")), t(rhs((TALL[0],))),
                      settings=ps.LSMRSettings(**TIGHT))
        assert int(got[1]) == int(ref[1])
    else:
        which = "vector" if case == "cg_vector" else "multi_rhs"
        ref = jax_cg(which)
        got = ps.linear_cg(to_port(spd("csr")), t(rhs(CG_CASES[which]["b"])),
                           settings=ps.LinearCGSettings(**CG_ST),
                           diagnostics=True)
        same_info(got[1], ref[1])
    close(got[0], ref[0], F64)
    which = "chunk_spmm_plain" if case == "cg_multi_rhs" else \
        "chunk_spmv_plain"
    assert plain_calls.get(which, 0) > 0


# --------------------------------------------------------------------------
# the device-side loop: results independent of CHECK_EVERY
# --------------------------------------------------------------------------

def _all_solves(A, Ar):
    """Each solver once (float32), with everything it returns."""
    b = torch.from_numpy(rhs((N, 3))).float()
    br = torch.from_numpy(rhs((40, 2))).float()
    st = dict(max_iter=40)
    return {
        "cg": ps.linear_cg(A, b, n_tridiag=2, diagnostics=True,
                           settings=ps.LinearCGSettings(rtol=1e-6, **st)),
        "minres": ps.minres(A, b, shifts=[0.0, 0.3], diagnostics=True,
                            settings=ps.MINRESSettings(rtol=1e-6, **st)),
        "bicgstab": ps.bicgstab(A, b, diagnostics=True,
                                settings=ps.BICGSTABSettings(rtol=1e-6,
                                                             **st)),
        "lsmr": ps.lsmr(Ar, br, settings=ps.LSMRSettings(**st)),
        "cg_capped": ps.linear_cg(A, b, diagnostics=True,
                                  settings=ps.LinearCGSettings(
                                      rtol=1e-30, max_iter=13)),
    }


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _flat(o)]


def test_results_do_not_depend_on_check_every(monkeypatch):
    A = make_spd_sparse(N, N + 4 * N, layout="csr", device="cpu")
    Ar = rand_sparse((40, 24), 200, layout="csr", device="cpu")
    runs, reads = [], []
    for every in (1, 3, 8):
        monkeypatch.setattr(common, "CHECK_EVERY", every)
        runs.append(_all_solves(A, Ar))
        # host reads of one CG solve: the loop's, and one for the warning
        with pytest.warns(UserWarning, match="did not converge"):
            before = common.host_read.reads
            x, info = ps.linear_cg(A, torch.ones(N), diagnostics=True,
                                   settings=ps.LinearCGSettings(
                                       rtol=1e-30, max_iter=21))
            capped = common.host_read.reads - before
        before = common.host_read.reads
        steps = common.while_loop.steps
        x, info = ps.linear_cg(A, torch.ones(N), diagnostics=True)
        it = int(info.iterations)
        reads.append((every, common.host_read.reads - before, it, capped,
                       common.while_loop.steps - steps))
    for got in runs[1:]:
        for name in runs[0]:
            for a, b in zip(_flat(runs[0][name]), _flat(got[name])):
                assert torch.equal(a, b), name
    for every, n_reads, it, capped, steps in reads:
        assert 0 < it < 1000
        # the loop's reads, and one for the warning
        assert n_reads == max(1, math.ceil(it / every)) + 1
        assert capped == math.ceil(21 / every) - 1 + 1
        # the steps run past convergence before the read that saw it
        assert steps == math.ceil(it / every) * every
    # cg_capped ran to its max_iter; the others converged before theirs
    assert int(runs[0]["cg_capped"][1].iterations) == 13


# --------------------------------------------------------------------------
# float32 against a dense solve, at the JAX tests' own tolerances
# --------------------------------------------------------------------------

def test_float32_solvers_match_dense_solve():
    A = make_spd_sparse(24, 24 + 2 * 48, device="cpu")
    Ad = A.todense()
    b = torch.from_numpy(rhs((24,))).float()
    ref = torch.linalg.solve(Ad, b)
    x = ps.linear_cg(A, b, settings=ps.LinearCGSettings(max_iter=200,
                                                        rtol=1e-6))
    torch.testing.assert_close(x, ref, rtol=1e-3, atol=1e-4)
    x = ps.minres(A, b, settings=ps.MINRESSettings(max_iter=300, rtol=1e-7))
    torch.testing.assert_close(x, ref, rtol=1e-3, atol=1e-3)
    W = rand_sparse((24, 24), 96, well_conditioned=True, device="cpu")
    x = ps.bicgstab(W, b, settings=ps.BICGSTABSettings(max_iter=400,
                                                       rtol=1e-7))
    torch.testing.assert_close(x, torch.linalg.solve(W.todense(), b),
                               rtol=1e-2, atol=1e-3)
    T = rand_sparse((30, 10), 80, device="cpu")
    bt = torch.from_numpy(rhs((30,))).float()
    x, _ = ps.lsmr(T, bt, settings=ps.LSMRSettings(max_iter=100))
    torch.testing.assert_close(
        x, torch.linalg.lstsq(T.todense(), bt[:, None]).solution[:, 0],
        rtol=1e-2, atol=1e-3)


def test_zero_rhs_and_shapes():
    A = make_spd_sparse(12, 12 + 2 * 10, device="cpu")
    x, itn = ps.lsmr(rand_sparse((12, 6), 20, device="cpu"), torch.zeros(12))
    assert torch.equal(x, torch.zeros(6)) and int(itn) == 0
    x = ps.linear_cg(A, torch.zeros(12))
    assert torch.equal(x, torch.zeros(12))
    x = ps.minres(A, torch.ones(12, 2), shifts=[0.0, 1.0, 2.0])
    assert x.shape == (3, 12, 2)
    with pytest.raises(ValueError, match="n_tridiag=3 exceeds"):
        ps.linear_cg(A, torch.ones(12, 2), n_tridiag=3)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        ps.minres(A, torch.ones(12, 2, 2))


@pytest.mark.parametrize("solver", ["linear_cg", "minres", "bicgstab"])
def test_nonconvergence_warns(solver):
    A = make_spd_sparse(24, 24 + 2 * 48, device="cpu")
    settings = getattr(ps, {"linear_cg": "LinearCGSettings",
                            "minres": "MINRESSettings",
                            "bicgstab": "BICGSTABSettings"}[solver])(
        max_iter=2, rtol=1e-12, min_iter=1)
    with pytest.warns(UserWarning, match=f"{solver}: did not converge "
                                         "after 2 iterations"):
        getattr(ps, solver)(A, torch.ones(24), settings=settings)


def test_verbose_prints_each_iteration(capfd):
    A = make_spd_sparse(24, 24 + 2 * 48, device="cpu")
    b = torch.ones(24)
    x = ps.linear_cg(A, b, settings=ps.LinearCGSettings(
        max_iter=12, verbose=True))
    quiet = ps.linear_cg(A, b, settings=ps.LinearCGSettings(max_iter=12))
    assert torch.equal(x, quiet)
    out = capfd.readouterr().out
    assert "linear_cg iter 1: mean residual" in out
    ps.minres(A, b, settings=ps.MINRESSettings(max_iter=3, verbose=True))
    ps.bicgstab(A, b, settings=ps.BICGSTABSettings(max_iter=3, verbose=True))
    out = capfd.readouterr().out
    assert "minres iter 3: max |phibar|" in out
    assert "bicgstab iter 1: max residual" in out


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

def _spd_rules(A):
    D = A.todense().double()
    assert torch.equal(D, D.T)
    off = D - torch.diag(torch.diag(D))
    torch.testing.assert_close(torch.diag(D), 1 + off.abs().sum(1))
    r = A.rows().astype(np.int64) * A.shape[1] + A.cols()
    assert (np.diff(r) > 0).all()                           # row-major


@pytest.mark.parametrize("n,offsets,nnz", [(64, [1, 8], None),
                                            (60, [-3, 1, 7, 20], 150)])
def test_make_spd_stencil_pattern_matches_jax(enable_x64, n, offsets, nnz):
    Aj = stencil() if nnz is None else jrs.make_spd_stencil(
        KEY, n, offsets, nnz=nnz)
    A = make_spd_stencil(n, offsets, nnz=nnz, device="cpu")
    np.testing.assert_array_equal(A.indptr_np(), Aj.indptr_np())
    np.testing.assert_array_equal(A.cols(), Aj.cols_np())
    _spd_rules(A)
    _spd_rules(to_port(Aj))


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_make_spd_sparse_rules(enable_x64, layout):
    A = make_spd_sparse(50, 50 + 2 * 80, layout=layout, device="cpu",
                        dtype=torch.float64)
    assert A.layout == layout and A.nnz == 210
    _spd_rules(A)
    _spd_rules(to_port(spd(layout)))
    with pytest.raises(ValueError, match="nnz >= n"):
        make_spd_sparse(10, 9, device="cpu")
    with pytest.raises(ValueError, match="must be even"):
        make_spd_sparse(10, 13, device="cpu")


# --------------------------------------------------------------------------
# a right-hand side of width 0, and a float64 A with a float32 B
# --------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["linear_cg", "minres", "bicgstab",
                                    "lsmr"])
def test_width_zero_rhs_matches_jax(enable_x64, solver):
    Aj = spd()
    ref = getattr(js, solver)(Aj, jnp.zeros((N, 0)))
    got = getattr(ps, solver)(to_port(Aj), torch.zeros((N, 0),
                                                      dtype=torch.float64))
    if solver == "lsmr":
        (got, itn), (ref, ritn) = got, ref
        assert int(itn) == int(ritn)
    assert tuple(got.shape) == ref.shape == (N, 0)
    assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("solver", ["linear_cg", "minres", "bicgstab",
                                    "lsmr"])
def test_dtype_mismatch_raises_jax_message(enable_x64, monkeypatch, route,
                                           solver):
    if route == "chunk":
        chunk = pspmm._chunk_plan
        monkeypatch.setattr(pspmm, "_chunk_plan",
                            lambda A, backend: chunk(A, "pallas"))
    A = to_port(route_case(route))
    msg = jax_mismatch_message(getattr(js, solver))
    assert msg == "sparse_mm: dtype mismatch, A is float64 and B is float32"
    steps = common.while_loop.steps
    with pytest.raises(ValueError, match=f"^{re.escape(msg)}$"):
        getattr(ps, solver)(A, torch.ones((A.shape[0], 2),
                                          dtype=torch.float32))
    assert common.while_loop.steps == steps     # raised before the loop
