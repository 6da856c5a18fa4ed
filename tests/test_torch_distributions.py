"""PyTorch port: ``models/distributions.py`` and ``utils/dist_stats.py``
held against the JAX package.

One numpy draw from a fixed seed gives each case its factor (a random
lower triangle of N = 12 in COO or CSR, or a strictly lower pairwise
encoder pattern, banded, which takes the DIA solve and SpMM), ``loc``,
``diagonal``, ε, the values scored by ``log_prob`` and the cotangents;
both packages get the same arrays (the port's through
``convert.from_arrays``).  For each of the four parameterisations the
centred samples ``loc + _transform_eps(ε)``, ``log_prob`` and the
gradients of both for ``loc``, ``diagonal`` and the factor's values are
held within ``rtol=1e-5, atol=1e-6`` of JAX's (float32 both), except
``log_prob`` and its gradients, held within ``rtol=1e-4, atol=1e-5``: a
sum of N squared terms and a log-determinant in float32, where JAX's own
``tests/test_distributions.py`` loosens ``log_prob`` to 1e-3.  Each JAX
reference is one jitted function, cached.

The statistical check draws 4,000 samples of the port's ``rsample``
from a seeded ``torch.Generator`` and requires both the Hotelling T²
test of the mean and the Nagao test of the covariance to accept at
confidence 0.999 (a p-value threshold of 0.001).

The JAX DIA value relayouts take their XLA branch
(``kernels/dia.py:_use_pallas_grid``) in place of the Pallas gather in
interpret mode, as ``tests/test_torch_lse.py`` does: the same function,
compiled in about a second in place of ten.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.kernels import dia as jdia
from torchsparsegradutils_tpu.models import distributions as jd
from torchsparsegradutils_tpu.utils import dist_stats as jstats
from torchsparsegradutils_tpu_torch import from_arrays
from torchsparsegradutils_tpu_torch.kernels import dia
from torchsparsegradutils_tpu_torch.models import distributions as pd
from torchsparsegradutils_tpu_torch.models import (
    PairwiseEncoder, SparseMultivariateNormal,
    SparseMultivariateNormalNative)
from torchsparsegradutils_tpu_torch.utils import (cov_nagao_test,
                                                  mean_hotelling_t2_test,
                                                  sample_mean_cov)

REPO = Path(__file__).resolve().parents[1]
N = 12
S = 5                      # samples per case
NS_STAT = 4000             # samples of the statistical check
LEVEL = 0.999              # its confidence level
TOL = dict(rtol=1e-5, atol=1e-6)
LP_TOL = dict(rtol=1e-4, atol=1e-5)
KINDS = ["coo", "csr", "encoder"]
FORMS = [(True, False), (True, True), (False, False), (False, True)]
FORM_IDS = ["cov-LLt", "cov-LDLt", "prec-LLt", "prec-LDLt"]
ENC_VOLUME = (1, 3, 4, 4)  # the flagship encoder's offsets on a small volume


@pytest.fixture(autouse=True, scope="module")
def jax_grid_on_xla():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdia, "_use_pallas_grid", lambda dtype: False)
        yield


def _pattern(kind, strict, rng, batch=()):
    """Row-major (rows, cols) of a lower triangle, and its size."""
    if kind == "encoder":
        enc = PairwiseEncoder(1.5, ENC_VOLUME, diag=not strict,
                              upper=False, layout="coo")
        L = enc(torch.ones((len(enc.offsets),) + ENC_VOLUME))
        return L.rows().astype(np.int64), L.cols().astype(np.int64), \
            L.shape[-1]
    r, c = np.tril_indices(N, -1)
    keep = np.sort(rng.choice(len(r), 14, replace=False))
    r, c = r[keep], c[keep]
    if not strict:
        r = np.concatenate([r, np.arange(N)])
        c = np.concatenate([c, np.arange(N)])
    order = np.lexsort((c, r))
    return r[order], c[order], N


def _factor_values(rows, cols, n, rng, batch=()):
    """Off-diagonal N(0, 0.5²) clipped to [-2, 2]; a stored diagonal is
    1 + its row's off-diagonal magnitudes (well conditioned)."""
    v = np.clip(0.5 * rng.standard_normal(batch + (len(rows),)), -2, 2)
    on = rows == cols
    v[..., on] = 0.0
    row_abs = np.zeros(batch + (n,))
    for idx in np.ndindex(*batch):
        np.add.at(row_abs[idx], rows, np.abs(v[idx]))
    v[..., on] = 1.0 + row_abs[..., rows[on]]
    return v.astype(np.float32)


def _containers(kind, rows, cols, vals, n):
    """The JAX and port containers of one numpy factor."""
    shape = vals.shape[:-1] + (n, n)
    coo = tj.SparseCOO(rows, cols, jnp.asarray(vals), shape)
    Lj = coo.tocsr() if kind == "csr" else coo
    if kind == "csr":
        L = from_arrays("csr", Lj.indptr_np(), Lj.cols_np(),
                        np.asarray(Lj.data), shape, device="cpu")
    else:
        L = from_arrays("coo", rows, cols, vals, shape, device="cpu")
    return Lj, L


@functools.lru_cache(maxsize=None)
def case(kind, cov, ldlt, batch=(), loc_batch=None):
    """numpy inputs of one case: the factor, loc, diagonal, ε, the scored
    values and the two cotangents."""
    rng = np.random.default_rng(16)
    rows, cols, n = _pattern(kind, ldlt, rng)
    lb = batch or ((loc_batch,) if loc_batch else ())
    c = dict(rows=rows, cols=cols, n=n,
             vals=_factor_values(rows, cols, n, rng, batch),
             loc=rng.standard_normal(lb + (n,)).astype(np.float32),
             diag=np.exp(0.3 * rng.standard_normal(lb + (n,))).astype(
                 np.float32),
             eps=rng.standard_normal((S,) + lb + (n,)).astype(np.float32),
             W=rng.standard_normal((S,) + lb + (n,)).astype(np.float32),
             w_lp=rng.standard_normal((S,) + lb).astype(np.float32))
    c["value"] = (c["loc"] + rng.standard_normal((S,) + lb + (n,))).astype(
        np.float32)
    return c


def _dist(mod, L, loc, diag, cov, ldlt):
    kw = {"scale_tril" if cov else "precision_tril": L}
    cls = mod.SparseMultivariateNormal
    return cls(loc, diag if ldlt else None, **kw)


@functools.lru_cache(maxsize=None)
def jax_ref(kind, cov, ldlt, batch=(), loc_batch=None):
    """JAX's samples, log densities and the gradients of
    ``sum(W · samples)`` and ``sum(w_lp · log_prob)`` for (values, loc,
    diagonal), one jitted function."""
    c = case(kind, cov, ldlt, batch, loc_batch)
    Lj, _ = _containers(kind, c["rows"], c["cols"], c["vals"], c["n"])
    perm = None
    if kind == "csr":               # CSR order of the numpy values
        perm = np.lexsort((c["cols"], c["rows"]))

    def f(vals, loc, diag):
        d = _dist(jd, Lj.with_data(vals), loc, diag, cov, ldlt)
        x = loc + d._transform_eps(jnp.asarray(c["eps"]))
        return x, d.log_prob(jnp.asarray(c["value"]))

    def both(vals, loc, diag):
        x, lp = f(vals, loc, diag)
        gx = jax.grad(lambda *a: (f(*a)[0] * c["W"]).sum(),
                      argnums=(0, 1, 2))(vals, loc, diag)
        glp = jax.grad(lambda *a: (f(*a)[1] * c["w_lp"]).sum(),
                       argnums=(0, 1, 2))(vals, loc, diag)
        return x, lp, gx, glp

    vals = c["vals"] if perm is None else c["vals"][..., perm]
    out = jax.jit(both)(jnp.asarray(vals), jnp.asarray(c["loc"]),
                        jnp.asarray(c["diag"]))
    return jax.tree_util.tree_map(np.asarray, out)


def port_run(kind, cov, ldlt, batch=(), loc_batch=None):
    """The port's counterpart of :func:`jax_ref`."""
    c = case(kind, cov, ldlt, batch, loc_batch)
    _, L = _containers(kind, c["rows"], c["cols"], c["vals"], c["n"])
    t = {k: torch.from_numpy(c[k]) for k in ("loc", "diag", "eps", "value",
                                             "W", "w_lp")}

    def leaves():
        return [L.values.detach().clone().requires_grad_(True),
                t["loc"].clone().requires_grad_(True),
                t["diag"].clone().requires_grad_(True)]

    lx = leaves()
    d = _dist(pd,
              L.with_data(lx[0]), lx[1], lx[2], cov, ldlt)
    x = lx[1] + d._transform_eps(t["eps"])
    gx = torch.autograd.grad((x * t["W"]).sum(), lx, allow_unused=True)
    ll = leaves()
    d = _dist(pd,
              L.with_data(ll[0]), ll[1], ll[2], cov, ldlt)
    lp = d.log_prob(t["value"])
    glp = torch.autograd.grad((lp * t["w_lp"]).sum(), ll, allow_unused=True)
    return x, lp, gx, glp


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    got = np.zeros_like(ref) if got is None else got.detach().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, err_msg=what, **tol)


def _check(kind, cov, ldlt, what, batch=(), loc_batch=None):
    got = port_run(kind, cov, ldlt, batch, loc_batch)
    ref = jax_ref(kind, cov, ldlt, batch, loc_batch)
    if what == "samples":
        _close(got[0], ref[0], TOL, "samples")
        pairs, tol = zip(got[2], ref[2]), TOL
    else:
        _close(got[1], ref[1], LP_TOL, "log_prob")
        pairs, tol = zip(got[3], ref[3]), LP_TOL
    for name, (g, r) in zip(("values", "loc", "diagonal"), pairs):
        if name == "diagonal" and not ldlt:
            continue
        _close(g, r, tol, f"{what} grad {name}")


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_samples_and_gradients_match_jax(kind, form):
    _check(kind, *form, "samples")


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_log_prob_and_gradients_match_jax(kind, form):
    _check(kind, *form, "log_prob")


@pytest.mark.parametrize("form", [(True, False), (False, True)],
                         ids=["cov-LLt", "prec-LDLt"])
@pytest.mark.parametrize("kind", ["coo", "encoder"])
def test_batched_factor_matches_jax(kind, form):
    """A (3, n, n) factor over one shared pattern: the per-batch loops
    build its plan once."""
    before = dia.build_dia_plan.cache_info().misses
    _check(kind, *form, "samples", batch=(3,))
    _check(kind, *form, "log_prob", batch=(3,))
    built = dia.build_dia_plan.cache_info().misses - before
    # the factor's plan and, for log_prob, that of its transpose
    assert built <= 2


def test_rank_dispatch_2d_factor_batched_loc():
    """A 2-D factor with a (5, n) loc: samples (S, 5, n), log_prob (S, 5)."""
    _check("csr", True, False, "samples", loc_batch=5)
    _check("csr", True, False, "log_prob", loc_batch=5)
    c = case("csr", True, False, (), 5)
    _, L = _containers("csr", c["rows"], c["cols"], c["vals"], N)
    d = SparseMultivariateNormal(torch.from_numpy(c["loc"]), scale_tril=L)
    s = d.rsample((7,), generator=torch.Generator().manual_seed(0))
    assert s.shape == (7, 5, N) and d.log_prob(s).shape == (7, 5)
    assert d.batch_shape == (5,) and d.event_shape == (N,)
    assert d.sample().shape == (5, N) and not d.sample().requires_grad


def _messages(fn_jax, fn_port):
    """The two packages raise the same error type and message."""
    with pytest.raises(Exception) as ej:
        fn_jax()
    with pytest.raises(Exception) as ep:
        fn_port()
    assert type(ep.value) is type(ej.value)
    assert str(ep.value) == str(ej.value)


def test_validation_matches_jax():
    c = case("coo", True, False)
    Lj, L = _containers("coo", c["rows"], c["cols"], c["vals"], N)
    cs = case("coo", True, True)
    Sj, Sp = _containers("coo", cs["rows"], cs["cols"], cs["vals"], N)
    Uj, U = _containers("coo", c["cols"], c["rows"], c["vals"], N)
    z, zt = jnp.zeros(N), torch.zeros(N)
    cases = [
        (lambda: jd.SparseMultivariateNormal(z),
         lambda: SparseMultivariateNormal(zt)),
        (lambda: jd.SparseMultivariateNormal(z, scale_tril=Lj,
                                             precision_tril=Lj),
         lambda: SparseMultivariateNormal(zt, scale_tril=L,
                                          precision_tril=L)),
        (lambda: jd.SparseMultivariateNormal(z, jnp.ones(N), scale_tril=Lj),
         lambda: SparseMultivariateNormal(zt, torch.ones(N), scale_tril=L)),
        (lambda: jd.SparseMultivariateNormal(z, scale_tril=Uj),
         lambda: SparseMultivariateNormal(zt, scale_tril=U)),
        (lambda: jd.SparseMultivariateNormal(jnp.zeros(N + 1),
                                             scale_tril=Lj),
         lambda: SparseMultivariateNormal(torch.zeros(N + 1), scale_tril=L)),
        (lambda: jd.SparseMultivariateNormal(z, jnp.ones(N + 2),
                                             precision_tril=Sj),
         lambda: SparseMultivariateNormal(zt, torch.ones(N + 2),
                                          precision_tril=Sp)),
        (lambda: jd.SparseMultivariateNormal(z, precision_tril=Sj).log_prob(
            jnp.zeros(N)),
         lambda: SparseMultivariateNormal(zt, precision_tril=Sp).log_prob(
            torch.zeros(N))),
        (lambda: jd.SparseMultivariateNormalNative(z, Lj.todense()),
         lambda: SparseMultivariateNormalNative(zt, L.todense())),
    ]
    for fj, fp in cases:
        _messages(fj, fp)
    with pytest.raises(TypeError, match="SparseCOO or SparseCSR"):
        SparseMultivariateNormal(zt, scale_tril=L.todense())


@pytest.mark.parametrize("kind", ["coo", "csr"])
def test_native_variant_matches_jax(kind):
    c = case(kind, True, False)
    Lj, L = _containers(kind, c["rows"], c["cols"], c["vals"], N)
    dj = jd.SparseMultivariateNormalNative(jnp.asarray(c["loc"]), Lj)
    dp = SparseMultivariateNormalNative(torch.from_numpy(c["loc"]), L)
    for name in ("covariance_matrix", "variance"):
        with pytest.warns(UserWarning, match=f"{name} densifies"):
            got = getattr(dp, name)()
        _close(got, getattr(dj, name)(), TOL, name)
    with pytest.warns(UserWarning, match="log_prob densifies"):
        got = dp.log_prob(torch.from_numpy(c["value"]))
    _close(got, dj.log_prob(jnp.asarray(c["value"])), LP_TOL, "log_prob")
    s = dp.rsample((3, 2), generator=torch.Generator().manual_seed(0))
    assert s.shape == (3, 2, N)
    batched = from_arrays("coo", c["rows"], c["cols"], c["vals"][None],
                          (1, N, N), device="cpu")
    with pytest.raises(ValueError, match="unbatched"):
        SparseMultivariateNormalNative(torch.zeros(N), batched)


def test_dist_stats_match_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((4, 4))
    cov = A @ A.T + 4 * np.eye(4)
    x = rng.multivariate_normal(np.zeros(4), cov, size=(300, 2))
    for got, ref in zip(sample_mean_cov(torch.from_numpy(x)),
                        jstats.sample_mean_cov(jnp.asarray(x))):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mean, emp = (np.asarray(a) for a in jstats.sample_mean_cov(x))
    for batched in (False, True):
        sl = slice(None) if batched else 0
        mj = jstats.mean_hotelling_t2_test(mean[sl], np.zeros(4)[None][sl]
                                           if batched else np.zeros(4),
                                           emp[sl], 300, 0.99)
        mp = mean_hotelling_t2_test(torch.from_numpy(mean[sl]),
                                    torch.zeros(4) if not batched else
                                    torch.zeros(1, 4),
                                    torch.from_numpy(emp[sl]), 300, 0.99)
        cj = jstats.cov_nagao_test(emp[sl], np.broadcast_to(cov, emp[sl]
                                                            .shape), 300,
                                   0.99)
        cp = cov_nagao_test(torch.from_numpy(emp[sl]), torch.from_numpy(
            np.broadcast_to(cov, emp[sl].shape).copy()), 300, 0.99)
        for got, ref in ((mp, mj), (cp, cj)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                       **TOL)
            assert got[2] == ref[2]
    with pytest.raises(ValueError, match="n > p"):
        mean_hotelling_t2_test(torch.zeros(4), torch.zeros(4),
                               torch.eye(4), 4)
    with pytest.raises(ValueError, match="expected 1-D or 2-D"):
        mean_hotelling_t2_test(torch.zeros(1, 1, 4), torch.zeros(4),
                               torch.eye(4), 40)


def _ref_cov(kind, cov, ldlt):
    c = case(kind, cov, ldlt)
    n = c["n"]
    Ld = np.zeros((n, n))
    np.add.at(Ld, (c["rows"], c["cols"]), c["vals"].astype(np.float64))
    M = ((Ld + np.eye(n)) @ np.diag(c["diag"].astype(np.float64))
         @ (Ld + np.eye(n)).T) if ldlt else Ld @ Ld.T
    return M if cov else np.linalg.inv(M)


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_rsample_statistics(form):
    """4,000 samples of the port's rsample pass both confidence-region
    tests at 0.999 against the covariance rebuilt densely."""
    cov, ldlt = form
    c = case("csr", cov, ldlt)
    _, L = _containers("csr", c["rows"], c["cols"], c["vals"], N)
    d = _dist(pd, L,
              torch.from_numpy(c["loc"]), torch.from_numpy(c["diag"]), cov,
              ldlt)
    s = d.rsample((NS_STAT,), generator=torch.Generator().manual_seed(4))
    assert s.shape == (NS_STAT, N)
    mean, emp = sample_mean_cov(s)
    ok, t2, thr = mean_hotelling_t2_test(mean, d.loc, emp, NS_STAT, LEVEL)
    assert bool(ok), f"T2={float(t2):.2f} > {thr:.2f}"
    ok, tn, thr = cov_nagao_test(emp, torch.from_numpy(_ref_cov("csr", cov,
                                                                ldlt)),
                                 NS_STAT, LEVEL)
    assert bool(ok), f"T_N={float(tn):.2f} > {thr:.2f}"


def test_port_sources_import_no_jax():
    """No module of the port, the new ones included, imports JAX or the
    JAX package (a scan of every import statement)."""
    bad = []
    for path in sorted((REPO / "torchsparsegradutils_tpu_torch").rglob(
            "*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{path.name}: {m}" for m in names
                    if m.split(".")[0] in ("jax", "jaxlib",
                                           "torchsparsegradutils_tpu")]
    assert bad == []
    assert (REPO / "torchsparsegradutils_tpu_torch" / "models" /
            "distributions.py").exists()
