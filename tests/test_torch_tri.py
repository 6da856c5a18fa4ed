"""PyTorch port: the triangular solve held against the JAX package's.

The banded core's plain version is compared with the JAX Pallas kernel
``tri_dia_core``, run in interpret mode on the CPU as
``tests/test_dia.py`` runs it; the host plans (``_TriPlan``,
``_WavePlan``, ``tri_levels``) field by field with the JAX planners; the
public ``sparse_triangular_solve`` with the JAX public op for every
algorithm, layout and flag, and which algorithm ``auto`` picks.  Matrices
come from numpy with fixed seeds or from the port's generators, and are
carried to JAX with ``to_arrays``; on the CPU the port's kernel wrappers
run their plain versions.

Tolerances:

* float32 outputs ``rtol=1e-4, atol=1e-5``: the JAX DIA tests use
  2e-4/2e-5 against a dense solve (``tests/test_dia.py:301``), and a block
  inverse rounds differently from substitution;
* float32 gradients ``rtol=1e-3, atol=1e-4`` (``tests/test_dia.py:317``);
* bfloat16 ``2e-2``;
* float64 ``1e-10`` against the JAX block or wave route: in float64 the
  JAX package never takes its banded kernel, the port's ``dia`` runs in
  float64, and every route is an exact solve up to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.kernels import dia_tri as jdt
from torchsparsegradutils_tpu.native import tri_levels as jax_tri_levels
from torchsparsegradutils_tpu.ops import triangular_solve as jts
from torchsparsegradutils_tpu.types import StaticArray as JStatic
from torchsparsegradutils_tpu_torch import (SparseCOO, sparse_triangular_solve,
                                            to_arrays)
from torchsparsegradutils_tpu_torch.kernels import dia_tri
from torchsparsegradutils_tpu_torch.ops import triangular_solve as ts
from torchsparsegradutils_tpu_torch.types import StaticArray
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    rand_sparse, rand_sparse_tri, stencil_sparse)

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD32 = dict(rtol=1e-3, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
F64 = dict(rtol=1e-10, atol=1e-10)
ALGORITHMS = ["auto", "dia", "block", "wave", "dense"]


def jax_of(A):
    """The JAX container holding the same arrays as port container A."""
    lay, i0, i1, data, shape = to_arrays(A)
    return (tj.SparseCOO if lay == "coo" else tj.SparseCSR)(i0, i1, data,
                                                             shape)


def rhs(n, p, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, p)).astype(dtype)


def banded(n, upper, unit=False, layout="csr", dtype=torch.float32):
    """A banded triangle on offsets {0, 3, 17, 130} or their negatives,
    as ``tests/test_dia.py``'s flag test builds it."""
    offs = [0, 3, 17, 130] if upper else [-130, -17, -3, 0]
    if unit:
        offs = [o for o in offs if o != 0]
    A = stencil_sparse((n, n), offs, well_conditioned=not unit,
                       layout=layout, dtype=dtype,
                       generator=torch.Generator().manual_seed(n + upper),
                       device="cpu")
    # damp a unit triangle's off-diagonals so the solution does not grow
    return A.with_data(A.values * 0.15) if unit else A


def factor(n, upper, layout="csr", dtype=torch.float32, seed=1):
    """A random triangular factor with about 4 entries per row."""
    return rand_sparse_tri((n, n), 4 * n, upper=upper, layout=layout,
                           dtype=dtype, seed=seed, device="cpu")


def assert_close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got.detach().double()),
                               np.asarray(ref, np.float64), **tol)


@pytest.fixture
def routes(monkeypatch):
    """The port's solve routes, recorded."""
    seen = {"port": []}

    def spy(module, name, who, label):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            seen[who].append(label)
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    spy(ts, "tri_dia_core", "port", "dia")
    spy(ts, "_blocked_tri_solve", "port", "block")
    spy(ts, "_wave_tri_solve", "port", "wave")
    return seen


# --------------------------------------------------------------------------
# the banded core against the JAX Pallas kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_dia_core_plain_matches_jax_kernel(monkeypatch, upper, unit,
                                           transpose):
    """Every flag reduces to the lower core: its inputs, as the port's
    reduction makes them, go to the JAX kernel too; the whole solve is
    held against a dense float64 solve."""
    n = 500
    A = banded(n, upper, unit)
    B = torch.from_numpy(rhs(n, 3, 9))
    calls = []
    real = dia_tri.tri_dia_core

    def spy(offsets, grid, B, *, unit):
        calls.append((np.asarray(offsets), grid, B))
        return real(offsets, grid, B, unit=unit)
    monkeypatch.setattr(ts, "tri_dia_core", spy)
    x = sparse_triangular_solve(A, B, upper=upper, unitriangular=unit,
                                transpose=transpose, algorithm="dia")
    (offsets, grid, Bc), = calls
    assert offsets.tolist() == [o for o in [-130, -17, -3, 0]
                                if o or not unit]
    ref = jdt.tri_dia_core(offsets, jnp.asarray(grid.numpy()),
                           jnp.asarray(Bc.numpy()), unit=unit)
    assert_close(dia_tri.tri_dia_core_plain(offsets, grid, Bc, unit=unit),
                 ref, F32)
    dense = A.todense().double()
    if unit:
        dense += torch.eye(n, dtype=torch.float64)
    M = dense.T if transpose else dense
    assert_close(x, torch.linalg.solve(M, B.double()), dict(rtol=2e-4,
                                                            atol=2e-5))


_AWKWARD = [(300, [-130, -17, -3, 0], 1),   # n not a multiple of 256, p = 1
            (500, [-256, -1, 0, 5], 3)]    # span at a block boundary, an upper


NB = dia_tri.KERNEL_NB   # the CUDA walk's row block
TP = 2                   # and its column tile (csrc/tri_dia.cu TP)


@pytest.mark.parametrize("n,offsets,p,nb", [
    *(pytest.param(*case, None, id=f"{case[0]}-offsets{i}-{case[2]}")
      for i, case in enumerate(_AWKWARD)),
    # the plain version at the CUDA walk's row block, as the card holds
    # the kernel against it
    *(pytest.param(*case, NB, id=f"{case[0]}-offsets{i}-{case[2]}-nb{NB}")
      for i, case in enumerate(_AWKWARD)),
    # the walk's edges: n = 3 nb + 1, offsets -(nb + 1), -nb and
    # -(nb - 1) around a block, -(2 nb + 1) past the two blocks of solved
    # rows it keeps (late against early terms), p = TP + 1
    pytest.param(3 * NB + 1, [-2 * NB - 1, -NB - 1, -NB, -NB + 1, -1, 0],
                 TP + 1, NB, id=f"edges-nb{NB}")])
def test_dia_core_plain_matches_jax_kernel_awkward(n, offsets, p, nb):
    """The plain version (through ``tri_dia_core``'s CPU path, or at the
    row block ``nb``) against the JAX kernel (256-row blocks)."""
    rng = np.random.default_rng(n)
    grid = rng.standard_normal((n, len(offsets))).astype(np.float32)
    grid[:, offsets.index(0)] = 4.0 + np.abs(grid[:, offsets.index(0)])
    B = rhs(n, p, n + 1)
    args = (np.array(offsets), torch.from_numpy(grid), torch.from_numpy(B))
    got = dia_tri.tri_dia_core(*args, unit=False) if nb is None else \
        dia_tri.tri_dia_core_plain(*args, unit=False, nb=nb)
    ref = jdt.tri_dia_core(np.array(offsets), jnp.asarray(grid),
                           jnp.asarray(B), unit=False)
    assert got.shape == (n, p)
    assert_close(got, ref, F32)


def test_dia_core_gates_follow_jax():
    grid, B = torch.ones(10, 2), torch.ones(10, 1)
    wide = np.array([-dia_tri.SPAN_CAP - 1, 0])
    assert dia_tri.tri_dia_core(wide, grid, B, unit=False) is None
    assert dia_tri.tri_dia_core(np.array([-1, 0]), grid.half(), B.half(),
                                unit=False) is None
    got = dia_tri.tri_dia_core(np.array([-1, 0]), grid.double(), B.double(),
                               unit=False)
    assert got.dtype == torch.float64         # float64 runs here


@pytest.mark.parametrize("offsets", [
    (-2500, -2499, -2451, -2450, -2449, -2401, -51, -50, -49, -3, -2, -1, 0),
    tuple(range(-255, 1)),
    (-8192, -NB, -(NB - 1), -1, 3),
    (0, 2)], ids=["tri-stencil", "256-offsets", "no-diagonal", "no-lower"])
def test_dia_kernel_meta_orders_offsets_as_the_kernels_read_them(offsets):
    """The CUDA kernels' offset table: the strictly-lower offsets' grid
    columns, then their distances, farthest first; how many lie outside
    a block's inverse (d >= the walk's row block); offset 0's column; the
    band's span."""
    km = dia_tri._kernel_meta(offsets, torch.device("cpu"))
    ks = [k for k, o in enumerate(offsets) if o < 0]
    ds = [-offsets[k] for k in ks]
    assert km.meta.tolist() == ks + ds and ds == sorted(ds, reverse=True)
    assert km.nk == len(ks)
    assert km.ni == sum(1 for d in ds if d >= NB)
    assert all(d >= NB for d in ds[:km.ni])
    assert all(0 < d < NB for d in ds[km.ni:])
    assert km.k0 == (offsets.index(0) if 0 in offsets else -1)
    assert km.span == max(ds, default=0)


# --------------------------------------------------------------------------
# host plans
# --------------------------------------------------------------------------

def _skewed_pattern(n=2048, every=34, seed=7):
    """tests/test_triangular.py's overflow-tier case: 1 to 4 random
    strictly-lower entries a row, every 34th row 160."""
    rng = np.random.default_rng(seed)
    rows, cols = [np.arange(n)], [np.arange(n)]
    for r in range(1, n):
        k = 160 if r % every == 0 else rng.integers(1, 5)
        c = rng.choice(r, size=min(int(k), r), replace=False)
        rows.append(np.full(len(c), r))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order]


def _plans_equal(pp, jp, fields):
    for f in fields:
        a, b = getattr(pp, f), getattr(jp, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)


TRI_FIELDS = ["n", "nb", "nblk", "diag_sel", "diag_bi", "diag_ri", "diag_ci",
              "ell_sel", "ell_cols", "nnz"]
WAVE_FIELDS = ["n", "nb", "gcap", "S", "W", "P_n", "perm", "rank", "offs",
               "diag_sel", "diag_si", "diag_gi", "diag_ri", "diag_ci",
               "pad_mask", "ell_sel", "ell_cols", "nnz", "ov_pos", "ov_sel",
               "ov_cols"]


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("nb", [16, 128])
def test_tri_plan_matches_jax(lower, nb):
    # a full random pattern: the wrong-side entries must be ignored alike
    A = rand_sparse((300, 300), 2500, seed=3, device="cpu")
    r, c = A.rows().astype(np.int32), A.cols().astype(np.int32)
    pp = ts._build_tri_plan(StaticArray(r), StaticArray(c), 300, nb, lower)
    jp = jts._build_tri_plan(JStatic(r), JStatic(c), 300, nb, lower)
    _plans_equal(pp, jp, TRI_FIELDS)


@pytest.mark.parametrize("case", ["lower", "upper", "skewed", "overflow"])
def test_wave_plan_matches_jax(case):
    """``skewed`` is the JAX package's own overflow-tier test case, whose
    heavy rows (3 %) lift the 99th percentile to the max, so its plan has
    no overflow tier; with one heavy row in 150 the tier engages."""
    if case in ("skewed", "overflow"):
        n, lower = (2048, True) if case == "skewed" else (3000, True)
        rows, cols = _skewed_pattern(n, 34 if case == "skewed" else 150)
    else:
        A = factor(700, upper=case == "upper")
        rows, cols, n, lower = A.rows(), A.cols(), 700, case == "lower"
    r, c = StaticArray(rows.astype(np.int32)), StaticArray(
        cols.astype(np.int32))
    pp = ts._build_wave_plan(r, c, n, 128, lower)
    jp = jts._build_wave_plan(JStatic(r.arr), JStatic(c.arr), n, 128, lower)
    _plans_equal(pp, jp, WAVE_FIELDS)
    assert (pp.ov_sel is not None) == (case == "overflow")


def test_tri_levels_match_jax():
    A = factor(2000, upper=False, seed=5)
    rows, cols = A.rows(), A.cols()
    ref = jax_tri_levels(rows, cols, 2000)
    np.testing.assert_array_equal(ts.tri_levels(rows, cols, 2000), ref)
    # any entry order gives the same levels (the JAX scan needs sorted rows)
    perm = np.random.default_rng(0).permutation(len(rows))
    np.testing.assert_array_equal(ts.tri_levels(rows[perm], cols[perm],
                                                2000), ref)
    assert ref.max() > 5
    chain = np.arange(1, 50)
    np.testing.assert_array_equal(ts.tri_levels(chain, chain - 1, 50),
                                  np.arange(50))


# --------------------------------------------------------------------------
# the public op against the JAX public op
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_solve_matches_jax(routes, algorithm, layout, upper, transpose):
    """Every algorithm against the JAX package's dense route: banded
    patterns for ``dia``, a random factor (n = 300 > 256) otherwise."""
    A = banded(300, upper, layout=layout) if algorithm == "dia" \
        else factor(300, upper, layout)
    B = rhs(300, 3, 4)
    x = sparse_triangular_solve(A, torch.from_numpy(B), upper=upper,
                                transpose=transpose, algorithm=algorithm)
    ref = tj.sparse_triangular_solve(jax_of(A), jnp.asarray(B), upper=upper,
                                     transpose=transpose, algorithm="dense")
    assert_close(x, ref, F32)
    if algorithm != "auto":
        assert routes["port"] == ([] if algorithm == "dense"
                                  else [algorithm])


def _column_skewed_factor(n=1200, seed=11):
    """Lower factor whose column degrees fall like 1/j: its transposed
    solve sees row degrees far above their 99th percentile."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(1, n), 3)
    c = np.floor(r * rng.random(len(r)) ** 4).astype(np.int64)
    keys = np.unique(np.concatenate([r * n + c, np.arange(n) * (n + 1)]))
    rows, cols = keys // n, keys % n
    vals = rng.standard_normal(len(rows)).astype(np.float32) * 0.1
    vals[rows == cols] = 2.0
    return SparseCOO(rows.astype(np.int32), cols.astype(np.int32),
                     torch.from_numpy(vals), (n, n))


class _Picked(Exception):
    pass


@pytest.mark.parametrize("kind", ["banded", "random", "skewed_transposed"])
def test_auto_picks_the_jax_algorithm(monkeypatch, kind):
    """``auto`` takes the JAX package's route: the JAX dispatch runs up to
    the solve it picks (each route raises there); the port's result is
    held against the JAX dense solve."""
    transpose = kind == "skewed_transposed"
    if kind == "banded":
        A, want = banded(300, upper=False), "dia"
    elif kind == "random":
        A, want = factor(300, upper=False), None
    else:
        A, want = _column_skewed_factor(), "wave"
    seen = []
    for module, name, label in ((ts, "tri_dia_core", "dia"),
                                (ts, "_blocked_tri_solve", "block"),
                                (ts, "_wave_tri_solve", "wave")):
        def spy(*a, _fn=getattr(module, name), _label=label, **k):
            seen.append(_label)
            return _fn(*a, **k)
        monkeypatch.setattr(module, name, spy)
    for module, name, label in ((jdt, "tri_dia_core", "dia"),
                                (jts, "_blocked_tri_solve", "block"),
                                (jts, "_wave_tri_solve", "wave")):
        def stop(*a, _label=label, **k):
            raise _Picked(_label)
        monkeypatch.setattr(module, name, stop)
    n = A.shape[0]
    B = rhs(n, 2, 6)
    x = sparse_triangular_solve(A, torch.from_numpy(B), upper=False,
                                transpose=transpose)
    with pytest.raises(_Picked) as picked:
        tj.sparse_triangular_solve(jax_of(A), jnp.asarray(B), upper=False,
                                   transpose=transpose)
    assert seen == [str(picked.value)]
    assert want is None or seen == [want]
    ref = tj.sparse_triangular_solve(jax_of(A), jnp.asarray(B), upper=False,
                                     transpose=transpose, algorithm="dense")
    assert_close(x, ref, F32)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_vector_and_batched_rhs(layout):
    A = factor(40, upper=False, layout=layout)
    Aj = jax_of(A)
    b = rhs(40, 1, 7)[:, 0]
    x = sparse_triangular_solve(A, torch.from_numpy(b), upper=False)
    assert x.shape == (40,)
    assert_close(x, tj.sparse_triangular_solve(Aj, jnp.asarray(b),
                                               upper=False,
                                               algorithm="dense"), F32)
    B3 = np.random.default_rng(8).standard_normal((3, 40, 2)).astype(
        np.float32)
    x3 = sparse_triangular_solve(A, torch.from_numpy(B3), upper=False,
                                 algorithm="block")
    assert_close(x3, tj.sparse_triangular_solve(
        Aj, jnp.asarray(B3), upper=False, algorithm="dense"), F32)


@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("shared", [False, True])
def test_batched_matrix(layout, shared):
    A = rand_sparse_tri((3, 16, 16), 36, upper=False, layout=layout,
                        shared_pattern=shared, device="cpu")
    assert A.indices_batched() == (not shared)
    B = np.random.default_rng(9).standard_normal((3, 16, 2)).astype(
        np.float32)
    x = sparse_triangular_solve(A, torch.from_numpy(B), upper=False)
    ref = tj.sparse_triangular_solve(jax_of(A), jnp.asarray(B), upper=False,
                                     algorithm="dense")
    assert_close(x, ref, F32)
    # a 2-D right-hand side is broadcast over the batch
    x2 = sparse_triangular_solve(A, torch.from_numpy(B[0]), upper=False)
    assert_close(x2, tj.sparse_triangular_solve(
        jax_of(A), jnp.asarray(B[0]), upper=False, algorithm="dense"), F32)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_wrong_triangle_is_ignored(algorithm):
    if algorithm == "dia":
        A = stencil_sparse((300, 300), [-40, -1, 0, 2, 60],
                           well_conditioned=True, device="cpu")
    else:
        A = rand_sparse((300, 300), 1500, well_conditioned=True, seed=2,
                        device="cpu")
    b = rhs(300, 1, 10)[:, 0]
    x = sparse_triangular_solve(A, torch.from_numpy(b), upper=False,
                                algorithm=algorithm)
    ref = tj.sparse_triangular_solve(jax_of(A), jnp.asarray(b), upper=False,
                                     algorithm="dense")
    assert_close(x, ref, F32)


@pytest.mark.parametrize("algorithm", ["auto", "block", "wave", "dense"])
@pytest.mark.parametrize("upper", [False, True])
def test_unitriangular(algorithm, upper):
    A = rand_sparse_tri((300, 300), 1200, upper=upper, strict=True,
                        layout="csr", device="cpu")
    A = A.with_data(A.values * (0.5 / 300))
    B = rhs(300, 2, 11)
    x = sparse_triangular_solve(A, torch.from_numpy(B), upper=upper,
                                unitriangular=True, algorithm=algorithm)
    ref = tj.sparse_triangular_solve(jax_of(A), jnp.asarray(B), upper=upper,
                                     unitriangular=True, algorithm="dense")
    assert_close(x, ref, F32)


def test_errors_match_jax():
    A = factor(40, upper=False)
    Aj = jax_of(A)
    b = torch.ones(40)
    cases = [
        (TypeError, "must be SparseCOO/SparseCSR",
         lambda: (A.todense(), b), lambda: (Aj.todense(), jnp.ones(40))),
        (ValueError, "square",
         lambda: (rand_sparse((4, 6), 5, device="cpu"), torch.ones(4)),
         lambda: (jax_of(rand_sparse((4, 6), 5, device="cpu")),
                  jnp.ones(4))),
        (ValueError, "dtype mismatch", lambda: (A, b.double()),
         lambda: (Aj, jnp.ones(40, jnp.bfloat16))),
        (ValueError, "incompatible shapes", lambda: (A, torch.ones(41)),
         lambda: (Aj, jnp.ones(41))),
        (ValueError, "explicit diagonal",
         lambda: (A, b, dict(unitriangular=True)),
         lambda: (Aj, jnp.ones(40), dict(unitriangular=True))),
        (ValueError, "unknown algorithm",
         lambda: (A, b, dict(algorithm="bogus")),
         lambda: (Aj, jnp.ones(40), dict(algorithm="bogus"))),
        (ValueError, "needs n > 256",
         lambda: (A, b, dict(algorithm="wave")),
         lambda: (Aj, jnp.ones(40), dict(algorithm="wave"))),
        (ValueError, "requires a diagonal-structured",
         lambda: (A, b, dict(algorithm="dia")),
         lambda: (Aj, jnp.ones(40), dict(algorithm="dia"))),
    ]
    for exc, msg, port_args, jax_args in cases:
        for fn, make in ((sparse_triangular_solve, port_args),
                         (tj.sparse_triangular_solve, jax_args)):
            args = make()
            kw = dict(upper=False, **(args[2] if len(args) > 2 else {}))
            with pytest.raises(exc, match=msg):
                fn(args[0], args[1], **kw)


def test_bfloat16_routes():
    for A, alg in ((banded(300, upper=False), "dia"),
                   (factor(300, upper=False), "block"),
                   (factor(300, upper=False), "wave")):
        A16 = A.astype(torch.bfloat16)
        B = torch.from_numpy(rhs(300, 2, 12)).bfloat16()
        x = sparse_triangular_solve(A16, B, upper=False, algorithm=alg)
        assert x.dtype == torch.bfloat16
        ref = tj.sparse_triangular_solve(
            jax_of(A16), jnp.asarray(B.float().numpy()), upper=False,
            algorithm="dense")
        assert_close(x, ref, BF16)


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

def _grads_port(A, B, G, kw):
    v = A.values.detach().clone().requires_grad_(True)
    b = B.clone().requires_grad_(True)
    x = sparse_triangular_solve(A.with_data(v), b, **kw)
    gv, gb = torch.autograd.grad((x * G).sum(), (v, b), create_graph=True)
    hv, hb = torch.autograd.grad((gv ** 2).sum() + (gb ** 2).sum(), (v, b))
    return gv, gb, hv, hb


def _grads_jax(Aj, B, G, kw):
    def loss(d, b):
        return (tj.sparse_triangular_solve(Aj.with_data(d), b, **kw)
                * G).sum()

    def loss2(d, b):
        gd, gb = jax.grad(loss, argnums=(0, 1))(d, b)
        return (gd ** 2).sum() + (gb ** 2).sum()

    f = jax.jit(lambda d, b: (*jax.grad(loss, argnums=(0, 1))(d, b),
                              *jax.grad(loss2, argnums=(0, 1))(d, b)))
    return f(Aj.data, B)


@pytest.mark.parametrize("route", ["dia", "block", "wave"])
def test_first_and_second_derivatives_match_jax_f64(enable_x64, route):
    """float64: the port's dia, block and wave routes against jax.grad of
    the same loss (JAX runs block or wave: it has no float64 banded
    kernel)."""
    upper = route == "dia"
    transpose = route == "wave"
    A = banded(300, upper, dtype=torch.float64) if route == "dia" \
        else factor(300, upper=False, dtype=torch.float64)
    B, G = rhs(300, 2, 13, np.float64), rhs(300, 2, 14, np.float64)
    kw = dict(upper=upper, transpose=transpose, algorithm=route)
    got = _grads_port(A, torch.from_numpy(B), torch.from_numpy(G), kw)
    ref = _grads_jax(jax_of(A), jnp.asarray(B), jnp.asarray(G),
                     dict(kw, algorithm="auto" if route == "dia" else route))
    for g, r in zip(got, ref):
        assert_close(g, r, F64)


def test_first_and_second_derivatives_match_jax_f32():
    A = factor(300, upper=False)
    B, G = rhs(300, 2, 15), rhs(300, 2, 16)
    kw = dict(upper=False, algorithm="wave")
    got = _grads_port(A, torch.from_numpy(B), torch.from_numpy(G), kw)
    ref = _grads_jax(jax_of(A), jnp.asarray(B), jnp.asarray(G), kw)
    for g, r in zip(got, ref):
        assert_close(g, r, GRAD32)


@pytest.mark.parametrize("route,n", [("dia", 40), ("block", 40),
                                     ("wave", 260), ("dense", 20)])
def test_gradcheck_and_gradgradcheck(route, n):
    if route == "dia":
        A = stencil_sparse((n, n), [0, 3, 17], well_conditioned=True,
                           dtype=torch.float64, device="cpu")
        upper = True
    else:
        A = rand_sparse_tri((n, n), 3 * n, dtype=torch.float64,
                            device="cpu")
        upper = False
    v = A.values.clone().requires_grad_(True)
    b = torch.from_numpy(rhs(n, 1, n, np.float64)).requires_grad_(True)

    def f(v, b):
        return sparse_triangular_solve(A.with_data(v), b, upper=upper,
                                       transpose=route != "block",
                                       algorithm=route)
    assert torch.autograd.gradcheck(f, (v, b), fast_mode=True)
    if route != "wave":      # the wave route's second derivatives: above
        assert torch.autograd.gradgradcheck(f, (v, b), fast_mode=True)


def test_gradient_lands_on_pattern_of_batched_values():
    A = rand_sparse_tri((2, 30, 30), 80, upper=True, shared_pattern=True,
                        dtype=torch.float64, device="cpu")
    v = A.values.clone().requires_grad_(True)
    B = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (2, 30, 2)))
    x = sparse_triangular_solve(A.with_data(v), B, upper=True)
    gv, = torch.autograd.grad(x.sum(), v)
    assert gv.shape == (2, 80)
    for i in range(2):
        vi = A.values[i].clone().requires_grad_(True)
        A2 = SparseCOO(A.row, A.col, vi, (30, 30))
        gi, = torch.autograd.grad(sparse_triangular_solve(
            A2, B[i], upper=True).sum(), vi)
        assert_close(gv[i], gi, F64)
