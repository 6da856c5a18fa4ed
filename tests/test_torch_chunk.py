"""PyTorch port: the chunk engine held against the JAX package's.

The plans are compared with the JAX ``build_chunk_plan`` and
``build_chunk_plan_transpose``; the kernels' plain versions with the JAX
Pallas chunk kernels, run in interpret mode on the CPU as
``tests/test_pallas_kernels.py`` runs them; ``sparse_mm``/``sddmm`` with
``backend="pallas"`` and the hybrid residual on the chunk route with the
JAX package's own paths.  Inputs are numpy arrays from fixed seeds,
handed to both packages.  On the CPU the port's wrappers run the plain
versions; the ``plain_calls`` fixture counts them, to show which route
ran.

Tolerances: float32 ``rtol=1e-5, atol=1e-6`` on outputs, ``1e-5/1e-5`` on
gradients, ``1e-4/1e-5`` on second derivatives, as in
``tests/test_torch_spmm.py``; bfloat16 ``2e-2``.  float64 is held against
the JAX ``backend="xla"`` path at ``1e-10``: the JAX chunk kernels
compute in float32 (``kernels/chunk_spmm.py:229-230``), the port's in
float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.kernels import chunk_spmm as jcs
from torchsparsegradutils_tpu.kernels import dia as jdia
from torchsparsegradutils_tpu.types import StaticArray as JStatic
from torchsparsegradutils_tpu_torch import (SparseCOO, SparseCSR, sddmm,
                                            sparse_mm, to_arrays)
from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
from torchsparsegradutils_tpu_torch.kernels import dia, row_packs
from torchsparsegradutils_tpu_torch.ops import spmm as ops
from torchsparsegradutils_tpu_torch.types import StaticArray
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    hybrid_sparse, rand_sparse)

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD32 = dict(rtol=1e-5, atol=1e-5)
HESS32 = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-10)
RNG = np.random.default_rng(23)


def jax_of(A):
    """The JAX container holding the same arrays as port container A."""
    lay, i0, i1, data, shape = to_arrays(A)
    return (tj.SparseCOO if lay == "coo" else tj.SparseCSR)(i0, i1, data,
                                                             shape)


def pattern(n, m, nnz, seed, empty_every=0, dense_row=None):
    """Row-major (rows, cols): ``nnz`` distinct uniform entries, every
    ``empty_every``-th row emptied, ``dense_row`` holding m // 2 more."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(n * m, nnz, replace=False))
    rows, cols = keys // m, keys % m
    if empty_every:
        keep = rows % empty_every != 1
        rows, cols = rows[keep], cols[keep]
    if dense_row is not None:
        keep = rows != dense_row
        extra = np.sort(rng.choice(m, m // 2, replace=False))
        rows = np.concatenate([rows[keep], np.full(len(extra), dense_row)])
        cols = np.concatenate([cols[keep], extra])
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
    return rows, cols


def plans(rows, cols, n, m):
    """(JAX row plan, JAX transpose plan, port row plan, port transpose
    plan) of one pattern."""
    jr, jc = JStatic(rows.astype(np.int32)), JStatic(cols.astype(np.int32))
    pr, pc = StaticArray(rows.astype(np.int32)), StaticArray(
        cols.astype(np.int32))
    return (jcs.build_chunk_plan(jr, jc, n, m),
            jcs.build_chunk_plan_transpose(jr, jc, n, m),
            cs.build_chunk_plan(pr, pc, n, m),
            cs.build_chunk_plan_transpose(pr, pc, n, m))


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the chunk kernels' plain versions, which the wrappers
    run on CPU tensors."""
    calls = {}
    for name in ("chunk_spmm_plain", "chunk_sddmm_plain",
                 "chunk_spmv_plain"):
        fn = getattr(cs, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(cs, name, counted)
    return calls


# --------------------------------------------------------------------------
# (a) plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,nnz,empty_every,dense_row", [
    (200, 150, 2000, 0, None), (90, 200, 1500, 4, 7), (200, 60, 1800, 0, 3)])
def test_plans_match_jax(n, m, nnz, empty_every, dense_row):
    rows, cols = pattern(n, m, nnz, n + m, empty_every, dense_row)
    jp, jpt, pp, ppt = plans(rows, cols, n, m)
    np.testing.assert_array_equal(ppt.perm, jpt.perm)
    assert (ppt.n, ppt.m, pp.n, pp.m) == (m, n, n, m)
    assert jp.nnz == pp.nnz == ppt.nnz == len(rows)
    np.testing.assert_array_equal(np.diff(pp.indptr),
                                  np.bincount(rows, minlength=n))
    np.testing.assert_array_equal(pp.cols, cols)
    np.testing.assert_array_equal(ppt.cols, rows[ppt.perm])
    np.testing.assert_array_equal(ppt.perm[ppt.inv], np.arange(len(rows)))
    assert pp.T is ppt and ppt.T is pp


def test_plans_refuse_what_jax_refuses():
    rows, cols = pattern(50, 40, 300, 1)
    shuffle = RNG.permutation(len(rows))                # unsorted COO
    jp, jpt, pp, ppt = plans(rows[shuffle], cols[shuffle], 50, 40)
    assert jp is None and pp is None
    # the port plans no Aᵀ either: such patterns run the generic branch
    assert ppt is None and jpt is not None
    empty = np.zeros(0, np.int64)
    assert plans(empty, empty, 5, 4) == (None, None, None, None)


# --------------------------------------------------------------------------
# (b) the kernels' plain versions against the JAX Pallas kernels
# --------------------------------------------------------------------------

def _check_kernels(rows, cols, n, m, ps, spmv=False):
    """Plain SpMM, SDDMM (and SpMV) at each width of ``ps`` against the
    JAX kernels, one JAX call each: the SpMM's columns are independent,
    so the widths go side by side; the SDDMM sums over the columns, so
    they go as the blocks of a block-diagonal pattern, zero-padded to
    the widest."""
    jp, _, pp, _ = plans(rows, cols, n, m)
    t = torch.from_numpy
    d = pp.maps("cpu")
    vals = RNG.standard_normal(pp.nnz).astype(np.float32)
    Bs = [RNG.standard_normal((m, p)).astype(np.float32) for p in ps]
    Xs = [RNG.standard_normal((n, p)).astype(np.float32) for p in ps]
    w = max(ps)
    k = np.arange(len(ps))[:, None]
    jbig, _, _, _ = plans((rows + k * n).ravel(), (cols + k * m).ravel(),
                          len(ps) * n, len(ps) * m)
    pad = lambda Z: np.concatenate([np.pad(z, ((0, 0), (0, w - z.shape[1])))
                                    for z in Z])
    spmm_want = np.asarray(jcs.chunk_spmm(jp, vals, np.concatenate(Bs, 1)))
    sddmm_want = np.asarray(jcs.chunk_sddmm(jbig, pad(Xs), pad(Bs))
                            ).reshape(len(ps), -1)
    starts = np.cumsum([0] + list(ps))
    for B, X, lo, hi, dd in zip(Bs, Xs, starts, starts[1:], sddmm_want):
        np.testing.assert_allclose(
            cs.chunk_spmm(d["indptr"], d["cols"], t(vals), t(B)).numpy(),
            spmm_want[:, lo:hi], **F32)
        np.testing.assert_allclose(  # gradA values: a gradient tolerance
            cs.chunk_sddmm(d["indptr"], d["cols"], t(X), t(B)).numpy(),
            dd, **GRAD32)
    if spmv:
        np.testing.assert_allclose(
            cs.chunk_spmv(d["indptr"], d["cols"], t(vals),
                          t(Bs[0][:, 0])).numpy(),
            jcs.chunk_spmv(jp, vals, Bs[0][:, 0]), **F32)
    return jp


def test_plain_kernels_match_jax_pallas(plain_calls):
    # p = 1, 3, 8 and 130, which crosses the JAX kernels' 128-lane pad
    rows, cols = pattern(200, 170, 2000, 3, empty_every=9)
    _check_kernels(rows, cols, 200, 170, (1, 3, 8, 130), spmv=True)
    assert plain_calls == {"chunk_spmm_plain": 4, "chunk_sddmm_plain": 4,
                           "chunk_spmv_plain": 1}


def test_plain_kernels_match_jax_pallas_across_chunks(monkeypatch):
    # 128-entry JAX chunks: rows of ~33 entries and one of 100 span chunk
    # boundaries (a pattern of its own: JAX plans are cached by content)
    monkeypatch.setenv("TSGU_CHUNK_C", "128")
    rows, cols = pattern(60, 200, 2000, 4, dense_row=30)
    jp = _check_kernels(rows, cols, 60, 200, (5,), spmv=True)
    assert jp.C == 128 and jp.nchunks > 8


# --------------------------------------------------------------------------
# (c) sparse_mm / sddmm with backend="pallas"
# --------------------------------------------------------------------------

def random_container(shape, nnz, layout, seed=0, dtype=torch.float32):
    rows, cols = pattern(*shape, nnz, seed)
    vals = torch.from_numpy(RNG.standard_normal(len(rows))).to(dtype)
    if layout == "coo":
        return SparseCOO(rows.astype(np.int32), cols.astype(np.int32), vals,
                         shape)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=shape[0]))])
    return SparseCSR(indptr.astype(np.int32), cols.astype(np.int32), vals,
                     shape)


def port_grads(A, B, G, second=True):
    """Output, first (and second) derivatives through the port's
    ``backend="pallas"``."""
    v = A.values.detach().clone().requires_grad_(True)
    b = torch.from_numpy(B).requires_grad_(True)
    out = sparse_mm(A.with_data(v), b, backend="pallas")
    gv, gb = torch.autograd.grad(out, (v, b), torch.from_numpy(G),
                                 create_graph=second)
    res = [out, gv, gb]
    if second:
        res += torch.autograd.grad((gv ** 2).sum() + (gb ** 2).sum(),
                                   (v, b))
    return [x.detach().numpy() for x in res]


def jax_grads(A, B, G, second=True):
    """The same through the JAX package's ``backend="xla"`` path."""
    Aj = jax_of(A)

    def f(d, b):
        return tj.sparse_mm(Aj.with_data(d), b, backend="xla")

    out, vjp = jax.vjp(f, Aj.data, jnp.asarray(B))
    res = [out, *vjp(jnp.asarray(G))]

    def g(d, b):
        gd, gbb = jax.vjp(f, d, b)[1](jnp.asarray(G))
        return (gd ** 2).sum() + (gbb ** 2).sum()

    if second:
        res += jax.grad(g, argnums=(0, 1))(Aj.data, jnp.asarray(B))
    return [np.asarray(x) for x in res]


@pytest.mark.parametrize("layout,p,sorted_rows", [
    ("csr", 1, True), ("coo", 16, True), ("coo", 3, False)])
def test_sparse_mm_pallas_matches_jax(layout, p, sorted_rows, plain_calls):
    A = random_container((120, 90), 900, layout, seed=p)
    if not sorted_rows:      # unsorted COO: the generic branch in both
        perm = torch.from_numpy(RNG.permutation(A.nnz))
        A = SparseCOO(A.rows()[perm.numpy()], A.cols()[perm.numpy()],
                      A.values[perm], A.shape)
    B = RNG.standard_normal((90, p)).astype(np.float32)
    G = RNG.standard_normal((120, p)).astype(np.float32)
    got = port_grads(A, B, G)
    for g, w, tol in zip(got, jax_grads(A, B, G),
                         (F32, GRAD32, GRAD32, HESS32, HESS32)):
        np.testing.assert_allclose(g, w, **tol)
    routed = sum(plain_calls.values())
    assert routed > 0 if sorted_rows else routed == 0
    if p == 1:
        assert plain_calls["chunk_spmv_plain"] >= 2     # A x and Aᵀ g


def test_sparse_mm_pallas_batched_shared_pattern(plain_calls):
    A = random_container((70, 50), 500, "csr", seed=9)
    vals = torch.stack([A.values, 3 * A.values])
    Ab = SparseCSR(A.indptr, A.indices, vals, (2, 70, 50))
    B = RNG.standard_normal((2, 50, 6)).astype(np.float32)
    G = RNG.standard_normal((2, 70, 6)).astype(np.float32)
    v = vals.clone().requires_grad_(True)
    b = torch.from_numpy(B).requires_grad_(True)
    out = sparse_mm(Ab.with_data(v), b, backend="pallas")
    gv, gb = torch.autograd.grad(out, (v, b), torch.from_numpy(G))
    Aj = jax_of(Ab)
    want, vjp = jax.vjp(
        lambda d, bb: tj.sparse_mm(Aj.with_data(d), bb, backend="xla"),
        Aj.data, jnp.asarray(B))
    for g, w, tol in zip((out.detach(), gv, gb), (want, *vjp(G)),
                         (F32, GRAD32, GRAD32)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert plain_calls["chunk_spmm_plain"] >= 2


def test_sddmm_pallas_matches_jax(plain_calls):
    A = random_container((80, 100), 1200, "csr", seed=5)
    X = RNG.standard_normal((80, 7)).astype(np.float32)
    Y = RNG.standard_normal((100, 7)).astype(np.float32)
    C = RNG.standard_normal(A.nnz).astype(np.float32)
    x = torch.from_numpy(X).requires_grad_(True)
    y = torch.from_numpy(Y).requires_grad_(True)
    vals = sddmm(A, x, y, backend="pallas").values
    gx, gy = torch.autograd.grad(vals, (x, y), torch.from_numpy(C))
    Aj = jax_of(A)
    want, vjp = jax.vjp(lambda a, b: tj.sddmm(Aj, a, b, backend="xla").data,
                        jnp.asarray(X), jnp.asarray(Y))
    for g, w, tol in zip((vals.detach(), gx, gy), (want, *vjp(C)),
                         (F32, GRAD32, GRAD32)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert plain_calls == {"chunk_sddmm_plain": 1, "chunk_spmm_plain": 2}


def test_pallas_float64_and_bfloat16(enable_x64):
    A = random_container((60, 80), 700, "csr", seed=2, dtype=torch.float64)
    B = RNG.standard_normal((80, 5))
    G = RNG.standard_normal((60, 5))
    for g, w in zip(port_grads(A, B, G, second=False),
                    jax_grads(A, B, G, second=False)):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, **F64)
    # bfloat16 storage: against float32 products of the same bf16 values
    Ab = A.astype(torch.bfloat16)
    Bb = torch.from_numpy(B).to(torch.bfloat16)
    out = sparse_mm(Ab, Bb, backend="pallas")
    assert out.dtype == torch.bfloat16
    want = tj.sparse_mm(jax_of(Ab.astype(torch.float32)),
                        np.asarray(Bb.float()), backend="xla")
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


# --------------------------------------------------------------------------
# (d) the hybrid residual on the chunk route
# --------------------------------------------------------------------------

def test_hybrid_residual_on_chunk_route_matches_jax(monkeypatch,
                                                    plain_calls):
    # the residual's own functions against the JAX package's on its chunk
    # route (its whole DIA path runs the window-gather kernels in
    # interpret mode, seconds a call); the whole op against JAX "xla"
    monkeypatch.setattr(dia, "RESID_ENGINE", "chunk")
    monkeypatch.setenv("TSGU_RESID_ENGINE", "chunk")
    H = hybrid_sparse((300, 300), [-9, -1, 0, 1, 9], 1600,
                      dia_coverage=0.8, generator=torch.Generator(
                          ).manual_seed(3), device="cpu")
    Hj = jax_of(H)
    pt = dia.build_dia_plan(H.row_sa(), H.col_sa(), 300, 300)
    pj = jdia.build_dia_plan(Hj.row_sa(), Hj.col_sa(), 300, 300)
    assert pt.is_hybrid and dia._resid_chunk_ok(pt, torch.device("cpu"))
    assert jdia._resid_chunk_ok(pj, 3, jnp.float32)
    t = torch.from_numpy
    B = RNG.standard_normal((300, 3)).astype(np.float32)
    G = RNG.standard_normal((300, 3)).astype(np.float32)
    rv = to_arrays(H)[3][pt.resid_sel]
    r = t(rv).requires_grad_(True)
    b = t(B).requires_grad_(True)
    out = dia._resid_spmm(pt, r, b)
    d_r, d_b = torch.autograd.grad(out, (r, b), t(G))
    _, rpt = jdia._resid_chunk_plans(pj)
    wants = (jdia._resid_spmm(pj, rv, B), jdia._resid_sddmm(pj, G, B),
             jcs.chunk_spmm(rpt, rv, G))
    for g, w, tol in zip((out.detach(), d_r, d_b), wants,
                         (F32, GRAD32, GRAD32)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert plain_calls == {"chunk_spmm_plain": 2, "chunk_sddmm_plain": 1}
    np.testing.assert_allclose(                                  # p = 1
        dia._resid_spmm(pt, t(rv), t(B[:, :1])).numpy(),
        jdia._resid_spmm(pj, rv, B[:, :1]), **F32)
    assert plain_calls["chunk_spmv_plain"] == 1

    # the whole op at p = 1, and the hoisted Krylov matvecs
    v = H.values.clone().requires_grad_(True)
    b = t(B[:, :1]).requires_grad_(True)
    out = sparse_mm(H.with_data(v), b)
    gv, gb = torch.autograd.grad(out, (v, b), t(G[:, :1]))
    want, vjp = jax.vjp(
        lambda d, bb: tj.sparse_mm(Hj.with_data(d), bb, backend="xla"),
        Hj.data, jnp.asarray(B[:, :1]))
    wv, wb = vjp(jnp.asarray(G[:, :1]))
    for g, w, tol in zip((out.detach(), gv, gb), (want, wv, wb),
                         (F32, GRAD32, GRAD32)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert plain_calls["chunk_spmv_plain"] == 3       # p = 1: A x, Aᵀ g
    np.testing.assert_allclose(
        dia.prepared_matvec(pt, H.values, False)(t(B[:, :1])).numpy(),
        want, **F32)
    np.testing.assert_allclose(
        dia.prepared_matvec(pt, H.values, True)(t(G[:, :1])).numpy(),
        wb, **GRAD32)
    d_v, d_B = dia.dia_bwd_pair(pt, H.values, t(B[:, :1]), t(G[:, :1]))
    torch.testing.assert_close(d_v, gv, rtol=0, atol=0)
    torch.testing.assert_close(d_B, gb, rtol=0, atol=0)
    X = RNG.standard_normal((300, 4)).astype(np.float32)
    np.testing.assert_allclose(
        sddmm(H, t(X), t(X)).values.numpy(),
        tj.sddmm(Hj, X, X, backend="xla").data, **GRAD32)


def test_hybrid_residual_route_switch():
    H = hybrid_sparse((300, 300), [-9, -1, 0, 1, 9], 1600,
                      dia_coverage=0.8, device="cpu")
    plan = dia.build_dia_plan(H.row_sa(), H.col_sa(), 300, 300)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert dia.RESID_ENGINE == "auto"
    assert not dia._resid_chunk_ok(plan, cpu)
    assert not dia._resid_chunk_ok(plan, cuda)      # < RESID_MIN_NNZ
    rp = dia._resid_chunk_plan(plan)
    assert rp is dia._resid_chunk_plan(plan) and rp.nnz == len(
        plan.resid_sel)


# --------------------------------------------------------------------------
# (e) gradcheck of the Functions, and the wrappers' refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2])
def test_functions_gradcheck(p):
    rows, cols = pattern(7, 5, 14, 1, empty_every=3)
    plan = cs.build_chunk_plan(StaticArray(rows), StaticArray(cols), 7, 5)
    vals, B, X = (torch.from_numpy(RNG.standard_normal(s)).requires_grad_()
                  for s in ((plan.nnz,), (5, p), (7, p)))
    for fn, args in ((cs.ChunkSpmm.apply, (vals, B)),
                     (cs.ChunkSddmm.apply, (X, B))):
        f = lambda a, b: fn(plan, a, b)
        assert torch.autograd.gradcheck(f, args)
        assert torch.autograd.gradgradcheck(f, args)
    dense = torch.zeros(7, 5, dtype=torch.float64)
    dense[torch.tensor(rows), torch.tensor(cols)] = vals.detach()
    torch.testing.assert_close(cs.ChunkSpmm.apply(plan, vals, B),
                               dense @ B, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(
        cs.ChunkSpmm.apply(plan.T, plan.to_T(vals), X), dense.T @ X,
        rtol=1e-12, atol=1e-12)


def test_chunk_spmv_pack_table_check_refuses_another_pattern():
    # the check K8's wrapper makes before a launch, run on the CPU: a
    # table cut for another (n, nnz), or at another pack size, raises;
    # None builds the plan's own at K8's size
    T = cs.SPMV_PACK
    ip, cols = torch.tensor([0, 1, 3]), torch.tensor([0, 1, 0])
    own = row_packs.pack_table(ip.numpy(), "cpu", T)
    built = row_packs._packs_for("chunk_spmv", ip, cols, None, T)
    assert torch.equal(built.table, own.table) and built[1:] == own[1:]
    assert built.T == T != row_packs.PACK_ENTRIES
    assert row_packs._packs_for("chunk_spmv", ip, cols, own, T) is own
    for other in ([0, 1, 2, 3], [0, 1, 4], [0, 3]):
        with pytest.raises(ValueError, match="chunk_spmv: packs were cut"):
            row_packs._packs_for("chunk_spmv", ip, cols,
                                 row_packs.pack_table(np.array(other),
                                                      "cpu", T), T)
    with pytest.raises(ValueError, match="cut at 2048 entries a pack, the "
                                         "kernel stages 512"):
        row_packs._packs_for("chunk_spmv", ip, cols,
                             row_packs.pack_table(ip.numpy()), T)
    # on CPU tensors the wrapper takes the plain version, table or not
    x = torch.tensor([2.0, 3.0])
    v = torch.tensor([1.0, 2.0, 4.0])
    assert cs.chunk_spmv(ip, cols, v, x, own).tolist() == [2.0, 14.0]
    assert cs.chunk_spmv(ip, cols, v, x).tolist() == [2.0, 14.0]


def test_chunk_spmm_p1_builds_no_pack_table_on_the_cpu(plain_calls):
    # ChunkSpmm passes the plan's cached table on the card only
    rows, cols = pattern(40, 30, 200, 5)
    plan = cs.build_chunk_plan(StaticArray(rows), StaticArray(cols), 40, 30)
    vals = torch.randn(plan.nnz, dtype=torch.float64, requires_grad=True)
    x = torch.randn(30, 1, dtype=torch.float64, requires_grad=True)
    out = cs.ChunkSpmm.apply(plan, vals, x)
    out.sum().backward()
    assert plain_calls["chunk_spmv_plain"] == 2         # A x and Aᵀ g
    assert plan not in row_packs._PLAN_PACKS
    assert plan.T not in row_packs._PLAN_PACKS


def test_plan_packs_caches_a_table_per_pack_size():
    # K8's table (SPMV_PACK) and K10's and K11's (PACK_ENTRIES) of one
    # plan are cached apart, each the pack_table of the plan at its size
    rows, cols = pattern(300, 200, 4000, 6, dense_row=7)
    plan = cs.build_chunk_plan(StaticArray(rows), StaticArray(cols), 300,
                               200)
    k8 = row_packs.plan_packs(plan, "cpu", cs.SPMV_PACK)
    lse = row_packs.plan_packs(plan, "cpu")
    assert row_packs.plan_packs(plan, "cpu", cs.SPMV_PACK) is k8
    assert row_packs.plan_packs(plan, "cpu") is lse
    assert (k8.T, lse.T) == (cs.SPMV_PACK, row_packs.PACK_ENTRIES)
    for pk, T in ((k8, cs.SPMV_PACK), (lse, row_packs.PACK_ENTRIES)):
        assert torch.equal(pk.table, row_packs.pack_table(plan.indptr,
                                                          "cpu", T).table)
        starts = pk.table[:, 0].numpy()
        ents = np.diff(plan.indptr[starts])
        several = np.diff(starts) > 1
        assert (ents[several] <= T).all()
    assert k8.table.shape[0] > lse.table.shape[0]


def test_chunk_wrappers_refuse_non_cpu_tensors():
    idx = torch.zeros(2, dtype=torch.int64, device="meta")
    v = torch.empty(1, device="meta")
    M = torch.empty(1, 3, device="meta")
    for call in (lambda: cs.chunk_spmm(idx, idx[:1], v, M),
                 lambda: cs.chunk_sddmm(idx, idx[:1], M, M),
                 lambda: cs.chunk_spmv(idx, idx[:1], v, v)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


# K6's and K13's slab and lane grouping, chosen on the host: (p, dtype,
# aligned, slab bytes) -> (path, lanes an entry, slab columns)
LANES = [
    (128, torch.float32, True, 256, "vec", 16, 64),     # two lines, 2 slabs
    (128, torch.float32, True, 512, "vec", 32, 128),    # short rows: one
    (64, torch.float32, True, 256, "vec", 16, 64),
    (32, torch.float32, True, 256, "vec", 8, 32),       # 8 lanes, 4 entries
    (16, torch.float32, True, 256, "vec", 4, 16),       # 4 lanes, 8 entries
    (4, torch.float32, True, 256, "vec", 1, 4),         # 32 entries a round
    (130, torch.float32, True, 256, "scalar", 32, 32),  # p % 4 != 0
    (3, torch.float32, True, 256, "scalar", 4, 4),
    (1, torch.float32, True, 256, "scalar", 1, 1),
    (128, torch.float32, False, 256, "scalar", 32, 32),  # unaligned
    (16, torch.float32, False, 256, "scalar", 16, 16),
    (128, torch.bfloat16, True, 256, "vec", 16, 128),   # 8 columns a lane
    (256, torch.bfloat16, True, 512, "vec", 32, 256),
    (12, torch.bfloat16, True, 256, "scalar", 16, 16),  # p % 8 != 0
    (128, torch.float64, True, 256, "vec", 16, 32),     # 2 columns a lane
    (2, torch.float64, True, 256, "vec", 1, 2),
    (128, torch.float64, False, 256, "scalar", 32, 32),
    (128, torch.float64, False, 512, "scalar", 32, 32),  # at most 32 lanes
]


@pytest.mark.parametrize("p,dtype,aligned,slab,path,lanes,cols", LANES)
def test_spmm_lanes_by_width_dtype_and_alignment(p, dtype, aligned, slab,
                                                  path, lanes, cols):
    got_path, lg, got_cols = cs.spmm_lanes(p, dtype, aligned, slab)
    assert (got_path, 1 << lg, got_cols) == (path, lanes, cols)


def test_slab_bytes_widen_for_short_rows():
    assert cs.slab_bytes(3_087_898, 123_440) == cs.SLAB_BYTES   # random
    assert cs.slab_bytes(463_169, 123_440) == cs.SHORT_SLAB_BYTES  # resid
    assert cs.slab_bytes(8 * 100, 100) == cs.SLAB_BYTES
    assert cs.slab_bytes(8 * 100 - 1, 100) == cs.SHORT_SLAB_BYTES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("lead", [0, 1])
def test_spmm_width_limit_is_max_col_blocks_slabs(dtype, lead):
    # the limit the wrappers check: MAX_COL_BLOCKS slabs of a wide B's
    # slab width (one B row, ``lead`` elements into its storage; an empty
    # pattern, and nothing is launched)
    indptr = torch.zeros(1, dtype=torch.int64)
    cols = torch.zeros(0, dtype=torch.int64)
    path, _, width = cs.spmm_lanes(1 << 20, dtype, lead == 0)
    for p, ok in ((cs.MAX_COL_BLOCKS * width, True),
                  (cs.MAX_COL_BLOCKS * width + width, False)):
        B = torch.empty(lead + p, dtype=dtype)[lead:].view(1, p)
        assert (B.data_ptr() % 16 == 0) == (lead == 0)
        if ok:
            entry, _ = cs._spmm_launch_args("chunk_spmm", indptr, cols, B)
            assert entry.endswith(path)
        else:
            with pytest.raises(ValueError, match=f"p <= {p - width} "):
                cs._spmm_launch_args("chunk_spmm", indptr, cols, B)


# K7's (and K12a's) lanes and passes: (p, dtype, aligned, nnz, n) ->
# (path, lanes an entry, slab columns, passes).  The random cfd2 pattern
# (25 entries a row) takes two-line slabs, the hybrid85 residual (3.8)
# four-line ones.
LONG, SHORT = (3_087_898, 123_440), (463_169, 123_440)
PASSES = [
    (128, torch.float32, True, *LONG, "vec", 16, 64, 2),    # the main path
    (128, torch.float32, True, *SHORT, "vec", 32, 128, 1),  # one pass
    (64, torch.float32, True, *LONG, "vec", 16, 64, 1),
    (32, torch.float32, True, *LONG, "vec", 8, 32, 1),
    (16, torch.float32, True, *LONG, "vec", 4, 16, 1),      # 8 a round
    (130, torch.float32, True, *LONG, "scalar", 32, 32, 5),
    (128, torch.float32, False, *LONG, "scalar", 32, 32, 4),  # unaligned
    (128, torch.float32, False, *SHORT, "scalar", 32, 32, 4),
    (3, torch.float32, True, *LONG, "scalar", 4, 4, 1),
    (1, torch.float32, True, *LONG, "scalar", 1, 1, 1),
    (0, torch.float32, True, *LONG, "vec", 1, 4, 1),        # one pass
    (128, torch.bfloat16, True, *LONG, "vec", 16, 128, 1),
    (256, torch.bfloat16, True, *LONG, "vec", 16, 128, 2),
    (260, torch.bfloat16, True, *LONG, "scalar", 32, 32, 9),
    (128, torch.float64, True, *LONG, "vec", 16, 32, 4),
    (128, torch.float64, True, *SHORT, "vec", 32, 64, 2),
    (130, torch.float64, False, *SHORT, "scalar", 32, 32, 5),
]


@pytest.mark.parametrize("p,dtype,aligned,nnz,n,path,lanes,cols,passes",
                         PASSES)
def test_sddmm_passes_by_width_dtype_alignment_and_row_length(
        p, dtype, aligned, nnz, n, path, lanes, cols, passes):
    got_path, lg, got_cols, got_passes = cs.sddmm_passes(p, dtype, aligned,
                                                         nnz, n)
    assert (got_path, 1 << lg, got_cols, got_passes) == (path, lanes, cols,
                                                         passes)


@pytest.mark.parametrize("lead", [0, 1])
def test_sddmm_launch_args_read_alignment_of_both_operands(lead):
    # X and Y each 16-byte aligned or not: the vector path needs both
    # (1.5 entries a row: four-line slabs)
    indptr = torch.tensor([0, 2, 3])
    cols = torch.tensor([0, 1, 1])
    buf = torch.zeros(1 + 2 * 128)
    a, u = buf[:256].view(2, 128), buf[1:].view(2, 128)
    assert u.data_ptr() % 16 != 0
    X, Y = (a, u) if lead else (u, a)
    assert cs._sddmm_launch_args("k", indptr, cols, a, a) == ("vec", 5, 1)
    assert cs._sddmm_launch_args("k", indptr, cols, X, Y) == ("scalar", 5,
                                                              4)


def test_sddmm_row_limit_is_int32_columns():
    # the gathered operand's rows reach K7's 32-bit column indices (a
    # stride-0 view: nothing is allocated or launched)
    indptr = torch.zeros(2, dtype=torch.int64)
    cols = torch.zeros(0, dtype=torch.int64)
    X = torch.zeros(1, 4)
    for m, ok in ((cs.MAX_SDDMM_ROWS, True), (cs.MAX_SDDMM_ROWS + 1, False)):
        Y = torch.zeros(1, 4).expand(m, 4)
        if ok:
            assert cs._sddmm_launch_args("chunk_sddmm", indptr, cols, X, Y)
        else:
            with pytest.raises(ValueError, match=f"at most {m - 1} rows"):
                cs._sddmm_launch_args("chunk_sddmm", indptr, cols, X, Y)


def test_dispatch_takes_the_chunk_engine_only_where_it_should():
    A = random_container((40, 30), 200, "csr")
    assert ops._chunk_plan(A, "pallas") is not None
    assert ops._chunk_plan(A, "auto") is None        # CPU: generic branch
    assert ops._chunk_plan(A, "xla") is None
    assert ops._chunk_plan(A.tocoo().T, "pallas") is None   # unsorted


# --------------------------------------------------------------------------
# rand_sparse
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_rand_sparse(layout):
    A = rand_sparse((40, 30), 300, layout=layout, device="cpu")
    assert A.layout == layout and A.nnz == 300 and A.shape == (40, 30)
    r, c = A.rows().astype(np.int64), A.cols().astype(np.int64)
    assert len(np.unique(r * 30 + c)) == 300
    assert (np.diff(r * 30 + c) > 0).all()                  # row-major
    W = rand_sparse((25, 25), 120, layout=layout, well_conditioned=True,
                    dtype=torch.float64, device="cpu")
    d = W.todense()
    assert W.nnz == 120 and bool(
        (2 * d.diagonal().abs() > d.abs().sum(1)).all())
    S = rand_sparse((3, 10, 8), 20, layout=layout, shared_pattern=True,
                    device="cpu")
    assert not S.indices_batched() and S.values.shape == (3, 20)
    P = rand_sparse((2, 10, 8), 20, layout=layout, seed=4, device="cpu")
    assert P.indices_batched() and P.values.shape == (2, 20)
    np.testing.assert_array_equal(
        P.todense().numpy(), np.asarray(jax_of(P).todense()))
    assert rand_sparse((40, 30), 300, layout=layout, device="cpu"
                       ).rows().tolist() == A.rows().tolist()   # seeded
