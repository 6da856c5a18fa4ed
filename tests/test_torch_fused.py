"""PyTorch port: the fused chunk backward (K12) held against the JAX
package's ``chunk_spmm_bwd_fused``.

The plain version of the one-pass launcher, ``chunk_bwd_cols``, against
the JAX Pallas kernels run in interpret mode on the CPU (p = 3, 8 and
130, exact and fast) and against the two-pass definition it replaces
(V rows rounded to V's dtype, then summed in column order), written out
here; ``sparse_mm``'s gradients under ``kernels/dia.py:SPMM_BWD =
"fused"`` against the JAX package under ``TSGU_SPMM_BWD=fused``, on the
chunk path and on a hybrid residual with ``RESID_ENGINE = "chunk"``;
second derivatives and ``grad_precision`` against the split backward.
Inputs are numpy arrays from fixed seeds, handed to both packages.

Tolerances: float32 gradients ``1e-5/1e-5``, second derivatives
``1e-4/1e-5``, as in ``tests/test_torch_chunk.py``; ``"fast"`` rounds
each product to bfloat16 before the column sum, so gradB is held
against exact gradients at ``3e-2``, as in
``tests/test_pallas_kernels.py:test_fast_grad_precision``, and gradA
stays equal.
"""

import jax
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.kernels import chunk_spmm as jcs
from torchsparsegradutils_tpu.kernels import dia as jdia
from torchsparsegradutils_tpu.types import StaticArray as JStatic
from torchsparsegradutils_tpu_torch import SparseCSR, sparse_mm, to_arrays
from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
from torchsparsegradutils_tpu_torch.kernels import dia
from torchsparsegradutils_tpu_torch.types import StaticArray
from torchsparsegradutils_tpu_torch.utils.random_sparse import hybrid_sparse

GRAD32 = dict(rtol=1e-5, atol=1e-5)
HESS32 = dict(rtol=1e-4, atol=1e-5)
FAST = dict(rtol=3e-2, atol=3e-2)
RNG = np.random.default_rng(53)


def pattern(n, m, nnz, seed):
    """Row-major (rows, cols): ``nnz`` distinct uniform entries, row 3
    empty."""
    keys = np.sort(np.random.default_rng(seed).choice(n * m, nnz, False))
    rows, cols = keys // m, keys % m
    keep = rows != 3
    return rows[keep], cols[keep]


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(dia, "SPMM_BWD", "fused")
    monkeypatch.setenv("TSGU_SPMM_BWD", "fused")


@pytest.fixture
def pass_calls(monkeypatch):
    """Counts of the fused backward's plain version (the launcher runs
    it on CPU tensors): one a fused backward."""
    calls = {}
    fn = cs.chunk_bwd_cols_plain

    def counted(*args):
        calls["chunk_bwd_cols_plain"] = calls.get("chunk_bwd_cols_plain",
                                                  0) + 1
        return fn(*args)
    monkeypatch.setattr(cs, "chunk_bwd_cols_plain", counted)
    return calls


def test_plain_passes_match_jax_pallas():
    n, m = 60, 50
    rows, cols = pattern(n, m, 500, 1)
    jr, jc = JStatic(rows.astype(np.int32)), JStatic(cols.astype(np.int32))
    jp = jcs.build_chunk_plan(jr, jc, n, m)
    jpt = jcs.build_chunk_plan_transpose(jr, jc, n, m)
    plan = cs.build_chunk_plan(StaticArray(rows), StaticArray(cols), n, m)
    vals = RNG.standard_normal(plan.nnz).astype(np.float32)
    cases = [(p, fast) for p in (3, 8, 130) for fast in (False, True)]
    Bs = [RNG.standard_normal((m, p)).astype(np.float32) for p, _ in cases]
    Gs = [RNG.standard_normal((n, p)).astype(np.float32) for p, _ in cases]
    wants = jax.jit(lambda v, Bs, Gs: [
        jcs.chunk_spmm_bwd_fused(jp, jpt, v, B, G, fast=fast)
        for (_, fast), B, G in zip(cases, Bs, Gs)])(vals, Bs, Gs)
    t = torch.from_numpy
    dt = plan.T.maps("cpu")
    for (p, fast), B, G, (want_dd, want_dB) in zip(cases, Bs, Gs, wants):
        dd, dB = cs.chunk_bwd_cols_plain(dt["indptr"], dt["cols"],
                                         dt["perm"], dt["inv"], t(vals),
                                         t(B), t(G), fast)
        assert dd.dtype == dB.dtype == torch.float32
        assert dB.shape == (m, p)
        np.testing.assert_allclose(dd.numpy(), np.asarray(want_dd), **GRAD32)
        np.testing.assert_allclose(dB.numpy(), np.asarray(want_dB), **GRAD32)
        # the launcher on CPU tensors and the pair's entry points are it
        for got in (cs.chunk_bwd_cols(dt["indptr"], dt["cols"], dt["perm"],
                                      dt["inv"], t(vals), t(B), t(G), fast),
                    cs.chunk_bwd_fused(plan, plan.T, t(vals), t(B), t(G),
                                       fast),
                    cs.chunk_bwd_fused_plain(plan, plan.T, t(vals), t(B),
                                             t(G), fast)):
            assert torch.equal(got[0], dd) and torch.equal(got[1], dB)


def _hub_column_plan():
    """(n, m) = (45, 30): every fifth row and every seventh column
    empty, column 4 holding an entry of every other row (a long
    column), the rest random at 20 %."""
    n, m = 45, 30
    rng = np.random.default_rng(17)
    mask = rng.random((n, m)) < 0.2
    mask[:, 4] = True
    mask[::5, :] = False
    mask[:, ::7] = False
    rows, cols = np.nonzero(mask)
    return cs.build_chunk_plan(StaticArray(rows), StaticArray(cols), n, m)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("p", [0, 1, 3, 8, 130])
def test_plain_matches_two_pass_definition(p, fast):
    plan = _hub_column_plan()
    n, m = plan.n, plan.m
    assert np.diff(plan.T.indptr).max() == 36       # the long column
    assert (np.diff(plan.indptr) == 0).sum() == 9
    assert (np.diff(plan.T.indptr) == 0).sum() == 5
    rng = np.random.default_rng(100 + p)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    vals = t(rng.standard_normal(plan.nnz))
    B, G = t(rng.standard_normal((m, p))), t(rng.standard_normal((n, p)))
    dt = plan.T.maps("cpu")
    dd, dB = cs.chunk_bwd_cols_plain(dt["indptr"], dt["cols"], dt["perm"],
                                     dt["inv"], vals, B, G, fast)
    # the two passes it replaces: V[e] = vals[e] · G[row_e] stored in V's
    # dtype, then V's rows summed one by one in column order
    rows = np.repeat(np.arange(n), np.diff(plan.indptr))
    V = (vals[:, None] * G[torch.from_numpy(rows)]).to(
        torch.bfloat16 if fast else torch.float32).float()
    want = torch.zeros(m, p)
    for c in range(m):
        for d in range(plan.T.indptr[c], plan.T.indptr[c + 1]):
            want[c] += V[plan.T.perm[d]]
    np.testing.assert_allclose(dB.numpy(), want.numpy(), **GRAD32)
    d = plan.maps("cpu")
    assert torch.equal(dd, cs.chunk_sddmm_plain(d["indptr"], d["cols"], G,
                                                B))
    assert dd.shape == (plan.nnz,) and dB.shape == (m, p)


def grads(A, B, G, second=False, **kw):
    """Output, gradients (and second derivatives) of ``sparse_mm``."""
    v = A.values.detach().clone().requires_grad_(True)
    b = torch.from_numpy(B).requires_grad_(True)
    out = sparse_mm(A.with_data(v), b, **kw)
    gv, gb = torch.autograd.grad(out, (v, b), torch.from_numpy(G),
                                 create_graph=second)
    res = [out, gv, gb]
    if second:
        res += torch.autograd.grad((gv ** 2).sum() + (gb ** 2).sum(),
                                   (v, b))
    return [x.detach().numpy() for x in res]


def chunk_case():
    n, m = 70, 50
    rows, cols = pattern(n, m, 600, 2)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    A = SparseCSR(indptr.astype(np.int32), cols.astype(np.int32),
                  torch.from_numpy(RNG.standard_normal(len(rows)).astype(
                      np.float32)), (n, m), device="cpu")
    return A, RNG.standard_normal((m, 6)).astype(np.float32), \
        RNG.standard_normal((n, 6)).astype(np.float32)


@pytest.mark.parametrize("grad_precision", ["exact", "fast"])
def test_sparse_mm_fused_matches_jax(fused, pass_calls, grad_precision):
    A, B, G = chunk_case()
    lay, i0, i1, data, shape = to_arrays(A)
    Aj = tj.SparseCSR(i0, i1, data, shape)

    def f(d, b):
        return tj.sparse_mm(Aj.with_data(d), b, backend="pallas",
                            grad_precision=grad_precision)

    want = jax.jit(lambda d, b, g: (f(d, b), *jax.vjp(f, d, b)[1](g)))(
        data, B, G)
    got = grads(A, B, G, backend="pallas", grad_precision=grad_precision)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, np.asarray(w_), **GRAD32)
    assert pass_calls == {"chunk_bwd_cols_plain": 1}
    split = grads(A, B, G, backend="xla")      # exact gradients
    np.testing.assert_allclose(got[1], split[1], **GRAD32)
    np.testing.assert_allclose(got[2], split[2],
                               **(FAST if grad_precision == "fast"
                                  else GRAD32))


def test_second_derivatives_under_fused_match_split(monkeypatch, pass_calls):
    A, B, G = chunk_case()
    split = grads(A, B, G, second=True, backend="pallas")
    assert pass_calls == {}
    monkeypatch.setattr(dia, "SPMM_BWD", "fused")
    got = grads(A, B, G, second=True, backend="pallas")
    assert pass_calls == {"chunk_bwd_cols_plain": 1}
    for g_, w_, tol in zip(got, split, (GRAD32, GRAD32, GRAD32, HESS32,
                                        HESS32)):
        np.testing.assert_allclose(g_, w_, **tol)
    rows, cols = pattern(7, 5, 16, 3)
    plan = cs.build_chunk_plan(StaticArray(rows), StaticArray(cols), 7, 5)
    args = [torch.from_numpy(RNG.standard_normal(s)).requires_grad_()
            for s in ((plan.nnz,), (5, 2), (7, 2))]
    f = lambda v, b, g: cs.ChunkBwdPair.apply(plan, False, v, b, g)
    assert torch.autograd.gradcheck(f, args)
    assert torch.autograd.gradgradcheck(f, args)


def test_hybrid_residual_fused_matches_jax(fused, pass_calls, monkeypatch):
    # the whole DIA path of the JAX package runs its window-gather kernel
    # in interpret mode, seconds a call: its XLA branch is the same map
    monkeypatch.setattr(dia, "RESID_ENGINE", "chunk")
    monkeypatch.setenv("TSGU_RESID_ENGINE", "chunk")
    monkeypatch.setattr(jdia, "_use_pallas_grid", lambda dtype: False)
    H = hybrid_sparse((200, 200), [-7, -1, 0, 1, 7], 1200,
                      dia_coverage=0.8, generator=torch.Generator(
                          ).manual_seed(5), device="cpu")
    lay, i0, i1, data, shape = to_arrays(H)
    Hj = tj.SparseCSR(i0, i1, data, shape)
    pt = dia.build_dia_plan(H.row_sa(), H.col_sa(), 200, 200)
    pj = jdia.build_dia_plan(Hj.row_sa(), Hj.col_sa(), 200, 200)
    assert pt.is_hybrid and dia._resid_chunk_ok(pt, torch.device("cpu"))
    B = RNG.standard_normal((200, 5)).astype(np.float32)
    G = RNG.standard_normal((200, 5)).astype(np.float32)
    t = torch.from_numpy
    for fast in (False, True):
        want = jax.jit(lambda d, b, g: jdia.dia_bwd_pair(pj, d, b, g,
                                                         fast=fast))(
            data, B, G)
        got = dia.dia_bwd_pair(pt, H.values, t(B), t(G), fast=fast)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **GRAD32)
    assert pass_calls == {"chunk_bwd_cols_plain": 2}
    # sparse_mm's own backward takes the fused residual too
    got = grads(H, B, G, second=True)
    monkeypatch.setattr(dia, "SPMM_BWD", "split")
    for g_, w_, tol in zip(got, grads(H, B, G, second=True),
                           (GRAD32, GRAD32, GRAD32, HESS32, HESS32)):
        np.testing.assert_allclose(g_, w_, **tol)
    assert pass_calls == {"chunk_bwd_cols_plain": 3}


def test_switch_values():
    assert dia.SPMM_BWD == "split"
    assert dia.chunk_bwd_fused_arg("fast") is None


def test_switch_refuses_unknown_modes(monkeypatch):
    monkeypatch.setattr(dia, "SPMM_BWD", "fusd")
    with pytest.raises(ValueError, match="SPMM_BWD"):
        dia.chunk_bwd_fused_arg()
    monkeypatch.setattr(dia, "SPMM_BWD", "fused")
    assert dia.chunk_bwd_fused_arg("fast") is True
    assert dia.chunk_bwd_fused_arg("exact") is False


def test_pass_wrappers_refuse_non_cpu_tensors():
    idx = torch.zeros(3, dtype=torch.int64, device="meta")
    v = torch.empty(2, device="meta")
    M = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cs.chunk_bwd_cols(idx, idx[:2], idx[:2], idx[:2], v, M, M)
    with pytest.raises(ValueError, match="CUDA device"):
        cs.chunk_bwd_cols(idx, idx[:2], idx[:2], idx[:2], v, M, M, True)
    # CPU indices with tensors elsewhere: no quiet plain version either
    cpu = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA device"):
        cs.chunk_bwd_cols(cpu, cpu[:2], cpu[:2], cpu[:2], v, M, M)
