"""PyTorch port: ``utils/structure.py`` held against the JAX package.

The eight cases of the JAX package's ``tests/test_structure.py``, on
numpy patterns and values from fixed seeds handed to both packages:
patterns must be equal, and values and gradients equal to float32
rounding (``rtol=1e-6, atol=1e-7``: both only move and add values).  The
JAX case on a traced (dynamic) pattern has no counterpart, since the
port's patterns are always host numpy; in its place ``coo_to_csr`` of an
unsorted pattern with duplicate-free random order, with the gradient
through the value permutation (the gather by the inverse permutation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu import utils as ju
from torchsparsegradutils_tpu_torch import SparseCOO, SparseCSR, from_arrays
from torchsparsegradutils_tpu_torch import utils as pu
from torchsparsegradutils_tpu_torch.kernels import window_gather as wg

TOL = dict(rtol=1e-6, atol=1e-7)


def _coo_arrays(seed, shape, nnz, batch=(), shared=True):
    """Distinct random coordinates in random (unsorted) order, and
    float32 values."""
    rng = np.random.default_rng(seed)
    n, m = shape

    def one():
        flat = rng.choice(n * m, nnz, replace=False)
        return (flat // m).astype(np.int32), (flat % m).astype(np.int32)
    if batch and not shared:
        pats = [one() for _ in range(int(np.prod(batch)))]
        rows = np.stack([p[0] for p in pats]).reshape(batch + (nnz,))
        cols = np.stack([p[1] for p in pats]).reshape(batch + (nnz,))
    else:
        rows, cols = one()
    vals = rng.standard_normal(batch + (nnz,)).astype(np.float32)
    return rows, cols, vals


def _pair(seed, shape, nnz, layout="coo", batch=(), shared=True):
    """The same matrix in both packages (CSR through JAX's conversion)."""
    rows, cols, vals = _coo_arrays(seed, shape, nnz, batch, shared)
    full = batch + tuple(shape)
    Aj = tj.SparseCOO(rows, cols, jnp.asarray(vals), full)
    if layout == "csr":
        Aj = ju.coo_to_csr(Aj)
        return Aj, from_arrays("csr", Aj.indptr_np(), Aj.cols_np(),
                               np.asarray(Aj.data), full, device="cpu")
    return Aj, from_arrays("coo", rows, cols, vals, full, device="cpu")


def _same(P, J):
    """Port container P equals JAX container J: layout, shape, pattern,
    values."""
    assert P.layout == J.layout and P.shape == J.shape
    if P.layout == "coo":
        np.testing.assert_array_equal(P.rows(), J.rows_np())
    else:
        np.testing.assert_array_equal(P.indptr_np(), J.indptr_np())
    np.testing.assert_array_equal(P.cols(), J.cols_np())
    np.testing.assert_allclose(P.values.detach().numpy(), np.asarray(J.data),
                               **TOL)


def test_coo_csr_roundtrip():
    Aj, A = _pair(0, (8, 6), 17)
    C = pu.coo_to_csr(A)
    _same(C, ju.coo_to_csr(Aj))
    _same(pu.csr_to_coo(C), ju.csr_to_coo(ju.coo_to_csr(Aj)))
    torch.testing.assert_close(pu.csr_to_coo(C).todense(), A.todense())
    indptr, cols, perm = pu.convert_coo_to_csr_indices_values(A)
    for got, ref in zip((indptr, cols, perm),
                        ju.coo_to_csr_indices_values(Aj)):
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_coo_to_csr_gradient_is_the_inverse_gather(monkeypatch):
    """The gradient through the value permutation equals JAX's, and runs
    as the gather kernel's plain version by the inverse permutation."""
    Aj, A = _pair(1, (6, 6), 10)
    rng = np.random.default_rng(2)
    w = rng.standard_normal(10).astype(np.float32)
    ref = jax.grad(lambda d: (ju.coo_to_csr(Aj.with_data(d)).data
                              * w).sum())(Aj.data)
    calls = []
    plain = wg.window_gather_plain
    monkeypatch.setattr(wg, "window_gather_plain",
                        lambda s, i: calls.append(len(i)) or plain(s, i))
    v = A.values.clone().requires_grad_(True)
    C = pu.coo_to_csr(A.with_data(v))
    (g,) = torch.autograd.grad((C.values * torch.from_numpy(w)).sum(), v)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), **TOL)
    assert calls == [10, 10]           # forward gather, backward gather


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_block_diag_and_split(layout):
    pairs = [_pair(10 + i, (4 + i, 3 + i), 6 + i, layout) for i in range(3)]
    bd = pu.sparse_block_diag(*[p for _, p in pairs])
    _same(bd, ju.sparse_block_diag(*[j for j, _ in pairs]))
    assert bd.shape == (4 + 5 + 6, 3 + 4 + 5)
    parts = pu.sparse_block_diag_split(bd, *[p.shape for _, p in pairs])
    for part, (_, p) in zip(parts, pairs):
        torch.testing.assert_close(part.todense(), p.todense())
    refs = ju.sparse_block_diag_split(
        ju.sparse_block_diag(*[j for j, _ in pairs]),
        *[p.shape for _, p in pairs])
    for part, ref in zip(parts, refs):
        _same(part, ref)


def test_block_diag_from_batched():
    Aj, A = _pair(3, (4, 4), 5, batch=(3,), shared=False)
    bd = pu.sparse_block_diag(A)
    assert bd.shape == (12, 12)
    _same(bd, ju.sparse_block_diag(Aj))
    with pytest.raises(ValueError, match="share a layout"):
        pu.sparse_block_diag(_pair(4, (3, 3), 3)[1],
                             _pair(4, (3, 3), 3, "csr")[1])


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_sparse_eye(layout):
    for shape in ((5, 5), (2, 4, 4)):
        got = pu.sparse_eye(shape, layout=layout, device="cpu")
        _same(got, ju.sparse_eye(shape, layout=layout))
    with pytest.raises(ValueError, match="square trailing shape"):
        pu.sparse_eye((3, 4), device="cpu")


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_sparse_stack(layout):
    base_j, base = _pair(5, (5, 5), 8, layout)
    rng = np.random.default_rng(6)
    vals = rng.standard_normal((3, 8)).astype(np.float32)
    st = pu.stack_csr([base.with_data(torch.from_numpy(v)) for v in vals])
    ref = ju.sparse_stack([base_j.with_data(jnp.asarray(v)) for v in vals])
    _same(st, ref)
    assert not st.indices_batched()
    pairs = [_pair(20 + i, (5, 5), 8, layout) for i in range(3)]
    st2 = pu.sparse_stack([p for _, p in pairs])
    _same(st2, ju.sparse_stack([j for j, _ in pairs]))
    assert st2.indices_batched()
    with pytest.raises(ValueError, match="share layout, shape, and nnz"):
        pu.sparse_stack([base, _pair(7, (5, 5), 7, layout)[1]])


def test_coalesce():
    row = np.array([0, 0, 1, 1, 0])
    col = np.array([1, 1, 2, 2, 0])
    data = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    v = torch.from_numpy(data).requires_grad_(True)
    co = pu.coalesce(SparseCOO(row, col, v, (3, 3)))
    ref = ju.coalesce(tj.SparseCOO(row, col, jnp.asarray(data), (3, 3)))
    assert co.nnz == 3
    _same(co, ref)
    (g,) = torch.autograd.grad(co.values.sum(), v)
    assert g.tolist() == [1.0] * 5
    # batched values over one pattern, and per-element patterns
    bv = np.stack([data, 2 * data])
    _same(pu.coalesce(SparseCOO(row, col, torch.from_numpy(bv), (2, 3, 3))),
          ju.coalesce(tj.SparseCOO(row, col, jnp.asarray(bv), (2, 3, 3))))
    rows = np.stack([row, row[::-1]])
    cols = np.stack([col, col[::-1]])
    _same(pu.coalesce(SparseCOO(rows, cols, torch.from_numpy(bv),
                                (2, 3, 3))),
          ju.coalesce(tj.SparseCOO(rows, cols, jnp.asarray(bv), (2, 3, 3))))
    uneven = np.stack([row, np.array([0, 1, 2, 1, 0])])
    with pytest.raises(ValueError, match="unequal nnz"):
        pu.coalesce(SparseCOO(uneven, cols, torch.from_numpy(bv),
                              (2, 3, 3)))


def test_csr_transpose_batched():
    Aj, A = _pair(8, (4, 6), 7, "csr", batch=(2,), shared=False)
    t = pu.csr_transpose(A)
    assert isinstance(t, SparseCSR) and t.shape == (2, 6, 4)
    _same(t, ju.csr_transpose(Aj))
    torch.testing.assert_close(t.todense(), A.todense().transpose(1, 2))
    _same(A.T, Aj.T)


@pytest.mark.parametrize("module_name", [
    "torchsparsegradutils_tpu_torch.utils.structure",
    "torchsparsegradutils_tpu_torch.ops.indexed_matmul",
    "torchsparsegradutils_tpu_torch.models.distributions",
])
def test_docstring_examples(module_name):
    import doctest
    import importlib
    result = doctest.testmod(importlib.import_module(module_name),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0
