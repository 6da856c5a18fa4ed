"""PyTorch port: containers, the carry-across functions, the package's
import boundary and the kernel wrappers' refusal to fall back.

Each matrix is a JAX container (built from numpy arrays with a fixed
seed), carried across with numpy (``np.asarray`` into ``from_arrays``)
and compared with the JAX container's own dense form.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsparsegradutils_tpu import SparseCOO as JCOO
from torchsparsegradutils_tpu import SparseCSR as JCSR
from torchsparsegradutils_tpu_torch import (SparseCOO, SparseCSR,
                                            from_arrays, to_arrays)
from torchsparsegradutils_tpu_torch.kernels import _build
from torchsparsegradutils_tpu_torch.kernels.dia import (build_dia_plan,
                                                        sddmm_core,
                                                        spmm_core)
from torchsparsegradutils_tpu_torch.kernels.window_gather import (
    window_gather)
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    stencil_sparse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand_sparse(shape, nnz, layout="coo", index_dtype=np.int32, seed=0):
    """JAX container with a uniform random pattern, made with numpy."""
    rng = np.random.default_rng(seed)
    *batch, n, m = shape
    pats = [np.sort(rng.choice(n * m, nnz, replace=False))
            for _ in range(int(np.prod(batch)) or 1)]
    rows = np.stack([k // m for k in pats]).reshape(*batch, nnz)
    cols = np.stack([k % m for k in pats]).reshape(*batch, nnz)
    data = rng.standard_normal((*batch, nnz)).astype(np.float32)
    idt = np.dtype(index_dtype)
    if layout == "coo":
        return JCOO(rows.astype(idt), cols.astype(idt), data, shape)
    indptr = np.stack([np.concatenate([[0], np.cumsum(np.bincount(
        r, minlength=n))]) for r in rows.reshape(-1, nnz)])
    indptr = indptr.reshape(*batch, n + 1).astype(idt)
    return JCSR(indptr, cols.astype(idt), data, shape)


def port(Aj):
    """The JAX container ``Aj`` as a port container on the CPU."""
    if Aj.layout == "csr":
        idx0 = Aj.indptr_np()
    else:
        idx0 = Aj.rows_np()
    return from_arrays(Aj.layout, idx0, Aj.cols_np(), np.asarray(Aj.data),
                       Aj.shape, device="cpu")


@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("index_dtype", [jnp.int32, jnp.int64])
def test_round_trip_with_jax_containers(layout, index_dtype):
    Aj = rand_sparse((9, 7), 20, layout, index_dtype)
    A = port(Aj)
    assert A.layout == layout and A.shape == (9, 7) and A.nnz == 20
    assert A.index_dtype() == np.dtype(index_dtype)   # kept as given
    np.testing.assert_array_equal(A.todense().numpy(),
                                  np.asarray(Aj.todense()))
    lay, i0, i1, data, shape = to_arrays(A)
    back = (JCOO if lay == "coo" else JCSR)(i0, i1, data, shape)
    np.testing.assert_array_equal(np.asarray(back.todense()),
                                  np.asarray(Aj.todense()))
    np.testing.assert_array_equal(A.rows(), Aj.rows_np())


def test_batched_round_trip_per_element_and_shared():
    Aj = rand_sparse((3, 6, 5), 8, "csr")                  # per element
    A = port(Aj)
    assert A.indices_batched() and A.values.shape == (3, 8)
    np.testing.assert_array_equal(A.todense().numpy(),
                                  np.asarray(Aj.todense()))
    one = rand_sparse((6, 5), 8)
    S = JCOO(one.rows_np(), one.cols_np(), np.stack([one.data, -one.data]),
             (2, 6, 5))                                     # shared
    As = port(S)
    assert not As.indices_batched()
    np.testing.assert_array_equal(As.todense().numpy(),
                                  np.asarray(S.todense()))


def test_csc_round_trip_with_jax_containers():
    from torchsparsegradutils_tpu import SparseCSC as JCSC
    from torchsparsegradutils_tpu_torch import SparseCSC
    At = rand_sparse((7, 9), 20, "csr")           # the CSR of Aᵀ
    Aj = JCSC(At.indptr_np(), At.cols_np(), np.asarray(At.data), (9, 7))
    A = from_arrays("csc", At.indptr_np(), At.cols_np(),
                    np.asarray(At.data), (9, 7), device="cpu")
    assert isinstance(A, SparseCSC) and A.layout == "csc"
    assert (A.shape, A.nnz, A.ndim) == ((9, 7), 20, 2)
    np.testing.assert_array_equal(A.todense().numpy(),
                                  np.asarray(Aj.todense()))
    lay, i0, i1, data, shape = to_arrays(A)
    assert lay == "csc" and shape == (9, 7)
    np.testing.assert_array_equal(
        np.asarray(JCSC(i0, i1, data, shape).todense()),
        np.asarray(Aj.todense()))
    assert A.transpose_csr().shape == (7, 9)
    B = A.with_data(2 * A.values)
    assert B.indptr is A.indptr and B.shape == A.shape
    np.testing.assert_array_equal(B.todense().numpy(),
                                  2 * A.todense().numpy())
    with pytest.raises(ValueError, match="2-D"):
        SparseCSC(At.indptr_np(), At.cols_np(), np.asarray(At.data),
                  (1, 9, 7))


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_transpose_matches_jax(layout):
    Aj = rand_sparse((8, 11), 25, layout)
    At = port(Aj).T
    assert At.shape == (11, 8) and At.layout == layout
    np.testing.assert_array_equal(At.todense().numpy(),
                                  np.asarray(Aj.todense()).T)


def test_fromdense_and_tocsr():
    x = np.asarray(rand_sparse((6, 6), 12).todense())
    A = SparseCOO.fromdense(x, device="cpu")
    Aj = JCOO.fromdense(x)
    np.testing.assert_array_equal(A.rows(), Aj.rows_np())
    np.testing.assert_array_equal(A.cols(), Aj.cols_np())
    C = SparseCSR.fromdense(torch.from_numpy(x))
    np.testing.assert_array_equal(C.indptr_np(), Aj.tocsr().indptr_np())
    np.testing.assert_array_equal(C.todense().numpy(), x)
    padded = SparseCOO.fromdense(x, nnz=15, device="cpu")
    assert padded.nnz == 15
    np.testing.assert_array_equal(padded.todense().numpy(), x)
    xb = np.stack([x, 2 * x])
    Ab = SparseCOO.fromdense(xb, device="cpu")
    assert not Ab.indices_batched() and Ab.values.shape == (2, 12)
    np.testing.assert_array_equal(Ab.todense().numpy(), xb)
    xp = np.stack([x, x.T])                      # per-element patterns
    Cp = SparseCSR.fromdense(xp, device="cpu")
    assert Cp.indices_batched() and Cp.indptr_np().shape == (2, 7)
    np.testing.assert_array_equal(Cp.todense().numpy(), xp)


def test_fromdense_keeps_values_differentiable():
    x = torch.tensor([[0.0, 2.0], [3.0, 0.0]], requires_grad=True)
    A = SparseCOO.fromdense(x)
    A.values.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[0, 1], [1, 0]])


def test_bfloat16_values_carry_across():
    one = rand_sparse((16, 16), 40)
    Aj = one.with_data(jnp.asarray(one.data, jnp.bfloat16))
    A = port(Aj)
    assert A.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        A.values.float().numpy(), np.asarray(Aj.data, np.float32))
    assert to_arrays(A)[3].dtype == np.float32


def test_pattern_hash_shares_plans():
    A = stencil_sparse((40, 40), [-3, 0, 3], device="cpu")
    B = from_arrays(*to_arrays(A), device="cpu")
    assert A.row_sa() == B.row_sa() and hash(A.col_sa()) == hash(
        B.col_sa())
    p1 = build_dia_plan(A.row_sa(), A.col_sa(), 40, 40)
    p2 = build_dia_plan(B.with_data(B.values * 2).row_sa(), B.col_sa(), 40,
                        40)
    assert p1 is not None and p1 is p2
    # device index tensors are made once per pattern and device
    assert A.rows_t() is A.with_data(A.values + 1).rows_t()


def test_container_checks():
    with pytest.raises(ValueError, match="nnz=3"):
        SparseCOO(np.array([0, 1]), np.array([0, 1]), torch.ones(3), (2, 2))
    with pytest.raises(ValueError, match="integer dtype"):
        SparseCOO(np.array([0.0]), np.array([0]), torch.ones(1), (2, 2))
    with pytest.raises(ValueError, match="indptr last dim"):
        SparseCSR(np.array([0, 1]), np.array([0]), torch.ones(1), (2, 2))


def test_import_leaves_jax_out():
    code = ("import sys, torchsparsegradutils_tpu_torch\n"
            "bad = [k for k in sys.modules if k in ('jax', "
            "'torchsparsegradutils_tpu') or k.startswith(("
            "'jax.', 'torchsparsegradutils_tpu.'))]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_wrappers_refuse_non_cpu_tensors_without_fallback():
    # a tensor off the CPU never takes the plain version: here the meta
    # device, which no kernel takes, raises instead of computing
    offs = torch.zeros(1, dtype=torch.int64, device="meta")
    g = torch.empty(4, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        spmm_core(offs, g, torch.empty(4, 2, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        sddmm_core(offs, torch.empty(4, 2, device="meta"),
                   torch.empty(4, 2, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        window_gather(torch.empty(3, device="meta"), offs)


def test_default_device_is_the_card_without_cpu_fallback():
    # the port's entry points run on the card unless the caller asks for
    # the CPU: with no CUDA, a container built with no device raises
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        SparseCOO(np.array([0]), np.array([0]), np.array([1.0], np.float32),
                  (1, 1))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.build()


def test_build_key_follows_sources():
    key = _build._source_key()
    assert len(key) == 16 and key == _build._source_key()
    assert {f"{k}.cu" for k in _build.KERNELS} <= {
        f.name for f in _build.CSRC.iterdir()}


@pytest.mark.parametrize("module_name", [
    "torchsparsegradutils_tpu_torch.convert",
    "torchsparsegradutils_tpu_torch.ops.spmm",
    "torchsparsegradutils_tpu_torch.kernels.dia",
    "torchsparsegradutils_tpu_torch.kernels.chunk_spmm",
    "torchsparsegradutils_tpu_torch.kernels.window_gather",
    "torchsparsegradutils_tpu_torch.kernels.grid_lse",
    "torchsparsegradutils_tpu_torch.kernels.chunk_lse",
    "torchsparsegradutils_tpu_torch.ops.logsumexp",
    "torchsparsegradutils_tpu_torch.utils.random_sparse",
    "torchsparsegradutils_tpu_torch.solvers",
    "torchsparsegradutils_tpu_torch.ops.solve",
    "torchsparsegradutils_tpu_torch.ops.lstsq",
    "torchsparsegradutils_tpu_torch.kernels.ell",
    "torchsparsegradutils_tpu_torch.kernels.explain",
    "torchsparsegradutils_tpu_torch.interop.torch_bridge",
    "torchsparsegradutils_tpu_torch.interop.scipy_solve",
])
def test_docstring_examples(module_name):
    import doctest
    import importlib
    result = doctest.testmod(importlib.import_module(module_name),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0
