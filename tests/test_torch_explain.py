"""PyTorch port: ``explain`` held against the JAX package's.

Both packages get the same patterns (numpy, fixed seeds).  The
``pattern`` section must be equal, and each op family's engine must be
JAX's where the two packages' gates agree.  They agree on the CPU, where
neither takes a fast route off the DIA engine, and on the card's gates
(JAX's ``dispatch.on_tpu()`` made True; the port's routes read
``"pallas"`` for ``"auto"``, as they do for A on the card) for p >= 32.
The deliberate differences are listed in ``DIFFERENCES`` and each is
tested: float64 runs on the kernels (JAX reports ``xla``); the chunk
engine takes every p (JAX's op gates at 32, its report at 8); no ``core``
(the TPU's MXU or VPU split); the triangular solve's wave/block choice
is the solve's own gate (JAX's report uses a gate of its own).  The
``kernels`` the report names are the ones the route calls, spied on the
CPU on the wrappers' plain paths.
"""

import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.kernels import dispatch as jax_dispatch
from torchsparsegradutils_tpu_torch import SparseCSR, explain, sddmm, sparse_mm
from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
from torchsparsegradutils_tpu_torch.kernels import dia
from torchsparsegradutils_tpu_torch.kernels import window_gather as wg
from torchsparsegradutils_tpu_torch.kernels.explain import KERNELS
from torchsparsegradutils_tpu_torch.ops import logsumexp as lse
from torchsparsegradutils_tpu_torch.ops import spmm

N = 300
OPS = ("sparse_mm", "sddmm", "sparse_logsumexp", "matvec")
DIFFERENCES = {
    "float64": "runs on the DIA, chunk and LSE kernels; JAX reports xla",
    "p_gate": "the chunk engine takes every p; JAX's op needs p >= 32, "
              "its report p >= MIN_P_PALLAS (8)",
    "core": "no MXU/VPU split: the port's report has no 'core'",
    "tri_gate": "wave or block by the solve's own gate (WAVE_GATE, "
                "TRI_SKEW); JAX's report has a gate of its own",
}


def _csr(rows, cols, seed, dtype=np.float32, shape=(N, N)):
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=shape[0]))]).astype(np.int32)
    vals = np.random.default_rng(seed).standard_normal(len(rows)).astype(
        dtype)
    return (SparseCSR(indptr, cols.astype(np.int32), torch.from_numpy(vals),
                      shape),
            tj.SparseCSR(indptr, cols.astype(np.int32), vals, shape))


def _stencil(offsets, seed=0, dtype=np.float32):
    r = np.arange(N)
    rows = np.concatenate([r[(r + o >= 0) & (r + o < N)] for o in offsets])
    cols = np.concatenate([r[(r + o >= 0) & (r + o < N)] + o
                           for o in offsets])
    return _csr(rows, cols, seed, dtype)


def _random(nnz, seed, lower=False):
    rng = np.random.default_rng(seed)
    keys = rng.choice(N * N, nnz, replace=False)
    rows, cols = keys // N, keys % N
    if lower:
        rows, cols = np.maximum(rows, cols), np.minimum(rows, cols)
        keys = np.unique(np.concatenate([rows * N + cols,
                                         np.arange(N) * (N + 1)]))
        rows, cols = keys // N, keys % N
    return _csr(rows, cols, seed)


def _hybrid(seed=3):
    A, _ = _stencil((-17, -1, 0, 1, 17))
    rng = np.random.default_rng(seed)
    keys = np.union1d(A.rows() * N + A.cols(),
                      rng.choice(N * N, A.nnz // 6, replace=False))
    return _csr(keys // N, keys % N, seed)


CASES = {
    "stencil": lambda: _stencil((-17, -1, 0, 1, 17)),
    "random": lambda: _random(3000, 1),
    "hybrid": _hybrid,
    "banded_lower": lambda: _stencil((-9, -1, 0)),
    "banded_upper": lambda: _stencil((0, 2, 30)),
    "random_lower": lambda: _random(2500, 2, lower=True),
}


@pytest.fixture
def card_gates(monkeypatch):
    """The card's gates on CPU tensors: JAX's ``on_tpu()`` True, the
    port's chunk and LSE routes reading ``"pallas"`` for ``"auto"``."""
    monkeypatch.setattr(jax_dispatch, "on_tpu", lambda: True)
    chunk_plan, fast_ok = spmm._chunk_plan, lse._fast_route_ok

    def as_card(fn):
        return lambda A, backend, *a: fn(
            A, "pallas" if backend == "auto" else backend, *a)
    monkeypatch.setattr(spmm, "_chunk_plan", as_card(chunk_plan))
    monkeypatch.setattr(lse, "_fast_route_ok", as_card(fast_ok))


@pytest.mark.parametrize("name", list(CASES))
def test_pattern_section_equals_jax(name):
    A, J = CASES[name]()
    got, ref = explain(A)["pattern"], tj.explain(J)["pattern"]
    assert got == ref


@pytest.mark.parametrize("name", list(CASES))
def test_engines_equal_jax_on_the_cpu(name):
    A, J = CASES[name]()
    got, ref = explain(A), tj.explain(J)
    assert {op: got[op]["engine"] for op in OPS} == {
        op: ref[op]["engine"] for op in OPS}
    assert ("triangular_solve" in got) == ("triangular_solve" in ref)
    if "triangular_solve" in ref:
        assert got["triangular_solve"]["triangular"] == \
            ref["triangular_solve"]["triangular"]
        if ref["triangular_solve"]["engine"] == "dia":
            assert got["triangular_solve"]["engine"] == "dia"


@pytest.mark.parametrize("name", ["stencil", "random", "hybrid"])
def test_engines_equal_jax_on_the_cards_gates(card_gates, name):
    A, J = CASES[name]()
    got, ref = explain(A, p=128), tj.explain(J, p=128)
    assert {op: got[op]["engine"] for op in OPS} == {
        op: ref[op]["engine"] for op in OPS}
    if name == "random":
        assert got["sparse_mm"]["engine"] == "pallas-chunk"
        assert got["sparse_logsumexp"]["route"] == "grid"


def test_difference_float64_runs_on_the_kernels(enable_x64):
    A, J = _stencil((-17, -1, 0, 1, 17), dtype=np.float64)
    got = explain(A)
    assert DIFFERENCES["float64"]
    assert {got[op]["engine"] for op in OPS} == {"dia"}
    assert {tj.explain(J)[op]["engine"] for op in OPS} == {"xla"}


def test_difference_no_p_gate(card_gates):
    A, J = CASES["random"]()
    assert DIFFERENCES["p_gate"]
    got, ref = explain(A, p=4), tj.explain(J, p=4)
    assert ref["sparse_mm"]["engine"] == "xla"
    assert got["sparse_mm"]["engine"] == "pallas-chunk"
    assert got["sparse_mm"]["kernels"] == ["K6", "K7", "K3"]
    assert explain(A, p=1)["sparse_mm"]["kernels"][0] == "K8"


def test_difference_no_core():
    A, J = CASES["stencil"]()
    assert DIFFERENCES["core"]
    assert "core" in tj.explain(J)["sparse_mm"]
    assert "core" not in explain(A)["sparse_mm"]


def test_difference_tri_gate_is_the_solves():
    from torchsparsegradutils_tpu_torch.ops import triangular_solve as ts
    A, _ = CASES["random_lower"]()
    assert DIFFERENCES["tri_gate"]
    got = explain(A)["triangular_solve"]
    assert got["engine"] == ts.tri_route(A, A.dtype, upper=False)
    assert got["engine"] in ("wave", "block") and got["kernels"] == []


def test_kernels_are_named_and_the_fused_switch_shows(card_gates,
                                                      monkeypatch):
    A, _ = CASES["hybrid"]()
    for name in CASES:
        rep = explain(CASES[name]()[0])
        for op in rep:
            assert set(rep[op].get("kernels", [])) <= set(KERNELS), op
    monkeypatch.setattr(dia, "RESID_ENGINE", "chunk")
    assert explain(A)["sparse_mm"]["kernels"] == ["K3", "K1", "K2", "K6",
                                                  "K7"]
    monkeypatch.setattr(dia, "SPMM_BWD", "fused")
    R, _ = CASES["random"]()
    assert explain(R)["sparse_mm"]["kernels"] == ["K6", "K12", "K3"]


def _spy(monkeypatch):
    """Which kernels' wrappers ran (their plain paths on the CPU)."""
    seen = set()
    for label, mod, name in (("K1", dia, "spmm_core"),
                             ("K2", dia, "sddmm_core"),
                             ("K3", wg, "window_gather"),
                             ("K6", cs, "chunk_spmm"),
                             ("K7", cs, "chunk_sddmm"),
                             ("K8", cs, "chunk_spmv")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _label=label, **k):
            seen.add(_label)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("name,p", [("stencil", 4), ("random", 4),
                                    ("random", 1)])
def test_kernels_are_the_routes_calls(card_gates, monkeypatch, name, p):
    A, _ = CASES[name]()
    rep = explain(A, p=p)
    seen = _spy(monkeypatch)
    v = A.values.clone().requires_grad_(True)
    B = torch.randn(N, p, requires_grad=True)
    sparse_mm(A.with_data(v), B).sum().backward()
    assert seen == set(rep["sparse_mm"]["kernels"])
    seen.clear()
    X = torch.randn(N, p, requires_grad=True)
    sddmm(A, X, B).values.sum().backward()
    assert seen == set(rep["sddmm"]["kernels"])


def test_refuses_batched_and_dense():
    A, _ = CASES["random"]()
    batched = SparseCSR(A.indptr, A.indices,
                        torch.stack([A.values, A.values]), (2, N, N))
    with pytest.raises(ValueError, match="unbatched 2-D"):
        explain(batched)
    with pytest.raises(ValueError, match="unbatched 2-D"):
        explain(torch.ones(3, 3))
