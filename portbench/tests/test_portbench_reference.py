"""The plain references against the port's CPU path, in float64, at a
tiny size: forward output, gradA at the entries and gradB."""

import numpy as np
import pytest
import torch

import portbench_helpers  # noqa: F401  (puts the repository on sys.path)
import torchsparsegradutils_tpu_torch as tsgu
from portbench import patterns
from portbench.reference import spmm, trisolve

P = 5


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _port(rows, cols, values, B, G, op, n, static=True):
    indptr = patterns.csr_indptr(rows, n)
    if static:
        A = tsgu.from_arrays("csr", indptr.numpy().astype(np.int32),
                             cols.numpy().astype(np.int32), values, (n, n),
                             device="cpu")
    else:
        A = tsgu.SparseCSR(indptr, cols, values, (n, n),
                           pattern_static=False)
    v = values.clone().requires_grad_(True)
    b = B.clone().requires_grad_(True)
    out = op(A.with_data(v), b)
    return (out.detach(), *torch.autograd.grad(out, (v, b), G))


CONFIGS = {
    "hpcg": {"name": "t", "generator": "hpcg", "nx": 9, "ny": 8, "nz": 10,
             "n": 720, "m": 720, "nnz": 25 * 22 * 28},
    "gap_urand": {"name": "t", "generator": "gap_urand", "scale": 9,
                  "degree": 3, "n": 512, "m": 512, "nnz": 2 * 3 * 512},
}


@pytest.mark.parametrize("generator", ["hpcg", "gap_urand"])
@pytest.mark.parametrize("static", [True, False])
def test_spmm_reference_matches_the_port(generator, static):
    cfg = CONFIGS[generator]
    n = cfg["n"]
    rows, cols = patterns.make(cfg, _gen(1), "cpu")
    values = torch.randn(rows.numel(), generator=_gen(2), dtype=torch.float64)
    B = torch.randn(n, P, generator=_gen(3), dtype=torch.float64)
    G = torch.randn(n, P, generator=_gen(4), dtype=torch.float64)
    got = _port(rows, cols, values, B, G, tsgu.sparse_mm, n, static)
    ref = spmm.step(rows, cols, values, B, G, n)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


def test_trisolve_reference_matches_the_port_across_blocks():
    # HPCG's factor on a 17 x 17 x 4 grid: a band of 307 rows over 1,156,
    # the reference's blocks of 512 rows
    cfg = {"name": "t", "generator": "hpcg", "nx": 17, "ny": 17, "nz": 4,
           "n": 1156, "m": 1156, "nnz": 49 * 49 * 10}
    n = cfg["n"]
    rows, cols = patterns.make(cfg, _gen(5), "cpu")
    values = torch.where(rows == cols, 26.0, -1.0).double() \
        + 0.1 * torch.randn(rows.numel(), generator=_gen(6),
                            dtype=torch.float64)
    rows, cols, values = patterns.lower_triangle(rows, cols, values)
    assert int((rows - cols).max()) == 17 * 17 + 17 + 1
    B = torch.randn(n, P, generator=_gen(7), dtype=torch.float64)
    G = torch.randn(n, P, generator=_gen(8), dtype=torch.float64)
    got = _port(rows, cols, values, B, G,
                lambda A, b: tsgu.sparse_triangular_solve(A, b, upper=False),
                n)
    ref = trisolve.step(rows, cols, values, B, G, n)
    assert len(trisolve._Blocks(rows, cols, values, n)) == 3
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_trisolve_reference_refuses_an_upper_entry():
    rows, cols = torch.tensor([0, 1, 1]), torch.tensor([0, 0, 2])
    with pytest.raises(ValueError, match="above its diagonal"):
        trisolve.step(rows, cols, torch.ones(3, dtype=torch.float64),
                      torch.ones(3, 1, dtype=torch.float64),
                      torch.ones(3, 1, dtype=torch.float64), 3)
