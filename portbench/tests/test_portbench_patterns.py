"""The generators give their sources' patterns: HPCG's 27-point matrix
against its definition written out, GAP's urand graph's properties, and
each configuration's stated sizes against its source's formulas.  The
full-size patterns are made on the card only, where every run checks
their entry counts against the files (patterns.make, steps.make_inputs).
"""

import itertools
import json

import pytest
import torch

from portbench_helpers import ROOT, hpcg_sizes
from portbench import patterns


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _hpcg_by_definition(nx, ny, nz):
    """HPCG's GenerateProblem loop, written out entry by entry."""
    entries = []
    for iz, iy, ix in itertools.product(range(nz), range(ny), range(nx)):
        row = ix + nx * (iy + ny * iz)
        for sz, sy, sx in itertools.product((-1, 0, 1), repeat=3):
            jx, jy, jz = ix + sx, iy + sy, iz + sz
            if 0 <= jx < nx and 0 <= jy < ny and 0 <= jz < nz:
                entries.append((row, jx + nx * (jy + ny * jz)))
    return sorted(entries)


@pytest.mark.parametrize("grid", [(5, 4, 3), (3, 3, 3), (8, 2, 6)])
def test_hpcg_is_its_definition(grid):
    nx, ny, nz = grid
    n, nnz, lower = hpcg_sizes(nx, ny, nz)
    cfg = {"name": "t", "generator": "hpcg", "nx": nx, "ny": ny, "nz": nz,
           "n": n, "m": n, "nnz": nnz}
    rows, cols = patterns.make(cfg, _gen(1), "cpu")
    assert list(zip(rows.tolist(), cols.tolist())) \
        == _hpcg_by_definition(nx, ny, nz)
    r, c, _ = patterns.lower_triangle(rows, cols, torch.ones(nnz))
    assert r.numel() == lower and bool((c <= r).all())


@pytest.mark.parametrize("name", ["hpcg_104", "hpcg_88"])
def test_hpcg_configurations_state_their_sizes(name):
    cfg = _cfg(name)
    n, nnz, lower = hpcg_sizes(cfg["nx"], cfg["ny"], cfg["nz"])
    assert (cfg["n"], cfg["m"], cfg["nnz"]) == (n, n, nnz)
    assert cfg.get("lower_nnz", lower) == lower
    assert cfg["values"] == {"diagonal": 26.0, "other": -1.0}
    assert cfg["nx"] % 8 == cfg["ny"] % 8 == cfg["nz"] % 8 == 0


def test_hpcg_88_band_is_one_the_banded_solve_takes():
    cfg = _cfg("hpcg_88")
    assert cfg["nx"] * cfg["ny"] + cfg["nx"] + 1 == 7833 <= 8192
    assert (cfg["nx"], cfg["n"], cfg["nnz"], cfg["lower_nnz"]) \
        == (88, 681_472, 17_984_728, 9_333_100)
    assert _cfg("hpcg_104")["nnz"] == 29_791_000


def test_urand_configuration_states_its_sizes():
    cfg = _cfg("gap_urand20")
    assert cfg["n"] == cfg["m"] == 2 ** cfg["scale"] == 1_048_576
    assert cfg["nnz"] == 2 * cfg["degree"] * cfg["n"] == 33_554_432
    assert cfg["degree"] == 16


def test_urand_is_simple_undirected_sorted_and_seeded():
    cfg = {"name": "t", "generator": "gap_urand", "scale": 10, "degree": 16,
           "n": 1024, "m": 1024, "nnz": 2 * 16 * 1024}
    rows, cols = patterns.make(cfg, _gen(3), "cpu")
    n = cfg["n"]
    keys = rows * n + cols
    assert bool((keys[1:] > keys[:-1]).all())     # distinct, row-major
    assert not bool((rows == cols).any())         # no self-loops
    assert torch.equal(torch.sort(cols * n + rows).values, keys)  # both ways
    assert int(rows.max()) < n and int(cols.min()) >= 0
    again = patterns.make(cfg, _gen(3), "cpu")
    assert torch.equal(again[0], rows) and torch.equal(again[1], cols)
    other = patterns.make(cfg, _gen(4), "cpu")
    assert not torch.equal(other[1], cols)
    # every vertex is as likely an end as any other: degrees near 32
    deg = torch.bincount(rows, minlength=n).double()
    assert abs(float(deg.mean()) - 32.0) < 1e-9
    assert 4.0 < float(deg.std()) < 7.5           # Poisson-like, sd ~5.7


def test_csr_indptr_counts_rows():
    rows = torch.tensor([0, 0, 2, 2, 2, 4])
    assert patterns.csr_indptr(rows, 5).tolist() == [0, 2, 2, 5, 5, 6]
