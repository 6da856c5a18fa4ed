"""Helpers of the benchmark's own tests (CPU, tiny sizes)."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY_GRID = 8         # HPCG's matrix on an 8^3 grid: 512 rows
TINY_SCALE = 10       # urand on 2^10 vertices: 1,024 rows


def hpcg_sizes(nx, ny, nz):
    """(n, nnz, lower_nnz) of HPCG's 27-point matrix on a grid."""
    n = nx * ny * nz
    nnz = (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    return n, nnz, (nnz - n) // 2 + n


def tiny_patch(spec: dict, p: int = 128) -> dict:
    """Overrides that cut a cell to a CPU size, keeping its generator and
    at most its own width."""
    gen = spec["config"]["generator"]
    if gen == "hpcg":
        g = TINY_GRID
        n, nnz, lower = hpcg_sizes(g, g, g)
        cfg = {"nx": g, "ny": g, "nz": g, "nnz": nnz, "lower_nnz": lower}
    elif gen == "gap_urand":
        n = 2 ** TINY_SCALE
        cfg = {"scale": TINY_SCALE,
               "nnz": 2 * spec["config"]["degree"] * n}
    else:
        raise ValueError(f"no tiny size for generator {gen!r}")
    cfg.update(n=n, m=n)
    return {"config": cfg,
            "traffic": {"p": min(p, spec["traffic"]["p"])}}


def tiny_spec(cell: str, p: int = 128) -> dict:
    """The cell's spec (harness.load) cut to a CPU size."""
    from portbench import harness
    full = harness.load(ROOT, cell)
    return harness.load(ROOT, cell, tiny_patch(full, p))
