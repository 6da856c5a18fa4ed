"""A run's result line at a tiny size on the CPU, and the entry's
refusals: no card, and a directory holding only the benchmark."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench_helpers import CELLS, ROOT, tiny_spec
from portbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys_and_order(cell):
    spec = tiny_spec(cell)
    res = harness.run_cell(spec, 2**40 + 3, 0.2, False, "cpu",
                           time.perf_counter())
    assert list(res) == KEYS                       # checks comes last
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res["metrics"]) == [m["name"] for m in spec["end_to_end"]]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "step_ms"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert list(res["checks"]) == ["out", "grad_values", "grad_b", "change"]
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(res["device"])
    json.dumps(res)
    assert harness.forbidden_modules() == []


def test_same_seed_same_inputs(tmp_path):
    from portbench import steps
    spec = tiny_spec(CELLS[0])
    a = steps.make_inputs(spec["config"], spec["traffic"], 2**35, "cpu")
    b = steps.make_inputs(spec["config"], spec["traffic"], 2**35, "cpu")
    c = steps.make_inputs(spec["config"], spec["traffic"], 2**35 + 1, "cpu")
    for key in ("values", "B"):
        assert torch.equal(a[key], b[key])
    assert torch.equal(a["G"][0], b["G"][0])
    assert not torch.equal(a["B"], c["B"])
    assert not torch.equal(a["G"][0], c["G"][0])


@pytest.mark.parametrize("cell", CELLS)
def test_every_pattern_and_cotangent_of_the_pool_is_checked(cell):
    spec = harness.load(ROOT, cell)
    assert spec["traffic"]["checked_steps"] >= spec["traffic"]["pool"]
    with pytest.raises(ValueError, match="would go unchecked"):
        harness.load(ROOT, cell, {"traffic": {
            "checked_steps": spec["traffic"]["pool"] - 1}})


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**33), "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_benchmark_alone_exits_nonzero_and_prints_nothing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
