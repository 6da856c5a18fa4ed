"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

Everything that belongs to a cell is found by name: its entry in
``BENCHMARK.json``, ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json`` and, for each per-layer metric,
``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from . import checks, steps, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "torchsparsegradutils_tpu")
HERE = Path(__file__).resolve().parent
ENQUEUE_STEPS = 20
TRACE_SECONDS = 1.0


def load(root: Path, workload: str, patch: dict = None) -> dict:
    """The cell ``workload`` with its configuration, traffic, limits and
    metrics; ``patch`` may override keys of the configuration and the
    traffic (``{"config": {...}, "traffic": {...}}``)."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    patch = patch or {}
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    cfg.update(patch.get("config", {}))
    traffic.update(patch.get("traffic", {}))
    if traffic["checked_steps"] < traffic["pool"]:
        raise ValueError(f"traffic {cell['traffic']!r}: checked_steps "
                         f"{traffic['checked_steps']} < pool "
                         f"{traffic['pool']}: a pattern or cotangent that "
                         f"the window drives would go unchecked")

    def mine(metric):
        return workload in metric.get("workloads", [workload])
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "limits": json.loads((HERE / "limits" / f"{workload}.json")
                                 .read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


class Clock:
    """Step boundaries on the device's stream (CUDA events), or on the
    host clock for a CPU run."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run_cell(spec: dict, seed: int, seconds: float, traced: bool,
             device, t_start: float, dtype: torch.dtype = None) -> dict:
    """Run the cell of ``spec`` (:func:`load`) once; returns the result
    line's object.  ``t_start`` is the host clock at process start;
    ``dtype`` runs the program in another precision (the control)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    clock = Clock(dev)
    cfg, traffic = spec["config"], spec["traffic"]
    name = spec["cell"]["name"]

    # ---- set-up: inputs, the step object, its checked and warm steps
    stages = {"start": time.perf_counter() - t_start}
    inputs = steps.make_inputs(cfg, traffic, seed, dev)
    shape = steps.shape_of(inputs)
    prog = steps.Program(inputs, dtype)
    del inputs
    clock.sync()
    stages["inputs"] = time.perf_counter() - t_start
    records = []
    t = time.perf_counter()
    prog.step(records)
    clock.sync()
    first_s = time.perf_counter() - t      # no copy to the host inside
    for k in range(traffic["checked_steps"]):
        if k:
            prog.step(records)
        records[k] = tuple(x.to("cpu") for x in records[k])
    state = prog.state()
    stages["checked"] = time.perf_counter() - t_start
    warm = []
    for _ in range(traffic["warm_steps"]):
        clock.sync()
        t = time.perf_counter()
        prog.step()
        clock.sync()
        warm.append(time.perf_counter() - t)
    gc.collect()
    clock.sync()
    setup_s = time.perf_counter() - t_start
    say(f"[{name}] seed {seed}: set-up {setup_s:.3f} s (at s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"), first step {first_s:.4f} s, warm steps "
        f"{[round(w * 1e3, 3) for w in warm]} ms")

    # ---- the measured window: steps enqueued with no host sync
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    marks = [clock.mark()]
    t0 = time.perf_counter()
    while True:
        prog.step()
        marks.append(clock.mark())
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    window_s = time.perf_counter() - t0
    n_steps = len(marks) - 1
    step_times = [clock.ms(marks[i], marks[i + 1]) for i in range(n_steps)]
    del marks
    measured = {
        "step_ms": window_s * 1e3 / n_steps,
        "step_p95_ms": p95(step_times),
        "peak_extra_mib": ((torch.cuda.max_memory_allocated() - base)
                           / 2**20 if cuda else 0.0),
        "setup_s": setup_s,
    }
    say(f"[{name}] window {window_s:.3f} s, {n_steps} steps, step "
        f"{measured['step_ms']:.4f} ms, p50 "
        f"{statistics.median(step_times):.4f} ms, p95 "
        f"{measured['step_p95_ms']:.4f} ms, peak extra "
        f"{measured['peak_extra_mib']:.1f} MiB")

    # ---- the traced stretch (--trace 1)
    parsed = None
    if traced:
        count = int(min(100, max(10, round(
            TRACE_SECONDS * 1e3 / measured["step_ms"]))))
        parsed = trace.profile(prog.step, count, clock.sync)
        enqueue = []
        for _ in range(ENQUEUE_STEPS):
            clock.sync()
            t = time.perf_counter()
            prog.step()
            enqueue.append((time.perf_counter() - t) * 1e3)
        clock.sync()
        ctx = {"trace": parsed, "shape": shape, "enqueue_ms": enqueue,
               "first_call_s": first_s - statistics.median(warm),
               "step_ms": measured["step_ms"]}
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda \
        else 0

    # ---- free the program, then check what it produced
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    inputs = steps.make_inputs(cfg, traffic, seed, dev)
    values = checks.numbers(inputs, records, state)
    compared, correct = checks.judge(values, spec["limits"])
    del inputs, records, state
    say(f"[{name}] reference check {time.perf_counter() - t:.3f} s")

    # ---- the result line
    metrics = {}
    if traced:
        for m in spec["per_layer"]:
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            value = reader.read(ctx)
            if value is None:
                say(f"[{name}] {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n_steps, "failed": 0,
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = parsed["busy_s"]
        device_info["window_s"] = parsed["window_s"]
        result["breakdown"] = {"device_ops": parsed["device_ops"],
                               "idle_gaps": parsed["idle_gaps"]}
    result["checks"] = compared
    return result


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_lines(result: dict) -> list:
    return [f"check {k}: {v['value']:.6e} (limit {v['limit']:.6e})"
            for k, v in result["checks"].items()]
