"""A profiled stretch of steps and what its trace says.

:func:`profile` runs steps under ``torch.profiler`` (host and CUDA
activity), writes the Chrome trace to a temporary file under ``TMPDIR``,
reads it back and deletes it; :func:`parse` reduces the trace to kernel
counts and times, the device's busy time (the union of kernel, copy and
set intervals), the device operations that took most time and the
longest idle gaps, each named by the innermost host operation open
across it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


class NoDeviceTime(RuntimeError):
    """The trace holds no device activity (a profiler dropout)."""


def profile(step, steps: int, sync) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return parse(data, steps, window_s)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_label(host, t0, t1):
    """The shortest host operation open across the gap [t0, t1]."""
    best = None
    for name, s, e in host:
        if s <= t0 and e >= t1 and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "no host operation open"


def parse(data, steps: int, window_s: float) -> dict:
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            device.append((e["name"], e["cat"], s, d))
        elif e.get("cat") in HOST_CATS:
            host.append((e["name"], s, s + d))
    busy_us = sum(e - s for s, e in _union((s, s + d)
                                           for _, _, s, d in device))
    if not device or busy_us <= 0:
        raise NoDeviceTime("the profiler's trace shows no device time")
    kernels = defaultdict(lambda: [0, 0.0])
    ops = defaultdict(float)
    for name, cat, s, d in device:
        ops[name] += d / 1e6
        if cat == "kernel":
            kernels[name][0] += 1
            kernels[name][1] += d / 1e6
    merged = _union((s, s + d) for _, _, s, d in device)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:TOP]
    return {
        "steps": steps, "window_s": window_s, "busy_s": busy_us / 1e6,
        "kernels": dict(kernels),
        "device_ops": sorted(([k, v] for k, v in ops.items()),
                             key=lambda r: -r[1])[:TOP],
        "idle_gaps": [[_host_label(host, t0, t1), g / 1e6]
                      for g, t0, t1 in gaps],
    }


def _named(name: str):
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])")


def kernel(parsed: dict, name: str) -> tuple:
    """(launches, device seconds) of the kernels called ``name``."""
    pat = _named(name)
    n, t = 0, 0.0
    for full, (count, secs) in parsed["kernels"].items():
        if pat.search(full):
            n += count
            t += secs
    return n, t


def roofline(ctx: dict, core, extra=()) -> float:
    """Percent of the summed device time of a family of kernels that the
    least time of their functions' work would take (count.KERNELS);
    None where a core kernel did not run once a step."""
    from . import count
    parsed, shape = ctx["trace"], ctx["shape"]
    steps = parsed["steps"]
    need = spent = 0.0
    for name in (*core, *extra):
        launches, secs = kernel(parsed, name)
        if launches == 0 and name not in core:
            continue
        if launches < steps:
            return None
        per, fn = count.KERNELS[name]
        calls = launches if per == "launch" else steps
        need += calls * count.least_s(*fn(shape))
        spent += secs
    return 100.0 * need / spent if spent > 0 else None
