"""The comparison that decides ``correct``.

The set-up drives the program's step object through its first steps
(the window's own call, each with its own cotangent) and keeps what they
produced; after the window, :func:`portbench.reference.follow` runs the
same steps in float64 from inputs drawn again from the seed.  Four
numbers, each against its cell's limit (``limits/<cell>.json``):

- ``out``, ``grad_values``, ``grad_b``: the worst, over the checked
  steps, of max |program - reference| / max |reference| of the forward
  output, gradA at the entries and gradB;
- ``change``: the worst leaf (values, B) of | |Δ program| - |Δ reference| |
  over the larger of that leaf's |Δ reference| and the median leaf's,
  where Δ is the leaf's change over the checked steps (the state that
  the next step takes, minus the inputs).
"""

from __future__ import annotations

import math
import statistics

import torch

from . import reference

NAMES = ("out", "grad_values", "grad_b", "change")


def rel_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    got = got.to(ref.device, torch.float64)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / scale if scale > 0 else \
        float((got - ref).abs().max())


def numbers(inputs: dict, records: list, state: tuple) -> dict:
    """The four numbers of the checked steps ``records`` (host (out,
    gradA, gradB) a step) and the program's ``state`` after them."""
    worst = dict.fromkeys(NAMES[:3], 0.0)

    def visit(k, out, gv, gb):
        for name, got, ref in zip(NAMES, records[k], (out, gv, gb)):
            worst[name] = max(worst[name], rel_max(got, ref))

    v_ref, b_ref = reference.follow(inputs, len(records), visit)
    norms = []
    for got, ref, start in zip(state, (v_ref, b_ref),
                               (inputs["values"], inputs["B"])):
        start = start.to(torch.float64)
        got = got.to(start.device, torch.float64)
        d_prog = float(torch.linalg.vector_norm(got - start)) \
            if bool(torch.isfinite(got).all()) else math.inf
        norms.append((d_prog, float(torch.linalg.vector_norm(ref - start))))
    median = statistics.median(r for _, r in norms)
    worst["change"] = max(abs(p - r) / max(r, median) for p, r in norms)
    return worst


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in NAMES order, and whether all hold."""
    out = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return out, ok
