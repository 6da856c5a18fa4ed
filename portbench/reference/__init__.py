"""Plain PyTorch references of the benchmark's ops, in float64.

They import nothing of the port and take only the inputs the benchmark
made (pattern, values, B, the cotangents), never what the port derived
from them.  :func:`follow` runs a traffic mix's chained steps from those
inputs, with its own state.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

OPS = {"sparse_mm": "spmm", "sparse_triangular_solve": "trisolve"}


@contextlib.contextmanager
def exact_matmul():
    """TF32 off for float32 products while the reference runs."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def follow(inputs: dict, steps: int, visit) -> tuple:
    """Run ``steps`` chained steps of ``inputs["op"]`` in float64 from the
    inputs: step k uses pattern k mod len(patterns) and cotangent k mod
    len(G), then values += lr gradA and B += lr gradB.  Calls
    ``visit(k, out, grad_values, grad_b)`` after each step; returns the
    final (values, B)."""
    mod = importlib.import_module(f"{__name__}.{OPS[inputs['op']]}")
    pats, G = inputs["patterns"], inputs["G"]
    v = inputs["values"].to(torch.float64)
    b = inputs["B"].to(torch.float64)
    lr = inputs["lr"]
    with exact_matmul(), torch.no_grad():
        for k in range(steps):
            rows, cols = pats[k % len(pats)]
            out, gv, gb = mod.step(rows, cols, v, b,
                                   G[k % len(G)].to(torch.float64),
                                   inputs["n"])
            visit(k, out, gv, gb)
            del out
            v = v + lr * gv
            b = b + lr * gb
    return v, b
