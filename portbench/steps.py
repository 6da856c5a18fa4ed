"""The one generator of the benchmark's traffic.

A configuration file (sizes, pattern generator, dtype) and a traffic
mix file (op, width p, static or dynamic pattern, pool sizes, learning
rate) give, from a seed, the inputs on the device (:func:`make_inputs`)
and the chained training step that the window drives (:class:`Program`):
the op forward, ``torch.autograd.grad`` for the step's cotangent G, and
an SGD update of the values and of B that feeds the next step, so no
step can be skipped or cached.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

import torchsparsegradutils_tpu_torch as tsgu

from . import patterns

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one draw of a run seeded ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _gen(device, seed, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The cell's inputs, drawn on ``device`` from ``seed``: patterns
    (one, or a pool of ``traffic["pool"]`` for a dynamic pattern),
    values (the configuration's ``"values"``, diagonal and other, where
    it states them, else normal draws), B and a pool of
    ``traffic["pool"]`` cotangents, each (n, p), in the configuration's
    dtype."""
    dev = torch.device(device)
    dtype = DTYPES[cfg["dtype"]]
    n, m, p = cfg["n"], cfg["m"], traffic["p"]
    dynamic = traffic["pattern"] == "dynamic"
    pats = [patterns.make(cfg, _gen(dev, seed, "pattern", i), dev)
            for i in range(traffic["pool"] if dynamic else 1)]
    rule = cfg.get("values")
    if rule:        # the configuration states its values
        rows, cols = pats[0]
        values = torch.where(rows == cols, float(rule["diagonal"]),
                             float(rule["other"])).to(torch.float32)
    else:
        values = torch.randn(cfg["nnz"], generator=_gen(dev, seed, "values"),
                             device=dev, dtype=torch.float32)
    if traffic.get("triangle"):
        if traffic["triangle"] != "lower" or dynamic or n != m:
            raise ValueError("a triangular mix takes the lower triangle of "
                             "a square static pattern")
        rows, cols, values = patterns.lower_triangle(*pats[0], values)
        if rows.numel() != cfg.get("lower_nnz", rows.numel()):
            raise ValueError(f"{cfg['name']}: the lower triangle has "
                             f"{rows.numel()} entries, the file states "
                             f"{cfg['lower_nnz']}")
        pats = [(rows, cols)]
    B = torch.randn(m, p, generator=_gen(dev, seed, "B"), device=dev)
    G = [torch.randn(n, p, generator=_gen(dev, seed, "G", i), device=dev)
         .to(dtype) for i in range(traffic["pool"])]
    return {"op": traffic["op"], "pattern": traffic["pattern"],
            "dtype": cfg["dtype"], "n": n, "m": m, "p": p,
            "nnz": pats[0][0].numel(), "patterns": pats,
            "values": values.to(dtype), "B": B.to(dtype), "G": G,
            "lr": traffic["lr"]}


def shape_of(inputs: dict) -> dict:
    """The sizes :mod:`portbench.count` reads."""
    return {k: inputs[k] for k in ("op", "pattern", "dtype", "n", "m", "p",
                                   "nnz")}


def _lower_solve(A, B):
    return tsgu.sparse_triangular_solve(A, B, upper=False)


OPS = {"sparse_mm": tsgu.sparse_mm, "sparse_triangular_solve": _lower_solve}


class Program:
    """The port's chained step on the inputs, as the window calls it:
    ``step()``; ``step(record)`` also appends (out, gradA, gradB) of the
    step, detached, on the device (no step writes to them later)."""

    def __init__(self, inputs: dict, dtype: torch.dtype = None):
        dtype = dtype or DTYPES[inputs["dtype"]]
        n, m = inputs["n"], inputs["m"]
        self.v = inputs["values"].to(dtype).clone()
        self.b = inputs["B"].to(dtype).clone()
        self.G = [g.to(dtype) for g in inputs["G"]]
        self.lr = inputs["lr"]
        self.op = inputs["op"]
        self.k = 0
        if inputs["pattern"] == "static":
            rows, cols = inputs["patterns"][0]
            indptr = patterns.csr_indptr(rows, n).cpu().numpy()
            self.mats = [tsgu.from_arrays(
                "csr", indptr.astype(np.int32),
                cols.cpu().numpy().astype(np.int32), self.v, (n, m),
                device=self.v.device)]
        else:
            self.mats = [tsgu.SparseCSR(patterns.csr_indptr(rows, n), cols,
                                        self.v, (n, m), pattern_static=False)
                         for rows, cols in inputs["patterns"]]

    def forward(self, A, b):
        return OPS[self.op](A, b)

    def update(self, v, gv, b, gb):
        with torch.no_grad():
            self.v = (v + self.lr * gv).detach()
            self.b = (b + self.lr * gb).detach()

    def step(self, record: list = None):
        k = self.k
        self.k += 1
        A = self.mats[k % len(self.mats)]
        v = self.v.detach().requires_grad_(True)
        b = self.b.detach().requires_grad_(True)
        out = self.forward(A.with_data(v), b)
        gv, gb = torch.autograd.grad(out, (v, b), self.G[k % len(self.G)])
        if record is not None:
            record.append((out.detach(), gv, gb))
        self.update(v, gv, b, gb)

    def state(self) -> tuple:
        """(values, B) as the next step will take them, on the host."""
        return self.v.to("cpu"), self.b.to("cpu")
