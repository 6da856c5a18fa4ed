"""Sparsity patterns drawn on the device from a seed.

A configuration's ``"generator"`` names a module of this package; its
``make(cfg, gen, device)`` returns the pattern as row-major sorted
``(rows, cols)`` int64 tensors on ``device``, drawing any randomness from
the ``torch.Generator`` ``gen``.
"""

from __future__ import annotations

import importlib

import torch


def make(cfg: dict, gen: torch.Generator, device) -> tuple:
    mod = importlib.import_module(f"{__name__}.{cfg['generator']}")
    rows, cols = mod.make(cfg, gen, torch.device(device))
    if rows.numel() != cfg["nnz"]:
        raise ValueError(f"{cfg['name']}: generator {cfg['generator']!r} "
                         f"gave {rows.numel()} entries, the file states "
                         f"{cfg['nnz']}")
    return rows, cols


def csr_indptr(rows: torch.Tensor, n: int) -> torch.Tensor:
    """Row pointers (n + 1,) int64 of row-major sorted ``rows``."""
    edges = torch.arange(n + 1, device=rows.device, dtype=torch.int64)
    return torch.searchsorted(rows, edges)


def lower_triangle(rows, cols, values):
    """The entries with col <= row, with their values."""
    keep = cols <= rows
    return rows[keep], cols[keep], values[keep]
