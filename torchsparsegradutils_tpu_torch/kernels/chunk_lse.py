"""Chunk LSE: row logsumexp of a degree-skewed sorted pattern, read as
CSR.

Port of ``torchsparsegradutils_tpu/kernels/chunk_lse.py``.  The TPU
kernel streams the entries in chunks, emits online ``(max, Σ exp)``
partials per chunk-local row and combines them with a segment max and
sum, because a TPU cannot scatter.  On the H100 the pattern is read as
CSR and one kernel writes each finished row result:

    out[r] = log(Σ_{e in row r} exp(v_e)  [+ (width - count_r) · exp(0)])
    d[e]   = exp(v_e - out[row_e]) · g[row_e]                 (backward)

Two hand-written CUDA kernels carry it, each beside its plain PyTorch
version: :func:`lse_rows` (K10, ``csrc/chunk_lse.cu``) and
:func:`lse_rows_bwd` (K11, the same file).  On CPU tensors the wrappers
run the plain versions; on CUDA tensors they launch the kernels or
raise.  The JAX ``_lse_combine`` has no kernel counterpart: K10 applies
its rules (``include_zeros`` mass, +inf passes, empty or all -inf rows
give -inf, or ``log(width - count)`` with ``include_zeros``) itself.

Both kernels walk one table of row packs, planned on the host by
:mod:`.row_packs` (:func:`lse_packs`, :func:`pack_lanes`,
:func:`pack_table`, re-exported here) and cached with the plan
(:func:`plan_packs`), as the chunk SpMV (K8) does: the rows, in order,
cut into packs of consecutive whole rows that hold at most ``T =
PACK_ENTRIES`` (2,048) entries and ``T / 2`` rows, a row of more than
``LONG_ROW`` entries a pack of its own.  One CUDA block takes one pack,
stages its entries in shared memory in one burst and finishes its rows
there, lane groups of ``G`` threads a row.  So the work is cut by
entries, as the TPU kernel cuts it, without its partials.

:class:`ChunkLse` makes the forward differentiable; its backward calls
K11 through :class:`LseRowsBwd`, whose own backward is plain
differentiable PyTorch, so higher derivatives work.

Example:
    >>> import torch
    >>> indptr = torch.tensor([0, 2, 2, 3])
    >>> v = torch.tensor([0.0, 0.0, 1.0])
    >>> [round(x, 4) for x in lse_rows(indptr, v, 4, False).tolist()]
    [0.6931, -inf, 1.0]
    >>> [round(x, 4) for x in lse_rows(indptr, v, 4, True).tolist()]
    [1.3863, 1.3863, 1.7437]
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from . import _build
from .chunk_spmm import _entry_rows, build_chunk_plan, transpose_order
from .grid_lse import grid_lse_fn
from .row_packs import (LONG_ROW, PACK_ENTRIES, LsePacks,  # noqa: F401
                        _packs_for, lse_packs, pack_lanes, pack_table,
                        plan_packs)
from .window_gather import WindowGather

__all__ = ["lse_rows", "lse_rows_plain", "lse_rows_bwd",
           "lse_rows_bwd_plain", "ChunkLse", "LseRowsBwd", "lse_fn",
           "lse_fn_transposed", "LsePacks", "lse_packs", "pack_lanes",
           "pack_table", "plan_packs"]

NEG_INF = float("-inf")
INF = float("inf")


def lse_rows_plain(indptr, values, width: int, include_zeros: bool):
    """Plain PyTorch version of :func:`lse_rows`: the segment
    formulation (``scatter_reduce`` max, ``index_add`` sum), in the
    accumulation dtype."""
    acc = _build.acc_dtype(values.dtype)
    n = indptr.shape[0] - 1
    rows = _entry_rows(indptr)
    v = values.to(acc)
    M = torch.full((n,), NEG_INF, dtype=acc, device=v.device).scatter_reduce(
        0, rows, v, "amax")
    Ms = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    if include_zeros:
        z = (width - indptr.diff()).to(acc)
        Ms = torch.where(z > 0, Ms.clamp_min(0.0), Ms)
    S = torch.zeros(n, dtype=acc, device=v.device).index_add_(
        0, rows, torch.exp(v - Ms[rows]))
    if include_zeros:
        S = S + torch.where(z > 0, z * torch.exp(-Ms), torch.zeros_like(S))
    empty = S == 0
    out = torch.where(empty, NEG_INF,
                      Ms + torch.log(torch.where(empty, torch.ones_like(S),
                                                 S)))
    return torch.where(M == INF, INF, out)


def _check_rows(name, indptr, values, *per_row):
    """dtype suffix of a CUDA launch; ``per_row`` tensors must be
    ``(n,)`` in the accumulation dtype of ``values``."""
    suffix = _build.cuda_operands(name, (values,), (indptr,))
    n = indptr.shape[0] - 1
    acc = _build.acc_dtype(values.dtype)
    if indptr.ndim != 1 or values.ndim != 1:
        raise ValueError(f"{name}: indptr and values must be 1-D, got "
                         f"{tuple(indptr.shape)} and {tuple(values.shape)}")
    for t in per_row:
        if t.shape != (n,) or t.dtype != acc or t.device != values.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: per-row tensors must be contiguous "
                             f"({n},) {acc} on {values.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return suffix


def lse_rows(indptr: torch.Tensor, values: torch.Tensor, width: int,
             include_zeros: bool,
             packs: Optional[LsePacks] = None) -> torch.Tensor:
    """Row LSE of a CSR pattern: ``out[r]`` over the entries
    ``[indptr[r], indptr[r+1])`` of ``values``, with ``width - count``
    structural zeros when ``include_zeros``.  int64 indptr (n+1,), values
    (nnz,) -> (n,) in the accumulation dtype (float32 for bfloat16).

    CPU tensors take :func:`lse_rows_plain`; CUDA tensors launch
    ``csrc/chunk_lse.cu`` (K10) over ``packs`` (:func:`plan_packs`; built
    from a host copy of ``indptr`` when None) and raise on what it does
    not take.
    """
    if indptr.device.type == "cpu" and values.device.type == "cpu":
        return lse_rows_plain(indptr, values, width, include_zeros)
    suffix = _check_rows("lse_rows", indptr, values)
    n = indptr.shape[0] - 1
    out = torch.empty(n, dtype=_build.acc_dtype(values.dtype),
                      device=values.device)
    if n == 0:
        return out
    packs = _packs_for("lse_rows", indptr, values, packs)
    _build.launch("chunk_lse", f"tsgu_lse_rows_{suffix}", indptr, values,
                  packs.table, out, packs.table.shape[0] - 1, width,
                  int(include_zeros))
    lse_rows.launches += 1
    return out


lse_rows.launches = 0


def lse_rows_bwd_plain(indptr, values, out, g):
    """Plain PyTorch version of :func:`lse_rows_bwd`."""
    rows = _entry_rows(indptr)
    v = values.to(out.dtype)
    o = out[rows]
    safe = torch.isfinite(o) & (v != NEG_INF)
    d = torch.exp(torch.where(safe, v - o, NEG_INF)) * torch.where(
        safe, g[rows], torch.zeros_like(o))
    return d.to(values.dtype)


def lse_rows_bwd(indptr: torch.Tensor, values: torch.Tensor,
                 out: torch.Tensor, g: torch.Tensor,
                 packs: Optional[LsePacks] = None) -> torch.Tensor:
    """``d[e] = exp(v_e - out[row_e]) · g[row_e]`` in entry order, 0 where
    ``out[row_e]`` is not finite or ``v_e = -inf``: indptr (n+1,), values
    (nnz,), out and g (n,) in the accumulation dtype -> (nnz,) in
    values' dtype.

    CPU tensors take :func:`lse_rows_bwd_plain`; CUDA tensors launch
    ``csrc/chunk_lse.cu`` (K11) over ``packs``, as :func:`lse_rows`, and
    raise on what it does not take.
    """
    if all(t.device.type == "cpu" for t in (indptr, values, out, g)):
        return lse_rows_bwd_plain(indptr, values, out, g)
    suffix = _check_rows("lse_rows_bwd", indptr, values, out, g)
    d = torch.empty_like(values)
    if d.numel() == 0:
        return d
    packs = _packs_for("lse_rows_bwd", indptr, values, packs)
    _build.launch("chunk_lse", f"tsgu_lse_rows_bwd_{suffix}", indptr, values,
                  packs.table, out, g, d, packs.table.shape[0] - 1)
    lse_rows_bwd.launches += 1
    return d


lse_rows_bwd.launches = 0


class ChunkLse(torch.autograd.Function):
    """Row LSE over a chunk row plan (K10), ``values`` in the plan's
    entry order; returned in the accumulation dtype.  Backward: K11
    through :class:`LseRowsBwd`, with ``out`` recomputed through this
    Function when a graph is being built (second order)."""

    @staticmethod
    def forward(ctx, plan, width, include_zeros, values):
        d = plan.maps(values.device)
        out = lse_rows(d["indptr"], values.contiguous(), width,
                       include_zeros, plan_packs(plan, values.device))
        ctx.args = (plan, width, include_zeros)
        ctx.save_for_backward(values, out)
        return out

    @staticmethod
    def backward(ctx, g):
        values, out = ctx.saved_tensors
        if torch.is_grad_enabled():
            out = ChunkLse.apply(*ctx.args, values)
        return None, None, None, LseRowsBwd.apply(ctx.args[0], values, out,
                                                  g)


class LseRowsBwd(torch.autograd.Function):
    """K11 as a differentiable function of ``values``, ``out`` and ``g``;
    its backward is plain PyTorch."""

    @staticmethod
    def forward(ctx, plan, values, out, g):
        d = plan.maps(values.device)
        ctx.plan = plan
        ctx.save_for_backward(values, out, g)
        return lse_rows_bwd(d["indptr"], values.contiguous(),
                            out.contiguous(), g.contiguous(),
                            plan_packs(plan, values.device))

    @staticmethod
    def backward(ctx, ct):
        values, out, g = ctx.saved_tensors
        rows = _entry_rows(ctx.plan.maps(values.device)["indptr"])
        v = values.to(out.dtype)
        o = out[rows]
        safe = torch.isfinite(o) & (v != NEG_INF)
        e = torch.exp(torch.where(safe, v - o, NEG_INF))
        ce = ct.to(out.dtype) * e
        ceg = ce * g[rows]
        n = out.shape[0]
        zeros = lambda: torch.zeros(n, dtype=out.dtype, device=out.device)
        need = ctx.needs_input_grad
        return (None, ceg.to(values.dtype) if need[1] else None,
                -zeros().index_add(0, rows, ceg) if need[2] else None,
                zeros().index_add(0, rows, ce) if need[3] else None)


@lru_cache(maxsize=64)
def lse_fn(rows_sa, cols_sa, n: int, m: int, include_zeros: bool):
    """Cached ``f(values) -> (n,)`` row LSE on the chunk kernels, or None
    for an unsorted or empty pattern."""
    plan = build_chunk_plan(rows_sa, cols_sa, n, m)
    if plan is None:
        return None
    return lambda values: ChunkLse.apply(plan, m, include_zeros,
                                         values).to(values.dtype)


@lru_cache(maxsize=64)
def lse_fn_transposed(rows_sa, cols_sa, n: int, m: int,
                      include_zeros: bool):
    """Column LSE as the row LSE of the transpose: ``(fn, reorder)`` with
    ``fn(reorder(values))`` the (m,) result, or None.  ``fn`` is the ELL
    grid route where its gate admits the transpose, else the chunk
    route; ``reorder`` moves values to (column, row) order by the K3
    gather, with the inverse gather as its backward."""
    res = transpose_order(rows_sa, cols_sa, n, m)
    if res is None:
        return None
    rt, ct, perm, inv = res
    fn = grid_lse_fn(rt, ct, m, n, include_zeros)
    if fn is None:
        fn = lse_fn(rt, ct, m, n, include_zeros)
    if fn is None:
        return None

    def reorder(values):
        return WindowGather.apply(values, perm.on(values.device),
                                  inv.on(values.device))

    return fn, reorder
