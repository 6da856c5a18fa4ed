"""Dispatch transparency: which engine each op runs for a pattern, and
why.

Port of ``torchsparsegradutils_tpu/kernels/explain.py``.  ``explain(A)``
calls the port's own gates, the ones the ops call, and returns one
report per op family, each with its ``engine``, a ``why`` and the
``kernels`` its forward and backward launch on the card (labels of
:data:`KERNELS`).  The JAX package asks ``dispatch.on_tpu()``; here the
fast routes run where A is on the card, so the report depends on A's
device, as the routes do.

Engine names are the JAX package's where the route is the same: ``dia``
(the DIA engine), ``pallas-chunk`` (the chunk engine; K8 at p = 1),
``chunk-spmv`` (the solvers' chunk matvec), ``pallas`` (the ELL-grid and
chunk LSE routes), ``xla`` (the generic gather and ``index_add``
branch), and ``dia``, ``wave`` or ``block`` for the triangular solve.
On purpose the report differs from JAX's where the gates do: float64
runs on the kernels (JAX sends it to XLA), the chunk engine takes every
p (JAX p >= 32), and there is no ``core`` (the TPU's MXU or VPU split).
A dynamic container (``pattern_static=False``) gets the JAX package's
report of its jit-time behaviour: ``static: False`` and engine ``xla``
for the four op families, with no kernel; its ``dia`` statistics are
counted on its device.

Example:
    >>> from torchsparsegradutils_tpu_torch import explain
    >>> from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    ...     stencil_sparse)
    >>> A = stencil_sparse((64, 64), [-8, 0, 1], device="cpu")
    >>> r = explain(A)
    >>> r["sparse_mm"]["engine"], r["sparse_mm"]["kernels"]
    ('dia', ['K3', 'K1', 'K2'])
    >>> r["pattern"]["dia"]["qualifies"]
    True
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["explain", "KERNELS"]

# the port's kernels by the labels of PERF.md's kernel table
KERNELS = {
    "K1": "kernels/dia.py:spmm_core (csrc/dia_spmm.cu)",
    "K2": "kernels/dia.py:sddmm_core (csrc/dia_sddmm.cu)",
    "K3": "kernels/window_gather.py:window_gather (csrc/gather.cu)",
    "K6": "kernels/chunk_spmm.py:chunk_spmm (csrc/chunk_spmm.cu)",
    "K7": "kernels/chunk_spmm.py:chunk_sddmm (csrc/chunk_sddmm.cu)",
    "K8": "kernels/chunk_spmm.py:chunk_spmv (csrc/chunk_spmv.cu)",
    "K9": "kernels/dia_tri.py:tri_dia_core, tri_dia_inv (csrc/tri_dia.cu)",
    "K10": "kernels/chunk_lse.py:lse_rows (csrc/chunk_lse.cu)",
    "K11": "kernels/chunk_lse.py:lse_rows_bwd (csrc/chunk_lse.cu)",
    "K12": "kernels/chunk_spmm.py:chunk_bwd_cols (csrc/chunk_bwd_fused.cu)",
}


def _chunk_kernels(p: int) -> list:
    """The chunk engine's launches in ``A @ B`` forward and backward: K6
    (K8 at p = 1) forward, then K7 and K6 over the transpose plan after
    K3's value reorder, or K12 between two K3s under ``SPMM_BWD =
    "fused"``."""
    from .dia import chunk_bwd_fused_arg
    fwd = "K8" if p == 1 else "K6"
    if chunk_bwd_fused_arg() is not None:
        return [fwd, "K12", "K3"]
    return [fwd, "K7", "K3"]


def _chunk_sddmm_kernels(p: int) -> list:
    """The chunk engine's launches in ``sddmm`` forward and backward: K7,
    then K6 (K8 at p = 1) for each gradient, over the transpose plan
    after K3's reorder for Y's."""
    return ["K7", "K8" if p == 1 else "K6", "K3"]


def _tri_report(A, n: int) -> Optional[dict]:
    """Triangular-solve route for a lower- or upper-triangular pattern
    (``ops.triangular_solve.tri_route``); None when the pattern is not
    triangular."""
    from ..ops.triangular_solve import tri_route

    rows, cols = A.rows().astype(np.int64), A.cols().astype(np.int64)
    lower, upper = bool((cols <= rows).all()), bool((cols >= rows).all())
    if lower == upper:
        return None
    route = tri_route(A, A.dtype, upper=upper)
    why = {"dia": "banded factor: K9, the block inverses then one chain "
                  "step a 64-row block",
           "wave": "level-scheduled wavefront: the rows of a level solved "
                   "together (PyTorch ops)",
           "block": "blocked back-substitution over dense diagonal blocks "
                    "(PyTorch ops)"}[route]
    return {"triangular": "upper" if upper else "lower", "engine": route,
            "why": why, "kernels": ["K3", "K9"] if route == "dia" else []}


def _lse_report(A) -> dict:
    """Row LSE route of ``ops.logsumexp``: DIA grid, ELL grid or chunk
    kernels, else the segment path."""
    from ..ops import logsumexp as lse
    from .chunk_lse import lse_fn
    from .grid_lse import grid_lse_fn

    if lse._dia_lse_gate(A, "auto") is not None:
        return {"engine": "dia", "kernels": ["K3"],
                "why": "masked reduce over the (n, K) diagonal grid, the "
                       "columns over the shifted grid"}
    if lse._fast_route_ok(A, "auto"):
        args = (A.row_sa(), A.col_sa(), *A.mat_shape, True)
        if grid_lse_fn(*args) is not None:
            return {"engine": "pallas", "route": "grid", "kernels": ["K3"],
                    "why": "row-ELL grid reduce (n·K <= 8·nnz, rows "
                           "sorted); the column direction over the "
                           "transpose after a K3 reorder"}
        if lse_fn(*args) is not None:
            return {"engine": "pallas", "route": "chunk",
                    "kernels": ["K10", "K11"],
                    "why": "skewed rows: the chunk LSE kernels over row "
                           "packs"}
    why = ("A is not on the card" if A.device.type != "cuda"
           else "rows not sorted")
    return {"engine": "xla", "kernels": [],
            "why": f"{why}: segment max/sum"}


def explain(A, p: int = 128) -> dict:
    """Report the route each op family takes for ``A``.

    Args:
      A: 2-D sparse container; its device decides the card's routes.
      p: the RHS width the SpMM and matvec gates assume (K8 at p = 1).

    Returns:
      dict with ``pattern`` (shape, nnz, dtype, layout, ``dia`` the
      :func:`~.dia.dia_coverage` statistics) and one entry per op family
      (``sparse_mm``, ``sddmm``, ``sparse_logsumexp``, ``matvec``, and
      ``triangular_solve`` for a triangular square pattern), each with
      ``engine``, ``why`` and ``kernels``.
    """
    from ..ops import spmm
    from ..solvers.common import matvec_route
    from ..types import is_sparse
    from .dia import _resid_chunk_ok, dia_coverage

    if not is_sparse(A) or A.ndim != 2:
        raise ValueError("explain expects an unbatched 2-D sparse "
                         "container")
    n, m = A.mat_shape
    cov = dia_coverage(A)
    rep = {"pattern": {
        "shape": (n, m), "nnz": A.nnz, "static": A.pattern_static,
        "dtype": str(A.dtype).removeprefix("torch."), "layout": A.layout,
        "dia": cov}}
    if not A.pattern_static:
        why = ("dynamic pattern: traced indices force the gather/segment "
               "XLA formulation everywhere")
        for op in ("sparse_mm", "sddmm", "sparse_logsumexp", "matvec"):
            rep[op] = {"engine": "xla", "why": why, "kernels": []}
        return rep

    dplan = spmm._dia_plan(A, "auto")
    if dplan is not None:
        mm, sd, hybrid = ["K3", "K1", "K2"], ["K2", "K3", "K1"], ""
        if dplan.is_hybrid:
            hybrid = f" + {cov['residual_nnz']} residual entries"
            if _resid_chunk_ok(dplan, A.device):
                hybrid += " on the chunk engine"
                mm += [k for k in _chunk_kernels(p) if k not in mm]
                sd += [k for k in _chunk_sddmm_kernels(p) if k not in sd]
            else:
                hybrid += " on the generic branch"
        why = (f"{cov['kept_diagonals']} diagonals cover "
               f"{cov['coverage']:.0%} of nnz: shifted dense streams "
               f"(K1; K2 for gradA){hybrid}")
        rep["sparse_mm"] = {"engine": "dia", "why": why, "kernels": mm}
        rep["sddmm"] = {"engine": "dia", "why": why, "kernels": sd}
    elif spmm._chunk_plan(A, "auto") is not None:
        rep["sparse_mm"] = {
            "engine": "pallas-chunk", "kernels": _chunk_kernels(p),
            "why": "row-sorted entries on the card: a warp a row"
                   + (" (K8 at p = 1)" if p == 1 else "")}
        rep["sddmm"] = {"engine": "pallas-chunk",
                        "kernels": _chunk_sddmm_kernels(p),
                        "why": "row-sorted entries on the card: a lane "
                               "group an entry's dot"}
    else:
        why = ("A is not on the card" if A.device.type != "cuda"
               else "rows not sorted")
        for op in ("sparse_mm", "sddmm"):
            rep[op] = {"engine": "xla", "kernels": [],
                       "why": f"{why}: gather + index_add"}
    rep["sparse_logsumexp"] = _lse_report(A)

    route, _ = matvec_route(A)
    rep["matvec"] = {
        "dia": {"engine": "dia", "kernels": ["K3", "K1"],
                "why": "grid (and residual) values hoisted out of the "
                       "Krylov loop (kernels/dia.py:prepared_matvec)"},
        "chunk": {"engine": "chunk-spmv", "kernels": ["K8"],
                  "why": "row packs of 512 entries, one launch a matvec"},
        "xla": {"engine": "xla", "kernels": [],
                "why": "gather + index_add"}}[route]

    tri = _tri_report(A, n) if n == m else None
    if tri is not None:
        rep["triangular_solve"] = tri
    return rep
