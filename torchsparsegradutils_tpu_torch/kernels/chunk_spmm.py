"""Chunk engine: SpMM, SDDMM and SpMV over a general row-sorted pattern.

Port of ``torchsparsegradutils_tpu/kernels/chunk_spmm.py``.  The TPU
kernels there cut the entry stream into chunks of C entries, reduce each
chunk's rows with a one-hot matrix on the MXU and combine the chunks
with a segment sum, because a TPU cannot scatter.  An H100 reads the
pattern as CSR: one warp owns one output row of one column slab (the
SpMM and the SDDMM) and walks its entries, and one block a pack of
whole rows (the SpMV, over :mod:`.row_packs`' table, cached with the
plan).  So a plan is only what the kernels read, the entries' row
pointers and gather columns:

    out[r, :] = Σ_{e in row r} val_e · B[col_e, :]     (SpMM, K6)
    dd[e]     = dot(X[row_e, :], Y[col_e, :])          (SDDMM, K7)
    y[r]      = Σ_{e in row r} val_e · x[col_e]        (SpMV, K8)

``Aᵀ G`` is the SpMM again over the transpose plan, whose entries are
sorted by (column, row), on the values reordered by the ported K3
gather (:mod:`.window_gather`), where the JAX package used its Beneš
network.

Three hand-written CUDA kernels carry the engine, each beside its plain
PyTorch version: :func:`chunk_spmm` (``csrc/chunk_spmm.cu``),
:func:`chunk_sddmm` (``csrc/chunk_sddmm.cu``) and :func:`chunk_spmv`
(``csrc/chunk_spmv.cu``).  :func:`chunk_spmm_slab` (K13, a separate
entry of ``csrc/chunk_spmm.cu``) computes one row slab of the SpMM for
the sharded path (``parallel/chunk_sharded.py``), and
:func:`chunk_bwd_cols` (K12, ``csrc/chunk_bwd_fused.cu``) both gradients
of the SpMM in one pass over the transpose plan, the fused backward
(``kernels/dia.py:SPMM_BWD = "fused"``).  On CPU tensors the
wrappers run the plain versions; on CUDA tensors they launch the
kernels or raise.
:class:`ChunkSpmm` and :class:`ChunkSddmm` make them differentiable,
each backward calling the Functions again, so higher derivatives work.

Example:
    >>> import numpy as np, torch
    >>> from torchsparsegradutils_tpu_torch.types import StaticArray
    >>> rows, cols = np.array([0, 0, 2]), np.array([1, 2, 0])
    >>> plan = build_chunk_plan(StaticArray(rows), StaticArray(cols), 3, 3)
    >>> plan.indptr.tolist(), plan.T.perm.tolist()
    ([0, 2, 2, 3], [2, 0, 1])
    >>> ChunkSpmm.apply(plan, torch.tensor([1.0, 2.0, 3.0]),
    ...                 torch.eye(3)).tolist()
    [[0.0, 1.0, 2.0], [0.0, 0.0, 0.0], [3.0, 0.0, 0.0]]
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..types import StaticArray
from . import _build
from .row_packs import LsePacks, _packs_for, plan_packs
from .window_gather import WindowGather, window_gather

__all__ = ["ChunkPlan", "build_chunk_plan", "build_chunk_plan_transpose",
           "transpose_order", "chunk_spmm", "chunk_spmm_slab", "chunk_sddmm",
           "chunk_spmv",
           "chunk_bwd_cols", "chunk_bwd_fused",
           "ChunkSpmm", "ChunkSddmm", "ChunkBwdPair"]

MAX_COL_BLOCKS = 65535   # CUDA grid y limit: column blocks (slabs) a launch
# K6's, K13's, K7's and K12's column slab of the gathered operand: two
# 128-byte lines of a row, or four where the rows hold fewer than SHORT_ROW
# entries on average (fewer passes over short rows); csrc/chunk_spmm.cu's
# and csrc/chunk_sddmm.cu's head comments give the times.
SLAB_BYTES = 256
SHORT_SLAB_BYTES = 512
SHORT_ROW = 8
MAX_SDDMM_ROWS = 2**31 - 1   # K7 shuffles its column indices as int32
# K8's pack size (csrc/chunk_spmv.cu SPMV_PACK): the entries a pack of rows
# holds in K8's row-pack plan (.row_packs at this T)
SPMV_PACK = 512


def _indptr(sorted_rows: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.bincount(
        sorted_rows, minlength=n))]).astype(np.int64)


class ChunkPlan:
    """Row pointers and gather columns of a pattern's entries, in one
    order.

    A row plan (:func:`build_chunk_plan`) keeps the pattern's own
    row-sorted order (``perm`` is None): ``n`` output rows, gather
    columns in ``[0, m)``.  A transpose plan
    (:func:`build_chunk_plan_transpose`) sorts the entries by (column,
    row): its ``n`` rows are the pattern's columns, its gather columns
    the pattern's rows, and ``perm[d]`` is the pattern entry at its
    position ``d`` (``inv`` the inverse).  ``T`` is the other plan of the
    same pattern, so ``plan.T.T is plan``.

    Host arrays are numpy int64; :meth:`maps` gives them per device.
    """

    def __init__(self, n: int, m: int, indptr: np.ndarray, cols: np.ndarray,
                 perm: Optional[np.ndarray] = None,
                 inv: Optional[np.ndarray] = None,
                 transpose: Optional["ChunkPlan"] = None):
        self.n, self.m = int(n), int(m)
        self.indptr, self.cols = indptr, cols
        self.perm, self.inv = perm, inv
        self._T = transpose
        self._dev = {}

    @property
    def nnz(self) -> int:
        return len(self.cols)

    @property
    def T(self) -> "ChunkPlan":
        if self._T is None:        # a row plan's transpose, made at first use
            rows = np.repeat(np.arange(self.n, dtype=np.int64),
                             np.diff(self.indptr))
            self._T = _transpose_plan(rows, self.cols, self.n, self.m, self)
        return self._T

    def maps(self, device) -> dict:
        """``indptr`` and ``cols`` (and a transpose plan's ``perm`` and
        ``inv``) as int64 tensors on ``device`` (cached)."""
        device = torch.device(device)
        d = self._dev.get(device)
        if d is None:
            names = ["indptr", "cols"] + (
                [] if self.perm is None else ["perm", "inv"])
            d = self._dev[device] = {
                k: torch.from_numpy(getattr(self, k)).to(device)
                for k in names}
        return d

    def to_T(self, values: torch.Tensor) -> torch.Tensor:
        """(nnz,) values in this plan's entry order -> in ``T``'s order
        (the K3 gather; differentiable, its backward the inverse
        gather)."""
        if self.perm is None:
            d = self.T.maps(values.device)
            return WindowGather.apply(values, d["perm"], d["inv"])
        d = self.maps(values.device)
        return WindowGather.apply(values, d["inv"], d["perm"])


def _transpose_plan(rows, cols, n, m, row_plan: ChunkPlan) -> ChunkPlan:
    # by column, then row: the JAX package's native.lexsort_rowcol(cols,
    # rows, n), whose numpy path is this same stable lexsort
    perm = np.lexsort((rows, cols)).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    return ChunkPlan(m, n, _indptr(cols[perm], m), rows[perm], perm=perm,
                     inv=inv, transpose=row_plan)


@lru_cache(maxsize=64)
def build_chunk_plan(rows_sa, cols_sa, n: int, m: int) -> Optional[ChunkPlan]:
    """Row plan of a static 1-D pattern in its natural order, or None
    when it has no entries or its rows are not sorted (the generic
    branch then runs).  Cached on the content hash of the index
    arrays."""
    rows = rows_sa.arr
    if rows.ndim != 1 or len(rows) == 0:
        return None
    rows = rows.astype(np.int64)
    if (np.diff(rows) < 0).any():
        return None
    return ChunkPlan(n, m, _indptr(rows, n), cols_sa.arr.astype(np.int64))


def build_chunk_plan_transpose(rows_sa, cols_sa, n: int,
                               m: int) -> Optional[ChunkPlan]:
    """Plan of Aᵀ, ``build_chunk_plan(...).T``: the entries sorted by
    (column, row), ``perm`` their order; None where there is no row
    plan.  (The JAX package plans Aᵀ of unsorted rows too, for its p = 1
    transpose; here such patterns take the generic branch throughout.)"""
    row_plan = build_chunk_plan(rows_sa, cols_sa, n, m)
    return None if row_plan is None else row_plan.T


@lru_cache(maxsize=64)
def transpose_order(rows_sa, cols_sa, n: int, m: int):
    """The pattern's entries sorted by (column, row), for patterns with
    or without sorted rows: ``(rows_t, cols_t, perm, inv)``, the
    transpose's row and column :class:`StaticArray`s, ``perm[d]`` the
    entry at sorted position ``d`` and ``inv`` its inverse (both
    StaticArrays, so ``.on(device)`` gives the K3 gather's maps).  A
    row-sorted pattern shares its row plan's transpose (``plan.T``);
    any other takes the same lexsort.  None for an empty or batched
    pattern."""
    rows, cols = rows_sa.arr, cols_sa.arr
    if rows.ndim != 1 or len(rows) == 0:
        return None
    plan = build_chunk_plan(rows_sa, cols_sa, n, m)
    if plan is not None:
        pt = plan.T          # copies: a StaticArray makes its array read-only
        perm, inv, ct = pt.perm.copy(), pt.inv.copy(), pt.cols.copy()
        rt = np.repeat(np.arange(m, dtype=np.int64), np.diff(pt.indptr))
    else:
        rows, cols = rows.astype(np.int64), cols.astype(np.int64)
        perm = np.lexsort((rows, cols)).astype(np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=np.int64)
        rt, ct = cols[perm], rows[perm]
    return (StaticArray(rt), StaticArray(ct), StaticArray(perm),
            StaticArray(inv))


# --------------------------------------------------------------------------
# the three kernels: wrappers and their plain versions
# --------------------------------------------------------------------------

def _entry_rows(indptr: torch.Tensor) -> torch.Tensor:
    n = indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, device=indptr.device), indptr.diff())


def chunk_spmm_plain(indptr, cols, values, B):
    """Plain PyTorch version of :func:`chunk_spmm` (bf16 accumulates in
    f32, as the kernel does)."""
    acc = _build.acc_dtype(B.dtype)
    prod = values.to(acc)[:, None] * B.to(acc).index_select(0, cols)
    out = torch.zeros((indptr.shape[0] - 1, B.shape[1]), dtype=acc,
                      device=B.device)
    return out.index_add_(0, _entry_rows(indptr), prod).to(B.dtype)


def slab_bytes(nnz: int, n: int) -> int:
    """Bytes of a gathered row that one slab of K6, K13, K7 or K12
    covers, for a pattern of ``nnz`` entries in ``n`` rows:
    :data:`SHORT_SLAB_BYTES` where the rows hold fewer than
    :data:`SHORT_ROW` entries on average, else :data:`SLAB_BYTES`."""
    return SHORT_SLAB_BYTES if nnz < SHORT_ROW * n else SLAB_BYTES


def spmm_lanes(p: int, dtype: torch.dtype, aligned: bool,
               slab: int = SLAB_BYTES):
    """K6's and K13's lane grouping for B of width ``p``: ``(path, lg,
    cols)``, the C entries' ``vec`` or ``scalar`` path, log2 of the lanes
    that share one entry (``G``) and the columns of one slab (``G`` times
    a lane's columns).

    A lane reads 16 bytes (``vec``: p a multiple of 16 bytes' elements and
    B and out 16-byte ``aligned``) or one element (``scalar``).  ``G`` is
    the least power of two whose lanes cover p, at most ``slab`` bytes
    (and 32 lanes): so a wide B runs slab by slab, and a narrow one
    spreads the warp over 32 / G entries at a time.
    """
    es = torch.empty((), dtype=dtype).element_size()
    vw = 16 // es
    vec = aligned and p % vw == 0
    if not vec:
        vw = 1
    cap = max(1, min(32, slab // (vw * es)))
    lanes = 1
    while lanes < cap and lanes * vw < p:
        lanes *= 2
    return ("vec" if vec else "scalar"), lanes.bit_length() - 1, lanes * vw


def _spmm_launch_args(name, indptr, cols, B):
    """(C entry suffix, lg) of :func:`spmm_lanes` for a launch over the
    whole pattern's ``indptr`` and ``cols`` (K13 too, so that its rows
    are K6's) into a freshly allocated, so aligned, output; raises when
    the slabs would not fit the grid."""
    p = B.shape[1]
    path, lg, width = spmm_lanes(
        p, B.dtype, B.data_ptr() % 16 == 0,
        slab_bytes(cols.shape[0], indptr.shape[0] - 1))
    if -(-p // width) > MAX_COL_BLOCKS:
        raise ValueError(f"{name}: takes p <= {MAX_COL_BLOCKS * width} for "
                         f"{B.dtype} on the {path} path, got {p}")
    return f"{_build.suffix(B.dtype)}_{path}", lg


def _shapes(name, *tensors):
    return ValueError(f"{name}: bad operand shapes " + ", ".join(
        str(tuple(t.shape)) for t in tensors))


def chunk_spmm(indptr: torch.Tensor, cols: torch.Tensor,
               values: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``out[r, :] = Σ_{e in [indptr[r], indptr[r+1])} values[e] ·
    B[cols[e], :]``: int64 indptr (n+1,) and cols (nnz,), values (nnz,),
    B (m, p) -> (n, p).

    CPU tensors take :func:`chunk_spmm_plain`; CUDA tensors launch
    ``csrc/chunk_spmm.cu``, slab by slab of B's columns as
    :func:`spmm_lanes` picks, and raise on what it does not take.
    """
    if all(t.device.type == "cpu" for t in (indptr, cols, values, B)):
        return chunk_spmm_plain(indptr, cols, values, B)
    _build.cuda_operands("chunk_spmm", (values, B), (indptr, cols))
    if indptr.ndim != 1 or values.shape != cols.shape or cols.ndim != 1 \
            or B.ndim != 2:
        raise _shapes("chunk_spmm", indptr, cols, values, B)
    n, p = indptr.shape[0] - 1, B.shape[1]
    entry, lg = _spmm_launch_args("chunk_spmm", indptr, cols, B)
    out = torch.empty((n, p), dtype=B.dtype, device=B.device)
    if out.numel() == 0:
        return out
    _build.launch("chunk_spmm", f"tsgu_chunk_spmm_{entry}", indptr, cols,
                  values, B, out, n, p, lg)
    chunk_spmm.launches += 1
    return out


chunk_spmm.launches = 0


def chunk_spmm_slab_plain(indptr, cols, values, B, row0: int, rps: int):
    """Plain PyTorch version of :func:`chunk_spmm_slab`."""
    n = indptr.shape[0] - 1
    r0, r1 = min(row0, n), min(row0 + rps, n)
    ip = indptr[r0:r1 + 1]
    lo, hi = int(ip[0]), int(ip[-1])
    out = chunk_spmm_plain(ip - lo, cols[lo:hi], values[lo:hi], B)
    return torch.cat([out, out.new_zeros((rps - (r1 - r0), B.shape[1]))])


def chunk_spmm_slab(indptr: torch.Tensor, cols: torch.Tensor,
                    values: torch.Tensor, B: torch.Tensor, row0: int,
                    rps: int) -> torch.Tensor:
    """Rows ``[row0, row0 + rps)`` of :func:`chunk_spmm`'s product, as a
    ``(rps, p)`` slab whose rows at or past n are 0 (K13, one shard's
    SpMM): the global int64 indptr (n+1,) and cols (nnz,) and values
    (nnz,) are read in place.

    CPU tensors take :func:`chunk_spmm_slab_plain`; CUDA tensors launch
    ``csrc/chunk_spmm.cu``'s slab entry and raise on what it does not
    take.
    """
    if all(t.device.type == "cpu" for t in (indptr, cols, values, B)):
        return chunk_spmm_slab_plain(indptr, cols, values, B, row0, rps)
    _build.cuda_operands("chunk_spmm_slab", (values, B), (indptr, cols))
    if indptr.ndim != 1 or values.shape != cols.shape or cols.ndim != 1 \
            or B.ndim != 2:
        raise _shapes("chunk_spmm_slab", indptr, cols, values, B)
    n, p = indptr.shape[0] - 1, B.shape[1]
    if row0 < 0 or rps < 0:
        raise ValueError(f"chunk_spmm_slab: needs row0 >= 0 and rps >= 0, "
                         f"got {row0}, {rps}")
    entry, lg = _spmm_launch_args("chunk_spmm_slab", indptr, cols, B)
    out = torch.empty((rps, p), dtype=B.dtype, device=B.device)
    if out.numel() == 0:
        return out
    _build.launch("chunk_spmm", f"tsgu_chunk_spmm_slab_{entry}", indptr,
                  cols, values, B, out, n, row0, rps, p, lg)
    chunk_spmm_slab.launches += 1
    return out


chunk_spmm_slab.launches = 0


def chunk_sddmm_plain(indptr, cols, X, Y):
    """Plain PyTorch version of :func:`chunk_sddmm`."""
    acc = _build.acc_dtype(X.dtype)
    Xe = X.to(acc).index_select(0, _entry_rows(indptr))
    return (Xe * Y.to(acc).index_select(0, cols)).sum(-1).to(X.dtype)


def sddmm_passes(p: int, dtype: torch.dtype, aligned: bool, nnz: int,
                 n: int):
    """K7's (and K12's) lanes and column slabs for operands of width
    ``p`` at a pattern of ``nnz`` entries in ``n`` rows: ``(path, lg,
    cols, passes)``, :func:`spmm_lanes` at :func:`slab_bytes`'s slab
    (``aligned``: X and Y, or G and B, both 16-byte aligned) and the
    number of slabs, one launch of K7 each (at least one: p <= 8, and p
    = 0, take one pass of the narrow path)."""
    path, lg, width = spmm_lanes(p, dtype, aligned, slab_bytes(nnz, n))
    return path, lg, width, max(1, -(-p // width))


def _sddmm_launch_args(name, indptr, cols, X, Y):
    """(path, lg, passes) of :func:`sddmm_passes` for a launch with row
    operand X and gathered operand Y; raises where Y has more rows than
    K7's 32-bit column indices reach."""
    if Y.shape[0] > MAX_SDDMM_ROWS:
        raise ValueError(f"{name}: takes at most {MAX_SDDMM_ROWS} rows of "
                         f"the gathered operand, got {Y.shape[0]}")
    path, lg, _, passes = sddmm_passes(
        X.shape[1], X.dtype, X.data_ptr() % 16 == 0 and Y.data_ptr() % 16
        == 0, cols.shape[0], indptr.shape[0] - 1)
    return path, lg, passes


def chunk_sddmm(indptr: torch.Tensor, cols: torch.Tensor, X: torch.Tensor,
                Y: torch.Tensor) -> torch.Tensor:
    """``out[e] = dot(X[r, :], Y[cols[e], :])`` for the entries ``e`` of
    row ``r`` (``[indptr[r], indptr[r+1])``), in entry order: X (n, p),
    Y (m, p) -> (nnz,).

    CPU tensors take :func:`chunk_sddmm_plain`; CUDA tensors launch
    ``csrc/chunk_sddmm.cu`` once per column slab of :func:`sddmm_passes`,
    in stream order, and raise on what it does not take.
    """
    if all(t.device.type == "cpu" for t in (indptr, cols, X, Y)):
        return chunk_sddmm_plain(indptr, cols, X, Y)
    suffix = _build.cuda_operands("chunk_sddmm", (X, Y), (indptr, cols))
    if indptr.ndim != 1 or cols.ndim != 1 or X.ndim != 2 or Y.ndim != 2 \
            or X.shape[1] != Y.shape[1] or X.shape[0] != indptr.shape[0] - 1:
        raise _shapes("chunk_sddmm", indptr, cols, X, Y)
    n, p = X.shape
    out = torch.empty(cols.shape, dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    path, lg, passes = _sddmm_launch_args("chunk_sddmm", indptr, cols,
                                          X, Y)
    entry = f"tsgu_chunk_sddmm_{suffix}_{path}"
    acc = _build.acc_dtype(X.dtype)
    # the sums of the passes so far: out itself, or a float buffer for
    # bfloat16
    part = out if acc == X.dtype or passes == 1 else torch.empty(
        cols.shape, dtype=acc, device=X.device)
    for s in range(passes):
        _build.launch("chunk_sddmm", entry, indptr, cols, X, Y, part, out,
                      n, p, lg, s, passes)
    chunk_sddmm.launches += 1
    return out


chunk_sddmm.launches = 0


def chunk_spmv_plain(indptr, cols, values, x):
    """Plain PyTorch version of :func:`chunk_spmv`."""
    acc = _build.acc_dtype(x.dtype)
    out = torch.zeros(indptr.shape[0] - 1, dtype=acc, device=x.device)
    return out.index_add_(0, _entry_rows(indptr),
                          values.to(acc) * x.to(acc)[cols]).to(x.dtype)


def chunk_spmv(indptr: torch.Tensor, cols: torch.Tensor,
               values: torch.Tensor, x: torch.Tensor,
               packs: Optional[LsePacks] = None) -> torch.Tensor:
    """``y[r] = Σ_{e in [indptr[r], indptr[r+1])} values[e] · x[cols[e]]``:
    x (m,) -> (n,).

    CPU tensors take :func:`chunk_spmv_plain`; CUDA tensors launch
    ``csrc/chunk_spmv.cu`` over the row packs ``packs`` cut at
    ``SPMV_PACK`` entries (:func:`.row_packs.plan_packs` of the plan at
    ``SPMV_PACK``, as :class:`ChunkSpmm` passes them; built from a host
    copy of ``indptr`` when None, for a direct call) and raise on what it
    does not take, a table cut for another pattern or size too.
    """
    if all(t.device.type == "cpu" for t in (indptr, cols, values, x)):
        return chunk_spmv_plain(indptr, cols, values, x)
    suffix = _build.cuda_operands("chunk_spmv", (values, x), (indptr, cols))
    if indptr.ndim != 1 or values.shape != cols.shape or cols.ndim != 1 \
            or x.ndim != 1:
        raise _shapes("chunk_spmv", indptr, cols, values, x)
    n = indptr.shape[0] - 1
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    packs = _packs_for("chunk_spmv", indptr, values, packs, SPMV_PACK)
    _build.launch("chunk_spmv", f"tsgu_chunk_spmv_{suffix}", indptr, cols,
                  values, x, packs.table, out, packs.table.shape[0] - 1)
    chunk_spmv.launches += 1
    return out


chunk_spmv.launches = 0


def chunk_bwd_cols_plain(indptr_t, cols_t, perm, inv, values, B, G,
                         fast: bool = False):
    """Plain PyTorch version of :func:`chunk_bwd_cols`: ``dd`` is
    :func:`chunk_sddmm_plain`'s arithmetic at A's entries, ``dB`` the
    column sums of the products ``values[e] · G[row_e]`` rounded to
    bfloat16 (``fast``, or B in bfloat16), summed in the accumulation
    dtype."""
    acc = _build.acc_dtype(B.dtype)
    col = _entry_rows(indptr_t)           # A's column of each entry, in order
    rows, cols = cols_t.index_select(0, inv), col.index_select(0, inv)
    dd = (G.to(acc).index_select(0, rows) * B.to(acc).index_select(
        0, cols)).sum(-1).to(B.dtype)
    prod = values.to(acc).index_select(0, perm)[:, None] * G.to(
        acc).index_select(0, cols_t)
    prod = prod.to(torch.bfloat16 if fast else B.dtype).to(acc)
    dB = torch.zeros(B.shape, dtype=acc, device=B.device)
    return dd, dB.index_add_(0, col, prod).to(B.dtype)


def chunk_bwd_cols(indptr_t: torch.Tensor, cols_t: torch.Tensor,
                   perm: torch.Tensor, inv: torch.Tensor,
                   values: torch.Tensor, B: torch.Tensor, G: torch.Tensor,
                   fast: bool = False):
    """The fused backward of ``A @ B`` (K12) in one pass over the
    transpose plan: for each column ``c`` of A and each position ``d`` in
    ``[indptr_t[c], indptr_t[c+1])``, with ``r = cols_t[d]`` and ``e =
    perm[d]``, ``dd[e] = dot(G[r], B[c])`` (gradA, in A's entry order)
    and ``dB[c] = Σ_d values[e] · G[r]`` (gradB = Aᵀ G), each product
    rounded to bfloat16 before the sum under ``fast``
    (``grad_precision="fast"``): indptr_t (m+1,), cols_t, perm and its
    inverse inv (nnz,), values (nnz,) in A's order, B (m, p), G (n, p)
    -> dd (nnz,), dB (m, p).

    CPU tensors take :func:`chunk_bwd_cols_plain`.  CUDA tensors launch
    ``csrc/chunk_bwd_fused.cu`` on K7's lanes and slabs for (X, Y) = (G,
    B), so dd is :func:`chunk_sddmm`'s bitwise, between two K3 gathers
    (:func:`.window_gather.window_gather`): the values into column order
    before it, its dd into A's order after it; and raise on what they do
    not take.
    """
    if all(t.device.type == "cpu" for t in (indptr_t, cols_t, perm, inv,
                                             values, B, G)):
        return chunk_bwd_cols_plain(indptr_t, cols_t, perm, inv, values, B,
                                    G, fast)
    suffix = _build.cuda_operands("chunk_bwd_cols", (values, B, G),
                                  (indptr_t, cols_t, perm, inv))
    if indptr_t.ndim != 1 or cols_t.ndim != 1 \
            or not cols_t.shape == perm.shape == inv.shape == values.shape \
            or B.ndim != 2 or G.ndim != 2 \
            or B.shape != (indptr_t.shape[0] - 1, G.shape[1]):
        raise _shapes("chunk_bwd_cols", indptr_t, cols_t, perm, inv, values,
                      B, G)
    if G.shape[0] > MAX_SDDMM_ROWS:
        raise ValueError(f"chunk_bwd_cols: takes at most {MAX_SDDMM_ROWS} "
                         f"rows of G, got {G.shape[0]}")
    (n, p), m, nnz = G.shape, B.shape[0], values.shape[0]
    dB = torch.empty((m, p), dtype=B.dtype, device=B.device)
    if nnz == 0 or p == 0:
        return torch.zeros_like(values), dB.zero_()
    # K7's lanes and slabs for (X, Y) = (G, B), so that dd is K7's bitwise
    path, lg, _, _ = sddmm_passes(
        p, B.dtype, G.data_ptr() % 16 == 0 and B.data_ptr() % 16 == 0, nnz,
        n)
    vals_t = window_gather(values, perm)
    # dd in column order, in the accumulation dtype: the slabs' running sum
    dd_t = torch.empty(nnz, dtype=_build.acc_dtype(B.dtype),
                       device=B.device)
    rsuffix = "bf16" if fast else suffix
    _build.launch("chunk_bwd_fused",
                  f"tsgu_chunk_bwd_cols_{suffix}_{rsuffix}_{path}", indptr_t,
                  cols_t, vals_t, B, G, dd_t, dB, m, p, lg)
    chunk_bwd_cols.launches += 1
    return window_gather(dd_t, inv).to(B.dtype), dB


chunk_bwd_cols.launches = 0


def chunk_bwd_fused(plan: "ChunkPlan", plan_t: "ChunkPlan", values, B, G,
                    fast: bool = False):
    """``(d_values, d_B)`` of ``A @ B`` for the output cotangent ``G`` by
    the fused backward, :func:`chunk_bwd_cols` over ``plan``'s transpose
    plan ``plan_t`` (whose maps are all it reads): one pass in column
    order that writes no (nnz, p) rows.  ``fast`` rounds each product ``values[e] · G[row_e]`` to
    bfloat16 before the column sum (gradB gains about 1e-3 relative
    error, gradA stays exact)."""
    dt = plan_t.maps(B.device)
    return chunk_bwd_cols(dt["indptr"], dt["cols"], dt["perm"], dt["inv"],
                          values.contiguous(), B.contiguous(),
                          G.contiguous(), fast)


def chunk_bwd_fused_plain(plan: "ChunkPlan", plan_t: "ChunkPlan", values, B,
                          G, fast: bool = False):
    """Plain PyTorch version of :func:`chunk_bwd_fused`, on any device."""
    dt = plan_t.maps(B.device)
    return chunk_bwd_cols_plain(dt["indptr"], dt["cols"], dt["perm"],
                                dt["inv"], values, B, G, fast)


# --------------------------------------------------------------------------
# differentiable Functions
# --------------------------------------------------------------------------

class ChunkSpmm(torch.autograd.Function):
    """Differentiable ``A @ B`` over a :class:`ChunkPlan`, ``values`` in
    the plan's entry order; p = 1 runs :func:`chunk_spmv` (over the
    plan's cached row packs on the card), wider B :func:`chunk_spmm`.

    Backward, split (``fused`` None, the default): ``d_values =
    ChunkSddmm(plan, G, B)`` and ``d_B = ChunkSpmm(plan.T,
    plan.to_T(values), G)``.  With ``fused`` a bool (the
    ``kernels/dia.py:SPMM_BWD = "fused"`` switch), both come from
    :class:`ChunkBwdPair`, one launch of K12, its products rounded to
    bfloat16 when ``fused`` is True.
    """

    @staticmethod
    def forward(ctx, plan, values, B, fused=None):
        ctx.plan, ctx.fused = plan, fused
        ctx.save_for_backward(values, B)
        d = plan.maps(B.device)
        values, B = values.contiguous(), B.contiguous()
        if B.shape[1] == 1:
            packs = None if B.device.type == "cpu" else plan_packs(
                plan, B.device, SPMV_PACK)
            return chunk_spmv(d["indptr"], d["cols"], values, B.view(-1),
                              packs).view(-1, 1)
        return chunk_spmm(d["indptr"], d["cols"], values, B)

    @staticmethod
    def backward(ctx, G):
        values, B = ctx.saved_tensors
        plan = ctx.plan
        need = ctx.needs_input_grad
        if ctx.fused is not None and need[1] and need[2]:
            d_values, d_B = ChunkBwdPair.apply(plan, ctx.fused, values, B, G)
            return None, d_values, d_B, None
        d_values = d_B = None
        if need[1]:
            d_values = ChunkSddmm.apply(plan, G, B)
        if need[2]:
            d_B = ChunkSpmm.apply(plan.T, plan.to_T(values), G)
        return None, d_values, d_B, None


class ChunkBwdPair(torch.autograd.Function):
    """``(d_values, d_B)`` of ``A @ B`` by :func:`chunk_bwd_fused` (K12),
    the JAX package's ``_spmm_bwd_pair`` under
    ``TSGU_SPMM_BWD=fused``.  Its own backward is built from
    :class:`ChunkSddmm` and :class:`ChunkSpmm` (split), so second
    derivatives match the split backward's."""

    @staticmethod
    def forward(ctx, plan, fast, values, B, G):
        ctx.plan = plan
        ctx.save_for_backward(values, B, G)
        return chunk_bwd_fused(plan, plan.T, values, B, G, fast)

    @staticmethod
    def backward(ctx, ct_dd, ct_dB):
        values, B, G = ctx.saved_tensors
        plan = ctx.plan
        need = ctx.needs_input_grad
        d_values = d_B = d_G = None
        if need[2]:                     # from d_B = Aᵀ G
            d_values = ChunkSddmm.apply(plan, G, ct_dB)
        if need[3]:                     # from d_values = sddmm(G, B)
            d_B = ChunkSpmm.apply(plan.T, plan.to_T(ct_dd), G)
        if need[4]:
            d_G = ChunkSpmm.apply(plan, ct_dd, B) + ChunkSpmm.apply(
                plan, values, ct_dB)
        return None, None, d_values, d_B, d_G


class ChunkSddmm(torch.autograd.Function):
    """Differentiable ``dot(X[row_e], Y[col_e])`` at a :class:`ChunkPlan`'s
    entries, in its entry order.

    Backward: ``d_X = ChunkSpmm(plan, ct, Y)`` and
    ``d_Y = ChunkSpmm(plan.T, plan.to_T(ct), X)``.
    """

    @staticmethod
    def forward(ctx, plan, X, Y):
        ctx.plan = plan
        ctx.save_for_backward(X, Y)
        d = plan.maps(X.device)
        return chunk_sddmm(d["indptr"], d["cols"], X.contiguous(),
                           Y.contiguous())

    @staticmethod
    def backward(ctx, ct):
        X, Y = ctx.saved_tensors
        plan = ctx.plan
        d_X = d_Y = None
        if ctx.needs_input_grad[1]:
            d_X = ChunkSpmm.apply(plan, ct, Y)
        if ctx.needs_input_grad[2]:
            d_Y = ChunkSpmm.apply(plan.T, plan.to_T(ct), X)
        return None, d_X, d_Y
