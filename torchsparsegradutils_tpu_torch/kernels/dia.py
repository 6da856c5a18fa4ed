"""Diagonal-structured (DIA) execution of SpMM and SDDMM.

Port of ``torchsparsegradutils_tpu/kernels/dia.py``.  Stencil and FEM
operators, banded factors and encoder outputs are unions of a few
diagonals.  Their entries on the selected diagonals live in an
``(n, K)`` value grid, and every product becomes K shifted dense rows:

    out[r, :]    = Σ_k  grid[r, k] · B[r + off_k, :]          (SpMM)
    d_grid[r, k] = Σ_p  X[r, p] · Y[r + off_k, p]             (SDDMM)
    (Aᵀ G)[c, :] = Σ_k  grid[c - off_k, k] · G[c - off_k, :]  (transpose)

The transpose is the SpMM again, over the negated offsets and a
column-shifted grid (:meth:`DiaGeometry.shift`).

Three hand-written CUDA kernels carry the engine, each beside its plain
PyTorch version:

* :func:`spmm_core` (``csrc/dia_spmm.cu``) and :func:`sddmm_core`
  (``csrc/dia_sddmm.cu``), here;
* :func:`~.window_gather.window_gather` (``csrc/gather.cu``), which moves
  values between CSR order and the grid.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.  :class:`DiaSpmmCore` and
:class:`DiaSddmmCore` make the two cores differentiable, each backward
calling the Functions again, so higher derivatives work.

A plan is built on the host from the pattern (numpy, as in the JAX
package) and cached on the pattern's content hash.  The entries off the
selected diagonals of a hybrid pattern form a residual, a general
row-sorted sub-pattern.  On the card a residual of at least
``RESID_MIN_NNZ`` entries runs the chunk engine (``kernels/chunk_spmm.py``,
as the JAX package routes it when ``_resid_chunk_ok`` holds); smaller
ones, and every residual on the CPU, take the JAX package's gather +
segment-sum branch in plain PyTorch (``index_select`` + ``index_add``).
:data:`RESID_ENGINE` forces either route.

Example:
    >>> import torch
    >>> from torchsparsegradutils_tpu_torch import sparse_mm
    >>> from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    ...     stencil_sparse)
    >>> A = stencil_sparse((64, 64), [-8, 0, 8], device="cpu")
    >>> B = torch.ones(64, 4)
    >>> out = sparse_mm(A, B, backend="dia")
    >>> bool(torch.allclose(out, A.todense() @ B, atol=1e-5))
    True
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..types import StaticArray
from . import _build
from .chunk_spmm import (ChunkBwdPair, ChunkSddmm, ChunkSpmm,
                         build_chunk_plan)
from .window_gather import WindowGather

MAX_DIAGS = 256          # offsets above this: not DIA-structured
DIA_MAX_EXPAND = 4.0     # grid cells (K*n) must be <= this x covered nnz
HYBRID_MIN_COVER = 0.7   # diagonals must cover >= this nnz fraction
# csrc/dia_spmm.cu's tile configurations, (VW, LANES, RG, RT) as its C
# entries instantiate them: a block of LANES x RG threads owns R = RG x RT
# rows and PT = LANES x VW columns; VW = 4 takes vectors of four elements
# (p % 4 == 0, B aligned), VW = 1 single elements.
SPMM_TILES = {"v32": (4, 8, 16, 8), "v16": (4, 4, 32, 8),
              "s32": (1, 32, 8, 8), "s4": (1, 4, 32, 4), "s1": (1, 1, 256, 1)}
WINDOW_B_BYTES = 40 * 1024   # shared memory of one stage's B window ...
WINDOW_G_BYTES = 16 * 1024   # ... and of its grid columns: two stages fit
WINDOW_MAX_COUNT = 32        # offsets of one window, at most


class DiaGeometry:
    """The diagonals of a DIA operator: sorted ``offsets`` (numpy int64),
    ``n`` output rows (grid rows) and ``m`` source rows.

    ``T`` is the transpose's geometry: offsets ``-offsets`` reversed,
    ``m`` output rows and ``n`` source rows.
    """

    def __init__(self, offsets: np.ndarray, n: int, m: int,
                 transpose: "DiaGeometry" = None):
        self.offsets = np.asarray(offsets, np.int64)
        self.n, self.m = int(n), int(m)
        self._T = transpose
        self._dev = {}

    @property
    def K(self) -> int:
        return len(self.offsets)

    @property
    def T(self) -> "DiaGeometry":
        if self._T is None:
            self._T = DiaGeometry(-self.offsets[::-1], self.m, self.n,
                                  transpose=self)
        return self._T

    def offsets_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = torch.from_numpy(
                self.offsets.copy()).to(device)
        return t

    def windows(self, rows_per_tile: int, cap: int,
                max_count: int = WINDOW_MAX_COUNT) -> np.ndarray:
        """The offset windows of K1's tiles of ``rows_per_tile`` rows
        (:func:`window_table`), cached per argument."""
        key = ("windows", rows_per_tile, cap, max_count)
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = window_table(self.offsets, rows_per_tile,
                                              cap, max_count)
        return t

    def windows_on(self, device, rows_per_tile: int, cap: int,
                   max_count: int = WINDOW_MAX_COUNT) -> tuple:
        """What K1 takes of :meth:`windows`, cached per device and
        argument: ``(plan, W, runs, span_max, count_max)``, ``plan`` the
        int64 :func:`window_plan` on ``device``, ``W`` its windows,
        ``runs`` its runs, and the largest window span and count."""
        key = ("windows", rows_per_tile, cap, max_count, device)
        t = self._dev.get(key)
        if t is None:
            table = self.windows(rows_per_tile, cap, max_count)
            if table.size and np.abs(table[:, 2:]).max() >= 2**30:
                raise ValueError("dia spmm_core: takes offsets below 2**30 "
                                 "in size")
            plan = window_plan(self.offsets, table)
            W = len(table)
            t = self._dev[key] = (
                torch.from_numpy(plan).to(device), W,
                (len(plan) - 5 * W - 1) // 3,
                int((table[:, 3] - table[:, 2]).max(initial=0)),
                int(table[:, 1].max(initial=0)))
        return t

    def shift(self, grid: torch.Tensor) -> torch.Tensor:
        """``(n, K)`` grid -> the transpose's ``(m, K)`` grid,
        ``gT[c, kT] = grid[c - off_k, k]`` with ``kT = K - 1 - k``
        (0 where ``c - off_k`` is outside ``[0, n)``).

        One zero pad of the rows and K column slices, as the JAX package
        does outside its kernels (``kernels/dia.py:_transpose_grid``);
        differentiable through PyTorch's own ops.
        """
        offs = self.offsets
        lo = max(0, int(offs.max()))
        hi = max(0, self.m - self.n - int(offs.min()))
        gp = F.pad(grid, (0, 0, lo, hi))
        cols = [gp[lo - int(off):lo - int(off) + self.m, k]
                for k, off in reversed(list(enumerate(offs)))]
        return torch.stack(cols, dim=1)


def window_table(offsets, rows_per_tile: int, cap: int,
                 max_count: int = WINDOW_MAX_COUNT) -> np.ndarray:
    """Group sorted ``offsets`` into the windows that K1 stages in shared
    memory: ``(W, 4)`` int64 rows ``(k_first, count, off_lo, off_hi)``.

    Greedy from the first offset: the next one joins the current window
    when its gap to the previous offset is below ``rows_per_tile`` (the
    tile's B rows then overlap), the window's span ``off_hi - off_lo``
    stays within ``cap`` and it holds at most ``max_count`` offsets.
    Offsets farther apart get a window each, which stages the same B rows
    as reading them one offset at a time.
    """
    wins = []
    for k, off in enumerate(int(o) for o in offsets):
        if wins:
            w = wins[-1]
            if (off - w[3] < rows_per_tile and off - w[2] <= cap
                    and w[1] < max_count):
                w[1] += 1
                w[3] = off
                continue
        wins.append([k, 1, off, off])
    return np.array(wins, np.int64).reshape(-1, 4)


def window_plan(offsets, table: np.ndarray) -> np.ndarray:
    """What K1 reads of a window table, flat int64: the ``(W, 4)`` rows,
    then ``W + 1`` run starts, then the runs of consecutive offsets in
    each window as ``(k - k_first, off_k - off_lo, length)``, window by
    window (window ``w``'s runs are ``first[w]`` to ``first[w + 1]``)."""
    offs = np.asarray(offsets, np.int64)
    first, runs = [0], []
    for kf, cnt, lo, _ in table.tolist():
        k = kf
        while k < kf + cnt:
            L = 1
            while k + L < kf + cnt and offs[k + L] == offs[k + L - 1] + 1:
                L += 1
            runs.append((k - kf, offs[k] - lo, L))
            k += L
        first.append(len(runs))
    return np.concatenate([table.reshape(-1), np.array(first, np.int64),
                           np.array(runs, np.int64).reshape(-1)])


@dataclass(frozen=True, eq=False)
class DiaPlan:
    """Execution plan for a (possibly hybrid) diagonal-structured matrix.

    Entries on the selected diagonals live in the ``(n, K)`` value grid;
    the rest (``resid_*``, at most ``1 - HYBRID_MIN_COVER`` of nnz) form
    the residual.  The value moves are plain partial maps, kept on the
    host and, per device, as int64 tensors (:meth:`maps`):

    * ``src_of_grid`` (n*K,): entry feeding each grid slot, or -1;
    * ``pos`` (nnz,): grid slot of each entry, or -1 (residual);
    * ``resid_sel`` (nnz_r,): entry of each residual value;
      ``resid_expand`` (nnz,) its inverse, -1 off the residual.
    """
    n: int
    m: int
    nnz: int
    offsets: np.ndarray
    K: int
    pos: np.ndarray
    src_of_grid: np.ndarray
    geo: DiaGeometry
    resid_rows: Optional[np.ndarray] = None
    resid_cols: Optional[np.ndarray] = None
    resid_sel: Optional[np.ndarray] = None
    resid_expand: Optional[np.ndarray] = None
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def span(self) -> int:
        return int(self.offsets[-1] - self.offsets[0])

    @property
    def is_hybrid(self) -> bool:
        return self.resid_sel is not None

    def maps(self, device) -> dict:
        """The plan's index maps as int64 tensors on ``device`` (cached)."""
        device = torch.device(device)
        d = self._dev.get(device)
        if d is None:
            names = ["src_of_grid", "pos"]
            if self.is_hybrid:
                names += ["resid_rows", "resid_cols", "resid_sel",
                          "resid_expand"]
            d = self._dev[device] = {
                k: torch.from_numpy(np.array(getattr(self, k), np.int64)
                                    ).to(device) for k in names}
        return d


def _select_diagonals(offs: np.ndarray, n: int):
    """The diagonal-selection rule shared by :func:`dia_coverage` and
    :func:`build_dia_plan` (the JAX package's ``_select_diagonals``).

    Keeps the densest diagonals within two budgets: each kept diagonal
    carries at least ``n / DIA_MAX_EXPAND`` entries (stray diagonals of a
    hybrid remainder stay residual), and in all ``K * n <= DIA_MAX_EXPAND
    * covered``.  When the first budget alone loses the 70 % coverage
    (uniformly thinned diagonals), the selection is retried with the
    aggregate budget only.

    Returns ``(keep_n, kept_order_idx, covered, uniq_offsets)``.
    """
    uniq, counts = np.unique(offs, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    cap = min(len(uniq), MAX_DIAGS)
    kept = order[:cap]
    cum = np.cumsum(counts[kept])

    def shrink(keep_n):
        while keep_n > 0 and keep_n * n > DIA_MAX_EXPAND * cum[keep_n - 1]:
            keep_n -= 1
        return keep_n

    keep_n = shrink(min(cap, int((counts[kept] * DIA_MAX_EXPAND >= n).sum())))
    covered = int(cum[keep_n - 1]) if keep_n else 0
    if covered < HYBRID_MIN_COVER * len(offs):
        keep_a = shrink(cap)
        cov_a = int(cum[keep_a - 1]) if keep_a else 0
        if cov_a >= HYBRID_MIN_COVER * len(offs):
            return keep_a, kept, cov_a, uniq
    return keep_n, kept, covered, uniq


def dia_coverage(A) -> dict:
    """How diagonal-structured a pattern is: the statistic the DIA gate
    uses.

    Returns a dict with ``nnz``, ``total_diagonals`` (distinct offsets),
    ``kept_diagonals`` (K of the budgeted selection), ``coverage``
    (fraction of nnz on the kept diagonals), ``qualifies`` (whether
    :func:`build_dia_plan` returns a plan) and ``residual_nnz``.  A
    batched pattern reports ``qualifies=False``.
    """
    rs, cs = A.row_sa(), A.col_sa()
    if rs.arr.ndim != 1:
        return {"nnz": A.nnz, "total_diagonals": -1, "kept_diagonals": 0,
                "coverage": 0.0, "qualifies": False, "residual_nnz": -1}
    n, m = A.mat_shape
    offs = cs.arr.astype(np.int64) - rs.arr.astype(np.int64)
    nnz = len(offs)
    keep_n, kept, covered, uniq = _select_diagonals(offs, n)
    plan = build_dia_plan(rs, cs, n, m)
    return {
        "nnz": nnz,
        "total_diagonals": int(len(uniq)),
        "kept_diagonals": int(keep_n),
        "coverage": covered / max(nnz, 1),
        "qualifies": plan is not None,
        "residual_nnz": nnz - covered,
    }


@lru_cache(maxsize=64)
def build_dia_plan(rows_sa, cols_sa, n: int, m: int) -> Optional[DiaPlan]:
    """DIA plan of a pattern, or None when it does not qualify.

    Needs entries in row-major (CSR) order.  Keeps the densest diagonals
    (:func:`_select_diagonals`); when they cover at least
    ``HYBRID_MIN_COVER`` of nnz the rest becomes the residual.  Cached on
    the content hash of the index arrays.
    """
    rows = rows_sa.arr.astype(np.int64)
    cols = cols_sa.arr.astype(np.int64)
    nnz = len(rows)
    if rows.ndim != 1 or nnz == 0:
        return None
    if nnz > 1:
        d = np.diff(rows)
        if (d < 0).any():
            return None
        if ((d == 0) & (np.diff(cols) <= 0)).any():
            return None
    offs = cols - rows
    keep_n, kept, covered, uniq = _select_diagonals(offs, n)
    if keep_n == 0 or covered < HYBRID_MIN_COVER * nnz:
        return None
    sel_offsets = np.sort(uniq[kept[:keep_n]])
    K = len(sel_offsets)
    on_dia = np.isin(offs, sel_offsets)
    diag_idx = np.searchsorted(sel_offsets, offs)
    pos = np.where(on_dia, rows * K + diag_idx, -1)
    src_of_grid = np.full(n * K, -1, np.int64)
    src_of_grid[pos[on_dia]] = np.nonzero(on_dia)[0]
    geo = DiaGeometry(sel_offsets, n, m)
    if covered == nnz:
        return DiaPlan(n=n, m=m, nnz=nnz, offsets=sel_offsets, K=K, pos=pos,
                       src_of_grid=src_of_grid, geo=geo)
    resid_sel = np.nonzero(~on_dia)[0]
    resid_expand = np.full(nnz, -1, np.int64)
    resid_expand[resid_sel] = np.arange(len(resid_sel))
    return DiaPlan(n=n, m=m, nnz=nnz, offsets=sel_offsets, K=K, pos=pos,
                   src_of_grid=src_of_grid, geo=geo,
                   resid_rows=rows[resid_sel], resid_cols=cols[resid_sel],
                   resid_sel=resid_sel, resid_expand=resid_expand)


# --------------------------------------------------------------------------
# value relayouts (differentiable; each backward is the inverse gather)
# --------------------------------------------------------------------------

def values_to_grid(plan: DiaPlan, values: torch.Tensor) -> torch.Tensor:
    """(nnz,) CSR-order values -> (n, K) diagonal grid, 0 at holes."""
    d = plan.maps(values.device)
    return WindowGather.apply(values, d["src_of_grid"], d["pos"]).view(
        plan.n, plan.K)


def grid_to_values(plan: DiaPlan, grid: torch.Tensor) -> torch.Tensor:
    """(n, K) grid -> (nnz,) values, 0 at a hybrid plan's residual."""
    d = plan.maps(grid.device)
    return WindowGather.apply(grid.reshape(-1), d["pos"], d["src_of_grid"])


def resid_values(plan: DiaPlan, values: torch.Tensor) -> torch.Tensor:
    """(nnz,) values -> (nnz_r,) residual values of a hybrid plan."""
    d = plan.maps(values.device)
    return WindowGather.apply(values, d["resid_sel"], d["resid_expand"])


def resid_expand_values(plan: DiaPlan, rvals: torch.Tensor) -> torch.Tensor:
    """(nnz_r,) residual values -> (nnz,) slots, 0 elsewhere."""
    d = plan.maps(rvals.device)
    return WindowGather.apply(rvals, d["resid_expand"], d["resid_sel"])


# --------------------------------------------------------------------------
# the two DIA cores: kernel wrappers and their plain versions
# --------------------------------------------------------------------------

def _shifted_rows(offsets, X: torch.Tensor, n: int, acc: torch.dtype):
    """Yield ``(k, view)`` with ``view[r] = X[r + off_k]`` (0 outside)."""
    offs = (offsets.tolist() if isinstance(offsets, torch.Tensor)
            else [int(o) for o in offsets])
    lo = max(0, -min(offs))
    hi = max(0, max(offs) + n - X.shape[0])
    Xp = F.pad(X.to(acc), (0, 0, lo, hi))
    for k, off in enumerate(offs):
        yield k, Xp[off + lo:off + lo + n]


def spmm_core_plain(offsets, grid: torch.Tensor, B: torch.Tensor):
    """Plain PyTorch version of :func:`spmm_core` (bf16 accumulates in
    f32, as the kernel does).  ``offsets`` may be a tensor or a list."""
    n = grid.shape[0]
    acc = _build.acc_dtype(grid.dtype)
    g = grid.to(acc)
    out = torch.zeros((n, B.shape[1]), dtype=acc, device=B.device)
    for k, Bs in _shifted_rows(offsets, B, n, acc):
        out.addcmul_(g[:, k:k + 1], Bs)
    return out.to(grid.dtype)


def spmm_tile(B: torch.Tensor):
    """K1's tile configuration for B (m, p): ``(name, rows, cols, cap,
    max_count)``, the window ``cap`` and ``max_count`` sized so that a
    stage fits :data:`WINDOW_B_BYTES` and :data:`WINDOW_G_BYTES`."""
    es, p = B.element_size(), B.shape[1]
    if p % 4 == 0 and B.data_ptr() % min(16, 4 * es) == 0:
        name = "v32" if p >= 32 and es <= 4 else "v16"
    else:
        name = "s1" if p == 1 else "s4" if p < 32 else "s32"
    return _tile(name, es)


@lru_cache(maxsize=None)
def _tile(name: str, es: int):
    vw, lanes, rg, rt = SPMM_TILES[name]
    rows, cols = rg * rt, lanes * vw
    cap = max(1, WINDOW_B_BYTES // (cols * es) - rows)
    max_count = min(WINDOW_MAX_COUNT,
                    max(1, WINDOW_G_BYTES // ((rows + 4) * es)))
    return name, rows, cols, cap, max_count


def spmm_core(offsets: torch.Tensor, grid: torch.Tensor,
              B: torch.Tensor, geo: DiaGeometry = None) -> torch.Tensor:
    """``out[r, :] = Σ_k grid[r, k] · B[r + off_k, :]``: grid (n, K),
    B (m, p), int64 sorted offsets (K,) -> (n, p).

    CPU tensors take :func:`spmm_core_plain`; CUDA tensors launch
    ``csrc/dia_spmm.cu`` and raise on what it does not take.  The kernel
    reads the offsets' windows (:func:`window_plan` of
    :func:`window_table`, for the tile :func:`spmm_tile` picks) from
    ``geo``, cached there (``geo.offsets`` must be ``offsets``), or from
    the offsets, copied to the host, when ``geo`` is None.
    """
    if all(t.device.type == "cpu" for t in (offsets, grid, B)):
        return spmm_core_plain(offsets, grid, B)
    suffix = _build.cuda_operands("dia spmm_core", (grid, B), (offsets,))
    if grid.ndim != 2 or B.ndim != 2 or offsets.shape != grid.shape[1:]:
        raise ValueError(f"dia spmm_core: needs grid (n, K), B (m, p) and "
                         f"offsets (K,), got {tuple(grid.shape)}, "
                         f"{tuple(B.shape)}, {tuple(offsets.shape)}")
    (n, K), (m, p) = grid.shape, B.shape
    tile, rows, cols, cap, max_count = spmm_tile(B)
    tiles = -(-n // rows) * -(-p // cols)
    if K > MAX_DIAGS or tiles >= 2**31:
        raise ValueError(f"dia spmm_core: takes K <= {MAX_DIAGS} and fewer "
                         f"than 2**31 tiles of {rows} x {cols}, got K={K}, "
                         f"{tiles} tiles")
    out = torch.empty((n, p), dtype=B.dtype, device=B.device)
    if out.numel() == 0:
        return out
    if geo is None:
        geo = DiaGeometry(np.array(offsets.tolist(), np.int64), n, m)
    wplan, W, NR, span_max, count_max = geo.windows_on(B.device, rows, cap,
                                                       max_count)
    _build.launch("dia_spmm", f"tsgu_dia_spmm_{suffix}_{tile}", grid, B,
                  wplan, out, n, m, K, p, W, NR, span_max, count_max)
    spmm_core.launches += 1
    return out


spmm_core.launches = 0


def sddmm_core_plain(offsets, X: torch.Tensor, Y: torch.Tensor):
    """Plain PyTorch version of :func:`sddmm_core`."""
    n = X.shape[0]
    acc = _build.acc_dtype(X.dtype)
    Xa = X.to(acc)
    cols = [(Xa * Ys).sum(dim=1) for _, Ys in _shifted_rows(offsets, Y, n,
                                                             acc)]
    return torch.stack(cols, dim=1).to(X.dtype)


def sddmm_core(offsets: torch.Tensor, X: torch.Tensor,
               Y: torch.Tensor) -> torch.Tensor:
    """``out[r, k] = dot(X[r, :], Y[r + off_k, :])`` (0 where ``r + off_k``
    is out of range): X (n, p), Y (m, p), int64 offsets (K,) -> (n, K).

    CPU tensors take :func:`sddmm_core_plain`; CUDA tensors launch
    ``csrc/dia_sddmm.cu`` and raise on what it does not take.
    """
    if all(t.device.type == "cpu" for t in (offsets, X, Y)):
        return sddmm_core_plain(offsets, X, Y)
    suffix = _build.cuda_operands("dia sddmm_core", (X, Y), (offsets,))
    if X.ndim != 2 or Y.ndim != 2 or X.shape[1] != Y.shape[1] \
            or offsets.ndim != 1:
        raise ValueError(f"dia sddmm_core: needs X (n, p), Y (m, p) and "
                         f"offsets (K,), got {tuple(X.shape)}, "
                         f"{tuple(Y.shape)}, {tuple(offsets.shape)}")
    (n, p), m, K = X.shape, Y.shape[0], offsets.shape[0]
    if K > MAX_DIAGS:
        raise ValueError(f"dia sddmm_core: takes K <= {MAX_DIAGS}, got {K}")
    out = torch.empty((n, K), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    _build.launch("dia_sddmm", f"tsgu_dia_sddmm_{suffix}", X, Y, offsets,
                  out, n, m, K, p)
    sddmm_core.launches += 1
    return out


sddmm_core.launches = 0


class DiaSpmmCore(torch.autograd.Function):
    """Differentiable :func:`spmm_core` over a :class:`DiaGeometry`.

    Backward: ``d_grid = DiaSddmmCore(geo, G, B)`` and
    ``d_B = DiaSpmmCore(geo.T, geo.shift(grid), G)``.
    """

    @staticmethod
    def forward(ctx, geo, grid, B):
        ctx.geo = geo
        ctx.save_for_backward(grid, B)
        return spmm_core(geo.offsets_on(grid.device), grid.contiguous(),
                         B.contiguous(), geo)

    @staticmethod
    def backward(ctx, G):
        grid, B = ctx.saved_tensors
        geo = ctx.geo
        d_grid = d_B = None
        if ctx.needs_input_grad[1]:
            d_grid = DiaSddmmCore.apply(geo, G, B)
        if ctx.needs_input_grad[2]:
            d_B = DiaSpmmCore.apply(geo.T, geo.shift(grid), G)
        return None, d_grid, d_B


class DiaSddmmCore(torch.autograd.Function):
    """Differentiable :func:`sddmm_core` over a :class:`DiaGeometry`.

    Backward: ``d_X = DiaSpmmCore(geo, ct, Y)`` and
    ``d_Y = DiaSpmmCore(geo.T, geo.shift(ct), X)``.
    """

    @staticmethod
    def forward(ctx, geo, X, Y):
        ctx.geo = geo
        ctx.save_for_backward(X, Y)
        return sddmm_core(geo.offsets_on(X.device), X.contiguous(),
                          Y.contiguous())

    @staticmethod
    def backward(ctx, ct):
        X, Y = ctx.saved_tensors
        geo = ctx.geo
        d_X = d_Y = None
        if ctx.needs_input_grad[1]:
            d_X = DiaSpmmCore.apply(geo, ct, Y)
        if ctx.needs_input_grad[2]:
            d_Y = DiaSpmmCore.apply(geo.T, geo.shift(ct), X)
        return None, d_X, d_Y


# --------------------------------------------------------------------------
# hybrid residual: the chunk engine, or the gather + segment-sum branch
# --------------------------------------------------------------------------

RESID_MIN_NNZ = 4096     # below this the gather + index_add branch is fine
# Route of the residual, in place of the JAX package's TSGU_RESID_ENGINE:
# "auto" (chunk engine on CUDA tensors for residuals of RESID_MIN_NNZ
# entries or more), "chunk" (always, also on the CPU, where the kernels'
# plain versions run), "xla" (never).  Tests monkeypatch it.
RESID_ENGINE = "auto"
# Backward of the chunk engine's A @ B, in place of the JAX package's
# TSGU_SPMM_BWD: "split" (K7 for gradA, K6 over the transpose plan on
# values reordered by the K3 gather for gradB) or "fused" (K12: one pass
# writing gradA and the (nnz, p) rows V = val · G[row], then their
# column-order sum).  It covers sparse_mm's chunk path and the hybrid
# residual.  The fused pair moves more bytes than split (the V rows), on
# the card as on the TPU, so split stays the default.
SPMM_BWD = "split"


def chunk_bwd_fused_arg(grad_precision: str = "exact"):
    """``ChunkSpmm``'s ``fused`` argument under :data:`SPMM_BWD`: None
    for the split backward, else whether V is stored in bfloat16
    (``grad_precision="fast"``)."""
    if SPMM_BWD == "split":
        return None
    if SPMM_BWD != "fused":
        raise ValueError(f"SPMM_BWD must be 'split' or 'fused', got "
                         f"{SPMM_BWD!r}")
    return grad_precision == "fast"


@lru_cache(maxsize=64)
def _resid_chunk_plan(plan: DiaPlan):
    """Chunk row plan of the residual sub-pattern (its transpose is
    ``.T``), cached per DiaPlan (id-hashed; DiaPlans are themselves
    cached by content).  The residual keeps the pattern's row-major
    order, so the plan always exists."""
    return build_chunk_plan(StaticArray(plan.resid_rows),
                            StaticArray(plan.resid_cols), plan.n, plan.m)


def _resid_chunk_ok(plan: DiaPlan, device: torch.device) -> bool:
    """Whether the hybrid residual runs on the chunk engine.  Unlike the
    JAX package there is no gate on p or dtype: the CUDA kernels pad
    nothing and take f32, bf16 and f64."""
    if not plan.is_hybrid or RESID_ENGINE == "xla":
        return False
    return RESID_ENGINE == "chunk" or (
        device.type == "cuda" and len(plan.resid_sel) >= RESID_MIN_NNZ)


def _resid_spmm(plan: DiaPlan, rvals, B, fused=None):
    """Residual entries' share of A @ B; ``fused`` as ChunkSpmm's."""
    if _resid_chunk_ok(plan, B.device):
        return ChunkSpmm.apply(_resid_chunk_plan(plan), rvals, B, fused)
    d = plan.maps(B.device)
    prod = rvals[:, None] * B.index_select(0, d["resid_cols"])
    out = torch.zeros((plan.n, B.shape[1]), dtype=B.dtype, device=B.device)
    return out.index_add(0, d["resid_rows"], prod)


def _resid_spmm_t(plan: DiaPlan, rvals, G, rvals_t=None):
    """Residual entries' share of Aᵀ @ G; ``rvals_t`` may pass the
    residual values already in the transpose plan's order."""
    if _resid_chunk_ok(plan, G.device):
        rp = _resid_chunk_plan(plan)
        return ChunkSpmm.apply(rp.T, rp.to_T(rvals) if rvals_t is None
                               else rvals_t, G)
    d = plan.maps(G.device)
    prod = rvals[:, None] * G.index_select(0, d["resid_rows"])
    out = torch.zeros((plan.m, G.shape[1]), dtype=G.dtype, device=G.device)
    return out.index_add(0, d["resid_cols"], prod)


def _resid_sddmm(plan: DiaPlan, X, Y):
    """(X @ Yᵀ) at the residual entries."""
    if _resid_chunk_ok(plan, X.device):
        return ChunkSddmm.apply(_resid_chunk_plan(plan), X, Y)
    d = plan.maps(X.device)
    return (X.index_select(0, d["resid_rows"])
            * Y.index_select(0, d["resid_cols"])).sum(-1)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def dia_spmm(plan: DiaPlan, values: torch.Tensor, B: torch.Tensor,
             fused=None) -> torch.Tensor:
    """A @ B for A in DIA form (plus the residual of a hybrid plan, whose
    backward ``fused`` picks as ChunkSpmm's)."""
    out = DiaSpmmCore.apply(plan.geo, values_to_grid(plan, values), B)
    if plan.is_hybrid:
        out = out + _resid_spmm(plan, resid_values(plan, values), B, fused)
    return out


def dia_spmm_transpose(plan: DiaPlan, values: torch.Tensor, G: torch.Tensor,
                       gv: torch.Tensor = None) -> torch.Tensor:
    """Aᵀ @ G -> (m, p): the SpMM core over the transposed geometry.

    ``gv`` may pass ``values_to_grid(plan, values)`` when the caller has
    it, saving one relayout."""
    grid = values_to_grid(plan, values) if gv is None else gv
    out = DiaSpmmCore.apply(plan.geo.T, plan.geo.shift(grid), G)
    if plan.is_hybrid:
        out = out + _resid_spmm_t(plan, resid_values(plan, values), G)
    return out


def dia_sddmm(plan: DiaPlan, X: torch.Tensor, Y: torch.Tensor):
    """Values of (X @ Yᵀ) at the pattern, in CSR order."""
    vals = grid_to_values(plan, DiaSddmmCore.apply(plan.geo, X, Y))
    if plan.is_hybrid:
        vals = vals + resid_expand_values(plan, _resid_sddmm(plan, X, Y))
    return vals


def dia_bwd_pair(plan: DiaPlan, values, B, g, gv=None, fast=False):
    """``(d_values, d_B)`` of ``A @ B`` for the output cotangent ``g``:
    the SDDMM at the pattern and Aᵀ g.  Built of the differentiable
    Functions, so it can be differentiated again.  Under ``SPMM_BWD =
    "fused"`` a residual on the chunk engine takes the fused pair (V in
    bfloat16 when ``fast``)."""
    grid = values_to_grid(plan, values) if gv is None else gv
    d_values = grid_to_values(plan, DiaSddmmCore.apply(plan.geo, g, B))
    d_B = DiaSpmmCore.apply(plan.geo.T, plan.geo.shift(grid), g)
    if plan.is_hybrid:
        rv = resid_values(plan, values)
        fused = chunk_bwd_fused_arg("fast" if fast else "exact")
        if fused is not None and _resid_chunk_ok(plan, g.device):
            d_rv, d_B_r = ChunkBwdPair.apply(_resid_chunk_plan(plan), fused,
                                             rv, B, g)
        else:
            d_rv, d_B_r = _resid_sddmm(plan, g, B), _resid_spmm_t(plan, rv,
                                                                  g)
        d_values = d_values + resid_expand_values(plan, d_rv)
        d_B = d_B + d_B_r
    return d_values, d_B


def prepared_matvec(plan: DiaPlan, values: torch.Tensor, transpose: bool):
    """Closure ``x -> A @ x`` (or ``Aᵀ @ x``) for ``x`` of shape (·, p),
    with the value relayouts done once, for the iterations of a Krylov
    solver."""
    gv = values_to_grid(plan, values)
    rv = resid_values(plan, values) if plan.is_hybrid else None
    if transpose:
        geo_t, gv_t = plan.geo.T, plan.geo.shift(gv)
        rv_t = None
        if rv is not None and _resid_chunk_ok(plan, values.device):
            rv_t = _resid_chunk_plan(plan).to_T(rv)

        def mv_t(x):
            out = DiaSpmmCore.apply(geo_t, gv_t, x)
            return out if rv is None else out + _resid_spmm_t(plan, rv, x,
                                                              rv_t)

        return mv_t

    def mv(x):
        out = DiaSpmmCore.apply(plan.geo, gv, x)
        return out if rv is None else out + _resid_spmm(plan, rv, x)

    return mv
