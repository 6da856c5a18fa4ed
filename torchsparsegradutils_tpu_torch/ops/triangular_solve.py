"""Sparse triangular solve with sparsity-preserving gradients.

Port of ``torchsparsegradutils_tpu/ops/triangular_solve.py``: solves
``A x = B`` (or ``Aᵀ x = B``) for a sparse triangular A with ``upper`` /
``unitriangular`` / ``transpose`` flags.  The backward is the JAX
package's custom VJP: ``gradB = A⁻ᵀ G``, the solve with ``transpose``
flipped, and ``gradA[i, j] = -dot(gradB[i, :], x[j, :])`` at A's stored
entries (i and j swapped under ``transpose``), an SDDMM at A's pattern.
Both come from differentiable calls, so higher derivatives work.

Forward algorithms, chosen per pattern as the JAX package chooses them:

* ``"dia"``: banded patterns.  One launch of the hand-written CUDA kernel
  ``csrc/tri_dia.cu`` (:func:`..kernels.dia_tri.tri_dia_core`) solves
  the whole system; upper and transposed solves reduce to its lower core
  by flips and the DIA grid shift.
* ``"wave"``: level-scheduled solve for unstructured patterns: rows
  permuted into dependency-level order (:func:`tri_levels`), packed into
  slabs of up to ``gcap`` blocks that depend only on earlier slabs.
* ``"block"``: blocked back-substitution, one row block per step.
* ``"dense"``: densify and call ``torch.linalg.solve_triangular``.  A
  dynamic pattern (``pattern_static=False``) takes it for every
  ``algorithm``, as in the JAX package (the plans need the pattern on
  the host), with the JAX package's ``UserWarning`` above n = 2,048;
  ``"dia"`` refuses it with the JAX package's message.

The wave and block solves are what the JAX package computes in XLA (a
``lax.scan`` of gather + contraction + block-inverse product, no
``pallas_call``): here a Python loop over the slabs or blocks of PyTorch
gathers, products and ``torch.linalg.solve_triangular`` for the batched
block inverses.  The host plans are numpy, cached on the pattern's
content hash.  ``"auto"`` tries ``dia``, then takes ``wave`` when the
level packing shortens the chain to ``WAVE_GATE`` of the blocked steps or
the row degrees are skewed (``TRI_SKEW``), else ``block``.

Example:
    >>> import torch
    >>> from torchsparsegradutils_tpu_torch import sparse_triangular_solve
    >>> from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    ...     stencil_sparse)
    >>> A = stencil_sparse((32, 32), [-4, -1, 0], well_conditioned=True,
    ...                    device="cpu")
    >>> B = torch.ones(32, 2)
    >>> x = sparse_triangular_solve(A, B, upper=False)
    >>> bool(torch.allclose(A.todense() @ x, B, atol=1e-4))
    True
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional, Union

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.dia import build_dia_plan, values_to_grid
from ..kernels.dia_tri import tri_dia_core, tri_dia_takes
from ..kernels.window_gather import WindowGather
from ..types import (SparseCOO, SparseCSR, StaticArray, is_sparse,
                     refuse_dynamic)
from .spmm import sddmm

__all__ = ["sparse_triangular_solve", "tri_levels", "tri_route"]

# In place of the JAX package's environment variables (TSGU_WAVE_KPCT,
# TSGU_WAVE_GATE, TSGU_TRI_SKEW), with their defaults.
WAVE_KPCT = 99.0   # percentile of the wave plan's base ELL width
WAVE_GATE = 0.25   # auto takes wave when its steps <= this x blocked steps
TRI_SKEW = 4.0     # ... or when the max row degree > this x the p99


def tri_levels(rows, cols, n: int) -> np.ndarray:
    """Dependency level per row for a lower-triangular solve.

    ``level[i] = 1 + max(level[j])`` over stored strictly-lower entries
    ``(i, j)``; rows without one get level 0.  Rows of one level are
    mutually independent.  The port's own copy of the JAX package's
    ``native.tri_levels``: entries are sorted by row, then one O(nnz)
    scan, so any entry order gives the same levels.
    """
    rows = np.asarray(rows, np.int64).reshape(-1)
    cols = np.asarray(cols, np.int64).reshape(-1)
    if len(rows) and (min(rows.min(), cols.min()) < 0
                      or max(rows.max(), cols.max()) >= n):
        raise ValueError(f"tri_levels: indices out of range for n={n}")
    strict = cols < rows
    r, c = rows[strict], cols[strict]
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    lev = [0] * n
    heads, starts = np.unique(r, return_index=True)
    ends = np.append(starts[1:], len(r))
    cl = c.tolist()
    get = lev.__getitem__
    for i, s, e in zip(heads.tolist(), starts.tolist(), ends.tolist()):
        lev[i] = 1 + max(map(get, cl[s:e]))
    return np.asarray(lev, np.int64)


# --------------------------------------------------------------------------
# the value gather of the plans' ELL tables
# --------------------------------------------------------------------------

class _ValGather:
    """``values`` -> a table of ``sel``'s shape, ``values[sel]`` where
    ``sel < nnz`` and 0 at the sentinel ``nnz`` (the JAX package's
    ``_make_val_gather``).  Each entry sits in at most one slot, so the
    backward is the inverse gather: both run the ported K3 gather
    (:class:`..kernels.window_gather.WindowGather`).  The JAX Beneš
    branch for large TPU tables has no counterpart."""

    def __init__(self, sel: np.ndarray, nnz: int):
        flat = sel.reshape(-1).astype(np.int64)
        pos = np.full(nnz, -1, np.int64)
        valid = flat < nnz
        pos[flat[valid]] = np.nonzero(valid)[0]
        self.shape = sel.shape
        self._idx = np.where(valid, flat, -1)
        self._inv = pos
        self._dev = {}

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        d = self._dev.get(values.device)
        if d is None:
            d = self._dev[values.device] = tuple(
                torch.from_numpy(a).to(values.device)
                for a in (self._idx, self._inv))
        return WindowGather.apply(values, *d).view(self.shape)


def _on(cache: dict, name: str, device, make) -> torch.Tensor:
    """``make()`` (a numpy array) as a tensor on ``device``, made once per
    plan and device."""
    key = (name, torch.device(device))
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.from_numpy(np.ascontiguousarray(make())).to(
            device)
    return t


# --------------------------------------------------------------------------
# blocked plan and solve
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class _TriPlan:
    n: int
    nb: int
    nblk: int
    # diagonal-block scatter (indices into values / block coordinates)
    diag_sel: np.ndarray   # (nd,)
    diag_bi: np.ndarray
    diag_ri: np.ndarray
    diag_ci: np.ndarray
    # off-diagonal ELL tables, shape (nblk, nb, K); ell_sel pads with the
    # sentinel nnz
    ell_sel: np.ndarray
    ell_cols: np.ndarray
    nnz: int
    val_gather: object = None
    _dev: dict = field(default_factory=dict, repr=False)


@lru_cache(maxsize=256)
def _build_tri_plan(rows_sa: StaticArray, cols_sa: StaticArray, n: int,
                    nb: int, lower: bool) -> _TriPlan:
    rows = rows_sa.arr.astype(np.int64)
    cols = cols_sa.arr.astype(np.int64)
    nblk = -(-n // nb)
    n_pad = nblk * nb
    rblk = rows // nb
    cblk = cols // nb
    diag_mask = rblk == cblk
    off_mask = (cblk < rblk) if lower else (cblk > rblk)
    # entries on the wrong side of the diagonal outside the block diagonal
    # are ignored (dense-triangular-solve semantics)

    diag_sel = np.nonzero(diag_mask)[0]
    diag_bi = rblk[diag_sel]
    diag_ri = rows[diag_sel] % nb
    diag_ci = cols[diag_sel] % nb

    off_sel = np.nonzero(off_mask)[0]
    off_rows = rows[off_sel]
    order = np.argsort(off_rows, kind="stable")
    off_sel = off_sel[order]
    off_rows = off_rows[order]
    counts = np.bincount(off_rows, minlength=n_pad)
    K = max(int(counts.max()) if len(off_rows) else 0, 1)
    starts = np.zeros(n_pad + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(off_rows)) - starts[off_rows]

    nnz = len(rows)
    ell_sel = np.full((n_pad, K), nnz, np.int32)   # sentinel -> zero value
    ell_cols = np.zeros((n_pad, K), np.int32)
    ell_sel[off_rows, slot] = off_sel
    ell_cols[off_rows, slot] = cols[off_sel]

    ell_sel3 = ell_sel.reshape(nblk, nb, K)
    return _TriPlan(n=n, nb=nb, nblk=nblk,
                    diag_sel=diag_sel.astype(np.int32),
                    diag_bi=diag_bi.astype(np.int32),
                    diag_ri=diag_ri.astype(np.int32),
                    diag_ci=diag_ci.astype(np.int32),
                    ell_sel=ell_sel3,
                    ell_cols=ell_cols.reshape(nblk, nb, K), nnz=nnz,
                    val_gather=_ValGather(ell_sel3, nnz))


def _block_inverses(D: torch.Tensor, lower: bool) -> torch.Tensor:
    """Inverses of the triangles of a batch of (nb, nb) blocks."""
    nb = D.shape[-1]
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    D_tri = D.tril() if lower else D.triu()
    return torch.linalg.solve_triangular(D_tri, eye.expand_as(D),
                                         upper=not lower)


def _blocked_tri_solve(plan: _TriPlan, values, B, *, lower: bool,
                       unit: bool):
    """Core solve on a 2-D rhs ``B`` of shape (n, p); no autograd (the
    caller's Function gives the gradients).  bfloat16 runs in float32."""
    n, nb, nblk = plan.n, plan.nb, plan.nblk
    n_pad = nblk * nb
    p = B.shape[1]
    dev = B.device
    acc = _build.acc_dtype(B.dtype)
    K = plan.ell_cols.shape[-1]
    c = plan._dev

    flat = _on(c, "diag_flat", dev, lambda: (
        plan.diag_bi.astype(np.int64) * nb + plan.diag_ri) * nb
        + plan.diag_ci)
    sel = _on(c, "diag_sel", dev, lambda: plan.diag_sel.astype(np.int64))
    D = torch.zeros(nblk * nb * nb, dtype=acc, device=dev).index_add_(
        0, flat, values.index_select(0, sel).to(acc)).view(nblk, nb, nb)
    if unit:
        D += torch.eye(nb, dtype=acc, device=dev)
    else:
        # unit diagonal for the padded rows of the last block
        D[-1].diagonal()[n - (nblk - 1) * nb:] += 1
    Dinv = _block_inverses(D, lower)
    vals = plan.val_gather(values).to(acc)
    Bp = F.pad(B.to(acc), (0, 0, 0, n_pad - n)).view(nblk, nb, p)
    cols = _on(c, "ell_cols", dev, lambda: plan.ell_cols.reshape(
        nblk, nb * K).astype(np.int64))
    x = torch.zeros((n_pad, p), dtype=acc, device=dev)
    for i in (range(nblk) if lower else reversed(range(nblk))):
        g = x.index_select(0, cols[i]).view(nb, K, p)
        rhs = Bp[i] - torch.einsum("rk,rkp->rp", vals[i], g)
        x[i * nb:(i + 1) * nb] = Dinv[i] @ rhs
    return x[:n].to(B.dtype)


# --------------------------------------------------------------------------
# level-scheduled wave plan and solve
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)  # id-hash: ndarray fields
class _WavePlan:
    """Level-scheduled solve schedule (see ``_build_wave_plan``)."""
    n: int
    nb: int
    gcap: int
    S: int
    W: int
    P_n: int
    perm: np.ndarray       # (n,) permuted position -> original row
    rank: np.ndarray       # (n,) original row -> permuted position
    offs: np.ndarray       # (S,) slab start row per step
    diag_sel: np.ndarray   # in-block entries: data index + scatter coords
    diag_si: np.ndarray
    diag_gi: np.ndarray
    diag_ri: np.ndarray
    diag_ci: np.ndarray
    pad_mask: np.ndarray   # (S, gcap, nb) rows with no real diagonal
    ell_sel: np.ndarray    # (S, W, K1) cross-block entry -> data index
    ell_cols: np.ndarray   # (S, W, K1) permuted source row
    val_gather: object
    nnz: int
    # overflow tier: rows with more than K1 cross-block entries keep the
    # excess here, scatter-added at their recorded slab positions
    ov_pos: np.ndarray = None    # (S, Wov) slab-local row (W = pad row)
    ov_sel: np.ndarray = None    # (S, Wov, K2)
    ov_cols: np.ndarray = None   # (S, Wov, K2)
    ov_val_gather: object = None
    _dev: dict = field(default_factory=dict, repr=False)


@lru_cache(maxsize=64)
def _build_wave_plan(rows_sa: StaticArray, cols_sa: StaticArray, n: int,
                     nb: int, lower: bool, gcap: int = 8,
                     kpct: float = 99.0) -> _WavePlan:
    """Level-scheduled wavefront schedule for an unstructured triangular
    solve.

    Rows are permuted into dependency-level order (:func:`tri_levels`),
    the permuted rows are cut into ``nb``-row blocks, and consecutive
    blocks with no cross-block dependency among them are packed into one
    step of up to ``gcap`` blocks (dependencies *within* a block are
    absorbed by that block's dense triangular inverse).  Upper-triangular
    input is flipped to lower form for the level computation; the permuted
    system is always block-lower.

    Steps write fixed ``gcap*nb`` slabs: a step whose run is shorter
    spills into the NEXT steps' rows, which their owners overwrite before
    any reader uses them, so no masking is needed."""
    rows = rows_sa.arr.astype(np.int64).reshape(-1)
    cols = cols_sa.arr.astype(np.int64).reshape(-1)
    nnz = len(rows)
    strict = (cols < rows) if lower else (cols > rows)
    r_s, c_s = rows[strict], cols[strict]
    if lower:
        lev = tri_levels(r_s, c_s, n)
    else:
        # flip to lower form; reversing keeps the rows ascending
        lev = tri_levels((n - 1 - r_s)[::-1], (n - 1 - c_s)[::-1], n)[::-1]
    perm = np.argsort(lev, kind="stable")
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)

    keep = strict | (rows == cols)
    e_idx = np.nonzero(keep)[0]
    r2 = rank[rows[e_idx]]
    c2 = rank[cols[e_idx]]
    nblk = -(-n // nb)
    br, bc = r2 // nb, c2 // nb
    cross = bc < br

    maxpred = np.full(nblk, -1, np.int64)
    if cross.any():
        np.maximum.at(maxpred, br[cross], bc[cross])
    steps = []
    b = 0
    while b < nblk:
        s0 = b
        while b < nblk and maxpred[b] < s0:
            b += 1
        b = max(b, s0 + 1)
        for t in range(s0, b, gcap):
            steps.append((t, min(gcap, b - t)))
    S = len(steps)
    W = gcap * nb
    start_blk = np.array([s0 for s0, _ in steps], np.int64)
    offs = (start_blk * nb).astype(np.int32)
    P_n = int(offs[-1]) + W
    step_of_blk = np.empty(nblk, np.int64)
    for si, (s0, g) in enumerate(steps):
        step_of_blk[s0:s0 + g] = si

    inb = ~cross
    diag_sel = e_idx[inb].astype(np.int32)
    rb = br[inb]
    d_si = step_of_blk[rb]
    diag_gi = (rb - start_blk[d_si]).astype(np.int32)
    diag_ri = (r2[inb] % nb).astype(np.int32)
    diag_ci = (c2[inb] % nb).astype(np.int32)

    ce = e_idx[cross]
    rc, cc = r2[cross], c2[cross]
    order = np.argsort(rc, kind="stable")
    ce, rc, cc = ce[order], rc[order], cc[order]
    counts = np.bincount(rc, minlength=nblk * nb)
    Kmax = max(int(counts.max()) if len(rc) else 0, 1)
    # two-level table: the base ELL width is about the kpct-th percentile
    # degree; the few heavier rows keep their excess in a small per-step
    # overflow tier
    nzc = counts[counts > 0]
    K = Kmax
    if len(nzc) > 1024:
        K = max(1, min(Kmax, int(np.percentile(nzc, kpct)) + 1))
    starts_ = np.zeros(nblk * nb + 1, np.int64)
    np.cumsum(counts, out=starts_[1:])
    slot = np.arange(len(rc)) - starts_[rc]
    si_r = step_of_blk[rc // nb]
    sl = rc - offs.astype(np.int64)[si_r]
    base = slot < K
    ell_sel = np.full((S, W, K), nnz, np.int32)
    ell_cols = np.zeros((S, W, K), np.int32)
    ell_sel[si_r[base], sl[base], slot[base]] = ce[base]
    ell_cols[si_r[base], sl[base], slot[base]] = cc[base]

    ov_pos = ov_sel = ov_cols = ov_gather = None
    if K < Kmax:
        K2 = Kmax - K
        ovf = ~base
        # overflow rows per step, each with its slab position recorded
        ov_rows = np.unique(np.stack([si_r[ovf], sl[ovf]], 1), axis=0)
        wov_counts = np.bincount(ov_rows[:, 0], minlength=S)
        Wov = max(8, -(-int(wov_counts.max()) // 8) * 8)
        # slot of each overflow row within its step: rank among the
        # step's rows (ov_rows is sorted by step, then position)
        first = np.searchsorted(ov_rows[:, 0], np.arange(S))
        t_of = np.arange(len(ov_rows)) - first[ov_rows[:, 0]]
        ov_pos = np.full((S, Wov), W, np.int32)       # W -> pad row
        ov_pos[ov_rows[:, 0], t_of] = ov_rows[:, 1]
        key = ov_rows[:, 0] * W + ov_rows[:, 1]
        t_e = t_of[np.searchsorted(key, si_r[ovf] * W + sl[ovf])]
        ov_sel = np.full((S, Wov, K2), nnz, np.int32)
        ov_cols = np.zeros((S, Wov, K2), np.int32)
        ov_sel[si_r[ovf], t_e, slot[ovf] - K] = ce[ovf]
        ov_cols[si_r[ovf], t_e, slot[ovf] - K] = cc[ovf]
        ov_gather = _ValGather(ov_sel, nnz)

    pad = np.ones((S, gcap, nb), bool)
    for si, (s0, g) in enumerate(steps):
        for gg in range(g):
            valid = min(nb, n - (s0 + gg) * nb)
            if valid > 0:
                pad[si, gg, :valid] = False

    return _WavePlan(n=n, nb=nb, gcap=gcap, S=S, W=W, P_n=P_n,
                     perm=perm, rank=rank, offs=offs,
                     diag_sel=diag_sel, diag_si=d_si.astype(np.int32),
                     diag_gi=diag_gi, diag_ri=diag_ri, diag_ci=diag_ci,
                     pad_mask=pad, ell_sel=ell_sel, ell_cols=ell_cols,
                     val_gather=_ValGather(ell_sel, nnz), nnz=nnz,
                     ov_pos=ov_pos, ov_sel=ov_sel, ov_cols=ov_cols,
                     ov_val_gather=ov_gather)


def _wave_tri_solve(plan: _WavePlan, values, B, *, unit: bool):
    """Core level-scheduled solve on a 2-D rhs ``B`` (n, p); no autograd.
    bfloat16 runs in float32."""
    S, gcap, nb, W = plan.S, plan.gcap, plan.nb, plan.W
    n, P_n = plan.n, plan.P_n
    p = B.shape[1]
    dev = B.device
    acc = _build.acc_dtype(B.dtype)
    K = plan.ell_cols.shape[-1]
    c = plan._dev

    flat = _on(c, "diag_flat", dev, lambda: (
        (plan.diag_si.astype(np.int64) * gcap + plan.diag_gi) * nb
        + plan.diag_ri) * nb + plan.diag_ci)
    sel = _on(c, "diag_sel", dev, lambda: plan.diag_sel.astype(np.int64))
    D = torch.zeros(S * gcap * nb * nb, dtype=acc, device=dev).index_add_(
        0, flat, values.index_select(0, sel).to(acc)).view(S * gcap, nb, nb)
    if unit:
        D += torch.eye(nb, dtype=acc, device=dev)
    else:
        pad = _on(c, "pad_mask", dev,
                  lambda: plan.pad_mask.reshape(S * gcap, nb))
        D.diagonal(0, 1, 2).add_(pad.to(acc))
    Dinv = _block_inverses(D, True).view(S, gcap, nb, nb)

    vals = plan.val_gather(values).to(acc)                # (S, W, K)
    Bp = F.pad(B.to(acc).index_select(
        0, _on(c, "perm", dev, lambda: plan.perm.astype(np.int64))),
        (0, 0, 0, P_n - n))
    cols = _on(c, "ell_cols", dev,
               lambda: plan.ell_cols.reshape(S, W * K).astype(np.int64))
    offs = plan.offs.tolist()
    has_ov = plan.ov_sel is not None
    if has_ov:
        ov_vals = plan.ov_val_gather(values).to(acc)      # (S, Wov, K2)
        Wov, K2 = plan.ov_pos.shape[1], plan.ov_cols.shape[-1]
        ov_cols = _on(c, "ov_cols", dev, lambda: plan.ov_cols.reshape(
            S, Wov * K2).astype(np.int64))
        ov_pos = _on(c, "ov_pos", dev, lambda: plan.ov_pos.astype(np.int64))
    x = torch.zeros((P_n, p), dtype=acc, device=dev)
    for s in range(S):
        off = offs[s]
        g = x.index_select(0, cols[s]).view(W, K, p)
        rhs = Bp[off:off + W] - torch.einsum("rk,rkp->rp", vals[s], g)
        if has_ov:
            gov = x.index_select(0, ov_cols[s]).view(Wov, K2, p)
            ov = torch.einsum("rk,rkp->rp", ov_vals[s], gov)
            rhs = F.pad(rhs, (0, 0, 0, 1)).index_add_(0, ov_pos[s],
                                                      -ov)[:W]
        x[off:off + W] = torch.bmm(Dinv[s], rhs.view(gcap, nb, p)).view(W,
                                                                         p)
    return x.index_select(0, _on(c, "rank", dev, lambda: plan.rank)).to(
        B.dtype)


# --------------------------------------------------------------------------
# forward dispatch (2-D core)
# --------------------------------------------------------------------------

def _tri_dia_plan(A, *, upper: bool, transpose: bool):
    """``(plan, lower-form offsets, upper-after-transpose)`` of the banded
    route, or None where it does not apply: a pattern that is not pure
    DIA.  Upper and transpose solves reduce to the lower core by
    grid-level shifts and flips."""
    rs, cs = A.row_sa(), A.col_sa()
    if rs is None or rs.arr.ndim != 1:
        return None
    n = A.shape[0]
    plan = build_dia_plan(rs, cs, n, n)
    if plan is None or plan.is_hybrid:
        return None
    geo = plan.geo.T if transpose else plan.geo
    eff_upper = upper != transpose
    # full index reversal turns upper into lower: the grid flips on both
    # axes, the offsets negate (and re-sort)
    offsets = np.sort(-geo.offsets) if eff_upper else geo.offsets
    return plan, offsets, eff_upper


def _tri_dia_forward(A, B, *, upper: bool, unit: bool, transpose: bool):
    """Banded path: one launch of the triangular kernel, with no value
    permutation.  Returns None when the pattern is not pure DIA or the
    kernel does not take it (too wide a band, another dtype)."""
    planned = _tri_dia_plan(A, upper=upper, transpose=transpose)
    if planned is None:
        return None
    plan, offsets, eff_upper = planned
    grid = values_to_grid(plan, A.values)
    if transpose:
        grid = plan.geo.shift(grid)
    B = B.contiguous()
    if eff_upper:
        grid, B = grid.flip(0, 1), B.flip(0)
    out = tri_dia_core(offsets, grid.contiguous(), B, unit=unit)
    if out is None:
        return None
    return out.flip(0) if eff_upper else out


@lru_cache(maxsize=256)
def _use_wave(rows: StaticArray, cols: StaticArray, n: int, nb: int,
              wnb: int, upper: bool, kpct: float, gate: float,
              skew: float) -> bool:
    """``auto``'s choice between the wave and the blocked solve (the JAX
    package's gates, cached per pattern).  Wave when the row degrees are
    skewed (the blocked plan pads every row to the max degree), or when
    the level packing cuts the sequential steps to ``WAVE_GATE`` of the
    blocked scan's."""
    off = (cols.arr < rows.arr) if not upper else (cols.arr > rows.arr)
    deg = np.bincount(rows.arr[off], minlength=n)
    kmax = int(deg.max(initial=0))
    kp99 = int(np.percentile(deg, 99.0)) if n else 0
    if kmax > skew * max(kp99, 1):
        return True
    wplan = _build_wave_plan(rows, cols, n, wnb, not upper, kpct=kpct)
    return wplan.S <= gate * -(-n // nb)


def _tri_sizes(A, *, upper: bool, transpose: bool, block_size):
    """The blocked solve's row block ``nb``, the wave plan's ``wnb``, and
    the (rows, cols, upper) the plans are built from: Aᵀ x = B swaps the
    two index arrays (and the triangle), so every plan table indexes A's
    own values, with no value permutation."""
    n = A.shape[0]
    if block_size:
        nb = block_size
    elif n >= 16384:
        nb = 512
    else:
        nb = min(128, max(8, 1 << (n - 1).bit_length() if n < 128 else 128))
    rows = A.col_sa() if transpose else A.row_sa()
    cols = A.row_sa() if transpose else A.col_sa()
    return nb, min(block_size or 128, 128), rows, cols, upper != transpose


def tri_route(A, dtype: torch.dtype, *, upper: bool, transpose: bool = False,
              algorithm: str = "auto", block_size: Optional[int] = None
              ) -> str:
    """The route ``sparse_triangular_solve`` takes for a 2-D A and a B of
    ``dtype``: ``"dia"`` (K9), ``"dense"``, ``"wave"`` or ``"block"``;
    raises what the solve raises for an algorithm it cannot run."""
    if algorithm in ("auto", "dia"):
        planned = _tri_dia_plan(A, upper=upper, transpose=transpose)
        if planned is not None and tri_dia_takes(planned[1], dtype):
            return "dia"
    if algorithm == "dia":
        raise ValueError(
            "sparse_triangular_solve: algorithm='dia' requires a "
            "diagonal-structured (banded) static pattern")
    if algorithm == "dense":
        return "dense"
    n = A.shape[0]
    if algorithm not in ("auto", "block", "wave"):
        raise ValueError(f"unknown algorithm {algorithm!r}; expected "
                         "'auto', 'dia', 'wave', 'block' or 'dense'")
    if not A.pattern_static:
        return "dense"
    if algorithm == "wave" and n <= 256:
        # nothing to schedule at this size (a single <=256-row block)
        raise ValueError(
            "sparse_triangular_solve: algorithm='wave' needs n > 256 "
            "(below that the blocked scan is a single step; use "
            "algorithm='block' or 'auto')")
    if algorithm in ("auto", "wave") and n > 256:
        nb, wnb, rows, cols, up = _tri_sizes(A, upper=upper,
                                             transpose=transpose,
                                             block_size=block_size)
        if algorithm == "wave" or _use_wave(rows, cols, n, nb, wnb, up,
                                            WAVE_KPCT, WAVE_GATE, TRI_SKEW):
            return "wave"
    return "block"


def _tri_forward_2d(A, B, *, upper: bool, unit: bool, transpose: bool,
                    algorithm: str, block_size: Optional[int]):
    route = tri_route(A, B.dtype, upper=upper, transpose=transpose,
                      algorithm=algorithm, block_size=block_size)
    if route == "dia":
        return _tri_dia_forward(A, B, upper=upper, unit=unit,
                                transpose=transpose)
    if route == "dense":
        if not A.pattern_static:
            if algorithm != "dense" and A.shape[0] > 2048:
                warnings.warn(
                    "sparse_triangular_solve: dynamic-pattern input falls "
                    "back to a densified solve (O(n^2) memory)", UserWarning)
        # Aᵀ x = B is the solve with the other triangle of the transpose
        Ad = A.todense().to(_build.acc_dtype(B.dtype))
        if transpose:
            Ad, upper = Ad.mT, not upper
        return torch.linalg.solve_triangular(
            Ad, B.to(Ad.dtype), upper=upper,
            unitriangular=unit).to(B.dtype)
    nb, wnb, rows, cols, upper = _tri_sizes(A, upper=upper,
                                            transpose=transpose,
                                            block_size=block_size)
    n = A.shape[0]
    if route == "wave":
        wplan = _build_wave_plan(rows, cols, n, wnb, not upper,
                                 kpct=WAVE_KPCT)
        return _wave_tri_solve(wplan, A.values, B, unit=unit)
    plan = _build_tri_plan(rows, cols, n, nb, not upper)
    return _blocked_tri_solve(plan, A.values, B, lower=not upper, unit=unit)


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------

class _TriSolve(torch.autograd.Function):
    """``x = A⁻¹ B`` (or ``A⁻ᵀ B``) on a 2-D B, differentiable in
    ``values`` and ``B``.  The forward runs without autograd; the
    backward is the solve with ``transpose`` flipped and an SDDMM at A's
    pattern, both differentiable, so it can be differentiated again."""

    @staticmethod
    def forward(ctx, values, B, A, flags):
        x = _tri_forward_2d(A.with_data(values), B, **flags)
        ctx.A, ctx.flags = A, flags
        ctx.save_for_backward(values, x)
        return x

    @staticmethod
    def backward(ctx, g):
        values, x = ctx.saved_tensors
        flags = ctx.flags
        A = ctx.A.with_data(values)
        gradB = _TriSolve.apply(values, g.contiguous(), A,
                                {**flags, "transpose": not flags["transpose"]})
        gradA = None
        if ctx.needs_input_grad[0]:
            # gradA[i, j] = -dot(gradB[i], x[j]); under transpose
            # -dot(x[i], gradB[j])
            X, Y = (x, gradB) if flags["transpose"] else (gradB, x)
            gradA = -sddmm(A, X, Y).values
        return gradA, (gradB if ctx.needs_input_grad[1] else None), None, \
            None


# --------------------------------------------------------------------------
# public op
# --------------------------------------------------------------------------

def _has_explicit_diag(A) -> bool:
    """Whether the pattern stores a diagonal entry; False for a dynamic
    pattern, which cannot be checked without a read (as in the JAX
    package)."""
    return A.pattern_static and bool((A.rows() == A.cols()).any())


def _batch_elem(A, i: Optional[int]):
    """2-D container of batch element i (or of the shared pattern, with
    the first element's values, for i=None)."""
    data = A.values[0] if i is None else A.values[i]
    if isinstance(A, SparseCOO):
        if i is None or not A.indices_batched():
            return SparseCOO(A.row, A.col, data, A.mat_shape)
        return SparseCOO(A.rows()[i], A.cols()[i], data, A.mat_shape)
    if i is None or not A.indices_batched():
        return SparseCSR(A.indptr, A.indices, data, A.mat_shape)
    return SparseCSR(A.indptr_np()[i], A.cols()[i], data, A.mat_shape)


def sparse_triangular_solve(A: Union[SparseCOO, SparseCSR], B, *,
                            upper: bool = True,
                            unitriangular: bool = False,
                            transpose: bool = False,
                            algorithm: str = "auto",
                            block_size: Optional[int] = None):
    """Solve ``A x = B`` (or ``Aᵀ x = B``) for sparse triangular ``A``.

    Args:
      A: ``(n, n)`` or batched ``(b, n, n)`` sparse triangular container.
      B: dense ``(n,)``, ``(n, p)`` or batched ``(b, n, p)`` on A's device.
      upper: whether A is upper triangular (default True, as in the
        reference and the JAX package).
      unitriangular: A has an implicit unit diagonal; the pattern must not
        contain explicit diagonal entries.
      transpose: solve ``Aᵀ x = B`` instead.
      algorithm: ``"auto"`` | ``"dia"`` (one launch of the banded kernel;
        auto prefers it) | ``"wave"`` (level-scheduled, n > 256) |
        ``"block"`` (blocked back-substitution) | ``"dense"``.
      block_size: row-block size for the block algorithm (default ≤128,
        512 from n = 16,384).

    Entries on the wrong side of the diagonal are ignored.  Gradients
    with respect to A land on ``A.values``, at its stored entries only.
    """
    if not is_sparse(A):
        raise TypeError(
            "sparse_triangular_solve: A must be SparseCOO/SparseCSR")
    if is_sparse(B):
        raise TypeError("sparse_triangular_solve: B must be a dense array")
    if not isinstance(B, torch.Tensor):
        B = torch.as_tensor(B, device=A.device)
    if A.ndim not in (2, 3):
        raise ValueError("sparse_triangular_solve: A must be 2-D or "
                         "batched 3-D")
    if A.shape[-1] != A.shape[-2]:
        raise ValueError("sparse_triangular_solve: A must be square")
    if A.dtype != B.dtype:
        raise ValueError(
            f"sparse_triangular_solve: dtype mismatch, A is "
            f"{str(A.dtype).removeprefix('torch.')} and B is "
            f"{str(B.dtype).removeprefix('torch.')}")
    if A.device != B.device:
        raise ValueError(f"sparse_triangular_solve: device mismatch, A is "
                         f"on {A.device} and B is on {B.device}")
    if unitriangular and _has_explicit_diag(A):
        raise ValueError(
            "sparse_triangular_solve: unitriangular=True requires a pattern "
            "without explicit diagonal entries")
    flags = dict(upper=upper, unit=unitriangular, transpose=transpose,
                 algorithm=algorithm, block_size=block_size)

    def f(A2, b):
        return _TriSolve.apply(A2.values, b, A2, flags)

    if A.ndim == 2:
        if B.ndim in (1, 2) and B.shape[0] != A.shape[0]:
            raise ValueError(
                f"sparse_triangular_solve: incompatible shapes "
                f"A {A.shape} vs B {tuple(B.shape)}")
        if B.ndim == 1:
            return f(A, B[:, None])[:, 0]
        if B.ndim == 2:
            return f(A, B)
        if B.ndim == 3:
            return torch.stack([f(A, b) for b in B.unbind(0)])
        raise ValueError("sparse_triangular_solve: B must be 1-D, 2-D or "
                         "3-D")
    # batched A
    if not A.pattern_static:
        refuse_dynamic("batched triangular solve")
    if B.ndim == 2:
        B = B.expand((A.shape[0],) + tuple(B.shape))
    if B.ndim != 3 or B.shape[0] != A.shape[0]:
        raise ValueError(
            f"sparse_triangular_solve: incompatible batch shapes A "
            f"{A.shape} vs B {tuple(B.shape)}")
    if B.shape[1] != A.shape[-1]:
        raise ValueError(
            f"sparse_triangular_solve: incompatible shapes A {A.shape} vs "
            f"B {tuple(B.shape)}")
    if not A.indices_batched():
        # shared pattern: one plan, a loop over (values, B)
        A2 = _batch_elem(A, None)
        return torch.stack([f(A2.with_data(A.values[i]), B[i])
                            for i in range(A.shape[0])])
    return torch.stack([f(_batch_elem(A, i), B[i])
                        for i in range(A.shape[0])])
