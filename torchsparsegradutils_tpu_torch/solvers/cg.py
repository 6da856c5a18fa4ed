"""Preconditioned conjugate gradients.

Port of ``torchsparsegradutils_tpu/solvers/cg.py``: batched multi-RHS,
an optional preconditioner, rhs normalisation, the "min 10 iterations"
and mean-residual convergence rule, per-column freezing of converged
columns, and optional Lanczos tridiagonals of the first ``n_tridiag``
columns (for stochastic log-determinants).  The loop is
:func:`~.common.while_loop`: the convergence test stays on the device
and the host reads it every ``CHECK_EVERY`` iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .common import (
    SolveInfo,
    as_matvec,
    col_dot,
    col_norms,
    ensure_matrix,
    maybe_warn_not_converged,
    safe_div,
    solve_group,
    while_loop,
)

__all__ = ["linear_cg", "LinearCGSettings"]


@dataclasses.dataclass(frozen=True)
class LinearCGSettings:
    max_iter: int = 1000
    rtol: float = 1e-5
    atol: float = 0.0
    min_iter: int = 10
    # when True, convergence uses the mean residual across columns;
    # False = per-column max
    mean_residual: bool = True
    # per-iteration residual printing (reads the device every iteration)
    verbose: bool = False


@torch.no_grad()
def linear_cg(A, rhs, *, settings: LinearCGSettings = LinearCGSettings(),
              preconditioner: Optional[Callable] = None, x0=None,
              n_tridiag: int = 0, diagnostics: bool = False, group=None):
    """Solve ``A x = rhs`` for SPD ``A`` (matrix-like or matvec closure).

    Runs under ``torch.no_grad()``: no autograd graph is kept across
    iterations; differentiate through ``sparse_generic_solve``.

    Args:
      A: sparse container, dense matrix, or callable ``x -> A @ x`` acting on
        ``(n,)`` / ``(n, k)``.
      rhs: ``(n,)`` or ``(n, k)`` right-hand side(s).
      preconditioner: optional callable ``r -> M⁻¹ r``.
      n_tridiag: tridiagonalise w.r.t. the first ``n_tridiag`` columns,
        returning ``(x, (t_diag, t_off, iters))`` with ``t_diag`` of shape
        ``(max_iter, n_tridiag)`` and ``t_off`` of shape
        ``(max_iter-1, n_tridiag)`` (entries beyond ``iters`` are 0).
      diagnostics: when True, additionally return a
        :class:`~.common.SolveInfo` as the last element.
      group: process group of a distributed solve (``rhs``, ``x0`` and
        ``x`` are this rank's row slabs); default ``A.group`` where the
        operator has one (``parallel.matvec_closures``), else none.

    Returns:
      ``x`` with the shape of ``rhs`` (plus the tridiag tuple if
      requested, plus the ``SolveInfo`` if ``diagnostics=True``).  A
      non-convergence ``UserWarning`` fires.
    """
    mv = as_matvec(A)
    group = solve_group(A, group)
    b, was_vec = ensure_matrix(rhs, A)
    n, k = b.shape
    dtype, dev = b.dtype, b.device
    if n_tridiag > k:
        raise ValueError(f"n_tridiag={n_tridiag} exceeds number of rhs "
                         f"columns {k}")

    precond = preconditioner if preconditioner is not None else (lambda r: r)

    # normalise rhs columns
    b_norm = col_norms(b, group)
    b_is_zero = b_norm < torch.finfo(dtype).tiny
    scale = torch.where(b_is_zero, 1.0, b_norm)
    b_hat = b / scale

    x = torch.zeros_like(b) if x0 is None else (
        ensure_matrix(x0)[0].to(dev) / scale)
    r = b_hat - (mv(x) if x0 is not None else torch.zeros_like(b))
    z = precond(r)
    p = z
    rz = col_dot(r, z, group)

    tol = torch.maximum(settings.rtol * col_norms(b_hat, group),
                        settings.atol / scale).to(dtype)

    mi = settings.max_iter
    nt = n_tridiag
    # one-hot rows of the tridiagonal writes (no device index)
    at_d = torch.arange(max(mi, 1), device=dev)[:, None]
    at_o = torch.arange(max(mi - 1, 1), device=dev)[:, None]

    def converged_mask(r):
        res = col_norms(r, group)
        if settings.mean_residual:
            return (res.mean() < tol.mean()).expand(k)
        return res < tol

    def cond(st, i):
        done = (converged_mask(st[1]) | b_is_zero).all()
        return ~((i >= settings.min_iter) & done) & (i < mi)

    def body(st, i):
        x, r, z, p, rz = st[:5]
        Ap = mv(p)
        pAp = col_dot(p, Ap, group)
        alpha = safe_div(rz, pAp)
        frozen = converged_mask(r) | b_is_zero
        alpha = torch.where(frozen, 0.0, alpha)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = col_dot(r, z, group)
        beta = torch.where(frozen, 0.0, safe_div(rz_new, rz))
        p = z + beta * p
        out = (x, r, z, p, rz_new)
        if nt:
            # T[i,i] = 1/alpha_i + beta_{i-1}/alpha_{i-1};
            # T[i,i+1] = sqrt(beta_i)/alpha_i  (Lanczos-from-CG recurrence)
            t_diag, t_off, a_prev, b_prev = st[5:]
            a_t = alpha[:nt]
            diag_entry = safe_div(torch.ones_like(a_t), a_t) + torch.where(
                i == 0, 0.0, safe_div(b_prev[:nt], a_prev[:nt]))
            off_entry = safe_div(torch.sqrt(torch.clamp(beta[:nt], min=0.0)),
                                 a_t)
            t_diag = torch.where(at_d == i, diag_entry, t_diag)
            t_off = torch.where((at_o == i) & (i < mi - 1), off_entry,
                                t_off)
            out += (t_diag, t_off, alpha, beta)
        return out

    state = (x, r, z, p, rz)
    if nt:
        state += (torch.zeros((max(mi, 1), nt), dtype=dtype, device=dev),
                  torch.zeros((max(mi - 1, 1), nt), dtype=dtype, device=dev),
                  torch.ones((k,), dtype=dtype, device=dev),
                  torch.zeros((k,), dtype=dtype, device=dev))
    verbose = None
    if settings.verbose:
        def verbose(st, i):
            print(f"linear_cg iter {int(i)}: mean residual "
                  f"{col_norms(st[1], group).mean().item():.3e}")
    state, iters = while_loop(cond, body, state, mi, verbose)
    x, r = state[0], state[1]

    x = x * scale
    x = torch.where(b_is_zero, 0.0, x)
    x_out = x[:, 0] if was_vec else x
    res = col_norms(r, group) * scale   # de-normalised absolute residual
    conv = converged_mask(r) | b_is_zero
    info = SolveInfo(iterations=iters,
                     residual=res[0] if was_vec else res,
                     converged=conv[0] if was_vec else conv)
    maybe_warn_not_converged(info, "linear_cg")
    out = (x_out,)
    if nt:
        out += ((state[5], state[6], iters),)
    if diagnostics:
        out += (info,)
    return out[0] if len(out) == 1 else out
