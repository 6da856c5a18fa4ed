"""BiCGSTAB for general square systems.

Port of ``torchsparsegradutils_tpu/solvers/bicgstab.py``: non-symmetric
square systems, an optional right preconditioner, multi-RHS (every
column in one ``(n, k)`` block, so an iteration is two matvecs for all
of them), in the device-side loop of :func:`~.common.while_loop`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .common import (
    SolveInfo,
    as_matvec,
    col_dot,
    ensure_matrix,
    maybe_warn_not_converged,
    safe_div,
    solve_group,
    while_loop,
)

__all__ = ["bicgstab", "BICGSTABSettings"]


@dataclasses.dataclass(frozen=True)
class BICGSTABSettings:
    max_iter: int = 1000       # 2 matvecs an iteration
    rtol: float = 1e-5
    atol: float = 0.0
    min_iter: int = 1
    # per-iteration residual printing (reads the device every iteration)
    verbose: bool = False


@torch.no_grad()
def bicgstab(A, rhs, *, settings: BICGSTABSettings = BICGSTABSettings(),
             preconditioner: Optional[Callable] = None, x0=None,
             diagnostics: bool = False, group=None):
    """Solve ``A x = rhs`` for general square ``A``.

    ``A`` may be a sparse container, dense matrix, or matvec closure over
    ``(n,)``/``(n, k)`` blocks.  ``group``: the process group of a
    distributed solve (row slabs; default ``A.group`` where the operator
    has one, as ``linear_cg``'s).  Returns ``x`` shaped like ``rhs``; with
    ``diagnostics=True`` returns ``(x, SolveInfo)``.  A non-convergence
    ``UserWarning`` fires.  Runs under ``torch.no_grad()``: no autograd
    graph is kept across iterations; differentiate through
    ``sparse_generic_solve``.
    """
    mv = as_matvec(A)
    group = solve_group(A, group)
    b, was_vec = ensure_matrix(rhs, A)
    n, k = b.shape
    dtype, dev = b.dtype, b.device
    M = preconditioner if preconditioner is not None else (lambda v: v)

    x = torch.zeros_like(b) if x0 is None else ensure_matrix(x0)[0].to(dev)
    r = b - (mv(x) if x0 is not None else torch.zeros_like(b))
    r_hat = r  # shadow residual
    ones = torch.ones((k,), dtype=dtype, device=dev)

    b_norm = torch.sqrt(col_dot(b, b, group))
    tol = torch.clamp(settings.rtol * b_norm, min=settings.atol).to(dtype)
    b_is_zero = b_norm < torch.finfo(dtype).tiny

    def res_ok(r):
        return (torch.sqrt(col_dot(r, r, group)) < tol) | b_is_zero

    def cond(st, i):
        return ~(res_ok(st[1]).all() & (i >= settings.min_iter)) & \
            (i < settings.max_iter)

    def body(st, i):
        x, r, p, v, rho, alpha, omega = st
        frozen = res_ok(r)
        rho_new = col_dot(r_hat, r, group)
        beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        p_hat = M(p)
        v = mv(p_hat)
        alpha = safe_div(rho_new, col_dot(r_hat, v, group))
        alpha = torch.where(frozen, 0.0, alpha)
        s = r - alpha * v
        s_hat = M(s)
        t = mv(s_hat)
        omega_new = safe_div(col_dot(t, s, group), col_dot(t, t, group))
        omega_new = torch.where(frozen, 0.0, omega_new)
        x = x + alpha * p_hat + omega_new * s_hat
        r = torch.where(frozen, r, s - omega_new * t)
        return (x, r, p, v, rho_new, alpha,
                torch.where(frozen, omega, omega_new))

    state = (x, r, torch.zeros_like(b), torch.zeros_like(b), ones, ones,
             ones)
    verbose = None
    if settings.verbose:
        def verbose(st, i):
            res = torch.sqrt(col_dot(st[1], st[1], group))
            print(f"bicgstab iter {int(i)}: max residual "
                  f"{res.max().item():.3e}")
    state, iters = while_loop(cond, body, state, settings.max_iter, verbose)
    x, r = state[0], state[1]
    x = torch.where(b_is_zero, 0.0, x)
    res = torch.sqrt(col_dot(r, r, group))
    conv = res_ok(r)
    info = SolveInfo(iterations=iters,
                     residual=res[0] if was_vec else res,
                     converged=conv[0] if was_vec else conv)
    maybe_warn_not_converged(info, "bicgstab")
    x_out = x[:, 0] if was_vec else x
    return (x_out, info) if diagnostics else x_out
