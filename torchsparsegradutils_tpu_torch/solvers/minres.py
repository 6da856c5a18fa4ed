"""MINRES, with joint multi-shift solves.

Port of ``torchsparsegradutils_tpu/solvers/minres.py``: symmetric
(possibly indefinite) systems, batched multi-RHS, and several shifted
systems ``(A + σI) x = b`` solved jointly off one shared Lanczos
recurrence (the JAX package's ``A + σI`` sign convention).  Only the
Givens-QR state is per (shift, column); one matvec per iteration serves
every shift and column.  The recurrence is the Paige–Saunders one
(cs/sn/dbar/epsln/phibar), vectorised over a ``(shifts, columns)`` grid,
in the device-side loop of :func:`~.common.while_loop`.
"""

from __future__ import annotations

import dataclasses

import torch

from .common import (
    SolveInfo,
    as_matvec,
    col_dot,
    col_norms,
    ensure_matrix,
    maybe_warn_not_converged,
    solve_group,
    while_loop,
)

__all__ = ["minres", "MINRESSettings"]


@dataclasses.dataclass(frozen=True)
class MINRESSettings:
    max_iter: int = 1000
    rtol: float = 1e-5
    atol: float = 0.0
    min_iter: int = 1
    # per-iteration residual printing (reads the device every iteration)
    verbose: bool = False


@torch.no_grad()
def minres(A, rhs, *, shifts=None,
           settings: MINRESSettings = MINRESSettings(),
           diagnostics: bool = False, group=None):
    """Solve ``A x = rhs`` (symmetric A), optionally for several shifts.

    Runs under ``torch.no_grad()``: no autograd graph is kept across
    iterations; differentiate through ``sparse_generic_solve``.

    Args:
      A: sparse container / dense matrix / matvec closure (symmetric).
      rhs: ``(n,)`` or ``(n, k)``.
      shifts: optional ``(s,)`` σ values; solves ``(A + σI) x = b``
        jointly, returning a leading shift axis.
      diagnostics: when True, also return a ``SolveInfo`` whose
        residual/converged carry the same (shift, column) axes as ``x``.
      group: process group of a distributed solve (row slabs); default
        ``A.group`` where the operator has one, as ``linear_cg``'s.

    Returns:
      ``x`` shaped like ``rhs`` (with a leading ``(s,)`` axis if shifts
      were given); ``(x, SolveInfo)`` with ``diagnostics=True``.  A
      non-convergence ``UserWarning`` fires.
    """
    mv = as_matvec(A)
    group = solve_group(A, group)
    b, was_vec = ensure_matrix(rhs, A)
    n, k = b.shape
    dtype, dev = b.dtype, b.device
    fi = torch.finfo(dtype)
    eps = fi.eps

    if shifts is None:
        sig = torch.zeros((1,), dtype=dtype, device=dev)
        squeeze_shift = True
    else:
        sig = torch.as_tensor(shifts, dtype=dtype, device=dev).reshape(-1)
        squeeze_shift = False
    s = sig.shape[0]

    b_norm = col_norms(b, group)
    b_is_zero = b_norm < fi.tiny
    scale = torch.where(b_is_zero, 1.0, b_norm)
    b_hat = b / scale  # unit columns
    tol = torch.clamp(settings.atol / torch.clamp(b_norm, min=fi.tiny),
                      min=settings.rtol).to(dtype)

    # shared Lanczos state
    beta0 = col_norms(b_hat, group)
    v = b_hat / torch.where(beta0 > 0, beta0, 1.0)
    v_prev = torch.zeros_like(b)

    # per-(shift, column) QR state
    zsk = torch.zeros((s, k), dtype=dtype, device=dev)
    zsnk = torch.zeros((s, n, k), dtype=dtype, device=dev)
    cs = -torch.ones((s, k), dtype=dtype, device=dev)
    phibar = beta0.expand(s, k).clone()

    def frozen_mask(phibar):
        return (phibar.abs() < tol[None, :]) | b_is_zero[None, :]

    def cond(st, i):
        return ~(frozen_mask(st[4]).all() & (i >= settings.min_iter)) \
            & (i < settings.max_iter)

    def body(st, i):
        (x, v_prev, v, beta, phibar, cs, sn, dbar, epsln, w_prev,
         w_pprev) = st
        frozen = frozen_mask(phibar)
        # shared Lanczos step on unshifted A
        Av = mv(v)
        alfa = col_dot(v, Av, group)                        # (k,)
        r = Av - alfa * v - beta * v_prev
        beta_new = col_norms(r, group)
        v_new = r / torch.where(beta_new > eps, beta_new, 1.0)

        # per-shift Paige–Saunders rotations
        alfa_s = alfa[None, :] + sig[:, None]               # (s, k)
        beta_nb = beta_new.expand(s, k)
        oldeps = epsln
        delta = cs * dbar + sn * alfa_s
        gbar = sn * dbar - cs * alfa_s
        epsln_new = sn * beta_nb
        dbar_new = -cs * beta_nb
        gamma = torch.clamp(torch.sqrt(gbar ** 2 + beta_nb ** 2), min=eps)
        cs_new = gbar / gamma
        sn_new = beta_nb / gamma
        phi = cs_new * phibar
        phibar_new = torch.where(frozen, phibar, sn_new * phibar)

        w_new = (v[None] - oldeps[:, None, :] * w_pprev
                 - delta[:, None, :] * w_prev) / gamma[:, None, :]
        x = torch.where(frozen[:, None, :], x, x + phi[:, None, :] * w_new)
        return (x, v, v_new, beta_new, phibar_new, cs_new, sn_new,
                dbar_new, epsln_new, w_new, w_prev)

    state = (zsnk, v_prev, v, torch.zeros((k,), dtype=dtype, device=dev),
             phibar, cs, zsk, zsk, zsk, zsnk, zsnk)
    verbose = None
    if settings.verbose:
        def verbose(st, i):
            print(f"minres iter {int(i)}: max |phibar| "
                  f"{st[4].abs().max().item():.3e}")
    state, iters = while_loop(cond, body, state, settings.max_iter, verbose)
    x, phibar = state[0], state[4]
    x = x * scale[None, None, :]
    x = torch.where(b_is_zero[None, None, :], 0.0, x)
    # |phibar| is the Paige–Saunders residual-norm estimate on the
    # unit-scaled system; de-normalise to rhs units
    res = phibar.abs() * scale[None, :]
    conv = frozen_mask(phibar)
    if was_vec:
        x, res, conv = x[:, :, 0], res[:, 0], conv[:, 0]
    if squeeze_shift:
        x, res, conv = x[0], res[0], conv[0]
    info = SolveInfo(iterations=iters, residual=res, converged=conv)
    maybe_warn_not_converged(info, "minres")
    return (x, info) if diagnostics else x
