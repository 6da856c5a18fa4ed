"""LSMR least-squares solver.

Port of ``torchsparsegradutils_tpu/solvers/lsmr.py`` (Fong & Saunders,
2011): damped least squares ``min ‖Ax − b‖² + damp²‖x‖²`` by
Golub–Kahan bidiagonalisation, with the three standard stopping tests
(residual, normal-equations residual, condition limit).  Every
per-column scalar recurrence runs over a ``(k,)`` column axis, so an
iteration is one ``A v`` and one ``Aᴴ u`` for all columns; a column
whose tests pass is frozen.  The loop is :func:`~.common.while_loop`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..types import is_sparse
from .common import as_matvec, as_rmatvec, col_norms, ensure_matrix, \
    solve_group, while_loop

__all__ = ["lsmr", "LSMRSettings"]


@dataclasses.dataclass(frozen=True)
class LSMRSettings:
    max_iter: int = 1000
    atol: float = 1e-6
    btol: float = 1e-6
    conlim: float = 1e8
    damp: float = 0.0


def _sym_ortho(a, b):
    """Stable Givens rotation (c, s, r) with r = hypot(a, b)."""
    r = torch.hypot(a, b)
    safe = torch.where(r > 0, r, 1.0)
    c = torch.where(r > 0, a / safe, torch.ones_like(a))
    s = torch.where(r > 0, b / safe, torch.zeros_like(b))
    return c, s, r


@torch.no_grad()
def lsmr(A, b, *, rmatvec: Optional[Callable] = None,
         settings: LSMRSettings = LSMRSettings(), x0=None, group=None):
    """Solve ``min ‖Ax − b‖²`` (+ damping) for tall or square ``A``.

    Runs under ``torch.no_grad()``: no autograd graph is kept across
    iterations; differentiate through ``sparse_generic_lstsq``.

    Args:
      A: sparse container, dense ``(n, m)`` matrix, or matvec closure (then
        ``rmatvec``, the ``Aᴴ`` closure, is required).
      b: ``(n,)`` or ``(n, k)``.
      x0: optional initial guess.
      group: process group of a distributed solve over ``(mv, mv_t)``
        closures (``b``, ``x`` and the Krylov vectors are row slabs);
        default ``A.group`` where the operator has one
        (``parallel.matvec_closures``).

    Returns:
      ``(x, itn)``: the solution shaped ``(m,)`` / ``(m, k)`` and the
      iteration count (int32 device scalar).
    """
    mv = as_matvec(A)
    rmv = as_rmatvec(A) if rmatvec is None else rmatvec
    group = solve_group(A, group)
    b2, was_vec = ensure_matrix(b, A)
    n, k = b2.shape
    dtype, dev = b2.dtype, b2.device
    # complex systems: vectors stay complex, every Golub-Kahan scalar
    # recurrence lives in the matching real dtype
    rdtype = b2.real.dtype if b2.is_complex() else dtype
    tiny = torch.finfo(rdtype).tiny
    damp = torch.full((), settings.damp, dtype=rdtype, device=dev)

    # m from the matrix's shape, or from one rmatvec of a closure
    if is_sparse(A) or isinstance(A, torch.Tensor):
        m = A.shape[1]
    else:
        m = rmv(torch.zeros((n, k), dtype=dtype, device=dev)).shape[0]

    if x0 is None:
        x = torch.zeros((m, k), dtype=dtype, device=dev)
        u = b2
    else:
        x = ensure_matrix(x0)[0].to(dev)
        u = b2 - mv(x)

    def zk():
        return torch.zeros((k,), dtype=rdtype, device=dev)

    def ok():
        return torch.ones((k,), dtype=rdtype, device=dev)

    normb = col_norms(b2, group)
    beta = col_norms(u, group)
    u = u / torch.where(beta > 0, beta, 1.0)
    v = rmv(u)
    alpha = torch.where(beta > 0, col_norms(v, group), 0.0)
    v = v / torch.where(alpha > 0, alpha, 1.0)

    already_done = alpha * beta == 0  # b (or the residual at x0) is zero
    ctol = 1.0 / settings.conlim if settings.conlim > 0 else 0.0
    safe_normb = torch.where(normb > 0, normb, 1.0)

    def stop_flags(st):
        (x, _, _, _, _, _, rho, _, _, _, zetabar, _, _, _, _, _, _, _, _,
         _, normA2, maxrbar, minrbar, normr) = st
        normA = torch.sqrt(normA2)
        condA = torch.maximum(maxrbar, rho) / torch.clamp(
            torch.minimum(minrbar, rho), min=tiny)
        normar = zetabar.abs()
        normx = col_norms(x, group)
        test1 = normr / safe_normb
        test2 = normar / torch.clamp(normA * normr, min=tiny)
        test3 = 1.0 / condA
        rtol = settings.btol + settings.atol * normA * normx / safe_normb
        return ((test1 <= rtol) | (test2 <= settings.atol)
                | (test3 <= ctol) | already_done)

    def cond(st, i):
        return ~stop_flags(st).all() & (i < settings.max_iter)

    def body(st, itn):
        (x, u, v, alpha, beta, alphabar, rho, rhobar, cbar, sbar, zetabar,
         zeta, h, hbar, betadd, betad, rhodold, tautildeold, thetatilde, d,
         normA2, maxrbar, minrbar, normr) = st
        frozen = stop_flags(st)

        # Golub–Kahan step
        u = mv(v) - alpha * u
        beta = col_norms(u, group)
        u = u / torch.where(beta > 0, beta, 1.0)
        v = rmv(u) - beta * v
        alpha = col_norms(v, group)
        v = v / torch.where(alpha > 0, alpha, 1.0)

        # damping rotation
        chat, shat, alphahat = _sym_ortho(alphabar, damp)
        # plane rotation P_i
        rhoold = rho
        c, s, rho_n = _sym_ortho(alphahat, beta)
        thetanew = s * alpha
        alphabar_n = c * alpha
        # rotation Pbar_i
        rhobarold = rhobar
        zetaold = zeta
        thetabar = sbar * rho_n
        cbar_n, sbar_n, rhobar_n = _sym_ortho(cbar * rho_n, thetanew)
        zeta_n = cbar_n * zetabar
        zetabar_n = -sbar_n * zetabar

        hbar_n = h - (thetabar * rho_n / (rhoold * rhobarold)) * hbar
        x_n = x + (zeta_n / (rho_n * rhobar_n)) * hbar_n
        h_n = v - (thetanew / rho_n) * h

        # ||r|| estimate
        betaacute = chat * betadd
        betacheck = -shat * betadd
        betahat = c * betaacute
        betadd_n = -s * betaacute
        thetatildeold = thetatilde
        ctildeold, stildeold, rhotildeold = _sym_ortho(rhodold, thetabar)
        thetatilde_n = stildeold * rhobar_n
        rhodold_n = ctildeold * rhobar_n
        betad_n = -stildeold * betad + ctildeold * betahat
        tautildeold_n = (zetaold - thetatildeold * tautildeold) / \
            torch.where(rhotildeold > 0, rhotildeold, 1.0)
        taud = (zeta_n - thetatilde_n * tautildeold_n) / \
            torch.where(rhodold_n != 0, rhodold_n, 1.0)
        d_n = d + betacheck * betacheck
        normr_n = torch.sqrt(d_n + (betad_n - taud) ** 2 + betadd_n ** 2)

        normA2_n = normA2 + beta * beta + alpha * alpha
        maxrbar_n = torch.maximum(maxrbar, rhobarold)
        minrbar_n = torch.where(itn > 0, torch.minimum(minrbar, rhobarold),
                                minrbar)

        def sel(new, old):
            return torch.where(frozen, old, new)

        # u, v, alpha and beta move on for frozen columns too, as in the
        # JAX package
        return (sel(x_n, x), u, v, alpha, beta, sel(alphabar_n, alphabar),
                sel(rho_n, rho), sel(rhobar_n, rhobar), sel(cbar_n, cbar),
                sel(sbar_n, sbar), sel(zetabar_n, zetabar),
                sel(zeta_n, zeta), sel(h_n, h), sel(hbar_n, hbar),
                sel(betadd_n, betadd), sel(betad_n, betad),
                sel(rhodold_n, rhodold), sel(tautildeold_n, tautildeold),
                sel(thetatilde_n, thetatilde), sel(d_n, d),
                sel(normA2_n, normA2), sel(maxrbar_n, maxrbar),
                sel(minrbar_n, minrbar), sel(normr_n, normr))

    st = (x, u, v, alpha, beta, alpha, ok(), ok(), ok(), zk(),
          alpha * beta, zk(), v, torch.zeros((m, k), dtype=dtype, device=dev),
          beta, zk(), ok(), zk(), zk(), zk(), alpha * alpha, zk(),
          torch.full((k,), 1e30, dtype=rdtype, device=dev), beta)
    st, itn = while_loop(cond, body, st, settings.max_iter)
    x = st[0]
    return (x[:, 0] if was_vec else x), itn
