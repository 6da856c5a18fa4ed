"""Shared plumbing for the Krylov solvers.

Port of ``torchsparsegradutils_tpu/solvers/common.py``.  The JAX solvers
are ``lax.while_loop`` loops whose predicate runs on the device; here
:func:`while_loop` keeps that predicate on the device too, as an
``active`` flag: every state update is ``torch.where(active, new,
old)``, the iteration counter advances by ``active``, and the host reads
the flag only every :data:`CHECK_EVERY` iterations.  Once the flag drops
it stays down (the state no longer changes), so the iterations run past
convergence before the next read change nothing: results and
:class:`SolveInfo` are bitwise the same for every ``CHECK_EVERY``.  The
loop reads the flag after steps ``CHECK_EVERY``, ``2 CHECK_EVERY``, ...
until it finds it down: ``max(1, ceil(iterations / CHECK_EVERY))``
reads for a solve that stops before ``max_iter``, and
``ceil(max_iter / CHECK_EVERY) - 1`` for one that runs to it.  A solve
reads once more at its end, for :func:`maybe_warn_not_converged`
(``lsmr``, which does not warn, does not); ``verbose`` reads every
iteration.  :func:`host_read` counts the reads.

Matrices: a sparse container runs on the DIA engine through
:func:`~..kernels.dia.prepared_matvec` (its value relayouts done once a
solve, outside the loop), else on the chunk engine where
``ops.spmm._chunk_plan`` gives a plan (on the card: K8 at one
right-hand side, K6 at several), else on the generic gather and
``index_add`` branch; dense matrices use ``@``, and a callable is taken
as the matvec itself.

Distributed solves: each driver takes ``group``, a
``torch.distributed`` process group, or reads it from the operator
(``parallel.dia_sharded.matvec_closures`` sets ``mv.group``).  With a
group, ``x``, the right-hand side and every Krylov vector are this
rank's row slab, and every column reduction that feeds a step length,
a residual or the convergence flag goes through :func:`col_dot` or
:func:`col_norms`, which sum the ``(k,)`` partials over the group
(``all_reduce``).  Every rank then holds the same scalars and flag, so
every rank stops at the same step with no collective left pending.
JAX sums these over the mesh inside XLA, on global arrays.  Without a
group nothing is added: a one-rank group gives the same bits.

Settings are frozen dataclasses, as in the JAX package.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..types import is_sparse

# iterations between host reads of a solve's device-side ``active`` flag
CHECK_EVERY = 8


class SolveInfo(NamedTuple):
    """Solver diagnostics, as the JAX package's.

    Attributes:
      iterations: int32 device scalar, the iterations taken.
      residual: final absolute residual norm(s), per RHS column (and per
        shift for multi-shift MINRES).
      converged: bool mask matching ``residual``, True where the
        solver's own stopping criterion was met before ``max_iter``.
    """
    iterations: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor


def host_read(t: torch.Tensor):
    """``t``'s value on the host (one device sync), counted in
    ``host_read.reads``."""
    host_read.reads += 1
    return t.item() if t.numel() == 1 else t.tolist()


host_read.reads = 0


def maybe_warn_not_converged(info: SolveInfo, name: str) -> None:
    """Warn when a column did not converge (the JAX package's eager
    warning), with one host read."""
    res = info.residual.reshape(-1).to(torch.float64)
    packed = torch.stack([
        info.converged.all().to(torch.float64),
        info.iterations.to(torch.float64),
        # a 0 beside the norms: a width-0 solve has none to take a max of
        torch.cat([res, res.new_zeros(1)]).max()])
    ok, iters, worst = host_read(packed)
    if ok:
        return
    warnings.warn(
        f"{name}: did not converge after {int(iters)} iterations "
        f"(worst residual {worst:.3e}); the returned solution is the "
        "final iterate", UserWarning, stacklevel=4)


def while_loop(cond: Callable, body: Callable, state: tuple,
               max_iter: int, verbose: Callable = None):
    """``lax.while_loop`` with the predicate on the device.

    ``cond(state, i)`` gives a 0-d bool tensor and ``body(state, i)`` the
    next state (a tuple of tensors); ``i`` is the int32 device counter.
    Runs at most ``max_iter`` steps, reading ``active`` on the host
    every :data:`CHECK_EVERY` steps (every step with ``verbose``, which
    is then called with the new state and counter after each step that
    ran).  Returns ``(state, i)``.  ``while_loop.steps`` counts the
    steps run (each calls ``body``, so its matvecs, once), the
    iterations and the steps past convergence before a read.
    """
    i = torch.zeros((), dtype=torch.int32, device=state[0].device)
    active = cond(state, i)
    every = 1 if verbose is not None else CHECK_EVERY
    for step in range(max_iter):
        if (verbose is not None or step) and step % every == 0 \
                and not host_read(active):
            break
        new = body(state, i)
        while_loop.steps += 1
        state = tuple(torch.where(active, a, b) for a, b in zip(new, state))
        i = i + active.to(torch.int32)
        if verbose is not None:
            verbose(state, i)
        active = cond(state, i)
    return state, i


while_loop.steps = 0


def _vec(core):
    """A matvec on (n, k) blocks, taking (n,) vectors too."""
    def mv(x):
        if x.ndim == 1:
            return core(x[:, None])[:, 0]
        return core(x)
    return mv


def matvec_route(A):
    """The route of a solve's matvec for a 2-D container, chosen once a
    solve: ``("dia", DiaPlan)``, else ``("chunk", ChunkPlan)`` (the chunk
    engine: K8 at one right-hand side, K6 at several), else ``("xla",
    None)``, the generic branch, which a dynamic pattern always takes
    (no plan is read)."""
    from ..ops import spmm

    if not A.pattern_static:
        return "xla", None
    plan = spmm._dia_plan(A, "auto")
    if plan is not None:
        return "dia", plan
    plan = spmm._chunk_plan(A, "auto")
    if plan is not None:
        return "chunk", plan
    return "xla", None


def _sparse_matvec(A, transpose: bool):
    """``x -> A x`` (or ``Aᵀ x``) for a 2-D container on the route of
    :func:`matvec_route`: the DIA matvec with its value relayouts
    hoisted out of the loop, the chunk engine (its transpose plan for
    ``Aᵀ``), or the generic branch."""
    from ..kernels.chunk_spmm import ChunkSpmm
    from ..kernels.dia import prepared_matvec
    from ..ops import spmm

    if A.ndim != 2:
        raise ValueError(f"solvers: A must be a 2-D matrix, got shape "
                         f"{A.shape}")
    route, plan = matvec_route(A)
    vals = A.values
    if route == "dia":
        return _vec(prepared_matvec(plan, vals, transpose))
    if route == "chunk":
        if transpose:
            plan, vals = plan.T, plan.to_T(vals)
        return _vec(lambda x: ChunkSpmm.apply(plan, vals, x))
    n, m = A.shape
    rows, cols = A.rows_t(), A.cols_t()
    if transpose:
        n, rows, cols = m, cols, rows
    return _vec(lambda x: spmm._fallback_spmm(n, rows, cols, vals, x))


def _dense(A) -> torch.Tensor:
    return A if isinstance(A, torch.Tensor) else torch.as_tensor(A)


def as_matvec(A) -> Callable:
    """Normalise a matrix-like into a closure acting on (n,) or (n, k)."""
    if is_sparse(A):
        return _sparse_matvec(A, transpose=False)
    if callable(A):
        return A
    A_t = _dense(A)
    return lambda x: A_t @ x


def as_rmatvec(A) -> Callable:
    """Adjoint matvec (needed by LSMR): ``Aᵀ`` for real operators, ``Aᴴ``
    for complex ones."""
    if is_sparse(A):
        base = _sparse_matvec(A, transpose=True)
        if A.dtype.is_complex:
            return lambda x: base(x.conj()).conj()
        return base
    if callable(A):
        raise ValueError(
            "a callable matmul closure needs an explicit transpose closure "
            "(pass rmatvec=...)")
    A_h = _dense(A).mH
    return lambda x: A_h @ x


def ensure_matrix(b, A=None):
    """(n,) -> (n, 1); returns (b2d, was_vector).

    With a sparse ``A``, refuses a ``b`` of another dtype as the JAX
    package's ``sparse_mm`` does, once a solve and on every route (the
    DIA and chunk matvecs do not check).
    """
    b = b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
    if is_sparse(A) and A.dtype != b.dtype:
        raise ValueError(
            f"sparse_mm: dtype mismatch, A is "
            f"{str(A.dtype).removeprefix('torch.')} and B is "
            f"{str(b.dtype).removeprefix('torch.')}")
    if b.ndim == 1:
        return b[:, None], True
    if b.ndim == 2:
        return b, False
    raise ValueError(f"rhs must be 1-D or 2-D, got {b.ndim}-D")


def solve_group(A, group=None):
    """The process group a solve's column reductions are summed over:
    ``group``, else the operator's ``group`` attribute, else None (no
    reduction).  ``parallel.dia_sharded.matvec_closures`` sets it on its
    closures, so ``linear_cg(mv, rhs_slab)`` is a distributed solve."""
    return group if group is not None else getattr(A, "group", None)


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (``all_reduce``), or ``t``
    itself when ``group`` is None; ``group_sum.calls`` counts the
    all-reduces."""
    if group is not None:
        dist.all_reduce(t, group=group)
        group_sum.calls += 1
    return t


group_sum.calls = 0


def col_dot(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """Column dots ``(a * b).sum(0)``, summed over ``group``'s row slabs."""
    return group_sum((a * b).sum(0), group)


def col_norms(x: torch.Tensor, group=None) -> torch.Tensor:
    """Real column 2-norms (complex-safe: |x|² via conjugation), over
    ``group``'s row slabs."""
    if x.is_complex():
        return torch.sqrt(group_sum((x * x.conj()).real.sum(0), group))
    return torch.sqrt(col_dot(x, x, group))


def safe_div(a, b, eps=None):
    eps = eps or torch.finfo(a.dtype).tiny
    e = torch.full_like(b, eps)
    return a / torch.where(b.abs() > eps, b, torch.where(b >= 0, e, -e))
