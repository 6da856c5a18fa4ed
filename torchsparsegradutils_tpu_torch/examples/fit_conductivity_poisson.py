"""Inverse screened-Poisson problem on the DIA + CG + implicit-gradient
stack.

Port of ``examples/fit_conductivity_poisson.py``.  The 2-D operator
``A(θ) = L + diag(exp(θ))`` (the 5-point Laplacian plus an unknown
per-cell screening field) is a 5-diagonal stencil matrix, the pattern
the DIA engine runs as shifted dense streams.  We observe ``y = A(θ*)⁻¹
f`` for a hidden field ``θ*`` and recover it by Adam on ``‖A(θ)⁻¹ f −
y‖²``: the solve is conjugate gradients over the hoisted DIA matvec, and
the gradient with respect to θ comes from ``sparse_generic_solve``'s
implicit-function-theorem backward (another CG solve and an SDDMM at the
operator's entries), never from differentiating the CG loop.

Run: ``python -m torchsparsegradutils_tpu_torch.examples.fit_conductivity_poisson``
(on the card; ``--cpu`` on the CPU).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from torchsparsegradutils_tpu_torch import SparseCSR, sparse_generic_solve
from torchsparsegradutils_tpu_torch.solvers import LinearCGSettings, linear_cg

NX = NY = 24
N = NX * NY
SETTINGS = LinearCGSettings(max_iter=300, rtol=1e-8)


def laplacian_pattern():
    """CSR pattern of the 5-point Laplacian on the NX x NY grid, and
    which entries lie on the diagonal."""
    rows, cols = [], []
    for i in range(N):
        x, y = divmod(i, NY)
        for dx, dy in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
            xx, yy = x + dx, y + dy
            if 0 <= xx < NX and 0 <= yy < NY:
                rows.append(i)
                cols.append(xx * NY + yy)
    rows, cols = np.asarray(rows), np.asarray(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(N + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return rows, cols, np.cumsum(indptr), rows == cols


ROWS, COLS, INDPTR, IS_DIAG = laplacian_pattern()


def operator(theta: torch.Tensor) -> SparseCSR:
    """A(θ) = L + diag(exp(θ)), differentiable in θ through its values."""
    dev = theta.device
    vals = torch.where(torch.from_numpy(IS_DIAG).to(dev),
                       4.0 + torch.exp(theta)[torch.from_numpy(ROWS).to(dev)],
                       -1.0)
    return SparseCSR(INDPTR.astype(np.int32), COLS.astype(np.int32), vals,
                     (N, N))


def solve(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return sparse_generic_solve(operator(theta), f, solve=linear_cg,
                                transpose_solve=linear_cg, settings=SETTINGS)


def loss_fn(theta, f, y_obs):
    return ((solve(theta, f) - y_obs) ** 2).sum() * 1e2


def theta_true(device) -> torch.Tensor:
    xs = torch.arange(NX, dtype=torch.float32)[:, None] / NX
    ys = torch.arange(NY, dtype=torch.float32)[None, :] / NY
    return (0.8 * torch.sin(2 * math.pi * xs)
            * torch.cos(2 * math.pi * ys)).reshape(-1).to(device)


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    parser.add_argument("--steps", type=int, default=150)
    args = parser.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    truth = theta_true(device)
    f = torch.randn(N, generator=torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        y_obs = solve(truth, f)
    theta = torch.zeros(N, device=device, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=5e-2)
    for it in range(args.steps):
        opt.zero_grad()
        loss = loss_fn(theta, f, y_obs)
        loss.backward()
        opt.step()
        if it % 15 == 0:
            err = (theta.detach() - truth).abs().mean().item()
            print(f"iter {it:3d}  loss {loss.item():.3e}  "
                  f"mean |θ−θ*| {err:.3f}", flush=True)
    final = (theta.detach() - truth).abs().mean().item()
    start = truth.abs().mean().item()
    print(f"final mean |θ−θ*| = {final:.3f} (initial {start:.3f})")
    if args.steps >= 150 and not final < 0.35 * start:
        raise SystemExit("the field was not recovered")
    return final


if __name__ == "__main__":
    main()
