"""Distributed stencil solve: the halo-exchange SpMM under CG.

Port of ``examples/distributed_stencil_solve.py``.  A 3-D 7-point
screened-Poisson operator (n = 131,072 rows, a 64 x 64 x 32 grid, made
SPD by diagonal dominance) is row-sharded over the ranks of a process
group together with its right-hand side: each rank holds one slab of the
operator's value grid, of the right-hand side and of the solution.  A
CG iteration's matvec exchanges two boundary strips with the
neighbouring ranks (``parallel.matvec_closures``), and every dot product
of ``linear_cg`` is summed over the group (``all_reduce``), which the
solver reads from the closure (``mv.group``).  JAX's call,
``linear_cg(mv, rhs)``, is the call here.

Run on one card (a one-rank NCCL group on a file store in a temporary
directory)::

    python -m torchsparsegradutils_tpu_torch.examples.distributed_stencil_solve

on several, one process a card::

    torchrun --nproc_per_node=4 -m torchsparsegradutils_tpu_torch.examples.distributed_stencil_solve

or on the CPU (gloo) with ``--cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.nn.functional as F

from torchsparsegradutils_tpu_torch.parallel import matvec_closures
from torchsparsegradutils_tpu_torch.solvers import LinearCGSettings, linear_cg
from torchsparsegradutils_tpu_torch.solvers.common import col_norms
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    make_spd_stencil)

N = 131_072
# the 7-point 3-D stencil's offsets on a 64 x 64 x 32 grid
OFFSETS = [-2048, -32, -1, 0, 1, 32, 2048]


@contextlib.contextmanager
def process_group(backend: str):
    """The group of a ``torchrun`` launch (its environment), else a
    one-rank group on a file store in a temporary directory; destroyed
    on exit."""
    tmp = None
    if "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        tmp = tempfile.mkdtemp(prefix="tsgu_example_")
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def solve(n: int, device, settings: LinearCGSettings, group=None):
    """Build the operator and right-hand side (seeds 0 and 1, the same
    on every rank), take this rank's slabs and run ``linear_cg`` over
    the sharded matvec.  Returns ``(x, rhs, info, mv)``: this rank's
    slabs of the solution and right-hand side."""
    A = make_spd_stencil(n, OFFSETS, device=device,
                         generator=torch.Generator().manual_seed(0))
    mv, _ = matvec_closures(A, group)
    rhs = torch.randn(n, 1, generator=torch.Generator().manual_seed(1))
    rank, rps = dist.get_rank(group), mv.rows_per_shard
    rhs = F.pad(rhs, (0, 0, 0, mv.n_padded - n))[rank * rps:(rank + 1)
                                                 * rps].to(device)
    x, info = linear_cg(mv, rhs, settings=settings, diagnostics=True)
    return x, rhs, info, mv


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (gloo) instead of the card")
    parser.add_argument("--n", type=int, default=N,
                        help="rows (at least 2,048 a rank: the halo)")
    parser.add_argument("--max-iter", type=int, default=400)
    parser.add_argument("--rtol", type=float, default=1e-6)
    args = parser.parse_args(argv)
    if args.cpu:
        backend, device = "gloo", torch.device("cpu")
    else:
        backend = "nccl"
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    with process_group(backend):
        S = dist.get_world_size()
        x, rhs, info, mv = solve(args.n, device, LinearCGSettings(
            max_iter=args.max_iter, rtol=args.rtol))
        rel = (col_norms(mv(x) - rhs, mv.group)
               / col_norms(rhs, mv.group)).item()
        if dist.get_rank() == 0:
            print(f"ranks: {S}, operator: n={args.n} ({len(OFFSETS)} "
                  f"diagonals), rows a rank {mv.rows_per_shard}, halo "
                  f"{mv.layout.halo}")
            print(f"distributed CG: {int(info.iterations)} iterations, "
                  f"relative residual {rel:.2e}")
    if not rel < 1e-4:
        raise SystemExit(f"the solve did not converge: {rel:.2e}")
    return rel


if __name__ == "__main__":
    main()
