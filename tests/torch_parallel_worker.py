"""Rank-side half of ``tests/test_torch_parallel.py``: one process per
rank of a gloo group, spawned by that file's fixture.

Each rank drives the port's sharded entry points on the inputs the
parent made (numpy arrays in ``spec``) and saves what it got, and the
messages of the errors it was meant to raise, to ``rank<r>.pt`` in the
output directory; the parent holds them against the JAX package.  This
module imports neither JAX nor the test file, so the spawned ranks do not
load JAX.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from torchsparsegradutils_tpu_torch import from_arrays, params_from_arrays
from torchsparsegradutils_tpu_torch.parallel import (
    build_sharded_chunk_plan, make_model, make_train_step, matvec_closures,
    shard_rows, sharded_chunk_spmm, sharded_dia_spmm, sharded_sparse_mm)
from torchsparsegradutils_tpu_torch.solvers import (bicgstab, linear_cg,
                                                     lsmr, minres)
from torchsparsegradutils_tpu_torch.solvers.common import group_sum


def _matrix(arrays, dtype=None):
    layout, i0, i1, data, shape = arrays
    A = from_arrays(layout, i0, i1, data, shape, device="cpu")
    return A if dtype is None else A.astype(dtype)


def _leaf(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return (t if dtype is None else t.to(dtype)).requires_grad_(True)


def _error(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _chunk(case, rank):
    dtype = getattr(torch, case["dtype"])
    A = _matrix(case["A"], dtype)
    plan = build_sharded_chunk_plan(A, case["S"])
    v, B = _leaf(A.values.detach()), _leaf(case["B"], dtype)
    out = sharded_chunk_spmm(plan, v, B)
    rps = plan.rows_per_shard
    G = F.pad(torch.from_numpy(case["G"]).to(dtype),
              (0, 0, 0, rps * case["S"] - A.shape[0]))
    (out * G[rank * rps:(rank + 1) * rps]).sum().backward()
    return {"out": out.detach(), "d_data": v.grad, "d_B": B.grad}


def _shard(case, rank):
    A = _matrix(case["A"])
    M = shard_rows(A, 4)
    M.data = M.data.detach().requires_grad_(True)
    B = _leaf(case["B"])
    out = sharded_sparse_mm(M, B)
    padded = sharded_sparse_mm(M, B.detach(), out_padded=True)
    r0 = rank * M.rows_per_shard
    G = torch.from_numpy(case["G"])[r0:r0 + out.shape[0]]
    (out * G).sum().backward()
    return {"out": out.detach(), "padded": padded.detach(),
            "d_data": M.data.grad, "d_B": B.grad}


def _dia(case, rank, group):
    A = _matrix(case["A"])
    f = sharded_dia_spmm(A, group)
    rps, n = f.rows_per_shard, A.shape[0]

    def slab(x):
        x = torch.from_numpy(x)
        return F.pad(x, (0, 0, 0, f.n_padded - n))[rank * rps:(rank + 1)
                                                     * rps].contiguous()

    v, B = _leaf(A.values.detach()), slab(case["B"]).requires_grad_(True)
    out = f(v, B)
    (out * slab(case["G"])).sum().backward()
    mv, mv_t = matvec_closures(A, group)
    x = slab(case["B"])[:, :2].contiguous()
    return {"out": out.detach(), "d_data": v.grad, "d_B": B.grad,
            "halo": f.halo, "rows_per_shard": rps, "n_padded": f.n_padded,
            "mv": mv(x), "mv_t": mv_t(x), "mv_1d": mv(x[:, 0].contiguous())}


def _solves(case, rank, group):
    """The four drivers over ``matvec_closures`` on this rank's slab of
    the right-hand side: each rank's slab of x and its iteration count,
    or the error a solve raised (a rank-local solve on the parent would
    hang in the halo exchange until the group's timeout)."""
    A = _matrix(case["A"])
    mv, mv_t = matvec_closures(A, group)
    rps, n = mv.rows_per_shard, A.shape[0]
    rhs = F.pad(torch.from_numpy(case["rhs"]), (0, 0, 0, mv.n_padded - n))[
        rank * rps:(rank + 1) * rps].contiguous()
    runs = {
        "cg": lambda: linear_cg(mv, rhs, diagnostics=True),
        "cg_vec": lambda: linear_cg(mv, rhs[:, 0].contiguous(),
                                    diagnostics=True),
        "minres": lambda: minres(mv, rhs, diagnostics=True),
        "bicgstab": lambda: bicgstab(lambda x: mv(x), rhs, diagnostics=True,
                                     group=group),
        "lsmr": lambda: lsmr(mv, rhs, rmatvec=mv_t),
    }
    out = {}
    for name, run in runs.items():
        before = group_sum.calls
        try:
            x, info = run()
        except Exception as exc:  # noqa: BLE001 - saved for the parent
            out[name] = {"error": repr(exc)}
            continue
        it = info if name == "lsmr" else info.iterations
        out[name] = {"x": x, "iterations": int(it),
                     "all_reduces": group_sum.calls - before}
    return out


def _train(case):
    enc = make_model(case["volume"], radius=case["radius"])
    step = make_train_step(enc, 2, 2, lr=case["lr"])
    params = params_from_arrays(case["params"], device="cpu")
    x = torch.from_numpy(case["x"])
    losses, after = [], []
    for _ in range(case["steps"]):
        params, loss = step(params, x)
        losses.append(loss.item())
        after.append({k: t.clone() for k, t in params.items()})
    return {"losses": losses, "params": after}


def run(rank, world, store_path, out_dir):
    """Entry of a spawned rank (``torch.multiprocessing`` passes the
    process index first); the inputs are ``spec.pt`` in ``out_dir``."""
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(out_dir, "spec.pt"), weights_only=False)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        group = dist.new_group(list(range(world)))
        res = {"chunk": {k: _chunk(c, rank) for k, c in spec["chunk"].items()},
               "shard": {k: _shard(c, rank) for k, c in spec["shard"].items()},
               "dia": {k: _dia(c, rank, group)
                       for k, c in spec["dia"].items()},
               "train": _train(spec["train"])}
        A = _matrix(spec["chunk"]["rand_float32"]["A"])
        wide, nondia = (_matrix(a) for a in spec["dia_errors"])
        enc = make_model(spec["train"]["volume"], spec["train"]["radius"])
        res["errors"] = {
            "chunk_shards": _error(lambda: sharded_chunk_spmm(
                build_sharded_chunk_plan(A, 8), A.values,
                torch.zeros(A.shape[1], 2))),
            "shard_shards": _error(lambda: sharded_sparse_mm(
                shard_rows(A, 2), torch.zeros(A.shape[1], 2))),
            "dia_halo": _error(lambda: sharded_dia_spmm(wide)),
            "dia_nondia": _error(lambda: sharded_dia_spmm(nondia, group)),
            "train_mesh": _error(lambda: make_train_step(enc, 3, 1)),
        }
        res["solves"] = _solves(spec["solves"], rank, group)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
