"""PyTorch port: ``parallel/`` held against the JAX package's.

Two halves:

* the per-rank bodies (``chunk_sharded.slab_spmm``,
  ``sharding.shard_spmm``, ``dia_sharded.ShardedDia.slab_spmm`` and the
  train step's rank terms) of every rank of a layout, run one after
  another in this process: their slabs, stacked, and their gradients,
  summed, against the JAX package's global outputs and gradients on
  ``tests/conftest.py``'s virtual CPU mesh (K13 in interpret mode, as
  ``tests/test_parallel.py`` runs it);
* the entry points on four gloo ranks, spawned once for the module
  (``tests/torch_parallel_worker.py``, which imports no JAX), each
  check a separate test on the saved results.

Inputs are numpy arrays made here from fixed seeds and handed to both
packages.  Tolerances are those of ``tests/test_parallel.py``: float32
``rtol=1e-4, atol=1e-5``; the train step's loss ``1e-5`` and parameters
``1e-4/1e-5`` against the unsharded step, as ``__graft_entry__.py``
asserts for JAX.  float64 is held against the JAX ``backend="xla"`` path
at ``1e-10``: the JAX K13 computes in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

import torchsparsegradutils_tpu as tj
import torchsparsegradutils_tpu.parallel as jpar
from torchsparsegradutils_tpu_torch import (SparseCOO, from_arrays,
                                            params_from_arrays, sparse_mm,
                                            to_arrays)
from torchsparsegradutils_tpu_torch.parallel import (
    build_sharded_chunk_plan, chunk_sharded, loss_fn, make_model, shard_rows,
    sharding, training)
from torchsparsegradutils_tpu_torch.parallel.dia_sharded import ShardedDia
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    make_spd_stencil, rand_sparse, stencil_sparse)

F32 = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-10)
WORLD = 4


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _uneven():
    """test_parallel.py's uneven case: n not divisible by the shards,
    some shards nearly empty."""
    A = SparseCOO(np.array([0, 0, 1, 5, 61]), np.array([1, 3, 2, 0, 4]),
                  torch.arange(1.0, 6.0), (62, 5)).tocsr()
    return to_arrays(A)


_RAND = to_arrays(rand_sparse((64, 40), 400, layout="csr", generator=_gen(1),
                              device="cpu"))
CHUNK = {
    "rand_float32": dict(A=_RAND, B=_np((40, 5), 2), G=_np((64, 5), 3),
                         S=WORLD, dtype="float32"),
    "rand_float64": dict(A=_RAND, B=_np((40, 5), 2, np.float64),
                         G=_np((64, 5), 3, np.float64), S=WORLD,
                         dtype="float64"),
    "uneven": dict(A=_uneven(), B=_np((5, 4), 4), G=_np((62, 4), 5),
                   S=WORLD, dtype="float32"),
}
SHARD = {
    "grad24": dict(A=to_arrays(rand_sparse((24, 24), 80, generator=_gen(6),
                                           device="cpu")),
                   B=_np((24, 3), 7), G=_np((24, 3), 8)),
    "dense50": dict(A=to_arrays(rand_sparse((50, 30), 200, generator=_gen(9),
                                            device="cpu")),
                    B=_np((30, 7), 10), G=_np((50, 7), 11)),
}
DIA = {
    "grads250": dict(A=to_arrays(stencil_sparse(
        (250, 250), [-16, -1, 0, 2], generator=_gen(12), device="cpu")),
        B=_np((250, 8), 13), G=_np((250, 8), 14)),
    "stencil512": dict(A=to_arrays(stencil_sparse(
        (512, 512), [-8, -1, 0, 1, 8], generator=_gen(15), device="cpu")),
        B=_np((512, 16), 16), G=_np((512, 16), 17)),
}
# tests/test_parallel.py:245's distributed CG: the SPD stencil of n = 512
# over offsets -8, -1, 0, 1, 8, two right-hand sides
SOLVES = dict(A=to_arrays(make_spd_stencil(512, [-8, -1, 0, 1, 8],
                                           generator=_gen(21),
                                           device="cpu")),
              rhs=_np((512, 2), 22))
DIA_ERRORS = (to_arrays(stencil_sparse((64, 64), [-32, 0, 32],
                                       generator=_gen(18), device="cpu")),
              to_arrays(rand_sparse((64, 64), 400, layout="csr",
                                    generator=_gen(19), device="cpu")))


def _train_case():
    x = _np((16, 16), 20)
    x[:, 1:] += 0.5 * x[:, :-1]          # a correlated Gaussian
    jenc = jpar.make_model((1, 4, 4), radius=1.0)
    params = jpar.init_params(jax.random.PRNGKey(0), jenc)
    return dict(volume=(1, 4, 4), radius=1.0, lr=5e-2, steps=4, x=x,
                params={k: np.asarray(v) for k, v in params.items()})


TRAIN = _train_case()


def port(arrays, dtype=None):
    A = from_arrays(*arrays, device="cpu")
    return A if dtype is None else A.astype(dtype)


def jax_of(arrays, dtype=np.float32):
    layout, i0, i1, data, shape = arrays
    cls = tj.SparseCSR if layout == "csr" else tj.SparseCOO
    return cls(i0, i1, jnp.asarray(data.astype(dtype)), shape)


def mesh1d(S):
    return Mesh(np.array(jax.devices()[:S]), ("x",))


def leaf(x, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    t = t.detach().clone()
    return (t if dtype is None else t.to(dtype)).requires_grad_(True)


def close(got, ref, tol=F32):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), **tol)


# --------------------------------------------------------------------------
# JAX references (cached: one compile each)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_chunk(name, S):
    """JAX sharded_chunk_spmm at S shards: output and the gradients of
    (out * G).sum() with respect to the values and B."""
    c = CHUNK[name]
    A = jax_of(c["A"])
    plan = jpar.build_sharded_chunk_plan(A, S, C=128)
    mesh, G = mesh1d(S), jnp.asarray(c["G"], jnp.float32)

    def f(d, b):
        return jpar.sharded_chunk_spmm(plan, d, b, mesh, "x")

    B = jnp.asarray(c["B"], jnp.float32)
    return _vjp_at(f, G, A.data, B)


def _vjp_at(f, G, *args):
    """numpy ``(f(*args), *grads of (f(*args) * G).sum())``, under one
    jit: one compile, and K13's interpret-mode grid runs compiled."""
    def run(*a):
        out, vjp = jax.vjp(f, *a)
        return (out, *vjp(G.astype(out.dtype)))
    return tuple(np.asarray(t) for t in jax.jit(run)(*args))


def jax_xla64(arrays, B, G):
    """float64 A @ B and its gradients by the JAX generic path (call
    under x64)."""
    A = jax_of(arrays, np.float64)
    B = jnp.asarray(B, jnp.float64)

    def f(d, b):
        return tj.sparse_mm(A.with_data(d), b, backend="xla")

    return _vjp_at(f, jnp.asarray(G, jnp.float64), A.data, B)


@functools.lru_cache(maxsize=None)
def jax_shard(name):
    """JAX sharded_sparse_mm at 4 shards: output, and the gradients of
    (out * G).sum() with respect to the shard-stacked values and B."""
    c = SHARD[name]
    A = jax_of(c["A"])
    M = jpar.shard_rows(A, WORLD)
    mesh, G = mesh1d(WORLD), jnp.asarray(c["G"])

    def f(data, B):
        M2 = type(M)(local_rows=M.local_rows, cols=M.cols, data=data,
                     shape=M.shape, rows_per_shard=M.rows_per_shard,
                     n_shards=M.n_shards, mask=M.mask)
        return jpar.sharded_sparse_mm(M2, B, mesh, "x")

    return (M, *_vjp_at(f, G, M.data, jnp.asarray(c["B"])))


def jax_dia_layout(name, S):
    """JAX sharded_dia_spmm's function at S shards (built, not run)."""
    return jpar.sharded_dia_spmm(jax_of(DIA[name]["A"]), mesh1d(S), "x")


@functools.lru_cache(maxsize=None)
def dia_refs(name):
    """``(out, d_data, d_B)`` of (A @ B * G).sum(): for "grads250" by
    JAX sharded_dia_spmm at 4 shards; for "stencil512" (which checks the
    layout at 8 shards and the matvec closures; one JAX compile of
    this op takes seconds) by a float64 dense product."""
    c = DIA[name]
    if name == "grads250":
        A = jax_of(c["A"])
        return _vjp_at(jax_dia_layout(name, WORLD), jnp.asarray(c["G"]),
                       A.data, jnp.asarray(c["B"]))
    _, rows, cols, data, shape = to_arrays(port(c["A"]).tocoo())
    Ad = np.zeros(shape)
    Ad[rows, cols] = data
    B, G = c["B"].astype(np.float64), c["G"].astype(np.float64)
    return Ad @ B, (G @ B.T)[rows, cols], Ad.T @ G


@functools.lru_cache(maxsize=None)
def jax_train():
    """JAX: the (2, 2) train step's loss and parameters, and the
    unsharded loss and gradient, from TRAIN's parameters."""
    enc = jpar.make_model(TRAIN["volume"], radius=TRAIN["radius"])
    params = {k: jnp.asarray(v) for k, v in TRAIN["params"].items()}
    x = jnp.asarray(TRAIN["x"])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    new, loss = jpar.make_train_step(enc, mesh, lr=TRAIN["lr"])(params, x)
    ref_loss, ref_grad = jax.value_and_grad(
        lambda p: jpar.loss_fn(p, x, enc))(params)
    as_np = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return float(loss), as_np(new), float(ref_loss), as_np(ref_grad)


# --------------------------------------------------------------------------
# the spawned ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run tests/torch_parallel_worker.py on 4 gloo ranks (one spawn for
    the module) and load each rank's results."""
    import torch_parallel_worker
    d = tmp_path_factory.mktemp("ranks")
    # the inputs go by file: a large argument would reach the ranks one
    # after another, each once the one before has imported torch
    torch.save({"chunk": CHUNK, "shard": SHARD, "dia": DIA, "train": TRAIN,
                "dia_errors": DIA_ERRORS, "solves": SOLVES}, d / "spec.pt")
    mp.start_processes(torch_parallel_worker.run,
                       args=(WORLD, str(d / "store"), str(d)),
                       nprocs=WORLD, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# --------------------------------------------------------------------------
# chunk_sharded: plan, bodies, ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,S", [("rand_float32", 8), ("rand_float32", 4),
                                    ("uneven", 4)])
def test_chunk_plan_matches_jax(name, S):
    arrays = CHUNK[name]["A"]
    jp = jpar.build_sharded_chunk_plan(jax_of(arrays), S, C=128)
    pp = build_sharded_chunk_plan(port(arrays), S)
    assert (pp.n, pp.m, pp.n_shards, pp.rows_per_shard, pp.nnz) == (
        jp.n, jp.m, jp.n_shards, jp.rows_per_shard, jp.nnz)
    for s in range(S):
        k = int((jp.entry_sel[s] < jp.nnz).sum())
        assert pp.bounds[s + 1] - pp.bounds[s] == k
        np.testing.assert_array_equal(pp.entry_sel(s), jp.entry_sel[s][:k])
        np.testing.assert_array_equal(pp.gather_idx(s), jp.gather_idx[s][:k])
        np.testing.assert_array_equal(pp.entry_rows(s), jp.entry_rows[s][:k])


def test_chunk_plan_refuses_what_jax_refuses():
    rows, cols = np.array([3, 1, 2]), np.array([0, 1, 2])
    A = SparseCOO(rows, cols, torch.ones(3), (4, 4))
    with pytest.raises(ValueError, match="sorted by row"):
        build_sharded_chunk_plan(A, 2)
    with pytest.raises(ValueError, match="sorted by row"):
        jpar.build_sharded_chunk_plan(
            tj.SparseCOO(rows, cols, jnp.ones(3), (4, 4)), 2)
    batched = rand_sparse((2, 6, 5), 7, shared_pattern=True, device="cpu")
    with pytest.raises(ValueError, match="unbatched 2-D"):
        build_sharded_chunk_plan(batched, 2)


def _chunk_bodies(name, S, dtype):
    c = CHUNK[name]
    A = port(c["A"], dtype)
    plan = build_sharded_chunk_plan(A, S)
    v, B = leaf(A.values), leaf(c["B"], dtype)
    out = torch.cat([chunk_sharded.slab_spmm(plan, r, v, B)
                     for r in range(S)])
    assert out.shape == (S * plan.rows_per_shard, B.shape[1])
    assert not out[A.shape[0]:].any()          # padding rows are 0
    G = torch.from_numpy(c["G"]).to(dtype)
    (out[:A.shape[0]] * G).sum().backward()
    return out[:A.shape[0]], v.grad, B.grad


@pytest.mark.parametrize("name,S", [("rand_float32", 8), ("rand_float32", 4),
                                    ("uneven", 4)])
def test_chunk_bodies_match_jax(name, S):
    out, gd, gb = _chunk_bodies(name, S, torch.float32)
    ref = jax_chunk(name, S)
    for got, r in zip((out, gd, gb), ref):
        close(got, r)


@pytest.mark.parametrize("S", [8, 4])
def test_chunk_bodies_float64_match_jax(enable_x64, S):
    c = CHUNK["rand_float64"]
    got = _chunk_bodies("rand_float64", S, torch.float64)
    for g, r in zip(got, jax_xla64(c["A"], c["B"], c["G"])):
        close(g, r, F64)


def _stack_slabs(res, key, n):
    return torch.cat([r[key] for r in res])[:n]


def _same_on_every_rank(res, section, name, keys):
    for key in keys:
        for r in res[1:]:
            assert torch.equal(r[section][name][key],
                               res[0][section][name][key]), key


@pytest.mark.parametrize("name", ["rand_float32", "uneven"])
def test_ranks_chunk_match_jax(ranks, name):
    res = [r["chunk"][name] for r in ranks]
    n = CHUNK[name]["A"][4][0]
    out, gd, gb = jax_chunk(name, WORLD)
    close(_stack_slabs(res, "out", n), out)
    close(res[0]["d_data"], gd)
    close(res[0]["d_B"], gb)
    _same_on_every_rank(ranks, "chunk", name, ("d_data", "d_B"))


def test_ranks_chunk_float64_match_jax(ranks, enable_x64):
    c = CHUNK["rand_float64"]
    res = [r["chunk"]["rand_float64"] for r in ranks]
    out, gd, gb = jax_xla64(c["A"], c["B"], c["G"])
    assert res[0]["out"].dtype == torch.float64
    close(_stack_slabs(res, "out", 64), out, F64)
    close(res[0]["d_data"], gd, F64)
    close(res[0]["d_B"], gb, F64)


def test_ranks_chunk_slab_padding_rows_are_zero(ranks):
    last = ranks[-1]["chunk"]["uneven"]["out"]      # rows 48..63 of n = 62
    assert last.shape == (16, 4) and not last[14:].any()


# --------------------------------------------------------------------------
# sharding: shard_rows, bodies, ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SHARD))
def test_shard_rows_matches_jax(name):
    JM = jax_shard(name)[0]
    M = shard_rows(port(SHARD[name]["A"]), WORLD)
    assert (M.shape, M.rows_per_shard, M.n_shards, M.padded_rows) == (
        JM.shape, JM.rows_per_shard, JM.n_shards, JM.padded_rows)
    for k in ("local_rows", "cols", "mask"):
        np.testing.assert_array_equal(getattr(M, k), getattr(JM, k))
    np.testing.assert_array_equal(M.data.numpy(), np.asarray(JM.data))


@pytest.mark.parametrize("name", list(SHARD))
def test_shard_bodies_match_jax(name):
    c = SHARD[name]
    M = shard_rows(port(c["A"]), WORLD)
    data, B = leaf(M.data), leaf(c["B"])
    out = torch.cat([sharding.shard_spmm(M, r, data, B)
                     for r in range(WORLD)])[:M.shape[0]]
    (out * torch.from_numpy(c["G"])).sum().backward()
    _, jout, jgd, jgb = jax_shard(name)
    close(out, jout)
    close(data.grad, jgd)            # gradient values in the shard layout
    close(B.grad, jgb)
    assert not data.grad[torch.from_numpy(~M.mask)].any()


@pytest.mark.parametrize("name", list(SHARD))
def test_ranks_shard_match_jax(ranks, name):
    res = [r["shard"][name] for r in ranks]
    _, jout, jgd, jgb = jax_shard(name)
    n = SHARD[name]["A"][4][0]
    close(torch.cat([r["out"] for r in res]), jout)
    close(_stack_slabs(res, "padded", n), jout)
    close(res[0]["d_data"], jgd)
    close(res[0]["d_B"], jgb)
    _same_on_every_rank(ranks, "shard", name, ("d_data", "d_B"))


# --------------------------------------------------------------------------
# dia_sharded: layout, bodies, errors, ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,S", [("grads250", 4), ("stencil512", 4),
                                    ("stencil512", 8)])
def test_dia_bodies_match_jax(name, S):
    c = DIA[name]
    L = ShardedDia(port(c["A"]), S)
    jf = jax_dia_layout(name, S)
    jout, jgd, jgb = dia_refs(name)        # global: the same for every S
    assert (L.rows_per_shard, L.halo, L.n_padded) == (
        jf.rows_per_shard, jf.halo, jf.n_padded)
    v, B = leaf(port(c["A"]).values), leaf(c["B"])
    out = torch.cat([L.slab_spmm(v, L.window(B, r), r)
                     for r in range(S)])
    n = B.shape[0]
    assert not out[n:].any()
    (out[:n] * torch.from_numpy(c["G"])).sum().backward()
    close(out[:n], jout)
    close(v.grad, jgd)
    close(B.grad, jgb)


def test_dia_rejects_wide_halo_and_nondia():
    wide, nondia = (port(a) for a in DIA_ERRORS)
    with pytest.raises(ValueError, match="halo"):
        ShardedDia(wide, 8)                    # 32-row halo > 8-row slab
    with pytest.raises(ValueError, match="halo"):
        jpar.sharded_dia_spmm(jax_of(DIA_ERRORS[0]), mesh1d(8), "x")
    with pytest.raises(ValueError, match="pure-DIA"):
        ShardedDia(nondia, 2)
    with pytest.raises(ValueError, match="square"):
        ShardedDia(port(SHARD["dense50"]["A"]), 2)


@pytest.mark.parametrize("name", list(DIA))
def test_ranks_dia_match_jax(ranks, name):
    res = [r["dia"][name] for r in ranks]
    jf = jax_dia_layout(name, WORLD)
    jout, jgd, jgb = dia_refs(name)
    n = DIA[name]["A"][4][0]
    assert (res[0]["rows_per_shard"], res[0]["halo"], res[0]["n_padded"]
            ) == (jf.rows_per_shard, jf.halo, jf.n_padded)
    close(_stack_slabs(res, "out", n), jout)
    close(res[0]["d_data"], jgd)                 # summed over the group
    close(_stack_slabs(res, "d_B", n), jgb)      # each rank its own slab
    _same_on_every_rank(ranks, "dia", name, ("d_data",))


@pytest.mark.parametrize("name", list(DIA))
def test_ranks_dia_matvec_closures(ranks, name):
    res = [r["dia"][name] for r in ranks]
    A = port(DIA[name]["A"]).todense().double()
    n = A.shape[0]
    x = torch.from_numpy(DIA[name]["B"][:, :2]).double()
    close(_stack_slabs(res, "mv", n), (A @ x).numpy())
    close(_stack_slabs(res, "mv_t", n), (A.T @ x).numpy())
    close(_stack_slabs(res, "mv_1d", n), (A @ x[:, 0]).numpy())


# --------------------------------------------------------------------------
# distributed Krylov solves over matvec_closures
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_distributed_cg():
    """JAX's distributed CG (tests/test_parallel.py:245) on SOLVES over a
    4-device mesh: ``linear_cg(mv, rhs)`` of ``matvec_closures``."""
    from torchsparsegradutils_tpu.solvers import linear_cg
    mv, _ = jpar.matvec_closures(jax_of(SOLVES["A"]), mesh1d(WORLD), "x")
    return np.asarray(jax.jit(lambda r: linear_cg(mv, r))(
        jnp.asarray(SOLVES["rhs"])))


def _single_device(name):
    """The same solve on the whole matrix in this process."""
    from torchsparsegradutils_tpu_torch import solvers as ps
    A = port(SOLVES["A"])
    rhs = torch.from_numpy(SOLVES["rhs"])
    if name == "lsmr":
        return ps.lsmr(A, rhs)
    if name == "cg_vec":
        x, info = ps.linear_cg(A, rhs[:, 0].contiguous(), diagnostics=True)
        return x, info.iterations
    x, info = getattr(ps, {"cg": "linear_cg"}.get(name, name))(
        A, rhs, diagnostics=True)
    return x, info.iterations


@pytest.mark.parametrize("name", ["cg", "cg_vec", "minres", "bicgstab",
                                  "lsmr"])
def test_ranks_distributed_solve_matches_single_device(ranks, name):
    """Each driver over the halo-exchange closures on 4 ranks: every rank
    took the same iterations and summed its reductions over the group,
    and the stacked slabs are the single-device solve (a rank-local
    reduction, as before the solvers took a group, gives each rank its
    own step lengths and a wrong answer)."""
    res = [r["solves"][name] for r in ranks]
    assert all("error" not in r for r in res), [r.get("error") for r in res]
    its = {r["iterations"] for r in res}
    assert len(its) == 1, its
    assert len({r["all_reduces"] for r in res}) == 1
    assert res[0]["all_reduces"] >= its.pop()
    n = SOLVES["A"][4][0]
    x = _stack_slabs(res, "x", n)
    ref, _ = _single_device(name)
    close(x, ref.numpy(), F32)
    A = port(SOLVES["A"]).todense().double()
    b = torch.from_numpy(SOLVES["rhs"]).double()
    b = b[:, 0] if name == "cg_vec" else b
    assert ((A @ x.double() - b).norm() / b.norm()).item() < 1e-4


def test_ranks_distributed_cg_matches_jax(ranks):
    res = [r["solves"]["cg"] for r in ranks]
    n = SOLVES["A"][4][0]
    close(_stack_slabs(res, "x", n), jax_distributed_cg(), F32)


def test_one_rank_group_solve_is_bitwise_the_plain_solve(tmp_path):
    """On a one-rank group the reductions' all-reduce is the identity: the
    closures' solve is bitwise the same closures' solve with no group."""
    import torch.distributed as dist
    from torchsparsegradutils_tpu_torch.parallel import matvec_closures
    from torchsparsegradutils_tpu_torch import solvers as ps
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        A = port(SOLVES["A"])
        mv, mv_t = matvec_closures(A)
        assert mv.group is dist.group.WORLD and mv_t.group is mv.group
        rhs = torch.from_numpy(SOLVES["rhs"])
        for solve in (ps.linear_cg, ps.minres, ps.bicgstab):
            got = solve(mv, rhs)
            assert torch.equal(got, solve(lambda x: mv(x), rhs))
        got, it = ps.lsmr(mv, rhs, rmatvec=mv_t)
        ref, it0 = ps.lsmr(lambda x: mv(x), rhs, rmatvec=lambda x: mv_t(x))
        assert torch.equal(got, ref) and int(it) == int(it0)
    finally:
        dist.destroy_process_group()


def test_distributed_stencil_example_on_the_cpu():
    """``examples/distributed_stencil_solve.py``'s port on a one-rank
    gloo group, cut to n = 8,192 (the 7-point offsets reach 2,048)."""
    from torchsparsegradutils_tpu_torch.examples import (
        distributed_stencil_solve as ex)
    assert ex.OFFSETS == [-2048, -32, -1, 0, 1, 32, 2048] and ex.N == 131_072
    assert ex.main(["--cpu", "--n", "8192"]) < 1e-4


# --------------------------------------------------------------------------
# training: parameters, bodies, ranks
# --------------------------------------------------------------------------

def _port_params():
    return params_from_arrays(TRAIN["params"], device="cpu")


def test_params_from_arrays_carries_jax_init():
    p = _port_params()
    for k, v in TRAIN["params"].items():
        assert p[k].dtype == torch.float32
        np.testing.assert_array_equal(p[k].numpy(), v)
    with pytest.raises(ValueError, match="missing"):
        params_from_arrays({"values": TRAIN["params"]["values"]},
                           device="cpu")
    enc = make_model(TRAIN["volume"], radius=TRAIN["radius"])
    q = training.init_params(enc, _gen(0), device="cpu")
    assert {k: tuple(t.shape) for k, t in q.items()} == {
        k: v.shape for k, v in TRAIN["params"].items()}


def test_loss_fn_matches_jax():
    enc = make_model(TRAIN["volume"], radius=TRAIN["radius"])
    p = {k: leaf(t) for k, t in _port_params().items()}
    loss = loss_fn(p, torch.from_numpy(TRAIN["x"]), enc)
    grads = torch.autograd.grad(loss, list(p.values()))
    _, _, ref_loss, ref_grad = jax_train()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5, atol=1e-5)
    for k, g in zip(p, grads):
        close(g, ref_grad[k])


def test_train_bodies_match_jax():
    """The four (dp, tp) = (2, 2) rank terms, summed, are the global
    loss; their gradients summed the global gradient."""
    enc = make_model(TRAIN["volume"], radius=TRAIN["radius"])
    slabs = training._TpSlabs(enc, 2)
    p = {k: leaf(t) for k, t in _port_params().items()}
    x = torch.from_numpy(TRAIN["x"])
    terms = [training._local_loss(enc, slabs, 2, 16, p, x[d * 8:(d + 1) * 8],
                                  t) for d in range(2) for t in range(2)]
    total = sum(terms)
    grads = torch.autograd.grad(total, list(p.values()))
    _, _, ref_loss, ref_grad = jax_train()
    np.testing.assert_allclose(total.item(), ref_loss, rtol=1e-5, atol=1e-5)
    for k, g in zip(p, grads):
        close(g, ref_grad[k])


def test_ranks_train_step_matches_jax_step(ranks):
    loss, new, _, _ = jax_train()
    res = ranks[0]["train"]
    np.testing.assert_allclose(res["losses"][0], loss, rtol=1e-5, atol=1e-5)
    for k in new:
        close(res["params"][0][k], new[k])


def test_ranks_train_step_matches_unsharded_step(ranks):
    enc = make_model(TRAIN["volume"], radius=TRAIN["radius"])
    p = {k: leaf(t) for k, t in _port_params().items()}
    loss = loss_fn(p, torch.from_numpy(TRAIN["x"]), enc)
    grads = torch.autograd.grad(loss, list(p.values()))
    res = ranks[0]["train"]
    np.testing.assert_allclose(res["losses"][0], loss.item(), rtol=1e-5,
                               atol=1e-5)
    for (k, t), g in zip(p.items(), grads):
        close(res["params"][0][k], (t - TRAIN["lr"] * g).detach().numpy())


def test_ranks_train_loss_decreases_and_agrees(ranks):
    losses = np.array(ranks[0]["train"]["losses"])
    assert np.isfinite(losses).all() and (np.diff(losses) < 0).all()
    for r in ranks[1:]:
        assert r["train"]["losses"] == ranks[0]["train"]["losses"]
        for a, b in zip(r["train"]["params"], ranks[0]["train"]["params"]):
            assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("what,msg", [
    ("chunk_shards", "8 shards but the process group has 4 ranks"),
    ("shard_shards", "2 shards but the process group has 4 ranks"),
    ("dia_halo", "halo .32 rows. exceeds the per-shard slab .16 rows."),
    ("dia_nondia", "not pure-DIA"),
    ("train_mesh", r"a \(3, 1\) mesh needs 3 ranks, the process group has 4"),
])
def test_ranks_raise_on_a_layout_the_group_cannot_run(ranks, what, msg):
    import re
    for r in ranks:
        assert re.search(msg, r["errors"][what]), r["errors"][what]


def test_slab_kernel_plain_version_matches_unsharded_spmm():
    """K13's plain version over every slab of uneven layouts (empty
    slabs, a slab starting past n) against the whole product."""
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_spmm_slab)
    A = port(CHUNK["uneven"]["A"])
    plan = build_sharded_chunk_plan(A, 7)
    d = plan.maps("cpu")
    B = torch.from_numpy(CHUNK["uneven"]["B"])
    ref = sparse_mm(A, B)
    for rps, S in ((9, 7), (20, 4), (62, 1), (100, 1)):
        slabs = torch.cat([chunk_spmm_slab(d["indptr"], d["cols"], A.values,
                                           B, r * rps, rps)
                           for r in range(S)])
        assert slabs.shape == (rps * S, 4)
        torch.testing.assert_close(slabs[:62], ref)
        assert not slabs[62:].any()
