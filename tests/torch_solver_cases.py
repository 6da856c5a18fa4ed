"""Matrices and helpers shared by the port's solver tests
(``test_torch_solvers.py``, ``test_torch_solve.py``).

The matrices are built once a process by the JAX package's generators
in float64 (so the callers need the ``enable_x64`` fixture), a few
shapes only: each new shape compiles the generators' JAX ops again.
``to_port`` carries a JAX container over to the port on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu.utils import random_sparse as jrs
from torchsparsegradutils_tpu_torch import from_arrays

KEY = jax.random.PRNGKey(3)
N = 32                   # the SPD matrices: N rows, 5 N entries
SQUARE = (24, 24)        # general square, well conditioned, 96 entries
TALL = (30, 10)          # least squares, 80 entries (tests/test_solvers.py)


def to_port(Aj):
    """The port container holding the arrays of JAX container ``Aj``."""
    data = np.asarray(Aj.data)
    if isinstance(Aj, tj.SparseCSR):
        return from_arrays("csr", Aj.indptr_np(), Aj.cols_np(), data,
                           Aj.shape, device="cpu")
    return from_arrays("coo", Aj.rows_np(), Aj.cols_np(), data, Aj.shape,
                       device="cpu")


@functools.lru_cache(maxsize=None)
def spd(layout="coo"):
    return jrs.make_spd_sparse(KEY, N, 5 * N, layout=layout,
                               value_dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def square(layout="coo"):
    return jrs.rand_sparse(KEY, SQUARE, 96, layout=layout,
                           value_dtype=jnp.float64, well_conditioned=True)


@functools.lru_cache(maxsize=None)
def tall(layout="coo"):
    return jrs.rand_sparse(KEY, TALL, 80, layout=layout,
                           value_dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def stencil():
    return jrs.make_spd_stencil(KEY, 64, [1, 8], value_dtype=jnp.float64)


def rhs(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, rtol):
    """|got - ref| <= rtol (|ref| + max |ref|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


# the routes of a solve's matvec: the generic branch, the chunk engine
# (with ``ops.spmm._chunk_plan`` read as ``backend="pallas"``) and DIA
ROUTES = ("generic", "chunk", "dia")


def route_case(route):
    """The JAX matrix whose port copy takes ``route`` on the CPU."""
    return {"generic": lambda: spd("coo"), "chunk": lambda: spd("csr"),
            "dia": stencil}[route]()


@functools.lru_cache(maxsize=None)
def jax_mismatch_message(solver):
    """The ValueError message of JAX ``solver`` on a float64 A and a
    float32 right-hand side (its ``sparse_mm`` refusal; JAX's DIA route
    fails later, in its loop, so the generic route gives the message)."""
    Aj = spd("coo")
    try:
        solver(Aj, jnp.ones((N, 2), jnp.float32))
    except ValueError as e:
        return str(e)
    raise AssertionError("JAX accepted a float64 A with a float32 B")
