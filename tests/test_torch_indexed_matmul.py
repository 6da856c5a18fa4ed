"""PyTorch port: ``segment_mm`` and ``gather_mm`` held against the JAX
package.

The five cases of the JAX package's ``tests/test_indexed_matmul.py``, on
numpy inputs from fixed seeds handed to both packages: outputs and the
gradients of ``sum(out²)`` for ``a`` and ``b`` within ``rtol=1e-5,
atol=1e-6`` of JAX's (``lax.ragged_dot``; float32 both, the JAX tests'
own tolerance), and the validation messages equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsparsegradutils_tpu as tj
from torchsparsegradutils_tpu_torch import gather_mm, segment_mm

TOL = dict(rtol=1e-5, atol=1e-6)
IDX = np.array([2, 0, 1, 1, 2, 0, 0, 2])


def _inputs(seed, a_shape, b_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(a_shape).astype(np.float32),
            rng.standard_normal(b_shape).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax(op, seed, a_shape, b_shape, third):
    """JAX's output and the gradients of sum(out²), jitted."""
    a, b = _inputs(seed, a_shape, b_shape)
    third = jnp.asarray(np.array(third))
    fn = functools.partial(getattr(tj, op), idx_b=third) if op == \
        "gather_mm" else functools.partial(getattr(tj, op),
                                           seglen_a=third)
    out, grads = jax.jit(lambda a, b: (fn(a, b), jax.grad(
        lambda a, b: (fn(a, b) ** 2).sum(), argnums=(0, 1))(a, b)))(a, b)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check(op, seed, a_shape, b_shape, third):
    a, b = _inputs(seed, a_shape, b_shape)
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    fn = {"segment_mm": segment_mm, "gather_mm": gather_mm}[op]
    out = fn(at, bt, torch.tensor(third))
    grads = torch.autograd.grad((out ** 2).sum(), (at, bt))
    ref, rgrads = _jax(op, seed, a_shape, b_shape, third)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    for g, r in zip(grads, rgrads):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    return a, b, out.detach().numpy()


def test_segment_mm():
    a, b, out = _check("segment_mm", 0, (10, 4), (3, 4, 5), (3, 0, 7))
    ref = np.concatenate([a[0:3] @ b[0], a[3:3] @ b[1], a[3:10] @ b[2]])
    np.testing.assert_allclose(out, ref, **TOL)


def test_segment_mm_grad():
    _check("segment_mm", 1, (6, 3), (2, 3, 4), (2, 4))
    # rows past the segments' sum give zeros, as lax.ragged_dot's
    _check("segment_mm", 2, (6, 3), (2, 3, 4), (2, 1))


def test_gather_mm():
    a, b, out = _check("gather_mm", 3, (8, 4), (3, 4, 5), tuple(IDX))
    np.testing.assert_allclose(out, np.stack([a[i] @ b[IDX[i]]
                                              for i in range(8)]), **TOL)


def test_gather_mm_grad():
    _check("gather_mm", 4, (8, 4), (3, 4, 5), tuple(IDX))
    # a stack entry no row uses gets a zero gradient
    _check("gather_mm", 5, (5, 2), (4, 2, 3), (3, 0, 3, 0, 0))


def test_validation_matches_jax():
    cases = [
        ("segment_mm", (4,), (2, 3, 5), [2, 2]),
        ("segment_mm", (4, 3), (3, 5), [2, 2]),
        ("segment_mm", (4, 3), (2, 4, 5), [2, 2]),
        ("segment_mm", (4, 3), (2, 3, 5), [2, 1, 1]),
        ("gather_mm", (4, 3), (2, 3, 5), [0, 1]),
        ("gather_mm", (4, 3), (2, 3, 5), [0.0, 0.0, 0.0, 0.0]),
    ]
    for op, a_shape, b_shape, third in cases:
        with pytest.raises(ValueError) as ej:
            getattr(tj, op)(jnp.ones(a_shape), jnp.ones(b_shape),
                            jnp.asarray(third))
        fn = {"segment_mm": segment_mm, "gather_mm": gather_mm}[op]
        with pytest.raises(ValueError) as ep:
            fn(torch.ones(a_shape), torch.ones(b_shape), torch.tensor(third))
        assert str(ep.value) == str(ej.value)
