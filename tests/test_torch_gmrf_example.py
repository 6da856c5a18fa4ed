"""PyTorch port: ``examples/fit_sparse_gmrf.py`` held against the JAX
package's example.

At a tiny grid, ``(1, 4, 4)``, the JAX example's own ground truth and
observations (its ``make_ground_truth`` and ``rsample`` from fixed keys)
are carried across with numpy.  The first step's loss and gradients
(``values``, ``log_diag``, ``loc``) must equal JAX's
``value_and_grad`` within ``rtol=1e-4, atol=1e-5``, the tolerance of the
port's ``log_prob`` tests (a sum of squares and a log-determinant in
float32); three steps of the port's ``step`` (``torch.optim.Adam``) must
give the losses of three optax Adam steps within ``1e-4`` relative, and
the loss must fall.  The JAX DIA value relayouts take their XLA branch
(``kernels/dia.py:_use_pallas_grid``), as in the distributions' tests.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from examples import fit_sparse_gmrf as jex
from torchsparsegradutils_tpu.kernels import dia as jdia
from torchsparsegradutils_tpu.models import PairwiseEncoder as JEncoder
from torchsparsegradutils_tpu_torch.examples import fit_sparse_gmrf as pex

VOLUME = (1, 4, 4)
SAMPLES = 64
STEPS = 3
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def jax_grid_on_xla():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdia, "_use_pallas_grid", lambda dtype: False)
        yield


@pytest.fixture(scope="module")
def jax_run():
    """The JAX example's data, first gradient and three Adam losses."""
    key = jax.random.PRNGKey(0)
    enc = JEncoder(radius=1.5, volume_shape=VOLUME, diag=False,
                   upper=False, layout="coo")
    truth = jex.make_ground_truth(jax.random.fold_in(key, 1), enc)
    data = jex.dist_from(truth, enc).rsample(jax.random.fold_in(key, 2),
                                             (SAMPLES,))
    n = enc.volume_numel
    params = {"values": jax.numpy.zeros_like(truth["values"]),
              "log_diag": jax.numpy.zeros((n,)),
              "loc": jax.numpy.zeros((n,))}

    def nll(p, batch):
        return -jex.dist_from(p, enc).log_prob(batch).mean()

    loss0, grads0 = jax.value_and_grad(nll)(params, data)
    opt = optax.adam(pex.LR)

    @jax.jit
    def step(p, state, batch):
        loss, g = jax.value_and_grad(nll)(p, batch)
        updates, state = opt.update(g, state)
        return optax.apply_updates(p, updates), state, loss

    state, losses = opt.init(params), []
    for _ in range(STEPS):
        params, state, loss = step(params, state, data)
        losses.append(float(loss))
    return {"offsets": np.asarray(enc.offsets), "data": np.array(data),
            "loss0": float(loss0),
            "grads0": {k: np.asarray(v) for k, v in grads0.items()},
            "losses": losses}


def test_first_step_matches_jax(jax_run):
    enc = pex.make_encoder(VOLUME)
    np.testing.assert_array_equal(np.asarray(enc.offsets),
                                  jax_run["offsets"])
    params = pex.init_params(enc, "cpu")
    loss = pex.nll(params, enc, torch.from_numpy(jax_run["data"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["loss0"], **TOL)
    for name, ref in jax_run["grads0"].items():
        np.testing.assert_allclose(params[name].grad.numpy(), ref, **TOL)


def test_adam_steps_match_optax_and_loss_falls(jax_run):
    enc = pex.make_encoder(VOLUME)
    params = pex.init_params(enc, "cpu")
    opt = torch.optim.Adam(params.values(), lr=pex.LR)
    batch = torch.from_numpy(jax_run["data"])
    losses = [pex.step(params, opt, enc, batch).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
