"""Fit a sparse Gaussian Markov random field to spatial data.

Port of ``examples/fit_sparse_gmrf.py``: a :class:`PairwiseEncoder`
builds the neighbourhood pattern of a 2-D image grid, its output
parameterises a :class:`SparseMultivariateNormal` in the precision-LDLᵀ
form, and Adam (``torch.optim.Adam`` in place of optax) maximises the
exact sparse log-likelihood of observed samples: gradients flow to the
encoder's per-offset value maps through the sparse kernels (the banded
triangular solve, K9, and its SDDMM, K2, on the card).  Every draw comes
from an explicit generator.

Run: ``python -m torchsparsegradutils_tpu_torch.examples.fit_sparse_gmrf``
(on the card; ``--cpu`` on the CPU).
"""

from __future__ import annotations

import argparse

import torch

from torchsparsegradutils_tpu_torch.models import (PairwiseEncoder,
                                                   SparseMultivariateNormal)

VOLUME = (1, 16, 16)
STEPS, LR = 300, 3e-2


def make_encoder(volume_shape=VOLUME) -> PairwiseEncoder:
    """The strictly lower neighbourhood pattern of the example's grid."""
    return PairwiseEncoder(radius=1.5, volume_shape=volume_shape,
                           diag=False, upper=False, layout="coo")


def make_ground_truth(enc: PairwiseEncoder, generator: torch.Generator,
                      device) -> dict:
    """A random (but valid) sparse-precision Gaussian over the grid."""
    n = enc.volume_numel
    values = 0.3 * torch.randn((len(enc.offsets),) + enc.volume_shape,
                               generator=generator)
    log_diag = 0.2 * torch.randn(n, generator=generator)
    return {"values": values.to(device), "log_diag": log_diag.to(device),
            "loc": torch.zeros(n, device=device)}


def dist_from(params: dict, enc: PairwiseEncoder) -> SparseMultivariateNormal:
    L = enc(params["values"])  # strictly lower factor
    return SparseMultivariateNormal(params["loc"],
                                    torch.exp(params["log_diag"]),
                                    precision_tril=L)


def init_params(enc: PairwiseEncoder, device) -> dict:
    """Zero parameters, each a leaf that requires its gradient."""
    n = enc.volume_numel
    return {"values": torch.zeros((len(enc.offsets),) + enc.volume_shape,
                                  device=device, requires_grad=True),
            "log_diag": torch.zeros(n, device=device, requires_grad=True),
            "loc": torch.zeros(n, device=device, requires_grad=True)}


def nll(params: dict, enc: PairwiseEncoder, batch: torch.Tensor):
    """The mean negative log-likelihood of ``batch``."""
    return -dist_from(params, enc).log_prob(batch).mean()


def step(params: dict, opt: torch.optim.Optimizer, enc: PairwiseEncoder,
         batch: torch.Tensor) -> torch.Tensor:
    """One Adam step on :func:`nll`; returns the loss before the step."""
    opt.zero_grad()
    loss = nll(params, enc, batch)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    gen = torch.Generator().manual_seed(0)

    enc = make_encoder()
    n = enc.volume_numel
    print(f"grid {enc.volume_shape}, event dim {n}, "
          f"{len(enc.offsets)} offsets, pattern nnz {enc.nnz}")

    # synthetic data from a ground-truth model
    truth = make_ground_truth(enc, gen, device)
    sample_gen = torch.Generator(device=device).manual_seed(2)
    data = dist_from(truth, enc).sample((4096,), generator=sample_gen)
    print(f"observations: {tuple(data.shape)}")

    params = init_params(enc, device)
    opt = torch.optim.Adam(params.values(), lr=LR)
    with torch.no_grad():
        truth_nll = float(nll(truth, enc, data))
    for i in range(args.steps):
        loss = step(params, opt, enc, data)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  nll {float(loss):9.3f}   "
                  f"(ground truth {truth_nll:9.3f})")

    with torch.no_grad():
        final = float(nll(params, enc, data))
    assert final < truth_nll + 0.15 * abs(truth_nll) + 5.0, (
        "did not approach the ground-truth likelihood")
    print("fitted within tolerance of the ground-truth likelihood")


if __name__ == "__main__":
    main()
