"""The flagship 2-D-parallel training step: sparse-precision Gaussian
fitting.

Port of ``torchsparsegradutils_tpu/parallel/training.py``.  The model is
the reference library's integration path: a ``PairwiseEncoder`` pattern
gives a strictly lower factor L over an nD volume, the precision is
``Ω = (I + L) D (I + L)ᵀ``, and the loss is the exact negative mean
log-likelihood of observations x:

    −log p(x) = ½ ‖D^½ (I + L)ᵀ (x − μ)‖² − ½ Σ log D
                + (n/2) log 2π

It is trained by SGD over ``dp × tp`` ranks laid out as JAX's
``Mesh(devices.reshape(dp, tp), ("dp", "tp"))``, rank ``d · tp + t``:

* ``dp``: data parallelism over observations (each rank takes its slice
  of the batch);
* ``tp``: the rows of ``Lᵀ`` are sharded (:mod:`.sharding`), each rank
  computing its slab's share of every sample's quadratic form.

Each rank's loss term is its slab's quadratic forms over its samples plus
a ``1/tp`` share of the log-determinant and constant of those samples,
so the terms of all ranks sum to the global loss.  The step sums the
terms and their gradients over the tp group and then over the dp group
(JAX's ``psum`` over "tp" and "dp"): every rank gets the global loss and
its true gradient, and applies the same update.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.encoders import PairwiseEncoder
from ..ops.spmm import sparse_mm
from ..types import StaticArray
from ._collectives import global_rank
from .sharding import local_shard_spmm, partition_rows

__all__ = ["make_model", "make_train_step", "init_params", "loss_fn"]

_NAMES = ("values", "log_diag", "loc")


def make_model(volume_shape=(1, 8, 8), radius: float = 1.0):
    """The flagship pattern: a strictly lower pairwise factor over an nD
    volume (LDLᵀ precision parameterisation)."""
    return PairwiseEncoder(radius, volume_shape, diag=False, upper=False,
                           layout="coo")


def init_params(enc: PairwiseEncoder, generator: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Factor values ``0.01 · N(0, 1)`` drawn from ``generator`` (a CPU
    ``torch.Generator``), ``log_diag`` and ``loc`` zero, float32 on
    ``device``."""
    n = enc.volume_numel
    values = 0.01 * torch.randn((len(enc.offsets),) + enc.volume_shape,
                                generator=generator)
    return {"values": values.to(device),
            "log_diag": torch.zeros(n, device=device),
            "loc": torch.zeros(n, device=device)}


def loss_fn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            enc: PairwiseEncoder) -> torch.Tensor:
    """Single-device negative mean log-likelihood (precision LDLᵀ).

    x: ``(S, n)`` observations.  L is strictly lower, from the encoder.
    """
    L = enc(params["values"])
    n = enc.volume_numel
    D = torch.exp(params["log_diag"])
    E = (x - params["loc"]).T                      # (n, S)
    y = E + sparse_mm(L.T, E)                      # (I + L)ᵀ δ
    quad = (D[:, None] * y * y).sum(0)             # (S,)
    logdet = torch.log(D).sum()
    nll = 0.5 * quad - 0.5 * logdet + 0.5 * n * math.log(2 * math.pi)
    return nll.mean()


class _TpSlabs:
    """The rows of ``Lᵀ`` sharded over ``tp`` slabs as
    :func:`.sharding.shard_rows` shards them (:func:`.sharding.
    partition_rows`), with each slab's pattern hashed once."""

    def __init__(self, enc: PairwiseEncoder, tp: int):
        # Lᵀ: the encoder's (row, col) swapped
        (self.local_rows, self.cols, self.sel, self.mask,
         self.rps) = partition_rows(enc._out_cols, enc._out_rows,
                                    enc.volume_numel, tp)
        self.n_pad = self.rps * tp
        self.patterns = [(StaticArray(r), StaticArray(c))
                         for r, c in zip(self.local_rows, self.cols)]
        self._dev = {}

    def maps(self, t: int, device):
        """Slab ``t``'s entry selection and mask on ``device`` (cached)."""
        key = (t, torch.device(device))
        d = self._dev.get(key)
        if d is None:
            d = self._dev[key] = (torch.from_numpy(self.sel[t]).to(device),
                                  torch.from_numpy(self.mask[t]).to(device))
        return d


def _local_loss(enc, slabs: _TpSlabs, tp: int, n_samples: int, params,
                x_local: torch.Tensor, t: int) -> torch.Tensor:
    """Rank ``(d, t)``'s term of the global loss, with no collectives:
    the quadratic forms of tp slab ``t`` over the dp slice ``x_local``,
    plus a ``1/tp`` share of those samples' log-determinant and
    constant, over the global sample count ``n_samples``."""
    n, rps = enc.volume_numel, slabs.rps
    vals = enc(params["values"]).values
    sel, mask = slabs.maps(t, vals.device)
    d_ = torch.where(mask, vals.index_select(0, sel), 0.0)
    D = torch.exp(params["log_diag"])
    E = (x_local - params["loc"]).T                          # (n, S_l)
    y = local_shard_spmm(*slabs.patterns[t], d_, E, rps)
    pad = (0, 0, 0, slabs.n_pad - n)
    y = y + F.pad(E, pad)[t * rps:(t + 1) * rps]             # (I + L)ᵀ δ
    D_slab = F.pad(D, (0, slabs.n_pad - n))[t * rps:(t + 1) * rps]
    quad = (D_slab[:, None] * y * y).sum()
    S_l = x_local.shape[0]
    rest = S_l * (-0.5 * torch.log(D).sum() + 0.5 * n * math.log(2 * math.pi))
    return (0.5 * quad + rest / tp) / n_samples


def make_train_step(enc: PairwiseEncoder, dp: int, tp: int,
                    lr: float = 1e-2, group=None):
    """Build the 2-D-parallel (dp × tp) SGD training step.

    The ranks of ``group`` (the default group when None; it must have
    ``dp · tp`` ranks, else ``ValueError``) form a ``(dp, tp)`` mesh,
    rank ``d · tp + t``; the tp and dp subgroups are made here with
    ``dist.new_group``, so every rank of the job must call this together.

    Returns ``step(params, x) -> (new_params, loss)``: ``x`` is the global
    ``(S, n)`` batch (S divisible by dp), of which the rank reads its dp
    slice; ``params`` are the same on every rank, and so are the returned
    parameters and loss.  ``step.local_loss(params, x, rank)`` is the
    per-rank body (the rank's loss term, no collectives).
    """
    size = dist.get_world_size(group)
    if size != dp * tp:
        raise ValueError(f"make_train_step: a ({dp}, {tp}) mesh needs "
                         f"{dp * tp} ranks, the process group has {size}")
    rank = dist.get_rank(group)
    members = [global_rank(group, r) for r in range(size)]
    tp_groups = [dist.new_group([members[d * tp + t] for t in range(tp)])
                 for d in range(dp)]
    dp_groups = [dist.new_group([members[d * tp + t] for d in range(dp)])
                 for t in range(tp)]
    d_me, t_me = divmod(rank, tp)
    slabs = _TpSlabs(enc, tp)

    def local_loss(params, x, r):
        if x.shape[0] % dp:
            raise ValueError(f"make_train_step: {x.shape[0]} observations "
                             f"do not split over dp = {dp}")
        d, t = divmod(r, tp)
        S_l = x.shape[0] // dp
        return _local_loss(enc, slabs, tp, x.shape[0], params,
                           x[d * S_l:(d + 1) * S_l], t)

    def step(params, x):
        leaves = {k: params[k].detach().requires_grad_(True) for k in _NAMES}
        loss = local_loss(leaves, x, rank)
        grads = torch.autograd.grad(loss, [leaves[k] for k in _NAMES])
        flat = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        for g in (tp_groups[d_me], dp_groups[t_me]):   # psum "tp", "dp"
            dist.all_reduce(flat, group=g)
        new, i = {}, 1
        for k in _NAMES:
            p = params[k]
            new[k] = (p.detach() - lr * flat[i:i + p.numel()].view_as(p))
            i += p.numel()
        return new, flat[0]

    step.local_loss = local_loss
    return step
