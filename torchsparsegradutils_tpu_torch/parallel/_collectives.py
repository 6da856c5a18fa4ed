"""The collectives of the sharded ops, on ``torch.distributed``.

A JAX ``shard_map`` over one mesh axis becomes one rank per shard of a
process group: ``group=None`` is the default group.  Where JAX's
transpose rules insert a ``psum`` (the gradient of an input replicated
over the axis), :class:`Replicated` sums the gradient over the group in
its backward.  Every rank of the group must make the same calls in the
same order, as for any collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_rank(n_shards: int, group, what: str) -> int:
    """This process's rank in ``group``; raises ``ValueError`` when the
    layout's shard count is not the group's size."""
    size = dist.get_world_size(group)
    if n_shards != size:
        raise ValueError(f"{what}: the layout has {n_shards} shards but the "
                         f"process group has {size} ranks")
    return dist.get_rank(group)


def global_rank(group, rank: int) -> int:
    """The default group's rank of ``group``'s rank ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


class Replicated(torch.autograd.Function):
    """``Replicated.apply(group, *tensors)``: the tensors unchanged; in
    the backward each gradient is summed over ``group``
    (``all_reduce``), so an input that every rank holds gets the gradient
    of the whole sharded computation, the same on every rank."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:         # materialised: every rank reduces each one
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


def exchange(ops, group) -> None:
    """Run point-to-point ``(op, tensor, group_rank)`` triples over
    ``group`` together and wait for all of them."""
    if ops:
        for req in dist.batch_isend_irecv(
                [dist.P2POp(op, t, global_rank(group, peer), group)
                 for op, t, peer in ops]):
            req.wait()
