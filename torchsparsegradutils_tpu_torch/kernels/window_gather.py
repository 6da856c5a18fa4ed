"""Value relayout by a partial map: ``dst[d] = src[map[d]]``, 0 where
``map[d] < 0``.

Port of ``torchsparsegradutils_tpu/kernels/window_gather.py``.  On the
TPU this gather is a Pallas kernel with z8 / drift / BigShift window
plans, because a TPU reads scalars at random slowly.  An H100 gathers
natively, so the port keeps only the function: the map itself is the
plan, and the CUDA kernel ``csrc/gather.cu`` reads it as it is.

:func:`window_gather` launches that kernel on CUDA tensors and runs its
plain PyTorch version, :func:`window_gather_plain`, on CPU tensors.
:class:`WindowGather` makes it differentiable: for an injective map its
backward is the same gather by the inverse map.

Example:
    >>> import torch
    >>> src = torch.tensor([1.0, 2.0, 3.0])
    >>> window_gather(src, torch.tensor([2, -1, 0])).tolist()
    [3.0, 0.0, 1.0]
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["window_gather", "window_gather_plain", "WindowGather"]


def window_gather_plain(src: torch.Tensor, idx: torch.Tensor):
    """Plain PyTorch version of the gather kernel."""
    srcz = torch.cat([src, src.new_zeros(1)])
    return srcz[torch.where(idx >= 0, idx, src.shape[0])]


def window_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dst[d] = src[idx[d]]`` (0 where ``idx[d] < 0``), 1-D ``src`` and
    int64 ``idx``.

    CPU tensors take :func:`window_gather_plain`; CUDA tensors launch
    ``csrc/gather.cu`` and raise on what it does not take.
    """
    if src.device.type == "cpu" and idx.device.type == "cpu":
        return window_gather_plain(src, idx)
    suffix = _build.cuda_operands("window_gather", (src,), (idx,))
    if src.ndim != 1 or idx.ndim != 1:
        raise ValueError(f"window_gather: src and idx must be 1-D, got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    out = torch.empty(idx.shape, dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    _build.launch("gather", f"tsgu_gather_{suffix}", src, idx, out,
                  src.shape[0], idx.shape[0])
    window_gather.launches += 1
    return out


window_gather.launches = 0


class WindowGather(torch.autograd.Function):
    """Differentiable ``window_gather(src, idx)``.

    ``inv`` is the inverse partial map, of ``src``'s length:
    ``inv[idx[d]] = d`` where ``idx[d] >= 0``, -1 at source slots no
    destination reads.  ``idx`` must be injective on its valid slots, so
    the backward is the gather ``ct[inv]``, itself a WindowGather:
    higher derivatives work.
    """

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(idx, inv)
        return window_gather(src.contiguous(), idx)

    @staticmethod
    def backward(ctx, ct):
        idx, inv = ctx.saved_tensors
        return WindowGather.apply(ct, inv, idx), None, None
