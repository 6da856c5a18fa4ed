"""Segmented and per-row-indexed grouped matmuls (DGL / PyG style).

Port of ``torchsparsegradutils_tpu/ops/indexed_matmul.py``, with its
checks and messages:

* :func:`segment_mm`: rows of ``a`` in contiguous segment ``i`` are
  multiplied by ``b[i]``;
* :func:`gather_mm`: ``out[i] = a[i] @ b[idx_b[i]]``, as a stable sort by
  index, :func:`segment_mm` and the inverse permutation.

The JAX package computes both with ``lax.ragged_dot``, outside any
Pallas kernel; here one ``torch.matmul`` a segment, differentiated by
autograd.  The segment lengths are read on the host.

Example:
    >>> import torch
    >>> a, b = torch.ones(5, 2), torch.stack([torch.eye(2), 2 * torch.eye(2)])
    >>> segment_mm(a, b, [2, 3])[:, 0].tolist()
    [1.0, 1.0, 2.0, 2.0, 2.0]
    >>> gather_mm(a, b, torch.tensor([1, 0, 1, 0, 0]))[:, 0].tolist()
    [2.0, 1.0, 2.0, 1.0, 1.0]
"""

from __future__ import annotations

import torch

__all__ = ["segment_mm", "gather_mm"]


def _check_ab(a, b, op: str):
    if a.ndim != 2:
        raise ValueError(f"{op}: a must be 2-D (N, D1), got {a.ndim}-D")
    if b.ndim != 3:
        raise ValueError(f"{op}: b must be 3-D (R, D1, D2), got {b.ndim}-D")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"{op}: inner dims disagree, a is "
                         f"{tuple(a.shape)} and b is {tuple(b.shape)}")


def _segments(a, b, lens):
    """``a``'s rows in segments of ``lens`` (host ints) times ``b[i]``;
    rows past the segments' sum give zeros, as ``lax.ragged_dot``'s."""
    outs, start = [], 0
    for i, k in enumerate(lens):
        outs.append(a[start:start + k] @ b[i])
        start += k
    rest = a.shape[0] - start
    if rest > 0:
        outs.append(a.new_zeros((rest, b.shape[2])))
    return torch.cat(outs) if outs else a.new_zeros((0, b.shape[2]))


def segment_mm(a, b, seglen_a) -> torch.Tensor:
    """Segmented matmul: rows of ``a`` in segment i are multiplied by
    ``b[i]``.

    Args:
      a: ``(N, D1)`` dense.
      b: ``(R, D1, D2)`` dense stack of matrices.
      seglen_a: ``(R,)`` integer segment lengths summing to N (rows
        ``a[sum(seglen_a[:i]) : sum(seglen_a[:i+1])]`` use ``b[i]``).

    Returns:
      ``(N, D2)``.
    """
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    _check_ab(a, b, "segment_mm")
    seglen_a = torch.as_tensor(seglen_a)
    if seglen_a.ndim != 1 or seglen_a.shape[0] != b.shape[0]:
        raise ValueError(
            f"segment_mm: seglen_a must be 1-D with length {b.shape[0]}, "
            f"got shape {tuple(seglen_a.shape)}")
    return _segments(a, b, [int(k) for k in seglen_a.tolist()])


def gather_mm(a, b, idx_b) -> torch.Tensor:
    """Indexed matmul: ``out[i] = a[i] @ b[idx_b[i]]``.

    Args:
      a: ``(N, D1)`` dense.
      b: ``(R, D1, D2)`` dense stack.
      idx_b: ``(N,)`` integer matrix index per row of ``a``.

    Returns:
      ``(N, D2)``.
    """
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    _check_ab(a, b, "gather_mm")
    idx_b = torch.as_tensor(idx_b, device=a.device)
    if idx_b.ndim != 1 or idx_b.shape[0] != a.shape[0]:
        raise ValueError(
            f"gather_mm: idx_b must be 1-D with length {a.shape[0]}, got "
            f"shape {tuple(idx_b.shape)}")
    if (idx_b.dtype.is_floating_point or idx_b.dtype.is_complex
            or idx_b.dtype == torch.bool):
        raise ValueError("gather_mm: idx_b must be an integer array")
    order = torch.sort(idx_b, stable=True).indices
    counts = torch.bincount(idx_b, minlength=b.shape[0])
    out = _segments(a.index_select(0, order), b, counts.tolist())
    return torch.empty_like(out).index_copy(0, order, out)
