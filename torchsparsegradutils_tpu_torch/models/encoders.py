"""Pairwise spatial-channel neighbourhood encoders.

Port of ``torchsparsegradutils_tpu/models/encoders.py`` (itself a rebuild
of the reference library's ``encoders/pairwise_encoder.py``):

* :func:`_trim_nd`: per-axis trimming (a positive offset drops the start
  of an axis, a negative one its end);
* :func:`_gen_coords_nd`: integer lattice points in an l2 ball, origin
  excluded;
* :func:`_gen_offsets_nd`: ``(channel, *spatial)`` offset tuples with the
  ``indep``/``intra``/``inter`` channel relations, ``upper`` filtering
  by the sign of the first non-zero entry, and the same deterministic
  sort key (channel-scaled radius, ``|entries|``, sign preference);
* :func:`calc_pairwise_coo_indices_nd`: per-offset ``(2, M)`` linear
  index pairs by double trimming of the row-major index lattice;
* :class:`PairwiseEncoder`: all index structure is host numpy, built at
  ``__init__``; ``__call__`` cuts the per-offset value blocks, joins
  them and reorders them (``index_select``, or ``index_add`` where
  duplicate pairs merge) into this package's :class:`~..types.SparseCOO`
  or :class:`~..types.SparseCSR`.  No kernel runs here, as in the JAX
  package.

Example:
    >>> import torch
    >>> enc = PairwiseEncoder(1.0, (1, 3, 3), upper=False, layout="coo")
    >>> enc.offsets
    [(0, 0, 1), (0, 1, 0)]
    >>> L = enc(torch.ones(len(enc.offsets), 1, 3, 3))
    >>> L.shape, L.nnz
    ((9, 9), 12)
"""

from __future__ import annotations

import math
import warnings
from functools import reduce
from itertools import product
from operator import mul
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..types import SparseCOO, SparseCSR, StaticArray

__all__ = [
    "PairwiseEncoder",
    "calc_pairwise_coo_indices_nd",
    "calc_pairwise_coo_indices",
    "PairwiseVoxelEncoder",
]


def calc_pairwise_coo_indices(radius, volume_shape, diag=False, upper=None,
                              channel_voxel_relation="indep",
                              index_dtype=np.int64):
    """Deprecated 3-D ``(C, H, D, W)`` wrapper of
    :func:`calc_pairwise_coo_indices_nd`."""
    warnings.warn("calc_pairwise_coo_indices is deprecated; use "
                  "calc_pairwise_coo_indices_nd", DeprecationWarning,
                  stacklevel=2)
    if len(volume_shape) != 4:
        raise ValueError("volume_shape must be a 4D tuple [C, H, D, W]")
    return calc_pairwise_coo_indices_nd(radius, volume_shape, diag, upper,
                                        channel_voxel_relation, index_dtype)


def _trim_slices(offsets: Tuple[int, ...]) -> Tuple[slice, ...]:
    return tuple(slice(None if o < 0 else o, None if o > -1 else o)
                 for o in offsets)


def _trim_nd(x, offsets: Tuple[int, ...]):
    """Trim each axis: k > 0 keeps ``x[k:]``, k < 0 keeps ``x[:k]`` (numpy
    arrays and torch tensors alike)."""
    if x.ndim != len(offsets):
        raise ValueError(
            f"Number of dimensions in tensor ({x.ndim}) does not match "
            f"number of offsets ({len(offsets)})")
    return x[_trim_slices(offsets)]


def _gen_coords_nd(radius: float, spatial_dims: int) -> Set[Tuple[int, ...]]:
    """Integer lattice points with ``||x||_2 <= radius``, origin
    excluded."""
    if spatial_dims <= 0:
        raise ValueError("spatial_dims must be a positive integer")
    rng = range(math.floor(-radius), math.ceil(radius) + 1)
    zero = tuple(0 for _ in range(spatial_dims))
    return {c for c in product(rng, repeat=spatial_dims)
            if sum(v * v for v in c) <= radius ** 2 and c != zero}


def _gen_offsets_nd(radius: float, spatial_dims: int,
                    upper: Optional[bool] = None, num_channels: int = 1,
                    channel_voxel_relation: str = "indep"
                    ) -> List[Tuple[int, ...]]:
    """Sorted ``(channel, *spatial)`` offset tuples (module docstring)."""
    coords = _gen_coords_nd(radius, spatial_dims)
    offsets = [(0,) + s for s in coords]
    if channel_voxel_relation != "indep":
        for c in range(1, num_channels):
            offsets.append((c,) + tuple(0 for _ in range(spatial_dims)))
    if channel_voxel_relation == "inter":
        for c in range(1, num_channels):
            offsets.extend([(c,) + s for s in coords])

    def first_nonzero_sign(t):
        for v in t:
            if v != 0:
                return 1 if v > 0 else -1
        return 0

    if upper is False:
        offsets = [o for o in offsets if first_nonzero_sign(o) > 0]
    elif upper is True:
        offsets = [o for o in offsets if first_nonzero_sign(o) < 0]

    return sorted(
        offsets,
        key=lambda x: (sum(v * v for v in ((10 * x[0],) + x[1:])),
                       tuple(map(abs, x)), tuple(v >= 0 for v in x)))


def calc_pairwise_coo_indices_nd(
        radius: float, volume_shape: Tuple[int, ...], diag: bool = False,
        upper: Optional[bool] = None,
        channel_voxel_relation: str = "indep",
        index_dtype=np.int64) -> Dict[Tuple[int, ...], np.ndarray]:
    """Per-offset ``(2, M)`` linear index pairs for a ``(C, *spatial)``
    volume.

    The second row is the first shifted by the offset, restricted to
    in-bounds pairs (double trim: no wrap, no padding).  Linearisation is
    row-major over the full volume shape.
    """
    if radius < 1:
        raise ValueError("radius must be >= 1")
    if not (len(volume_shape) >= 2
            and all(isinstance(d, (int, np.integer)) and d > 0
                    for d in volume_shape)):
        raise ValueError("volume_shape must be a tuple of at least 2 "
                         "positive integers")
    if channel_voxel_relation not in ("indep", "intra", "inter"):
        raise ValueError(
            "channel_voxel_relation must be 'indep', 'intra', or 'inter'")
    if volume_shape[0] == 1 and channel_voxel_relation != "indep":
        raise ValueError("channel_voxel_relation must be 'indep' when "
                         "number of channels is 1")
    spatial_dims = len(volume_shape) - 1
    offsets = _gen_offsets_nd(radius, spatial_dims, upper, volume_shape[0],
                              channel_voxel_relation)
    numel = reduce(mul, volume_shape)
    idx = np.arange(numel, dtype=np.dtype(index_dtype)).reshape(volume_shape)
    indices: Dict[Tuple[int, ...], np.ndarray] = {}
    if diag:
        zero = tuple(0 for _ in range(len(volume_shape)))
        flat = idx.reshape(-1)
        indices[zero] = np.stack([flat, flat])
    for off in offsets:
        x1 = _trim_nd(idx, off).reshape(-1)
        x2 = _trim_nd(idx, tuple(-o for o in off)).reshape(-1)
        indices[off] = np.stack([x1, x2])
    return indices


class PairwiseEncoder:
    """Encode per-offset neighbourhood values as one sparse matrix.

    Args:
      radius: spatial neighbourhood radius (>= 1).
      volume_shape: ``(C, *spatial_dims)``.
      diag: include the diagonal (self-pair) offset.
      upper: triangular selection: True keeps offsets whose first
        non-zero is negative (upper triangle), False the positive ones,
        None all.
      channel_voxel_relation: ``'indep'`` | ``'intra'`` | ``'inter'``.
      layout: ``"coo"`` or ``"csr"`` output container.
      index_dtype: int32 (default) or int64.

    ``__call__(values)`` with values of shape ``[(B), N, C, *spatial]``
    (``N == len(self.offsets)``) returns a sparse ``[(B), S, S]``
    container with ``S = C * prod(spatial)``, its values a
    differentiable function of ``values``, on ``values``' device.
    """

    def __init__(self, radius: float, volume_shape: Tuple[int, ...],
                 diag: bool = False, upper: Optional[bool] = None,
                 channel_voxel_relation: str = "indep",
                 layout: str = "coo", index_dtype=np.int32):
        if layout not in ("coo", "csr"):
            raise ValueError("layout must be 'coo' or 'csr'")
        if np.dtype(index_dtype) not in (np.dtype(np.int32),
                                         np.dtype(np.int64)):
            raise ValueError("index_dtype must be int32 or int64")
        self.radius = radius
        self.volume_shape = tuple(int(s) for s in volume_shape)
        self.diag = diag
        self.upper = upper
        self.channel_voxel_relation = channel_voxel_relation
        self.layout = layout
        self.index_dtype = np.dtype(index_dtype)
        self.volume_numel = reduce(mul, self.volume_shape)
        self.spatial_dims = len(self.volume_shape) - 1

        idx_dict = calc_pairwise_coo_indices_nd(
            radius, self.volume_shape, diag, upper, channel_voxel_relation,
            index_dtype)
        self.offsets = list(idx_dict.keys())
        indices = np.concatenate([idx_dict[o] for o in self.offsets], axis=1)
        self.indices = indices  # (2, nnz) in offset order
        nnz = indices.shape[1]
        self.nnz = nnz

        rows, cols = indices[0].astype(np.int64), indices[1].astype(np.int64)
        keys = rows * self.volume_numel + cols
        uniq, inv = np.unique(keys, return_inverse=True)
        self._has_duplicates = len(uniq) != nnz
        if self._has_duplicates:
            # coalesce semantics: merge duplicate pairs by a segment map
            self._segment_map = inv.astype(np.int64)
            self._out_rows = (uniq // self.volume_numel).astype(
                self.index_dtype)
            self._out_cols = (uniq % self.volume_numel).astype(
                self.index_dtype)
            self._out_nnz = len(uniq)
        else:
            order = np.lexsort((cols, rows))
            self._coo_perm = order.astype(np.int64)
            self._out_rows = indices[0][order]
            self._out_cols = indices[1][order]
            self._out_nnz = nnz
        if layout == "csr":
            counts = np.bincount(self._out_rows.astype(np.int64),
                                 minlength=self.volume_numel)
            indptr = np.zeros(self.volume_numel + 1, self.index_dtype)
            np.cumsum(counts, out=indptr[1:])
            self.crow_indices = indptr
            self.col_indices = self._out_cols
        # the output pattern, hashed once: every call's container shares it
        # (and so its index tensors on each device and its plans)
        self._patt = ((StaticArray(self._out_rows), StaticArray(
            self._out_cols)) if layout == "coo" else (StaticArray(
                self.crow_indices), StaticArray(self.col_indices)))
        self._templates = {}
        self._dev = {}

    def _map(self, device) -> torch.Tensor:
        """The output reorder (or segment map) as an int64 tensor on
        ``device`` (cached)."""
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            arr = (self._segment_map if self._has_duplicates
                   else self._coo_perm)
            t = self._dev[device] = torch.from_numpy(arr).to(device)
        return t

    def _calc_values(self, values: torch.Tensor) -> torch.Tensor:
        """``(..., N, C, *S)`` -> ``(..., nnz)`` values in offset order."""
        axis = -self.spatial_dims - 2
        lead = values.shape[:axis]
        return torch.cat([
            values.select(axis, k)[(Ellipsis,) + _trim_slices(off)].reshape(
                lead + (-1,)) for k, off in enumerate(self.offsets)], dim=-1)

    def __call__(self, values) -> Union[SparseCOO, SparseCSR]:
        if not isinstance(values, torch.Tensor):
            values = torch.as_tensor(np.asarray(values))
        full = self.spatial_dims + 2
        if values.ndim not in (full, full + 1):
            raise ValueError(
                f"values must have {full} dimensions (N, C, *spatial) or "
                f"{full + 1} dimensions (B, N, C, *spatial)")
        if tuple(values.shape[-self.spatial_dims:]) != \
                self.volume_shape[1:]:
            raise ValueError(
                f"Spatial dimensions do not match: expected "
                f"{self.volume_shape[1:]}, got "
                f"{tuple(values.shape[-self.spatial_dims:])}")
        if values.shape[-full] != len(self.offsets):
            raise ValueError(
                f"Shape of values at index {-full} "
                f"({values.shape[-full]}) must match number of offsets "
                f"({len(self.offsets)})")
        if not values.is_floating_point():
            raise ValueError("values must have a floating dtype")
        batched = values.ndim == full + 1
        flat = self._calc_values(values)
        idx = self._map(values.device)
        if self._has_duplicates:
            out = flat.new_zeros(flat.shape[:-1] + (self._out_nnz,))
            flat = out.index_add(-1, idx, flat)
        else:
            flat = flat.index_select(-1, idx)

        S = self.volume_numel
        shape = ((values.shape[0], S, S) if batched else (S, S))
        template = self._templates.get(shape)
        if template is None:
            cls = SparseCOO if self.layout == "coo" else SparseCSR
            template = self._templates[shape] = cls(
                *self._patt, torch.zeros(flat.shape, dtype=flat.dtype),
                shape)
        return template.with_data(flat)


class PairwiseVoxelEncoder(PairwiseEncoder):
    """Deprecated 3-D ``(C, H, D, W)`` wrapper of
    :class:`PairwiseEncoder`."""

    def __init__(self, radius: float, volume_shape: Tuple[int, int, int, int],
                 *args, **kwargs):
        warnings.warn("PairwiseVoxelEncoder is deprecated; use "
                      "PairwiseEncoder", DeprecationWarning, stacklevel=2)
        if len(volume_shape) != 4:
            raise ValueError("volume_shape must be (C, H, D, W)")
        super().__init__(radius, volume_shape, *args, **kwargs)
