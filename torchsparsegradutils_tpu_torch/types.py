"""Sparse containers of the PyTorch port.

Same design as the JAX package's containers (``torchsparsegradutils_tpu/
types.py``), in PyTorch idiom:

* The sparsity *pattern* is host numpy, wrapped in :class:`StaticArray`,
  which hashes by content.  Plans built from a pattern (the DIA plan of
  ``kernels/dia.py``) are cached on that hash, so two containers with the
  same pattern share one plan.
* ``values`` is a torch tensor and the only differentiable leaf.
  Gradients of every op land on it, with shape ``(*batch, nnz)``: nothing
  of the dense ``(n, m)`` shape is ever built by an op.
* Index tensors on a device are made once per pattern and device, and
  cached on the :class:`StaticArray` (``StaticArray.on``).

Index-dtype policy (``docs/ARCHITECTURE.md``, "Index-dtype and batching
policy"): int32 and int64 patterns are both accepted and kept as given.
Batching: a batched container has values ``(*batch, nnz)`` with one nnz
shared by every element, and either one shared ``(nnz,)`` pattern or one
pattern per element, ``(batch, nnz)``.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["SparseCOO", "SparseCSR", "SparseCSC", "StaticArray",
           "is_sparse"]


class StaticArray:
    """Read-only numpy index array, hashed and compared by content.

    ``on(device)`` returns the same indices as an int64 tensor on
    ``device``, made once and cached.
    """

    __slots__ = ("arr", "_digest", "_hash", "_dev")

    def __init__(self, arr):
        arr = np.asarray(arr)
        arr.setflags(write=False)
        self.arr = arr
        h = hashlib.blake2b(digest_size=16)
        h.update(str((arr.shape, arr.dtype.str)).encode())
        h.update(arr.tobytes())
        self._digest = h.digest()
        self._hash = hash(self._digest)
        self._dev = {}

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: object) -> bool:
        return isinstance(other, StaticArray) and self._digest == other._digest

    def __repr__(self) -> str:
        return f"StaticArray(shape={self.arr.shape}, dtype={self.arr.dtype})"

    @property
    def shape(self):
        return self.arr.shape

    @property
    def dtype(self):
        return self.arr.dtype

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = torch.from_numpy(np.array(self.arr, dtype=np.int64)).to(device)
            self._dev[device] = t
        return t


def _static(x, name: str, index_dtype=None) -> StaticArray:
    if isinstance(x, StaticArray):
        if index_dtype is None or x.dtype == np.dtype(index_dtype):
            return x
        x = x.arr
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if index_dtype is not None:
        x = x.astype(np.dtype(index_dtype), copy=False)
    if not np.issubdtype(x.dtype, np.integer):
        raise ValueError(f"{name} must have an integer dtype, got {x.dtype}")
    return StaticArray(x)


def _as_values(values, device) -> torch.Tensor:
    """Values as a tensor: a tensor stays where it is unless ``device`` is
    given; anything else goes to ``device`` (the card by default)."""
    if isinstance(values, torch.Tensor):
        return values if device is None else values.to(device)
    return torch.as_tensor(np.array(values),
                           device="cuda" if device is None else device)


def is_sparse(x) -> bool:
    return isinstance(x, (SparseCOO, SparseCSR))


class _SparseBase:
    """Shared behaviour of SparseCOO and SparseCSR."""

    shape: Tuple[int, ...]
    values: torch.Tensor

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> int:
        return int(self.values.shape[-1])

    @property
    def n_batch(self) -> int:
        return self.ndim - 2

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return self.shape[:-2]

    @property
    def mat_shape(self) -> Tuple[int, int]:
        return self.shape[-2:]

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype}, device={self.device})")

    def rows_t(self) -> torch.Tensor:
        """Row index per entry as an int64 tensor on ``self.device``."""
        return self.row_sa().on(self.device)

    def cols_t(self) -> torch.Tensor:
        return self.col_sa().on(self.device)

    def astype(self, dtype):
        return self.with_data(self.values.to(dtype))

    def todense(self) -> torch.Tensor:
        """Dense copy (differentiable in ``values``); for tests and small
        matrices only."""
        n, m = self.mat_shape
        r, c = self.rows_t(), self.cols_t()
        if self.n_batch == 0:
            out = torch.zeros((n, m), dtype=self.dtype, device=self.device)
            return out.index_put((r, c), self.values, accumulate=True)
        b = int(np.prod(self.batch_shape))
        vals = self.values.reshape(b, self.nnz)
        r = r.reshape(-1, self.nnz).expand(b, self.nnz)
        c = c.reshape(-1, self.nnz).expand(b, self.nnz)
        bi = torch.arange(b, device=self.device)[:, None].expand(b, self.nnz)
        out = torch.zeros((b, n, m), dtype=self.dtype, device=self.device)
        out = out.index_put((bi, r, c), vals, accumulate=True)
        return out.reshape(self.batch_shape + (n, m))


class SparseCOO(_SparseBase):
    """Coordinate-format sparse matrix, optionally batched.

    Attributes:
      row, col: :class:`StaticArray` indices, ``(nnz,)`` for a pattern
        shared by the batch or ``(batch, nnz)`` per element.
      values: ``(*batch, nnz)`` tensor, the differentiable leaf.
      shape: ``(*batch, n, m)``.
    """

    def __init__(self, row, col, values, shape, *, index_dtype=None,
                 device=None, _skip_checks: bool = False):
        shape = tuple(int(s) for s in shape)
        if len(shape) < 2:
            raise ValueError(f"shape must have >= 2 dims, got {shape}")
        self.row = _static(row, "row", index_dtype)
        self.col = _static(col, "col", index_dtype)
        self.values = _as_values(values, device)
        self.shape = shape
        if not _skip_checks:
            nnz = self.values.shape[-1]
            for name, idx in (("row", self.row), ("col", self.col)):
                ish = idx.shape
                if ish[-1] != nnz:
                    raise ValueError(
                        f"{name} has {ish[-1]} entries but data has nnz={nnz}")
                if len(ish) not in (1, len(shape) - 1):
                    raise ValueError(
                        f"{name} must be 1-D or have one leading batch dim "
                        f"per batch axis; got shape {ish} for shape {shape}")
            if tuple(self.values.shape[:-1]) != shape[:-2]:
                raise ValueError(
                    f"data batch dims {tuple(self.values.shape[:-1])} do not "
                    f"match shape batch dims {shape[:-2]}")

    @property
    def layout(self) -> str:
        return "coo"

    def row_sa(self) -> StaticArray:
        return self.row

    def col_sa(self) -> StaticArray:
        return self.col

    def rows(self) -> np.ndarray:
        """Row index per entry (host numpy), ``(*patt_batch?, nnz)``."""
        return self.row.arr

    def cols(self) -> np.ndarray:
        return self.col.arr

    def indices_batched(self) -> bool:
        return self.row.arr.ndim > 1

    def index_dtype(self):
        return self.row.dtype

    def with_data(self, values) -> "SparseCOO":
        obj = object.__new__(SparseCOO)
        obj.row, obj.col, obj.shape = self.row, self.col, self.shape
        obj.values = values
        return obj

    @classmethod
    def fromdense(cls, x, *, nnz: Optional[int] = None,
                  index_dtype=np.int32, device=None) -> "SparseCOO":
        """Build from a dense tensor or array; the pattern is its nonzeros.

        With ``nnz`` given, pads with zero-valued entries at (0, 0), or
        raises if there are more nonzeros.  A batched input needs equal
        nnz in every element, or ``nnz``.  The values of a tensor input
        are indexed out of it, so they stay differentiable.
        """
        xt = x if isinstance(x, torch.Tensor) else _as_values(x, device)
        if device is not None:
            xt = xt.to(device)
        if xt.ndim < 2:
            raise ValueError("fromdense requires ndim >= 2")
        xn = xt.detach().cpu().numpy() if xt.dtype != torch.bfloat16 else \
            xt.detach().float().cpu().numpy()
        idt = np.dtype(index_dtype)
        if xt.ndim == 2:
            r, c = np.nonzero(xn)
            k = len(r)
            target = nnz if nnz is not None else k
            if k > target:
                raise ValueError(f"array has {k} nonzeros > nnz={target}")
            pad = target - k
            rt = torch.from_numpy(r).to(xt.device)
            ct = torch.from_numpy(c).to(xt.device)
            vals = torch.cat([xt[rt, ct], xt.new_zeros(pad)])
            rr = np.concatenate([r, np.zeros(pad, r.dtype)]).astype(idt)
            cc = np.concatenate([c, np.zeros(pad, c.dtype)]).astype(idt)
            return cls(rr, cc, vals, xt.shape)
        bshape = tuple(xt.shape[:-2])
        flat = xt.reshape((-1,) + tuple(xt.shape[-2:]))
        if nnz is None:
            counts = {int((xm != 0).sum()) for xm in
                      xn.reshape((-1,) + xn.shape[-2:])}
            if len(counts) != 1:
                raise ValueError(
                    f"batched fromdense requires equal nnz per element "
                    f"(got {sorted(counts)}); pass nnz= to pad")
            nnz = counts.pop()
        parts = [cls.fromdense(xm, nnz=nnz, index_dtype=idt) for xm in flat]
        row = np.stack([p.rows() for p in parts])
        col = np.stack([p.cols() for p in parts])
        vals = torch.stack([p.values for p in parts]).reshape(bshape + (nnz,))
        if (row == row[0]).all() and (col == col[0]).all():
            row, col = row[0], col[0]
        elif len(bshape) != 1:
            raise ValueError("batched fromdense with per-element patterns "
                             "supports exactly one batch dim")
        return cls(row, col, vals, xt.shape)

    def transpose(self) -> "SparseCOO":
        shape = self.batch_shape + (self.shape[-1], self.shape[-2])
        return SparseCOO(self.col, self.row, self.values, shape,
                         _skip_checks=True)

    @property
    def T(self) -> "SparseCOO":
        return self.transpose()

    def sort_indices(self) -> "SparseCOO":
        """Copy with entries sorted row-major (row, then col)."""
        r, c = self.rows(), self.cols()
        if r.ndim == 1:
            perm = np.lexsort((c, r))
            p_t = torch.from_numpy(perm).to(self.device)
            return SparseCOO(r[perm], c[perm],
                             self.values.index_select(-1, p_t), self.shape)
        perms = np.stack([np.lexsort((cc, rr)) for rr, cc in
                          zip(r.reshape(-1, self.nnz),
                              c.reshape(-1, self.nnz))]).reshape(r.shape)
        p_t = torch.from_numpy(perms).to(self.device)
        return SparseCOO(np.take_along_axis(r, perms, -1),
                         np.take_along_axis(c, perms, -1),
                         torch.take_along_dim(self.values, p_t, -1),
                         self.shape)

    def tocsr(self) -> "SparseCSR":
        """COO -> CSR: entries sorted row-major, rows compressed."""
        s = self.sort_indices()
        r, c = s.rows(), s.cols()
        n = self.shape[-2]
        flat = r.reshape(-1, self.nnz)
        indptr = np.stack([np.concatenate(
            [[0], np.cumsum(np.bincount(rr, minlength=n))]) for rr in flat])
        indptr = indptr.astype(r.dtype).reshape(r.shape[:-1] + (n + 1,))
        return SparseCSR(indptr, c, s.values, self.shape)

    def tocoo(self) -> "SparseCOO":
        return self


class SparseCSR(_SparseBase):
    """Compressed-sparse-row matrix, optionally batched.

    Attributes:
      indptr: ``(*patt_batch?, n+1)`` row pointers (:class:`StaticArray`).
      indices: ``(*patt_batch?, nnz)`` column indices.
      values: ``(*batch, nnz)`` tensor, the differentiable leaf.
      shape: ``(*batch, n, m)``.
    """

    def __init__(self, indptr, indices, values, shape, *, index_dtype=None,
                 device=None, _skip_checks: bool = False):
        shape = tuple(int(s) for s in shape)
        if len(shape) < 2:
            raise ValueError(f"shape must have >= 2 dims, got {shape}")
        self.indptr = _static(indptr, "indptr", index_dtype)
        self.indices = _static(indices, "indices", index_dtype)
        self.values = _as_values(values, device)
        self.shape = shape
        # decompressed rows, shared by every with_data() copy
        self._rows: dict = {}
        if not _skip_checks:
            n = shape[-2]
            ip, ix = self.indptr.shape, self.indices.shape
            if ip[-1] != n + 1:
                raise ValueError(f"indptr last dim {ip[-1]} != n+1 = {n + 1}")
            if ix[-1] != self.values.shape[-1]:
                raise ValueError(
                    f"indices nnz {ix[-1]} != data nnz "
                    f"{self.values.shape[-1]}")
            if tuple(self.values.shape[:-1]) != shape[:-2]:
                raise ValueError(
                    f"data batch dims {tuple(self.values.shape[:-1])} do not "
                    f"match shape batch dims {shape[:-2]}")

    @property
    def layout(self) -> str:
        return "csr"

    def row_sa(self) -> StaticArray:
        """Decompressed row indices, content-hashed (cached)."""
        sa = self._rows.get("sa")
        if sa is None:
            ip = self.indptr.arr
            n = self.shape[-2]
            ar = np.arange(n, dtype=ip.dtype)
            if ip.ndim == 1:
                rows = np.repeat(ar, np.diff(ip))
            else:
                rows = np.stack([np.repeat(ar, np.diff(p)) for p in
                                 ip.reshape(-1, ip.shape[-1])]
                                ).reshape(ip.shape[:-1] + (self.nnz,))
            sa = self._rows["sa"] = StaticArray(rows)
        return sa

    def col_sa(self) -> StaticArray:
        return self.indices

    def rows(self) -> np.ndarray:
        return self.row_sa().arr

    def cols(self) -> np.ndarray:
        return self.indices.arr

    def indptr_np(self) -> np.ndarray:
        return self.indptr.arr

    def indices_batched(self) -> bool:
        return self.indptr.arr.ndim > 1

    def index_dtype(self):
        return self.indices.dtype

    def with_data(self, values) -> "SparseCSR":
        obj = object.__new__(SparseCSR)
        obj.indptr, obj.indices, obj.shape = (self.indptr, self.indices,
                                              self.shape)
        obj._rows = self._rows
        obj.values = values
        return obj

    @classmethod
    def fromdense(cls, x, *, nnz: Optional[int] = None,
                  index_dtype=np.int32, device=None) -> "SparseCSR":
        return SparseCOO.fromdense(x, nnz=nnz, index_dtype=index_dtype,
                                   device=device).tocsr()

    def tocoo(self) -> SparseCOO:
        return SparseCOO(self.row_sa(), self.indices, self.values,
                         self.shape, _skip_checks=True)

    def tocsr(self) -> "SparseCSR":
        return self

    def transpose(self) -> "SparseCSR":
        """CSR of the transpose (host pattern work, values permuted)."""
        return self.tocoo().transpose().tocsr()

    @property
    def T(self) -> "SparseCSR":
        return self.transpose()


class SparseCSC:
    """Compressed-sparse-column matrix (2-D), as the JAX package's
    ``SparseCSC``: stored as the CSR of its transpose, with the shape
    swapped back at the boundary.  ``sparse_logsumexp`` and
    ``sparse_bidir_logsumexp`` take it; the other ops take its
    :meth:`transpose_csr`.

    Attributes:
      indptr: ``(m+1,)`` column pointers.
      indices: ``(nnz,)`` row indices.
      values: ``(nnz,)`` tensor in column-major order, the
        differentiable leaf.
      shape: ``(n, m)``.
    """

    def __init__(self, indptr, indices, values, shape, *, index_dtype=None,
                 device=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            raise ValueError("SparseCSC supports 2-D matrices only")
        self._t = SparseCSR(indptr, indices, values, (shape[1], shape[0]),
                            index_dtype=index_dtype, device=device)
        self.shape = shape

    @property
    def layout(self) -> str:
        return "csc"

    @property
    def ndim(self) -> int:
        return 2

    @property
    def indptr(self) -> StaticArray:
        return self._t.indptr

    @property
    def indices(self) -> StaticArray:
        return self._t.indices

    @property
    def values(self) -> torch.Tensor:
        return self._t.values

    data = values

    @property
    def dtype(self) -> torch.dtype:
        return self._t.dtype

    @property
    def device(self) -> torch.device:
        return self._t.device

    @property
    def nnz(self) -> int:
        return self._t.nnz

    def __repr__(self) -> str:
        return (f"SparseCSC(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype}, device={self.device})")

    def transpose_csr(self) -> SparseCSR:
        """The transpose as a CSR container (no copy)."""
        return self._t

    def with_data(self, values) -> "SparseCSC":
        obj = object.__new__(SparseCSC)
        obj._t = self._t.with_data(values)
        obj.shape = self.shape
        return obj

    def todense(self) -> torch.Tensor:
        return self._t.todense().T
