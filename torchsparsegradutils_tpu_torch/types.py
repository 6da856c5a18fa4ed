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
* ``pattern_static=False`` (the JAX package's dynamic-pattern mode)
  keeps the indices as int32 or int64 tensors on the values' device
  instead: no numpy copy, no hash, no plan.  Such a container behaves as
  the JAX package's does under ``jax.jit``, where its indices are
  traced: every op that JAX runs on a traced pattern runs on the device
  here with no host read of the pattern (``row_sa()`` is None, so no
  plan is built), and every op that JAX refuses raises JAX's message
  (:func:`refuse_dynamic`).  It serves a user whose pattern changes at
  every step (a kNN graph, a top-k mask) and lives on the card.

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
           "is_sparse", "refuse_dynamic"]


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


def refuse_dynamic(what: str):
    """Raise the JAX package's refusal of a host pattern operation on a
    traced pattern (its ``types._concrete_numpy``), for a dynamic
    container."""
    raise ValueError(
        f"{what} requires a concrete (non-traced) sparsity pattern. "
        "Build the container outside jit (pattern-static mode, the "
        "default) or precompute the required plan before jit-tracing.")


def _dynamic(x, name: str, index_dtype, device) -> torch.Tensor:
    """Index tensor of a dynamic pattern on ``device``: int32 or int64
    (kept as given; other integer dtypes become int64), never a host
    copy of a tensor."""
    if isinstance(x, StaticArray):
        x = x.arr
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.integer):
            raise ValueError(f"{name} must have an integer dtype, got "
                             f"{x.dtype}")
        x = torch.from_numpy(np.array(x))
    if index_dtype is not None:
        x = x.to(getattr(torch, np.dtype(index_dtype).name))
    if x.dtype.is_floating_point or x.dtype.is_complex \
            or x.dtype == torch.bool:
        raise ValueError(f"{name} must have an integer dtype, got "
                         f"{str(x.dtype).removeprefix('torch.')}")
    if x.dtype not in (torch.int32, torch.int64):
        x = x.to(torch.int64)
    return x.to(device)


def _long(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int64 else t.to(torch.int64)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).removeprefix("torch."))


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
    pattern_static: bool = True

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
        mode = "static" if self.pattern_static else "dynamic"
        return (f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype}, pattern={mode}, device={self.device})")

    def rows_t(self) -> torch.Tensor:
        """Row index per entry as an int64 tensor on ``self.device``."""
        if not self.pattern_static:
            return self._cached("rows", lambda: _long(self._dyn_rows()))
        return self.row_sa().on(self.device)

    def cols_t(self) -> torch.Tensor:
        if not self.pattern_static:
            return self._cached("cols", lambda: _long(self._dyn_cols()))
        return self.col_sa().on(self.device)

    def _cached(self, key: str, make) -> torch.Tensor:
        """Device index tensor of a dynamic pattern, made once and shared
        by every ``with_data`` copy."""
        t = self._idx.get(key)
        if t is None:
            t = self._idx[key] = make()
        return t

    def rows_np(self, what: str = "this operation") -> np.ndarray:
        """Row index per entry as host numpy; a dynamic container refuses
        (:func:`refuse_dynamic`)."""
        if not self.pattern_static:
            refuse_dynamic(what)
        return self.rows()

    def cols_np(self, what: str = "this operation") -> np.ndarray:
        if not self.pattern_static:
            refuse_dynamic(what)
        return self.cols()

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
        shared by the batch or ``(batch, nnz)`` per element; int32 or
        int64 tensors on the values' device when ``pattern_static`` is
        False.
      values: ``(*batch, nnz)`` tensor, the differentiable leaf.
      shape: ``(*batch, n, m)``.
      pattern_static: False for the dynamic-pattern mode (see the
        module docstring).
    """

    def __init__(self, row, col, values, shape, *, pattern_static: bool = True,
                 index_dtype=None, device=None, _skip_checks: bool = False):
        shape = tuple(int(s) for s in shape)
        if len(shape) < 2:
            raise ValueError(f"shape must have >= 2 dims, got {shape}")
        self.values = _as_values(values, device)
        self.pattern_static = bool(pattern_static)
        if self.pattern_static:
            self.row = _static(row, "row", index_dtype)
            self.col = _static(col, "col", index_dtype)
        else:
            self.row = _dynamic(row, "row", index_dtype, self.values.device)
            self.col = _dynamic(col, "col", index_dtype, self.values.device)
        self.shape = shape
        self._idx: dict = {}
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

    def row_sa(self) -> Optional[StaticArray]:
        """The content-hashed rows, or None for a dynamic pattern."""
        return self.row if self.pattern_static else None

    def col_sa(self) -> Optional[StaticArray]:
        return self.col if self.pattern_static else None

    def rows(self) -> np.ndarray:
        """Row index per entry (host numpy), ``(*patt_batch?, nnz)``; a
        dynamic container refuses (its rows are :meth:`rows_t`)."""
        if not self.pattern_static:
            refuse_dynamic("this operation")
        return self.row.arr

    def cols(self) -> np.ndarray:
        if not self.pattern_static:
            refuse_dynamic("this operation")
        return self.col.arr

    def _dyn_rows(self) -> torch.Tensor:
        return self.row

    def _dyn_cols(self) -> torch.Tensor:
        return self.col

    def indices_batched(self) -> bool:
        return len(self.row.shape) > 1

    def index_dtype(self):
        return self.row.dtype if self.pattern_static else _np_dtype(self.row)

    def with_data(self, values) -> "SparseCOO":
        obj = object.__new__(SparseCOO)
        obj.row, obj.col, obj.shape = self.row, self.col, self.shape
        obj.pattern_static, obj._idx = self.pattern_static, self._idx
        obj.values = values
        return obj

    @classmethod
    def fromdense(cls, x, *, nnz: Optional[int] = None,
                  index_dtype=np.int32, device=None,
                  pattern_static: bool = True) -> "SparseCOO":
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
            return cls(rr, cc, vals, xt.shape, pattern_static=pattern_static)
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
        return cls(row, col, vals, xt.shape, pattern_static=pattern_static)

    def transpose(self) -> "SparseCOO":
        shape = self.batch_shape + (self.shape[-1], self.shape[-2])
        return SparseCOO(self.col, self.row, self.values, shape,
                         pattern_static=self.pattern_static,
                         _skip_checks=True)

    @property
    def T(self) -> "SparseCOO":
        return self.transpose()

    def sort_indices(self) -> "SparseCOO":
        """Copy with entries sorted row-major (row, then col); a dynamic
        pattern is sorted on its device (a stable ``torch.sort`` of the
        int64 key ``row * m + col``)."""
        if not self.pattern_static:
            from .utils.structure import sort_dynamic
            return sort_dynamic(self)
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
        if not self.pattern_static:
            from .utils.structure import coo_to_csr
            return coo_to_csr(self)
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
      indptr: ``(*patt_batch?, n+1)`` row pointers (:class:`StaticArray`,
        or an int32 or int64 tensor on the values' device when
        ``pattern_static`` is False).
      indices: ``(*patt_batch?, nnz)`` column indices.
      values: ``(*batch, nnz)`` tensor, the differentiable leaf.
      shape: ``(*batch, n, m)``.
      pattern_static: False for the dynamic-pattern mode.
    """

    def __init__(self, indptr, indices, values, shape, *,
                 pattern_static: bool = True, index_dtype=None, device=None,
                 _skip_checks: bool = False):
        shape = tuple(int(s) for s in shape)
        if len(shape) < 2:
            raise ValueError(f"shape must have >= 2 dims, got {shape}")
        self.values = _as_values(values, device)
        self.pattern_static = bool(pattern_static)
        if self.pattern_static:
            self.indptr = _static(indptr, "indptr", index_dtype)
            self.indices = _static(indices, "indices", index_dtype)
        else:
            dev = self.values.device
            self.indptr = _dynamic(indptr, "indptr", index_dtype, dev)
            self.indices = _dynamic(indices, "indices", index_dtype, dev)
        self.shape = shape
        # decompressed rows, shared by every with_data() copy
        self._rows: dict = {}
        if not _skip_checks:
            n = shape[-2]
            ip, ix = tuple(self.indptr.shape), tuple(self.indices.shape)
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

    @property
    def _idx(self) -> dict:
        return self._rows

    def row_sa(self) -> Optional[StaticArray]:
        """Decompressed row indices, content-hashed (cached); None for a
        dynamic pattern."""
        if not self.pattern_static:
            return None
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

    def col_sa(self) -> Optional[StaticArray]:
        return self.indices if self.pattern_static else None

    def rows(self) -> np.ndarray:
        if not self.pattern_static:
            refuse_dynamic("this operation")
        return self.row_sa().arr

    def cols(self) -> np.ndarray:
        if not self.pattern_static:
            refuse_dynamic("this operation")
        return self.indices.arr

    def indptr_np(self, what: str = "this operation") -> np.ndarray:
        if not self.pattern_static:
            refuse_dynamic(what)
        return self.indptr.arr

    def indptr_t(self) -> torch.Tensor:
        """Row pointers as an int64 tensor on ``self.device``."""
        if self.pattern_static:
            return self.indptr.on(self.device)
        return self._cached("indptr", lambda: _long(self.indptr))

    def _dyn_rows(self) -> torch.Tensor:
        """Rows of a dynamic pattern from ``indptr`` on its device, with
        no sync: entry e lies in the row of the last pointer <= e."""
        ip = self.indptr
        e = torch.arange(self.nnz, dtype=ip.dtype, device=ip.device)
        if ip.ndim > 1:
            e = e.expand(ip.shape[:-1] + (self.nnz,)).contiguous()
        return torch.searchsorted(ip[..., 1:].contiguous(), e, right=True)

    def _dyn_cols(self) -> torch.Tensor:
        return self.indices

    def indices_batched(self) -> bool:
        return len(self.indptr.shape) > 1

    def index_dtype(self):
        return self.indices.dtype if self.pattern_static else \
            _np_dtype(self.indices)

    def with_data(self, values) -> "SparseCSR":
        obj = object.__new__(SparseCSR)
        obj.indptr, obj.indices, obj.shape = (self.indptr, self.indices,
                                              self.shape)
        obj.pattern_static = self.pattern_static
        obj._rows = self._rows
        obj.values = values
        return obj

    @classmethod
    def fromdense(cls, x, *, nnz: Optional[int] = None,
                  index_dtype=np.int32, device=None,
                  pattern_static: bool = True) -> "SparseCSR":
        return SparseCOO.fromdense(x, nnz=nnz, index_dtype=index_dtype,
                                   device=device,
                                   pattern_static=pattern_static).tocsr()

    def tocoo(self) -> SparseCOO:
        if not self.pattern_static:
            return SparseCOO(self.rows_t().to(self.indices.dtype),
                             self.indices, self.values, self.shape,
                             pattern_static=False, _skip_checks=True)
        return SparseCOO(self.row_sa(), self.indices, self.values,
                         self.shape, _skip_checks=True)

    def tocsr(self) -> "SparseCSR":
        return self

    def transpose(self) -> "SparseCSR":
        """CSR of the transpose (host pattern work, values permuted; on
        the device for a dynamic pattern)."""
        if not self.pattern_static:
            from .utils.structure import csr_transpose
            return csr_transpose(self)
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

    def __init__(self, indptr, indices, values, shape, *,
                 pattern_static: bool = True, index_dtype=None, device=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            raise ValueError("SparseCSC supports 2-D matrices only")
        self._t = SparseCSR(indptr, indices, values, (shape[1], shape[0]),
                            pattern_static=pattern_static,
                            index_dtype=index_dtype, device=device)
        self.shape = shape

    @property
    def layout(self) -> str:
        return "csc"

    @property
    def ndim(self) -> int:
        return 2

    @property
    def indptr(self):
        return self._t.indptr

    @property
    def indices(self):
        return self._t.indices

    @property
    def pattern_static(self) -> bool:
        return self._t.pattern_static

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
        mode = "static" if self.pattern_static else "dynamic"
        return (f"SparseCSC(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype}, pattern={mode}, device={self.device})")

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
