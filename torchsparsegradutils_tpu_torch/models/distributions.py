"""Sparse-factor multivariate normal distributions.

Port of ``torchsparsegradutils_tpu/models/distributions.py``:

* :class:`SparseMultivariateNormal`: a mean and a sparse lower-triangular
  factor of either the covariance (``scale_tril``) or the precision
  (``precision_tril``), each in Cholesky form (LLᵀ, the diagonal stored
  in the factor) or modified-Cholesky form (LDLᵀ, a separate positive
  ``diagonal``, the factor strictly lower with an implied unit
  diagonal); one optional batch dim.  Reparameterised samples:

    - cov-LLᵀ:   ``x = μ + L ε``              (``sparse_mm``)
    - cov-LDLᵀ:  ``x = μ + (I + L)(√D ε)``    (``sparse_mm``)
    - prec-LLᵀ:  ``x = μ + L⁻ᵀ ε``            (transposed triangular solve)
    - prec-LDLᵀ: ``x = μ + (I + L)⁻ᵀ(ε/√D)``  (unit transposed solve)

  The samples ride the right-hand side's column axis of one sparse op,
  so one SpMM or one solve serves the whole sample batch: on the card a
  banded factor (the pairwise encoder's) runs the DIA SpMM
  (``csrc/dia_spmm.cu``) or the banded triangular solve
  (``csrc/tri_dia.cu``).  ``log_prob`` is exact and sparse in all four
  forms: the quadratic form by a triangular solve (covariance) or
  ``sparse_mm(L.T, ·)`` (precision), the log-determinant from ``D`` or
  the factor's diagonal.

* :class:`SparseMultivariateNormalNative`: the minimal unbatched cov-LLᵀ
  variant on ``sparse_mm``, with densifying ``covariance_matrix``,
  ``variance`` and ``log_prob`` (each warns).

PyTorch idiom in place of JAX's: ``rsample(sample_shape, generator)``
draws ε with ``torch.randn`` from an optional ``torch.Generator`` on
``loc``'s device, where the JAX package takes a PRNG key first.

Example:
    >>> import torch
    >>> from torchsparsegradutils_tpu_torch.models import (
    ...     SparseMultivariateNormal)
    >>> from torchsparsegradutils_tpu_torch.utils import rand_sparse_tri
    >>> L = rand_sparse_tri((8, 8), 20, device="cpu")
    >>> d = SparseMultivariateNormal(torch.zeros(8), scale_tril=L)
    >>> s = d.rsample((5,), generator=torch.Generator().manual_seed(1))
    >>> s.shape, d.log_prob(s).shape
    (torch.Size([5, 8]), torch.Size([5]))
"""

from __future__ import annotations

import math
import warnings
from typing import Tuple

import numpy as np
import torch

from ..ops.spmm import sparse_mm
from ..ops.triangular_solve import sparse_triangular_solve
from ..types import StaticArray, is_sparse

__all__ = ["SparseMultivariateNormal", "SparseMultivariateNormalNative"]


def _check_tril(factor, strict: bool, what: str):
    """Host-side triangularity check of the factor's pattern; a dynamic
    pattern is trusted, as in the JAX package (checking it would read it
    back)."""
    if not factor.pattern_static:
        return
    r, c = factor.rows(), factor.cols()
    if strict:
        if not (c < r).all():
            raise ValueError(
                f"{what}: LDLᵀ factor must be strictly lower-triangular "
                "(no diagonal entries; the diagonal is passed separately)")
    elif not (c <= r).all():
        raise ValueError(f"{what}: factor must be lower-triangular")


def _diag_positions(factor) -> np.ndarray:
    """Indices into the values of the n diagonal entries, in row order
    (host numpy); a dynamic pattern refuses, as in the JAX package."""
    r, c = factor.rows_np("log_prob"), factor.cols_np("log_prob")
    if r.ndim != 1:
        raise ValueError("per-element batched patterns are not supported "
                         "for log_prob; use a shared pattern")
    sel = np.nonzero(r == c)[0]
    n = factor.shape[-1]
    if len(sel) != n:
        raise ValueError(
            f"LLᵀ factor must store all {n} diagonal entries (found "
            f"{len(sel)}); missing diagonal entries make the factor "
            "singular")
    return sel[np.argsort(r[sel])]


def _as_tensor(x, like) -> torch.Tensor:
    """A tensor stays as it is; anything else goes to ``like``'s dtype
    and device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=like.dtype,
                           device=like.device)


def _sample_shape(sample_shape) -> Tuple[int, ...]:
    if isinstance(sample_shape, int):
        return (sample_shape,)
    return tuple(sample_shape)


class SparseMultivariateNormal:
    """Multivariate normal with a sparse Cholesky or LDLᵀ factor.

    Args:
      loc: mean, ``(n,)`` or ``(B, n)``.
      diagonal: optional ``(n,)`` or ``(B, n)`` diagonal of D; passing it
        selects the LDLᵀ parameterisation (factor strictly lower, unit
        diagonal implied).  Must be positive.
      scale_tril: sparse lower-triangular covariance factor (exclusive
        with ``precision_tril``), shape ``(n, n)`` or ``(B, n, n)``.
      precision_tril: sparse lower-triangular precision factor.

    Gradients of samples and log densities flow to ``loc``, ``diagonal``
    and the factor's ``values``.
    """

    def __init__(self, loc, diagonal=None, scale_tril=None,
                 precision_tril=None):
        if (scale_tril is None) == (precision_tril is None):
            raise ValueError(
                "exactly one of scale_tril or precision_tril must be given")
        factor = scale_tril if scale_tril is not None else precision_tril
        if not is_sparse(factor):
            raise TypeError("the triangular factor must be a SparseCOO or "
                            "SparseCSR container")
        if factor.ndim not in (2, 3):
            raise ValueError("the factor must be (n, n) or batched "
                             "(B, n, n)")
        if factor.shape[-1] != factor.shape[-2]:
            raise ValueError("the factor must be square")
        loc = _as_tensor(loc, factor.values)
        n = factor.shape[-1]
        if loc.shape[-1] != n:
            raise ValueError(f"loc event dim {loc.shape[-1]} != factor dim "
                             f"{n}")
        if factor.ndim == 3:
            if loc.ndim == 1:
                loc = loc.expand(factor.shape[0], n)
            if loc.shape[0] != factor.shape[0]:
                raise ValueError("loc batch dim does not match the factor")
        elif loc.ndim not in (1, 2):
            raise ValueError("loc must be (n,) or (B, n)")
        self._is_cov = scale_tril is not None
        self._is_ldlt = diagonal is not None
        if self._is_ldlt:
            diagonal = _as_tensor(diagonal, factor.values)
            if diagonal.shape != loc.shape and tuple(diagonal.shape) != (n,):
                raise ValueError(
                    f"diagonal shape {tuple(diagonal.shape)} incompatible "
                    f"with loc shape {tuple(loc.shape)}")
        _check_tril(factor, strict=self._is_ldlt,
                    what="SparseMultivariateNormal")
        self.loc = loc
        self.diagonal = diagonal
        self.factor = factor

    # ------------------------------------------------------------ properties
    @property
    def is_ldlt_parameterization(self) -> bool:
        return self._is_ldlt

    @property
    def is_covariance_parameterization(self) -> bool:
        return self._is_cov

    @property
    def scale_tril(self):
        return self.factor if self._is_cov else None

    @property
    def precision_tril(self):
        return None if self._is_cov else self.factor

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return (self.factor.shape[-1],)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        if self.factor.ndim == 3:
            return self.factor.shape[:-2]
        return tuple(self.loc.shape[:-1])

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    # -------------------------------------------------------------- sampling
    def rsample(self, sample_shape=(), generator=None) -> torch.Tensor:
        """Reparameterised sample of shape ``sample_shape + batch + (n,)``.

        ε is drawn by ``torch.randn`` on ``loc``'s device from
        ``generator`` (a ``torch.Generator`` on that device; the global
        one if None).
        """
        sample_shape = _sample_shape(sample_shape)
        n = self.factor.shape[-1]
        bshape = tuple(self.loc.shape[:-1])
        S = math.prod(sample_shape)
        eps = torch.randn((S,) + bshape + (n,), generator=generator,
                          dtype=self.loc.dtype, device=self.loc.device)
        out = self.loc + self._transform_eps(eps)
        return out.reshape(sample_shape + bshape + (n,))

    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        """:meth:`rsample`'s draw, detached."""
        with torch.no_grad():
            return self.rsample(sample_shape, generator)

    def _transform_eps(self, eps: torch.Tensor) -> torch.Tensor:
        """eps ``(S, *B, n)`` -> centred samples of the same shape,
        carried on the right-hand side's column axis of one sparse op."""
        L = self.factor
        batched = eps.ndim == 3
        E = eps.movedim(0, -1)                       # (*B, n, S)
        if self._is_ldlt:
            sqrtD_col = torch.sqrt(self.diagonal)[..., :, None]
        if self._is_cov:
            if self._is_ldlt:
                eta = sqrtD_col * E
                X = sparse_mm(L, eta) + eta
            else:
                X = sparse_mm(L, E)
        elif self._is_ldlt:
            X = sparse_triangular_solve(L, E / sqrtD_col, upper=False,
                                        unitriangular=True, transpose=True)
        else:
            X = sparse_triangular_solve(L, E, upper=False, transpose=True)
        return X.movedim(-1, 0) if batched else X.T

    # -------------------------------------------------------------- log_prob
    def log_prob(self, value) -> torch.Tensor:
        """Exact log density, computed sparsely (nothing densified).

        value: ``(..., n)``, broadcast over leading sample dims; a batched
        distribution expects ``(..., B, n)``.
        """
        n = self.factor.shape[-1]
        loc = self.loc
        delta = _as_tensor(value, loc) - loc
        batched = loc.ndim == 2
        lead = tuple(delta.shape[:-2 if batched else -1])
        S = math.prod(lead)
        if batched:
            E = delta.reshape(S, loc.shape[0], n).movedim(0, -1)  # (B, n, S)
        else:
            E = delta.reshape(S, n).T                              # (n, S)
        L = self.factor
        if self._is_cov:
            if self._is_ldlt:
                z = sparse_triangular_solve(L, E, upper=False,
                                            unitriangular=True)
                quad = (z * z / self.diagonal[..., :, None]).sum(-2)
                logdet_sigma = torch.log(self.diagonal).sum(-1)
            else:
                z = sparse_triangular_solve(L, E, upper=False)
                quad = (z * z).sum(-2)
                logdet_sigma = 2.0 * torch.log(
                    self._factor_diag().abs()).sum(-1)
        else:
            if self._is_ldlt:
                y = E + sparse_mm(L.T, E)            # (I + L)ᵀ δ
                quad = (self.diagonal[..., :, None] * y * y).sum(-2)
                logdet_sigma = -torch.log(self.diagonal).sum(-1)
            else:
                y = sparse_mm(L.T, E)
                quad = (y * y).sum(-2)
                logdet_sigma = -2.0 * torch.log(
                    self._factor_diag().abs()).sum(-1)
        if batched:
            quad = quad.movedim(-1, 0)               # (S, B)
        lp = -0.5 * (quad + n * math.log(2.0 * math.pi)) - 0.5 * logdet_sigma
        return lp.reshape(lead + ((loc.shape[0],) if batched else ()))

    def _factor_diag(self) -> torch.Tensor:
        """The factor's diagonal values, ``(*B, n)``: host positions, one
        gather on the values' device."""
        sel = StaticArray(_diag_positions(self.factor))
        vals = self.factor.values
        return vals.index_select(-1, sel.on(vals.device))


class SparseMultivariateNormalNative:
    """Minimal cov-LLᵀ variant on ``sparse_mm``: unbatched, no LDLᵀ, with
    densifying covariance and variance helpers."""

    def __init__(self, loc, scale_tril):
        if not is_sparse(scale_tril):
            raise TypeError("scale_tril must be a sparse container")
        if scale_tril.ndim != 2:
            raise ValueError("SparseMultivariateNormalNative is unbatched")
        _check_tril(scale_tril, strict=False, what="scale_tril")
        self.loc = _as_tensor(loc, scale_tril.values)
        self.scale_tril = scale_tril

    def rsample(self, sample_shape=(), generator=None) -> torch.Tensor:
        sample_shape = _sample_shape(sample_shape)
        n = self.scale_tril.shape[-1]
        eps = torch.randn((math.prod(sample_shape), n), generator=generator,
                          dtype=self.loc.dtype, device=self.loc.device)
        x = sparse_mm(self.scale_tril, eps.T).T + self.loc
        return x.reshape(sample_shape + (n,))

    def covariance_matrix(self) -> torch.Tensor:
        warnings.warn("covariance_matrix densifies the sparse factor",
                      UserWarning, stacklevel=2)
        Ld = self.scale_tril.todense()
        return Ld @ Ld.T

    def variance(self) -> torch.Tensor:
        warnings.warn("variance densifies the sparse factor", UserWarning,
                      stacklevel=2)
        Ld = self.scale_tril.todense()
        return (Ld * Ld).sum(-1)

    def log_prob(self, value) -> torch.Tensor:
        warnings.warn("log_prob densifies the sparse factor", UserWarning,
                      stacklevel=2)
        cov = self.covariance_matrix()
        n = cov.shape[-1]
        delta = _as_tensor(value, self.loc) - self.loc
        sol = torch.linalg.solve(cov, delta[..., None])[..., 0]
        quad = (delta * sol).sum(-1)
        _, logdet = torch.linalg.slogdet(cov)
        return -0.5 * (quad + n * math.log(2 * math.pi) + logdet)
