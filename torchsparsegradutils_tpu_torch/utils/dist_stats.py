"""Statistical checks of samples: Hotelling T² (mean) and Nagao
(covariance) confidence-region tests.

Port of ``torchsparsegradutils_tpu/utils/dist_stats.py`` on torch
tensors, computing in float64 on the inputs' device; the critical values
come from ``scipy.stats`` (``f``, ``chi2``), as there, imported at
the first call.

* :func:`mean_hotelling_t2_test`: ``T² = n (x̄−μ₀)ᵀ Σ̂⁻¹ (x̄−μ₀)``,
  accepted iff ``T² ≤ p(n−1)/(n−p) · F_{p,n−p;level}``.
* :func:`cov_nagao_test`: whiten by the Cholesky factor of the reference
  covariance, ``T_N = (n/2)‖W − I‖²_F``, accepted iff
  ``T_N ≤ χ²_{p(p+1)/2;level}``.

Inputs may be unbatched ``(p,)`` / ``(p, p)`` or batched ``(B, p)`` /
``(B, p, p)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["mean_hotelling_t2_test", "cov_nagao_test", "sample_mean_cov"]


def _f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64)
    return torch.from_numpy(np.asarray(x, np.float64))


def _ensure_batched(x, want_ndim: int):
    x = _f64(x)
    if x.ndim == want_ndim - 1:
        return x[None], True
    if x.ndim == want_ndim:
        return x, False
    raise ValueError(f"expected {want_ndim - 1}-D or {want_ndim}-D input, "
                     f"got {x.ndim}-D")


def sample_mean_cov(samples) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbiased sample mean and covariance over axis 0, in float64:
    samples ``(n, ..., p)`` -> ``((..., p), (..., p, p))``."""
    samples = _f64(samples)
    n = samples.shape[0]
    mean = samples.mean(0)
    centered = samples - mean
    cov = torch.einsum("n...i,n...j->...ij", centered, centered) / (n - 1)
    return mean, cov


def mean_hotelling_t2_test(sample_mean, true_mean, sample_cov, n: int,
                           confidence_level: float = 0.95):
    """One-sample Hotelling T² confidence-region test of the mean.

    Args:
      sample_mean, true_mean: ``(p,)`` or ``(B, p)``.
      sample_cov: ``(p, p)`` or ``(B, p, p)``.
      n: number of samples behind ``sample_mean`` and ``sample_cov``.

    Returns:
      ``(accepted, t2_statistic, threshold)``: a boolean mask ``(B,)``,
      the statistic ``(B,)`` (scalars when unbatched) and the critical
      value, a float.
    """
    sm, squeezed = _ensure_batched(sample_mean, 2)
    tm, _ = _ensure_batched(true_mean, 2)
    sc, _ = _ensure_batched(sample_cov, 3)
    B, p = sm.shape
    if n <= p:
        raise ValueError(f"Hotelling T² requires n > p (got n={n}, p={p})")
    diff = sm - tm.to(sm.device)
    sol = torch.linalg.solve(sc.to(sm.device), diff[..., None])[..., 0]
    t2 = n * (diff * sol).sum(-1)
    from scipy.stats import f as _f
    f_crit = float(_f.ppf(confidence_level, dfn=p, dfd=n - p))
    threshold = (p * (n - 1) / (n - p)) * f_crit
    accepted = t2 <= threshold
    if squeezed:
        accepted, t2 = accepted[0], t2[0]
    return accepted, t2, threshold


def cov_nagao_test(emp_cov, ref_cov, n: int,
                   confidence_level: float = 0.95):
    """Nagao (1973) one-sample confidence-region test of the covariance.

    Args:
      emp_cov, ref_cov: ``(p, p)`` or ``(B, p, p)``.
      n: number of samples behind ``emp_cov``.

    Returns:
      ``(accepted, t_n_statistic, threshold)``.
    """
    ec, squeezed = _ensure_batched(emp_cov, 3)
    rc, _ = _ensure_batched(ref_cov, 3)
    _, p, _ = ec.shape
    invL = torch.linalg.inv(torch.linalg.cholesky(rc.to(ec.device)))
    W = invL @ ec @ invL.mT
    diff = W - torch.eye(p, dtype=ec.dtype, device=ec.device)
    t_n = (n / 2.0) * (diff * diff).sum((-2, -1))
    from scipy.stats import chi2 as _chi2
    threshold = float(_chi2.ppf(confidence_level, df=0.5 * p * (p + 1)))
    accepted = t_n <= threshold
    if squeezed:
        accepted, t_n = accepted[0], t_n[0]
    return accepted, t_n, threshold
