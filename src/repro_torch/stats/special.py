"""p-value machinery in PyTorch: chi-square, normal, Poisson,
Kolmogorov (``repro/stats/special.py``).

Statistics are float32, as in the reference; each distribution function
is evaluated in float64 and its p-value rounded to float32. The
reference evaluates them in float32, where ``x^a e^-x / Gamma(a)``
carries a rounding error of about ``eps32 * (a |ln x| + x + ln Gamma(a))``
relative (about 1e-3 for serial2d's 4095 degrees of freedom); the
port's p is the exact value of the same statistic, and the two agree
within that bound (``tests/test_torch_stats.py``).
"""
from __future__ import annotations

import math

import torch


def _f64(x) -> torch.Tensor:
    return x.to(torch.float64)


def chi2_sf(x: torch.Tensor, k) -> torch.Tensor:
    """P[Chi2_k >= x] (regularized upper incomplete gamma)."""
    xd = _f64(x)
    return torch.special.gammaincc(torch.full_like(xd, k / 2.0),
                                   xd / 2.0).to(x.dtype)


def normal_p_two_sided(z: torch.Tensor) -> torch.Tensor:
    """2 P[N(0,1) >= |z|]."""
    return (2.0 * torch.special.ndtr(-torch.abs(_f64(z)))).to(z.dtype)


def poisson_sf(k: torch.Tensor, lam) -> torch.Tensor:
    """P[Poisson(lam) >= k] = gammainc(k, lam) (regularized lower)."""
    kd = _f64(k)
    p = torch.special.gammainc(torch.clamp(kd, min=1e-9),
                               torch.full_like(kd, lam))
    return torch.where(kd <= 0, torch.ones_like(p), p)


def poisson_midp_upper(k: torch.Tensor, lam) -> torch.Tensor:
    """Mid-p upper tail: P[X > k] + 0.5 P[X = k], clipped to [1e-300, 1]
    (the reference's clip; its lower end is 0 in float32)."""
    p_ge = poisson_sf(k, lam)
    p_ge1 = poisson_sf(k + 1.0, lam)
    p = torch.clamp(p_ge - 0.5 * (p_ge - p_ge1), 1e-300, 1.0)
    return p.to(k.dtype)


def kolmogorov_sf(lam: torch.Tensor) -> torch.Tensor:
    """Q(lam) = 2 sum_{j>=1} (-1)^{j-1} exp(-2 j^2 lam^2), 100 terms."""
    j = torch.arange(1, 101, dtype=torch.float64, device=lam.device)
    terms = (torch.pow(-1.0, j - 1)
             * torch.exp(-2.0 * j ** 2 * _f64(lam) ** 2))
    return torch.clamp(2.0 * torch.sum(terms), 0.0, 1.0).to(lam.dtype)


def ks_pvalue(sorted_u: torch.Tensor) -> torch.Tensor:
    """One-sample KS against U(0,1). sorted_u: ascending float32[n]."""
    n = sorted_u.shape[0]
    i = torch.arange(1, n + 1, dtype=torch.float32, device=sorted_u.device)
    d_plus = torch.max(i / n - sorted_u)
    d_minus = torch.max(sorted_u - (i - 1) / n)
    d = torch.maximum(d_plus, d_minus)
    lam = (math.sqrt(n) + 0.12 + 0.11 / math.sqrt(n)) * d
    return kolmogorov_sf(lam)


def chi2_from_counts(counts: torch.Tensor, expected) -> torch.Tensor:
    """Pearson statistic with TestU01-style clamping of tiny bins."""
    expected = torch.clamp(torch.as_tensor(expected, device=counts.device),
                           min=1e-9)
    return torch.sum(torch.square(counts - expected) / expected)
