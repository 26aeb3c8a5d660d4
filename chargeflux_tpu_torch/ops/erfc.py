"""Short-range Coulomb helpers for the direct space (torch).

Counterpart of ``chargeflux_tpu.ops.erfc``:

* :func:`erfc_fast` — Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7)
  for f32; the exact ``torch.special.erfc`` for f64.
* :func:`erf_over_r_eval` — erf(alpha*r)/r as one degree-12 polynomial in
  r^2 (the coefficients come from :func:`erf_over_r_coeffs`, NumPy,
  identical to the JAX package's), so the f32 direct walk computes
  erfc(alpha*r)/r = 1/r - P(r^2) exactly as the JAX walk does.  The
  derivative dP/d(r^2) comes from the same coefficients, so forces stay
  the exact gradient of the computed energy.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_P = 0.3275911
_A1 = 0.254829592
_A2 = -0.284496736
_A3 = 1.421413741
_A4 = -1.453152027
_A5 = 1.061405429


def erfc_fast(x: torch.Tensor) -> torch.Tensor:
    """erfc(x) for x >= 0 (pair distances are nonnegative)."""
    if x.dtype == torch.float64:
        return torch.special.erfc(x)
    t = 1.0 / (1.0 + _P * x)
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    return poly * torch.exp(-x * x)


@lru_cache(maxsize=64)
def erf_over_r_coeffs(alpha: float, cutoff: float,
                      degree: int = 12) -> tuple:
    """Monomial coefficients (ascending) of P(w) ~= erf(alpha*r)/r in the
    scaled variable w = r^2 * (2/cutoff^2) - 1 in [-1, 1] (Chebyshev fit
    converted to the monomial basis)."""
    smax = cutoff * cutoff
    s = np.linspace(0.0, smax, 4001)
    r = np.sqrt(s[1:])
    f = np.empty_like(s)
    f[0] = 2.0 * alpha / math.sqrt(math.pi)        # lim_{r->0} erf(ar)/r
    f[1:] = np.vectorize(math.erf)(alpha * r) / r
    w = s * (2.0 / smax) - 1.0
    cheb = np.polynomial.chebyshev.chebfit(w, f, degree)
    mono = np.polynomial.chebyshev.cheb2poly(cheb)
    return tuple(float(c) for c in mono)


def erf_over_r_eval(r2, alpha: float, cutoff: float,
                    with_derivative: bool = False):
    """P ~= erf(alpha*r)/r and optionally dP/d(r^2), evaluated from r^2
    (valid for r2 in [0, cutoff^2]; callers mask out-of-range pairs)."""
    coeffs = erf_over_r_coeffs(alpha, cutoff)
    ws = 2.0 / (cutoff * cutoff)
    w = r2 * ws - 1.0
    p = coeffs[-1]
    if not with_derivative:
        for ck in coeffs[-2::-1]:
            p = p * w + ck
        return p
    d = 0.0
    for ck in coeffs[-2::-1]:
        d = d * w + p
        p = p * w + ck
    return p, d * ws
