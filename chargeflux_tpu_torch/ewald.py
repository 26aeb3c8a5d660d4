"""Ewald self energy (torch counterpart of ``chargeflux_tpu.ewald``).

Classical Ewald (structure factors and the reciprocal sum) is not ported
yet; ROADMAP.md lists it with the dense route.
"""

from __future__ import annotations

import torch

from .units import ONE_4PI_EPS0, SQRT_PI


def self_energy(q: torch.Tensor, alpha: float) -> torch.Tensor:
    """E_self = -k_e * alpha/sqrt(pi) * sum q_i^2."""
    return -ONE_4PI_EPS0 * alpha / SQRT_PI * torch.sum(q * q)
