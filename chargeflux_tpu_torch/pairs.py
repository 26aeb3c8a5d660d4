"""Displacement geometry and dense pair masking (torch counterpart of
``chargeflux_tpu.pairs``).

Orthorhombic minimum image: ``delta - box * floor(delta / box + 0.5)``,
OpenMM's reference convention.  A [3, 3] reduced lower-triangular lattice
(triclinic) is wrapped by the sequential c-then-b-then-a subtraction.
"""

from __future__ import annotations

import math

import torch


def delta_direct(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Displacement a -> b without PBC: pb - pa."""
    return pb - pa


def delta_periodic(pa: torch.Tensor, pb: torch.Tensor,
                   box: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement a -> b."""
    d = pb - pa
    if box.ndim == 2:
        d = d - box[2] * torch.floor(d[..., 2:3] / box[2, 2] + 0.5)
        d = d - box[1] * torch.floor(d[..., 1:2] / box[1, 1] + 0.5)
        d = d - box[0] * torch.floor(d[..., 0:1] / box[0, 0] + 0.5)
        return d
    return d - box * torch.floor(d / box + 0.5)


def displacement(pa, pb, box, pbc: bool):
    """Displacement a -> b, minimum image when ``pbc``."""
    if pbc:
        return delta_periodic(pa, pb, box)
    return pb - pa


def box_volume(box: torch.Tensor) -> torch.Tensor:
    """Edge product ([3]) or diagonal product of a reduced [3, 3] lattice."""
    if box.ndim == 2:
        return box[0, 0] * box[1, 1] * box[2, 2]
    return box[0] * box[1] * box[2]


def box_inverse(box: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the reduced lower-triangular [3, 3] lattice."""
    b00, b11, b22 = box[0, 0], box[1, 1], box[2, 2]
    i00 = 1.0 / b00
    i11 = 1.0 / b11
    i22 = 1.0 / b22
    i10 = -box[1, 0] * (i00 * i11)
    i21 = -box[2, 1] * (i11 * i22)
    i20 = (box[1, 0] * box[2, 1] - box[2, 0] * b11) * (i00 * i11 * i22)
    z = torch.zeros_like(b00)
    return torch.stack([torch.stack([i00, z, z]),
                        torch.stack([i10, i11, z]),
                        torch.stack([i20, i21, i22])])


def frac_coords(x: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Fractional coordinates f with x = f @ box (x / box when
    orthorhombic); the triclinic transform is expanded elementwise, as in
    the JAX package."""
    if box.ndim == 2:
        inv = box_inverse(box)
        f0 = x[..., 0] * inv[0, 0] + x[..., 1] * inv[1, 0] \
            + x[..., 2] * inv[2, 0]
        f1 = x[..., 1] * inv[1, 1] + x[..., 2] * inv[2, 1]
        f2 = x[..., 2] * inv[2, 2]
        return torch.stack([f0, f1, f2], dim=-1)
    return x / box


def lattice_cart(n: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Cartesian coordinates of lattice or fractional vectors ``n`` (last
    axis 3): ``n @ box`` for a [3, 3] row-vector lattice, expanded
    elementwise (no f32 matmul), ``n * box`` for an orthorhombic box."""
    if box.ndim == 2:
        return (n[..., 0:1] * box[0] + n[..., 1:2] * box[1]
                + n[..., 2:3] * box[2])
    return n * box


def plane_widths(box: torch.Tensor) -> torch.Tensor:
    """Perpendicular widths as a [3] tensor (the box itself when
    orthorhombic)."""
    if box.ndim == 2:
        inv = box_inverse(box)
        return 1.0 / torch.sqrt(torch.sum(inv * inv, dim=0))
    return box


def reciprocal_metric(box: torch.Tensor, dtype) -> torch.Tensor:
    """G [3, 3] with |k(n)|^2 = n . G . n for k = 2 pi n B^-T: the
    reciprocal-lattice Gram matrix (2 pi)^2 B^-T B^-1 of a [3, 3] box, from
    the closed-form inverse, summed elementwise in f64 and then cast;
    diagonal (2 pi / L_i)^2 for an orthorhombic box."""
    if box.ndim == 2:
        inv = box_inverse(box.to(torch.float64))
        g = torch.sum(inv[:, :, None] * inv[:, None, :], dim=0)
        return ((2.0 * math.pi) ** 2 * g).to(dtype)
    r = (2.0 * math.pi) / box.to(dtype)
    return torch.diag(r * r)


def metric_k2(g: torch.Tensor, ax, ay, az):
    """|k|^2 = n . G . n on broadcast integer frequencies (ax, ay, az) for
    the reciprocal metric ``g`` of a [3, 3] lattice: the diagonal terms
    and the three cross terms."""
    return (g[0, 0] * ax * ax + g[1, 1] * ay * ay + g[2, 2] * az * az
            + 2.0 * (g[0, 1] * ax * ay + g[0, 2] * ax * az
                     + g[1, 2] * ay * az))


def safe_norm(d: torch.Tensor, dim: int = -1):
    """(r, r^2) with a grad-safe sqrt: where r^2 == 0 the norm is 0 with
    zero gradient instead of NaN (the double-where trick)."""
    r2 = torch.sum(d * d, dim=dim)
    nonzero = r2 > 0
    r = torch.where(nonzero, torch.sqrt(torch.where(nonzero, r2, 1.0)), 0.0)
    return r, r2


def pair_matrix_mask(n: int, exclusions: torch.Tensor) -> torch.Tensor:
    """[N, N] bool mask of interacting ordered pairs i < j with the excluded
    pairs removed (an excluded pair has neither short-range Coulomb nor
    LJ)."""
    i = torch.arange(n, device=exclusions.device)
    mask = i[:, None] < i[None, :]
    if exclusions.shape[0] > 0:
        p1, p2 = exclusions[:, 0], exclusions[:, 1]
        excl = torch.zeros((n, n), dtype=torch.bool, device=exclusions.device)
        # a device tensor of True, not a Python True (which a CUDA index_put
        # copies from the host on every call)
        true = torch.ones_like(p1, dtype=torch.bool)
        excl.index_put_((p1, p2), true)
        excl.index_put_((p2, p1), true)
        mask = mask & ~excl
    return mask
