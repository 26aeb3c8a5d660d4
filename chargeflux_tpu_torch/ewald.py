"""Classical Ewald: self energy, structure factors and the reciprocal sum
(torch counterpart of ``chargeflux_tpu.ewald``).

S(k) = sum_i q_i e^{i k.x_i} factorizes per axis in fractional
coordinates, so per-axis phase tables are built once and contracted over
atoms.  The half-space grid is kx in [0, kmax_x) times the full (ky, kz)
plane, weighted 1/2 at kx == 0 and 0 at the origin:

    E_rec = (4 pi k_e / V) sum_k w(k) exp(-k^2 / (4 alpha^2)) / k^2 |S(k)|^2

:func:`structure_factors` has the JAX package's two methods:

* ``"xla"``, the plain factorized product: q folded into the combined
  [Kx*Ky, N] tables cxy/sxy, contracted with [cos_z | sin_z] by
  ``device.ieee_matmul`` (the JAX package leaves this product to XLA too,
  with its precision pinned; here IEEE f32 whatever the caller's TF32
  switches say);
* ``"pallas"``, which keeps the JAX spec string and here names the
  hand-written structure-factor kernel (``ops/structure_factor.py``,
  ``csrc/structure_factor.cu``): q folded into zq = q [cos_z | sin_z], the
  combined tables formed inside the kernel.  f32 only, and a grid within
  the kernels' Ky / 2Kz limits (``recip_method="auto"`` picks it only for
  such a grid).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .device import device_key, ieee_matmul
from .ops.structure_factor import structure_factor, xy_tables
from .pairs import box_volume, frac_coords, metric_k2, reciprocal_metric
from .units import ONE_4PI_EPS0, SQRT_PI


def kvector_grid(kmax: Tuple[int, int, int]):
    """(nx [Kx], ny [Ky], nz [Kz], w [Kx, Ky, Kz]) as NumPy arrays, with
    Kx = kmax_x, Ky = 2 kmax_y - 1, Kz = 2 kmax_z - 1; w is 1 for nx > 0,
    0.5 for nx == 0 and 0 at the origin."""
    kx, ky, kz = kmax
    nx = np.arange(0, kx)
    ny = np.arange(-(ky - 1), ky)
    nz = np.arange(-(kz - 1), kz)
    w = np.where(nx[:, None, None] > 0, 1.0, 0.5) * np.ones(
        (len(nx), len(ny), len(nz)))
    origin = ((nx[:, None, None] == 0) & (ny[None, :, None] == 0)
              & (nz[None, None, :] == 0))
    return nx, ny, nz, np.where(origin, 0.0, w)


class KGridTensors(NamedTuple):
    """:func:`kvector_grid` as tensors of one type on one device: the
    per-axis indices ``n`` and their squares ``sq`` ([Kx], [Ky], [Kz] each)
    and the weights ``w`` [Kx*Ky, Kz]."""
    n: tuple
    sq: tuple
    w: torch.Tensor


@lru_cache(maxsize=None)
def _kgrid_cached(kmax, dtype, device) -> KGridTensors:
    axes = kvector_grid(kmax)

    def put(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return KGridTensors(tuple(put(v) for v in axes[:3]),
                        tuple(put(v * v) for v in axes[:3]),
                        put(axes[3].reshape(-1, len(axes[2]))))


def kgrid_tensors(kmax, dtype, device) -> KGridTensors:
    """The k grid's constant tensors, copied to ``device`` once per (kmax,
    dtype, device) and kept, as ``device.constant`` keeps its tensors: an
    energy evaluation makes no host-to-device copy for them.  They are
    shared: do not write to them.  The first call for a key does copy, so
    make it before a CUDA graph capture of the evaluation, not inside
    one."""
    return _kgrid_cached(tuple(int(k) for k in kmax), dtype,
                         device_key(device))


def phase_tables(positions, box, kmax):
    """(cx, sx, cy, sy, cz, sz), each [..., N, K_axis]: cos and sin of
    2 pi f n per axis (positions [..., N, 3]: any leading replica axes
    carry through).  The fractional coordinates are wrapped into [0, 1)
    with a detached floor (f32 phase accuracy; the periodic energy and its
    gradient are unchanged)."""
    dtype, dev = positions.dtype, positions.device
    frac = frac_coords(positions, box)
    frac = frac - torch.floor(frac).detach()
    out = []
    for axis, nk in enumerate(kgrid_tensors(kmax, dtype, dev).n):
        ph = 2.0 * math.pi * frac[..., axis:axis + 1] * nk
        out += [torch.cos(ph), torch.sin(ph)]
    return tuple(out)


def kernel_inputs(positions, q, box, kmax):
    """(cxT, sxT, cyT, syT, zq) in the layouts of
    :func:`ops.structure_factor.structure_factor`."""
    cx, sx, cy, sy, cz, sz = phase_tables(positions, box, kmax)
    zq = q[..., :, None] * torch.cat([cz, sz], dim=-1)
    return tuple(t.transpose(-1, -2).contiguous() for t in (cx, sx, cy, sy)
                 ) + (zq.contiguous(),)


def assemble(a, b, kz: int):
    """(s_cos, s_sin) [..., Kx*Ky, Kz] from the contractions A, B
    [..., Kx*Ky, 2Kz] of the cos and sin xy tables with [cos_z | sin_z]."""
    return a[..., :kz] - b[..., kz:], b[..., :kz] + a[..., kz:]


def structure_factors(positions, q, box, kmax, method: str = "xla",
                      plain: bool = False):
    """S(k) over the weighted half-space grid as (s_cos, s_sin), each
    [..., Kx*Ky, Kz] for positions [..., N, 3] and charges [..., N] (a
    leading replica axis goes through one batched product, or one batched
    launch of each kernel).  ``plain=True`` runs the kernel's plain
    version for ``method="pallas"``."""
    kz = 2 * kmax[2] - 1
    if method == "pallas":
        if positions.dtype != torch.float32:
            raise ValueError(
                "recip_method='pallas' is the f32 structure-factor kernel "
                f"and would degrade a {positions.dtype} system's ~1e-10 "
                "parity contract; use 'xla' (or 'pme') for f64 work")
        return assemble(*structure_factor(
            *kernel_inputs(positions, q, box, kmax), plain=plain), kz)
    if method != "xla":
        raise ValueError(f"unknown structure-factor method {method!r}")
    cx, sx, cy, sy, cz, sz = phase_tables(positions, box, kmax)
    cxy, sxy = xy_tables(*(t.transpose(-1, -2)
                           for t in (cx, sx, cy, sy)))  # [.., Kx*Ky, N]
    cz_sz = torch.cat([cz, sz], dim=-1)                 # [.., N, 2Kz]
    qr = q[..., None, :]
    return assemble(ieee_matmul(cxy * qr, cz_sz),
                    ieee_matmul(sxy * qr, cz_sz), kz)


def reciprocal_energy_from_sf(s_cos, s_sin, box, alpha: float, kmax):
    """E_rec from assembled structure factors; for a [3, 3] lattice |k|^2
    = n . G . n takes the three cross terms of the reciprocal metric on
    the signed integer frequencies."""
    dtype, dev = s_cos.dtype, s_cos.device
    grid = kgrid_tensors(kmax, dtype, dev)
    if box.ndim == 2:
        nx, ny, nz = grid.n
        k2 = metric_k2(reciprocal_metric(box, dtype), nx[:, None, None],
                       ny[None, :, None], nz[None, None, :]).reshape(
                           grid.w.shape)
    else:
        sqx, sqy, sqz = grid.sq
        g = torch.diagonal(reciprocal_metric(box, dtype))  # (2 pi / L)^2
        k2 = (g[0] * sqx[:, None, None] + g[1] * sqy[None, :, None]
              + g[2] * sqz[None, None, :]).reshape(grid.w.shape)
    k2_safe = torch.where(k2 > 0, k2, 1.0)
    eak = torch.exp(-k2_safe * (0.25 / (alpha * alpha))) / k2_safe
    wk = grid.w * eak
    const = 4.0 * math.pi * ONE_4PI_EPS0 / box_volume(box)
    return const * torch.sum(wk * (s_cos * s_cos + s_sin * s_sin),
                             dim=(-2, -1))


def reciprocal_energy(positions, q, box, alpha: float, kmax,
                      method: str = "xla", plain: bool = False):
    """Reciprocal-space Ewald energy through the factorized structure
    factors."""
    s_cos, s_sin = structure_factors(positions, q, box, kmax, method=method,
                                     plain=plain)
    return reciprocal_energy_from_sf(s_cos, s_sin, box, alpha, kmax)


def self_energy(q: torch.Tensor, alpha: float) -> torch.Tensor:
    """E_self = -k_e * alpha/sqrt(pi) * sum q_i^2 (per leading replica)."""
    return -ONE_4PI_EPS0 * alpha / SQRT_PI * torch.sum(q * q, dim=-1)
