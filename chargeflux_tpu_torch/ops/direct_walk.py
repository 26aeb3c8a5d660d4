"""Fused direct-space walk over the cell blocks: the CUDA kernel wrapper
and its plain-PyTorch version.

Counterpart of ``chargeflux_tpu.cells._concat_fused_walk``.  Both
versions return ``(e, g, dq)``: the direct-space energy, dE/dx as
[3, gx, gy, gz, cap] and dE/dq as [gx, gy, gz, cap] on the block layout.
The plain version is the JAX package's half-shell walk (self cell with
i < j by atom id plus 13 rolled neighbor slabs, j-side sums rolled back).
The kernel (``csrc/direct_walk.cu``) walks the full 27-cell shell, one
block per i-cell, so that no output is written by two threads: it stages
the neighbor tiles compacted (sentinel slots and every atom beyond the
cutoff of the bounding box of the cell's real atoms dropped), lets each
thread list the staged atoms within the cutoff of its own i atom, and
evaluates the pair terms from those lists, every sum in a fixed order.
A [3, 3] box (a reduced triclinic lattice) takes the kernel's triclinic
instantiation, which turns a neighbor tile's image offset into lattice
rows; its launches count apart (``direct_walk_tri``).

:func:`direct_walk` runs the plain version on a CPU tensor and the kernel
on a CUDA tensor, or raises (f64 on the card raises: the kernel is f32
only; an f64 system records the plain route when it is built).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from . import native
from ..device import constant
from .erfc import erf_over_r_coeffs, erf_over_r_eval
from ..units import ONE_4PI_EPS0

#: Kernel launches since the last reset: the orthorhombic instantiation,
#: and the triclinic one (a [3, 3] box).
LAUNCHES = {"direct_walk": 0, "direct_walk_tri": 0}
#: The kernel each counts, as a profiler trace names it.
SYMBOLS = {"direct_walk": "direct_walk_kernel",
           "direct_walk_tri": "direct_walk_tri_kernel"}


def _crossing(n: int, d: int, dtype, device):
    c = torch.arange(n, device=device)
    return torch.where(c + d >= n, 1.0, torch.where(c + d < 0, -1.0, 0.0)).to(
        dtype)


def image_offsets(grid, shift, box, dtype, device):
    """Cartesian image offsets of the neighbor slab of a half-shell
    ``shift``, one per coordinate, broadcastable to [gx, gy, gz, 1] (the
    JAX package's ``shift_image_offsets``): an orthorhombic box shifts
    coordinate k by +-L_k where the roll wraps along axis k; a [3, 3]
    lower-triangular lattice adds the whole row +-B[a] where it wraps
    along grid axis a, so coordinate k collects the crossings of every
    axis a >= k."""
    gx, gy, gz = grid
    dx, dy, dz = shift
    cx = _crossing(gx, dx, dtype, device).view(gx, 1, 1, 1)
    cy = _crossing(gy, dy, dtype, device).view(1, gy, 1, 1)
    cz = _crossing(gz, dz, dtype, device).view(1, 1, gz, 1)
    if box.ndim == 2:
        return (cx * box[0, 0] + cy * box[1, 0] + cz * box[2, 0],
                cy * box[1, 1] + cz * box[2, 1],
                cz * box[2, 2])
    return cx * box[0], cy * box[1], cz * box[2]


def direct_walk_plain(x, y, z, q, hs, se, ids, box, n_atoms: int,
                      alpha: float, cutoff: float):
    """Half-shell fused walk in plain tensor ops (any device, f32 or f64;
    f64 uses the exact erfc, f32 the erf(alpha r)/r polynomial)."""
    from ..cells import HALF_SHELL

    gx, gy, gz, cap = x.shape
    dtype, dev = x.dtype, x.device
    ax = (0, 1, 2)
    valid = ids < n_atoms
    cut2 = cutoff * cutoff

    xs, ys, zs, qs, hss, ses, idss = [], [], [], [], [], [], []
    for (dx, dy, dz) in HALF_SHELL:
        sh = (-dx, -dy, -dz)

        def roll(a):
            return torch.roll(a, sh, ax)

        ox, oy, oz = image_offsets((gx, gy, gz), (dx, dy, dz), box, dtype,
                                   dev)
        xs.append(roll(x) + ox)
        ys.append(roll(y) + oy)
        zs.append(roll(z) + oz)
        qs.append(roll(q))
        hss.append(roll(hs))
        ses.append(roll(se))
        idss.append(roll(ids))
    xj, yj, zj, qj, hj, sj, idj = (torch.cat(a, dim=-1) for a in
                                   (xs, ys, zs, qs, hss, ses, idss))

    ddx = x[..., :, None] - xj[..., None, :]
    ddy = y[..., :, None] - yj[..., None, :]
    ddz = z[..., :, None] - zj[..., None, :]
    r2 = ddx * ddx + ddy * ddy + ddz * ddz
    ordered = ((torch.arange(14 * cap, device=dev) >= cap)
               | (ids[..., :, None] < idj[..., None, :]))
    mask = (valid[..., :, None] & (idj < n_atoms)[..., None, :]
            & (r2 < cut2) & ordered)
    r2s = torch.where(mask, r2, 1.0)
    inv_r = torch.rsqrt(r2s)
    u = inv_r * inv_r
    qq = (ONE_4PI_EPS0 * q[..., :, None]) * qj[..., None, :]
    if dtype == torch.float64:
        xa = alpha * (r2s * inv_r)
        kern = inv_r * torch.special.erfc(xa)
        coul = qq * kern
        derfc = (-2.0 / math.sqrt(math.pi)) * torch.exp(-xa * xa)
        dcoul_over_r = (qq * derfc * alpha - coul) * u
    else:
        p, dpds = erf_over_r_eval(r2s, alpha, cutoff, with_derivative=True)
        kern = inv_r - p
        coul = qq * kern
        dcoul_over_r = -qq * (u * inv_r + 2.0 * dpds)
    sig2 = ((hs[..., :, None] + hj[..., None, :]) * inv_r) ** 2
    sig6 = sig2 * sig2 * sig2
    epr = se[..., :, None] * sj[..., None, :]
    lj = epr * sig6 * (sig6 - 1.0)
    e = torch.sum(torch.where(mask, coul + lj, 0.0))
    dlj_over_r = -epr * sig6 * (12.0 * sig6 - 6.0) * u
    f = torch.where(mask, dcoul_over_r + dlj_over_r, 0.0)
    gi = [torch.sum(f * d, dim=-1) for d in (ddx, ddy, ddz)]
    gj = [-torch.sum(f * d, dim=-2) for d in (ddx, ddy, ddz)]
    ec = torch.where(mask, kern, 0.0) * ONE_4PI_EPS0
    dq = torch.sum(ec * qj[..., None, :], dim=-1)
    dqj = torch.sum(ec * q[..., :, None], dim=-2)
    g = list(gi)
    for s, back in enumerate(HALF_SHELL):
        sl = slice(s * cap, (s + 1) * cap)
        for k in range(3):
            g[k] = g[k] + torch.roll(gj[k][..., sl], back, ax)
        dq = dq + torch.roll(dqj[..., sl], back, ax)
    return e, torch.stack(g), dq


@lru_cache(maxsize=None)
def _tables(grid, device):
    """The walk's neighbor and image tables, kept per (grid, device) as
    ``device.constant`` keeps its tensors."""
    from ..cells import full_shell_tables

    nbr, img = full_shell_tables(grid)
    return (torch.as_tensor(nbr, device=device).contiguous(),
            torch.as_tensor(img, dtype=torch.int32, device=device).contiguous())


def _refusal(named, shape, alpha: float, cutoff: float):
    """Why the walk kernel cannot take float inputs ``named``, (name,
    dtype, device) triples, in the block shape ``shape`` [gx, gy, gz, cap]
    at this alpha and cutoff: (exception class, message), or None.  It
    reads types, devices and sizes only."""
    for name, dtype, device in named:
        if torch.device(device).type != "cuda" or dtype != torch.float32:
            return TypeError, (f"direct walk kernel: {name} must be a "
                               f"float32 CUDA tensor (got {dtype} on "
                               f"{device}); the f64 walk on the card is the "
                               f"plain version")
    gx, gy, gz, cap = shape
    max_coef, max_cap = native.limits("cf_walk_limits")
    if (cap > max_cap or len(erf_over_r_coeffs(alpha, cutoff)) > max_coef
            or min(gx, gy, gz) < 3):
        return ValueError, (f"direct walk kernel: needs capacity <= "
                            f"{max_cap} and >= 3 cells per axis")
    return None


def direct_walk(x, y, z, q, hs, se, ids, box, n_atoms: int, alpha: float,
                cutoff: float):
    """Fused walk: plain version on the CPU, the CUDA kernel on the card."""
    if x.device.type == "cpu":
        return direct_walk_plain(x, y, z, q, hs, se, ids, box, n_atoms,
                                 alpha, cutoff)
    shape = x.shape
    named = (("x", x), ("y", y), ("z", z), ("q", q), ("hs", hs), ("se", se),
             ("box", box))
    refusal = _refusal([(k, t.dtype, t.device) for k, t in named],
                       tuple(shape), float(alpha), float(cutoff))
    if refusal is not None:
        raise refusal[0](refusal[1])
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"direct walk kernel: {name} must be contiguous")
        if t is not box and t.shape != shape:
            raise ValueError(f"direct walk kernel: {name} shape {tuple(t.shape)}"
                             f" != {tuple(shape)}")
    if box.shape not in ((3,), (3, 3)) or box.device != x.device:
        raise ValueError("direct walk kernel: the box must be a [3] or a "
                         "[3, 3] tensor on the device of the blocks")
    if (ids.dtype != torch.int32 or ids.shape != shape
            or not ids.is_contiguous() or ids.device != x.device):
        raise ValueError("direct walk kernel: ids must be contiguous int32 in "
                         "the block shape, on the device of the blocks")
    gx, gy, gz, cap = shape
    coef = constant(erf_over_r_coeffs(float(alpha), float(cutoff)),
                    torch.float32, x.device)
    n_cells = gx * gy * gz
    nbr, img = _tables((gx, gy, gz), x.device)
    e_part = torch.empty((n_cells,), dtype=torch.float32, device=x.device)
    g = torch.empty((3,) + tuple(shape), dtype=torch.float32, device=x.device)
    dq = torch.empty(shape, dtype=torch.float32, device=x.device)
    err = native.library().cf_direct_walk(
        *(t.data_ptr() for t in (x, y, z, q, hs, se, ids, nbr, img, box,
                                 coef)),
        coef.numel(), 2.0 / (cutoff * cutoff), cutoff * cutoff, n_atoms,
        n_cells, cap, int(box.ndim == 2), e_part.data_ptr(), g.data_ptr(),
        dq.data_ptr(), native.stream_ptr(x))
    native.check(err, "cf_direct_walk")
    LAUNCHES["direct_walk_tri" if box.ndim == 2 else "direct_walk"] += 1
    return torch.sum(e_part), g, dq
