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

The halo route's slab form (:func:`direct_walk_slab`, its launches counted
as ``direct_walk_halo``) walks the owned cells of one rank's extended slab,
owned blocks first and the exchanged halo cells after them, through the
tables of ``cells.slab_shell_tables``; it returns the rank's half of each
of its cells' full-shell sums, and dE/dx, dE/dq on the owned slots only.
Its plain version, :func:`direct_walk_slab_plain`, gathers the 27 tiles
through the same tables.

:func:`direct_walk` and :func:`direct_walk_slab` run the plain version on
a CPU tensor and the kernel on a CUDA tensor, or raise (f64 on the card
raises: the kernel is f32 only; an f64 system records the plain route
when it is built).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from . import native
from .native import FLOAT, INT, INT_OUT, PTR
from ..device import constant
from .erfc import erf_over_r_coeffs, erf_over_r_eval
from ..units import ONE_4PI_EPS0

#: Kernel launches since the last reset: the orthorhombic instantiation,
#: the triclinic one (a [3, 3] box), and the halo route's slab form (either
#: box).
LAUNCHES = {"direct_walk": 0, "direct_walk_tri": 0, "direct_walk_halo": 0}
#: The kernel each counts, as a profiler trace names it.
SYMBOLS = {"direct_walk": "direct_walk_kernel",
           "direct_walk_tri": "direct_walk_tri_kernel",
           "direct_walk_halo": "direct_walk_slab_kernel"}
native.declare(cf_walk_limits=[INT_OUT] * 2,
               cf_direct_walk=[PTR] * 11 + [INT, FLOAT, FLOAT] + [INT] * 4
               + [PTR] * 4,
               cf_direct_walk_slab=[PTR] * 11 + [INT, FLOAT, FLOAT]
               + [INT] * 5 + [PTR] * 4)


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


def _pair_terms(r2, mask, q_i, q_j, hs_i, hs_j, se_i, se_j, alpha: float,
                cutoff: float):
    """The walk's pair terms on an [..., i, j] tile with the i columns
    [..., i] and the j rows [..., j]: (E_ij, (dE/dr)/r and the Coulomb
    kernel erfc(alpha r)/r times 1/(4 pi eps0)), each 0 off ``mask``.
    f64 takes the exact erfc, f32 the erf(alpha r)/r polynomial."""
    r2s = torch.where(mask, r2, 1.0)
    inv_r = torch.rsqrt(r2s)
    u = inv_r * inv_r
    qq = (ONE_4PI_EPS0 * q_i[..., :, None]) * q_j[..., None, :]
    if r2.dtype == torch.float64:
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
    sig2 = ((hs_i[..., :, None] + hs_j[..., None, :]) * inv_r) ** 2
    sig6 = sig2 * sig2 * sig2
    epr = se_i[..., :, None] * se_j[..., None, :]
    lj = epr * sig6 * (sig6 - 1.0)
    dlj_over_r = -epr * sig6 * (12.0 * sig6 - 6.0) * u
    return (torch.where(mask, coul + lj, 0.0),
            torch.where(mask, dcoul_over_r + dlj_over_r, 0.0),
            torch.where(mask, kern, 0.0) * ONE_4PI_EPS0)


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
    e_ij, f, ec = _pair_terms(r2, mask, q, qj, hs, hj, se, sj, alpha,
                              cutoff)
    e = torch.sum(e_ij)
    gi = [torch.sum(f * d, dim=-1) for d in (ddx, ddy, ddz)]
    gj = [-torch.sum(f * d, dim=-2) for d in (ddx, ddy, ddz)]
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


def _check_inputs(what, blocks, ids, box, shape, alpha, cutoff,
                  grid_shape=None):
    """Raise unless the kernel takes ``blocks`` (x, y, z, q, hs, se), ids
    and box in the block shape ``shape``: :func:`_refusal` at
    ``grid_shape`` (default ``shape``), then contiguity, shapes and
    devices."""
    named = tuple(zip(("x", "y", "z", "q", "hs", "se"), blocks)) + (
        ("box", box),)
    refusal = _refusal([(k, t.dtype, t.device) for k, t in named],
                       grid_shape or shape, alpha, cutoff)
    if refusal is not None:
        raise refusal[0](refusal[1])
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t is not box and tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"{shape}")
    device = blocks[0].device
    if box.shape not in ((3,), (3, 3)) or box.device != device:
        raise ValueError(f"{what}: the box must be a [3] or a [3, 3] tensor "
                         f"on the device of the blocks")
    if (ids.dtype != torch.int32 or tuple(ids.shape) != shape
            or not ids.is_contiguous() or ids.device != device):
        raise ValueError(f"{what}: ids must be contiguous int32 in the block "
                         f"shape, on the device of the blocks")


def direct_walk(x, y, z, q, hs, se, ids, box, n_atoms: int, alpha: float,
                cutoff: float):
    """Fused walk: plain version on the CPU, the CUDA kernel on the card."""
    if x.device.type == "cpu":
        return direct_walk_plain(x, y, z, q, hs, se, ids, box, n_atoms,
                                 alpha, cutoff)
    shape = x.shape
    _check_inputs("direct walk kernel", (x, y, z, q, hs, se), ids, box,
                  tuple(shape), float(alpha), float(cutoff))
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


@lru_cache(maxsize=None)
def _slab_tables(grid, decomp, device):
    """The slab walk's neighbor and image tables, kept per (global grid,
    decomposition, device) as :func:`_tables` keeps its own; the layout
    is alike on every rank (``cells.slab_shell_tables``)."""
    from ..cells import slab_shell_tables

    nbr, img = slab_shell_tables(grid, decomp)
    return (torch.as_tensor(nbr, device=device).contiguous(),
            torch.as_tensor(img, dtype=torch.int32,
                            device=device).contiguous())


def _slab_shape(grid, decomp, cap: int):
    """(n_own, n_ext, cap): the owned and extended cells of one rank's
    slab of the global ``grid`` under ``decomp``."""
    from ..cells import slab_halo_cells

    n_own = (grid[0] // decomp[0]) * (grid[1] // decomp[1]) * grid[2]
    return n_own, n_own + slab_halo_cells(grid, decomp), cap


def direct_walk_slab_plain(x, y, z, q, hs, se, ids, box, n_atoms: int,
                           alpha: float, cutoff: float, grid, decomp):
    """The slab walk in plain tensor ops (any device, f32 or f64): inputs
    [n_ext, cap] on the extended slab of a rank of ``decomp`` over the
    global ``grid``; each owned cell's 27 tiles gathered through the slab
    tables, image offsets added, every in-cutoff pair but the atom with
    itself.  Returns (e, g [3, n_own, cap], dq [n_own, cap]): half the
    owned cells' full-shell energy, and the full dE/dx and dE/dq of the
    owned atoms."""
    dtype, dev = x.dtype, x.device
    nbr, img = _slab_tables(tuple(grid), tuple(decomp), dev)
    n_own, n_ext, cap = _slab_shape(grid, decomp, x.shape[-1])
    if x.shape != (n_ext, cap):
        raise ValueError(f"slab walk: blocks {tuple(x.shape)} are not the "
                         f"extended slab ({n_ext}, {cap})")
    nb = nbr.long()
    im = img.to(dtype)
    if box.ndim == 2:
        ox = (im[..., 0] * box[0, 0] + im[..., 1] * box[1, 0]
              + im[..., 2] * box[2, 0])
        oy = im[..., 1] * box[1, 1] + im[..., 2] * box[2, 1]
        oz = im[..., 2] * box[2, 2]
    else:
        ox, oy, oz = (im[..., k] * box[k] for k in range(3))

    def tiles(a, off=None):
        t = a[nb] if off is None else a[nb] + off[..., None]
        return t.reshape(n_own, 27 * cap)

    xj, yj, zj = tiles(x, ox), tiles(y, oy), tiles(z, oz)
    qj, hj, sj = tiles(q), tiles(hs), tiles(se)
    valid_j = tiles(ids) < n_atoms
    xi, yi, zi, qi, hi, si = (a[:n_own] for a in (x, y, z, q, hs, se))
    valid_i = ids[:n_own] < n_atoms
    ddx = xi[..., :, None] - xj[..., None, :]
    ddy = yi[..., :, None] - yj[..., None, :]
    ddz = zi[..., :, None] - zj[..., None, :]
    r2 = ddx * ddx + ddy * ddy + ddz * ddz
    # tile 13 is the cell itself: its slot k is the i atom of slot k
    itself = (torch.arange(27 * cap, device=dev)
              == 13 * cap + torch.arange(cap, device=dev)[:, None])
    mask = (valid_i[..., :, None] & valid_j[..., None, :]
            & (r2 < cutoff * cutoff) & ~itself)
    e_ij, f, ec = _pair_terms(r2, mask, qi, qj, hi, hj, si, sj, alpha,
                              cutoff)
    e = 0.5 * torch.sum(e_ij)
    g = torch.stack([torch.sum(f * d, dim=-1) for d in (ddx, ddy, ddz)])
    return e, g, torch.sum(ec * qj[..., None, :], dim=-1)


def direct_walk_slab(x, y, z, q, hs, se, ids, box, n_atoms: int,
                     alpha: float, cutoff: float, grid, decomp):
    """Slab walk: plain version on the CPU, the CUDA kernel
    (``cf_direct_walk_slab``) on the card.  The kernel's conditions are the
    periodic walk's on the global ``grid`` (>= 3 cells per axis), so a
    rank's slab may be one or two cells thick."""
    if x.device.type == "cpu":
        return direct_walk_slab_plain(x, y, z, q, hs, se, ids, box, n_atoms,
                                      alpha, cutoff, grid, decomp)
    n_own, n_ext, cap = _slab_shape(grid, decomp, x.shape[-1])
    # the kernel's conditions on the global grid; the blocks are the
    # extended slab's
    _check_inputs("slab walk kernel", (x, y, z, q, hs, se), ids, box,
                  (n_ext, cap), float(alpha), float(cutoff),
                  tuple(grid) + (cap,))
    coef = constant(erf_over_r_coeffs(float(alpha), float(cutoff)),
                    torch.float32, x.device)
    nbr, img = _slab_tables(tuple(grid), tuple(decomp), x.device)
    e_part = torch.empty((n_own,), dtype=torch.float32, device=x.device)
    g = torch.empty((3, n_own, cap), dtype=torch.float32, device=x.device)
    dq = torch.empty((n_own, cap), dtype=torch.float32, device=x.device)
    err = native.library().cf_direct_walk_slab(
        *(t.data_ptr() for t in (x, y, z, q, hs, se, ids, nbr, img, box,
                                 coef)),
        coef.numel(), 2.0 / (cutoff * cutoff), cutoff * cutoff, n_atoms,
        n_own, n_ext, cap, int(box.ndim == 2), e_part.data_ptr(),
        g.data_ptr(), dq.data_ptr(), native.stream_ptr(x))
    native.check(err, "cf_direct_walk_slab")
    LAUNCHES["direct_walk_halo"] += 1
    return torch.sum(e_part), g, dq
