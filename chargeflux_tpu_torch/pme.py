"""Smooth particle-mesh Ewald reciprocal space (torch counterpart of
``chargeflux_tpu.pme``).

E_rec = sum_m D(m) |Q^(m)|^2 with Q the charge mesh spread by order-p
cardinal B-splines and D the influence function.

The dense-mesh route (:func:`pme_reciprocal_energy`, the reciprocal of
``direct_method="dense"`` with ``recip_method="pme"``) spreads with dense
per-axis weight matrices W[i, g] = M_p((u_i - g) mod G) over the whole mesh
and one product [Gx Gy, N] @ [N, Gz] in IEEE f32 (``device.ieee_matmul``),
on fractional coordinates, so it serves triclinic boxes too.

The cell route's spread is the
cell-column route of the JAX package's ``pme_cell_pallas_reciprocal_energy``:
each cell's atoms touch only a static patch of the mesh, so per cell
column the compact x/y weights and the order-p z taps go to
``ops.pme_spread.spread_columns`` (the hand-written CUDA kernel on the
card), two static folds wrap the padded x/y edges, and ``torch.fft.rfftn``
(cuFFT) does the transform.  The column weights come from
``ops.pme_weights.patch_weights`` (a hand-written CUDA kernel forward and
backward on the card).  Forces come from autograd; the B-spline backward
uses the analytic identity M_p' = M_{p-1}(t) - M_{p-1}(t-1).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .device import constant, device_key, ieee_matmul
from .ops.pme_spread import fold_padded_axis, spread_columns
from .ops.pme_weights import PatchGeometry, bspline, patch_weights
from .pairs import (box_inverse, box_volume, frac_coords, metric_k2,
                    reciprocal_metric)
from .units import ONE_4PI_EPS0

# Order 8: the spline order never enters a contraction shape, so a higher
# order is nearly free while the mesh shrinks at equal accuracy.
DEFAULT_ORDER = 8


def good_fft_size(n: int) -> int:
    """Smallest size >= n whose factors are all 2, 3 or 5."""
    while True:
        m = n
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


# Measured prefactors of the PME force-error law relF ~= C_p (alpha h)^p
# (the JAX package's calibration, tools/calibrate_pme.py).
_ERR_PREFACTOR = {4: 0.26, 6: 0.06, 8: 0.027}


def pme_grid_size(box, alpha: float, tol: float,
                  order: int = DEFAULT_ORDER) -> Tuple[int, int, int]:
    """Per-axis mesh size for a target relative force error ``tol``."""
    c = 2.0 * _ERR_PREFACTOR.get(order, 0.3)
    h = (tol / c) ** (1.0 / order) / alpha
    out = []
    for L in np.asarray(box, dtype=np.float64):
        n = max(int(math.ceil(float(L) / h)), 2 * order)
        out.append(good_fft_size(n))
    return tuple(out)


def spread_weights(u: torch.Tensor, grid_n: int, order: int) -> torch.Tensor:
    """Dense per-axis spread weights W[i, g] = M_p((u_i - g) mod G) [N, G]
    for ``u``, the fractional coordinate scaled to [0, G); entries outside
    the spline support are exactly zero."""
    g = torch.arange(grid_n, device=u.device).to(u.dtype)
    t = u[:, None] - g[None, :]
    t = t - grid_n * torch.floor(t / grid_n)        # (u - g) mod G
    return bspline(t, order)


def _spread_grid(wx, wy, wz, q):
    """Q[x, y, z] = sum_i q_i Wx[i,x] Wy[i,y] Wz[i,z] as one product
    [Gx Gy, N] @ [N, Gz] (IEEE f32 on the card, no scatter)."""
    n, gx = wx.shape
    gy = wy.shape[1]
    a = ((q[:, None] * wx)[:, :, None] * wy[:, None, :]).reshape(n, gx * gy)
    return ieee_matmul(a.transpose(0, 1), wz).reshape(gx, gy, wz.shape[1])


def pme_reciprocal_energy(positions: torch.Tensor, q: torch.Tensor,
                          box: torch.Tensor, alpha: float, grid,
                          order: int = DEFAULT_ORDER) -> torch.Tensor:
    """Dense-mesh SPME reciprocal energy (forces and dE/dq by autograd):
    the drop-in for ``ewald.reciprocal_energy`` on the dense route, with
    accuracy set by (grid, order) — see :func:`pme_grid_size`."""
    dtype = positions.dtype
    frac = frac_coords(positions, box)
    frac = frac - torch.floor(frac).detach()
    u = frac * constant(grid, dtype, positions.device)
    wx, wy, wz = (spread_weights(u[:, a], grid[a], order) for a in range(3))
    qhat = torch.fft.rfftn(_spread_grid(wx, wy, wz, q.to(dtype)))
    d = influence_function(tuple(grid), box, alpha, order, dtype)
    return torch.sum(d * (qhat.real * qhat.real + qhat.imag * qhat.imag))


def _bspline_dft_sq(grid_n: int, order: int) -> np.ndarray:
    """|b(m)|^2 Euler factors, NumPy [G] (f64)."""
    j = np.arange(order - 1)

    def m_n(n, t):
        if n == 2:
            return max(0.0, 1.0 - abs(t - 1.0))
        return (t * m_n(n - 1, t) + (n - t) * m_n(n - 1, t - 1.0)) / (n - 1)
    nodes = np.array([m_n(order, float(k + 1)) for k in j])
    m = np.arange(grid_n)
    ph = np.exp(2j * np.pi * m[:, None] * j[None, :] / grid_n)
    denom = ph @ nodes
    return 1.0 / np.maximum(np.abs(denom) ** 2, 1e-300)


@lru_cache(maxsize=None)
def _influence_static(grid, order, dtype, device):
    """Box-independent factors of the influence function: signed integer
    frequencies, the origin mask and the B-spline/half-space weights
    (kept per (grid, order, dtype, device), as ``device.constant`` keeps
    its tensors)."""
    gx, gy, gz = grid

    def ifreqs(n):
        return np.fft.fftfreq(n, d=1.0 / n)

    bx = _bspline_dft_sq(gx, order)[:, None, None]
    by = _bspline_dft_sq(gy, order)[None, :, None]
    bz = _bspline_dft_sq(gz, order)[: (gz // 2 + 1)][None, None, :]
    wz = np.full(gz // 2 + 1, 2.0)
    wz[0] = 1.0
    if gz % 2 == 0:
        wz[-1] = 1.0
    origin = np.zeros((gx, gy, gz // 2 + 1), dtype=bool)
    origin[0, 0, 0] = True

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return (t(ifreqs(gx)), t(ifreqs(gy)), t(np.arange(gz // 2 + 1)),
            t(origin, torch.bool), t(bx * by * bz * wz[None, None, :]))


def influence_function(grid, box: torch.Tensor, alpha: float, order: int,
                       dtype=torch.float64) -> torch.Tensor:
    """Real rFFT-space influence function D [Gx, Gy, Gz//2+1] with
    E_rec = sum(D |Q^|^2), origin masked to zero.  For a [3, 3] lattice
    |k|^2 = m . G . m with the reciprocal Gram matrix G, three cross terms
    on the half-space grid."""
    fx, fy, fz, origin, static = _influence_static(
        tuple(grid), order, dtype, device_key(box.device))
    two_pi = 2.0 * math.pi
    if box.ndim == 2:
        k2 = metric_k2(reciprocal_metric(box, dtype), fx[:, None, None],
                       fy[None, :, None], fz[None, None, :])
    else:
        kx = (two_pi * fx / box[0])[:, None, None]
        ky = (two_pi * fy / box[1])[None, :, None]
        kz = (two_pi * fz / box[2])[None, None, :]
        k2 = kx * kx + ky * ky + kz * kz
    k2s = torch.where(origin, 1.0, k2)
    kern = torch.where(origin, 0.0,
                       torch.exp(-k2s * (0.25 / (alpha * alpha))) / k2s)
    const = two_pi * ONE_4PI_EPS0 / box_volume(box)
    return const * kern * static


def _patch_origins(n_cells: int, grid_n: int, order: int,
                   extra: int = 0) -> np.ndarray:
    """Static mesh origin of each cell's spread patch (may be negative)."""
    c = np.arange(n_cells)
    return (np.floor(c * grid_n / n_cells)).astype(np.int64) - order - extra


def _patch_width(n_cells: int, grid_n: int, order: int,
                 extra: int = 0) -> int:
    """Patch extent covering every support point of every atom in a cell:
    one point of slack per side for binning rounding plus ``extra`` per
    side for neighbor-reuse drift (spec.pme_slack)."""
    return int(math.ceil(grid_n / n_cells)) + order + 2 + 2 * extra


def _cell_patch_weights(coord, n_cells, grid_n, length, extra, cell_axis,
                        order, dtype):
    """Per-cell compact B-spline patch weights [..., W] (the tap axis
    last); returns (weights, int patch origins [n_cells], patch width)."""
    u = coord * (grid_n / length)
    org = _patch_origins(n_cells, grid_n, order, extra)
    w = _patch_width(n_cells, grid_n, order, extra)
    shape = [1, 1, 1, 1, 1]
    shape[cell_axis] = n_cells
    base = constant(org.tolist(), dtype, coord.device).reshape(shape)
    j = torch.arange(w, device=coord.device).to(dtype).reshape(1, 1, 1, 1, w)
    return bspline(u[..., None] - (base + j), order), org, w


def _block_spread_coords(blocks, box):
    """Per-axis spread coordinates and the axis lengths L [3] of u = coord
    * G / L: the Cartesian block coordinates against the edge lengths, or
    for a [3, 3] lattice the fractional ones (f = x B^-1 by
    lower-triangular back-substitution on the blocks) against ones, the
    B-spline mesh living on the unit cell."""
    if box.ndim == 2:
        inv = box_inverse(box)
        fx = blocks.x * inv[0, 0] + blocks.y * inv[1, 0] + blocks.z * inv[2, 0]
        fy = blocks.y * inv[1, 1] + blocks.z * inv[2, 1]
        fz = blocks.z * inv[2, 2]
        return (fx, fy, fz), constant((1.0, 1.0, 1.0), fx.dtype, fx.device)
    return (blocks.x, blocks.y, blocks.z), box


def column_patch_geometry(spec):
    """The static layout of the column spread: (``PatchGeometry`` of the
    weights, per-column (x, y) offsets into the padded mesh, the padded
    mesh (Px, Py, Gz)), laid out as the JAX package's Pallas route lays
    them out."""
    gx, gy, gz = spec.pme_grid
    order = spec.pme_order
    ngx, ngy, _ = spec.cell_grid
    ex, ey, _ = spec.pme_slack
    orgx = _patch_origins(ngx, gx, order, ex)
    orgy = _patch_origins(ngy, gy, order, ey)
    wx = _patch_width(ngx, gx, order, ex)
    wy = _patch_width(ngy, gy, order, ey)
    wyp = -(-wy // 8) * 8          # Wy padded with zero weight rows
    geom = PatchGeometry((gx, gy, gz), order, tuple(orgx.tolist()),
                         tuple(orgy.tolist()), wx, wy, wyp)
    # the kernel's placement-origin convention: patch origins shifted by
    # order + slack, so that none is negative
    opx, opy = orgx + order + ex, orgy + order + ey
    n_col = ngx * ngy
    offsets = (tuple(int(opx[c // ngy]) for c in range(n_col)),
               tuple(int(opy[c % ngy]) for c in range(n_col)))
    return geom, offsets, (int(opx.max()) + wx, int(opy.max()) + wyp, gz)


def column_spread_inputs(blocks, ids, system):
    """The arguments of ``spread_columns`` for the cell blocks: (qwlxt,
    wlyt, wzt, zorg, offsets, pad_xy).  The weights come from
    ``ops.pme_weights.patch_weights`` (its plain version for a system on
    the plain route)."""
    geom, offsets, pad_xy = column_patch_geometry(system.spec)
    coords, lengths = _block_spread_coords(blocks, system.box)
    weights = patch_weights(*coords, blocks.q, ids, lengths, system.n_atoms,
                            geom, plain=not system.uses_kernels)
    return (*weights, offsets, pad_xy)


def mesh_energy(qpad, system) -> torch.Tensor:
    """E_rec of a padded charge mesh: fold the x/y ghost edges, rFFT, and
    contract |Q^|^2 with the influence function."""
    spec = system.spec
    gx, gy, _ = spec.pme_grid
    order = spec.pme_order
    qgrid = fold_padded_axis(
        fold_padded_axis(qpad, gx, order + spec.pme_slack[0], 0),
        gy, order + spec.pme_slack[1], 1)
    qhat = torch.fft.rfftn(qgrid)
    d = influence_function(spec.pme_grid, system.box, spec.alpha, order,
                           qpad.dtype)
    return torch.sum(d * (qhat.real * qhat.real + qhat.imag * qhat.imag))


def pme_cell_column_reciprocal_energy(blocks, ids, system) -> torch.Tensor:
    """SPME reciprocal energy through the cell-column spread (counterpart
    of the JAX package's ``pme_cell_pallas_reciprocal_energy``: same
    weights, patch offsets, folds and influence function).  A system on
    the plain route computes the weights and spreads with the plain
    versions on any device."""
    return mesh_energy(spread_columns(
        *column_spread_inputs(blocks, ids, system),
        plain=not system.uses_kernels), system)


# ---------------------------------------------------------------------------
# The halo route's distributed spread (parallel/halo.py)
# ---------------------------------------------------------------------------


def _spread_patches(qwlx, wly, wlz):
    """Per-cell patch contraction P[c, x, y, z] = sum_a qwlx[c, a, x]
    wly[c, a, y] wlz[c, a, z]: one batched product [C, Wx Wy, cap] @ [C,
    cap, Wz] in IEEE f32 on the card (the JAX package's "x3" precision)."""
    c, cap, wx = qwlx.shape
    wy = wly.shape[-1]
    a = (qwlx[..., :, None] * wly[..., None, :]).reshape(c, cap, wx * wy)
    return ieee_matmul(a.transpose(1, 2), wlz).reshape(c, wx, wy,
                                                      wlz.shape[-1])


@lru_cache(maxsize=None)
def _placement(origins, w: int, grid_n: int, dtype, device):
    """The 0/1 placement [n_cells * w, grid_n] of :func:`_fold_axis`."""
    t = np.zeros((len(origins), w, grid_n))
    for c, o in enumerate(origins):
        for j in range(w):
            t[c, j, (o + j) % grid_n] = 1.0
    return torch.as_tensor(t.reshape(-1, grid_n), device=device).to(dtype)


def _fold_axis(parts, origins, grid_n: int, patch_axis: int, cell_axis: int):
    """Overlap-add a cell-indexed patch axis onto the grid axis:
    out[..., g] = sum_{c, w} parts[.., c, .., w, ..] [g == (origins[c] + w)
    mod G], the other axes of ``parts`` first in their order, then the
    grid axis (the JAX package's ``dot_general`` against a static 0/1
    placement; exact in IEEE f32)."""
    c, w = parts.shape[cell_axis], parts.shape[patch_axis]
    rest = [a for a in range(parts.ndim) if a not in (cell_axis, patch_axis)]
    moved = parts.permute(*rest, cell_axis, patch_axis)
    keep = moved.shape[:-2]
    t = _placement(tuple(int(o) for o in origins), w, grid_n, parts.dtype,
                   device_key(parts.device))
    out = ieee_matmul(moved.reshape(-1, c * w), t)
    return out.reshape(keep + (grid_n,))


def _pad_to_cell_multiple(grid_n: int, n_cells: int) -> int:
    """Smallest mesh extent >= grid_n divisible by n_cells, preferring the
    first 5-smooth multiple within +25 % (a finer mesh only lowers the PME
    error)."""
    gm = -(-grid_n // n_cells) * n_cells
    cand = gm
    while cand <= gm + (gm + 3) // 4:
        if good_fft_size(cand) == cand:
            return cand
        cand += n_cells
    return gm


def pme_halo_mesh(spec, pad_y: bool = False) -> Tuple[int, int, int]:
    """SPME mesh of the halo route (``parallel/halo.py``): x padded up to a
    multiple of cell_grid[0], so the patch origins along x are a uniform
    pattern (c * stride) plus one per-rank slab offset; with ``pad_y`` (the
    2-D x-by-y decomposition) y the same; z, and otherwise y, keep the
    single-device mesh.  A cell-grid axis with a factor outside {2, 3, 5}
    takes the smallest multiple."""
    gmx = _pad_to_cell_multiple(spec.pme_grid[0], spec.cell_grid[0])
    gmy = (_pad_to_cell_multiple(spec.pme_grid[1], spec.cell_grid[1])
           if pad_y else spec.pme_grid[1])
    return (gmx, gmy, spec.pme_grid[2])


def pme_halo_local_mesh(g8, ids, system, dev: int,
                        mesh_grid: Tuple[int, int, int],
                        dev_y=None) -> torch.Tensor:
    """Partial SPME charge mesh [Gx, Gy, Gz] of one rank's slab blocks (the
    halo route's g8 layout [gxl, gy(l), gz, cap, 8]: x|y|z|q|hs|se|valid|0
    with wrapped coordinates); the sum over the ranks is the full charge
    mesh.  ``mesh_grid`` from :func:`pme_halo_mesh`; for the 2-D
    decomposition pass the rank's y index ``dev_y`` and a ``pad_y`` mesh.
    The spread weights are the cell route's B-spline taps on the same patch
    origins, in plain tensor ops (:func:`_cell_patch_weights`), so on a
    matching mesh the two routes agree to reduction-order rounding."""
    spec = system.spec
    dtype, device = g8.dtype, g8.device
    box = system.box
    order = spec.pme_order
    gxl, ngy, ngz, cap, _ = g8.shape
    gmx, gmy, gmz = mesh_grid
    ngx = spec.cell_grid[0]
    stride = gmx // ngx
    if stride * ngx != gmx:
        raise ValueError(f"mesh x {gmx} not divisible by cell grid {ngx}")
    local_y = ngy != spec.cell_grid[1]
    if local_y:
        stride_y = gmy // spec.cell_grid[1]
        if stride_y * spec.cell_grid[1] != gmy or dev_y is None:
            raise ValueError(
                "2-D halo spread needs pme_halo_mesh(spec, pad_y=True) "
                "and the rank's y index")
    qv = torch.where(ids < system.n_atoms, g8[..., 3], 0.0)
    ex, ey, ez = spec.pme_slack
    if box.ndim == 2:
        inv = box_inverse(box)
        cx_ = (g8[..., 0] * inv[0, 0] + g8[..., 1] * inv[1, 0]
               + g8[..., 2] * inv[2, 0])
        cy_ = g8[..., 1] * inv[1, 1] + g8[..., 2] * inv[2, 1]
        cz_ = g8[..., 2] * inv[2, 2]
        lx = ly = lz = 1.0
    else:
        cx_, cy_, cz_ = g8[..., 0], g8[..., 1], g8[..., 2]
        lx, ly, lz = box[0], box[1], box[2]

    def taps(u, origins, w, axis):
        shape = [1] * 5
        shape[axis] = len(origins)
        base = constant(origins.tolist(), dtype, device).reshape(shape)
        j = torch.arange(w, device=device).to(dtype)
        return bspline(u[..., None] - (base + j), order)

    # x: uniform local origins (c stride - order - ex) plus the slab offset
    wx = stride + order + 2 + 2 * ex
    orgx = dev * (gxl * stride) + np.arange(gxl) * stride - order - ex
    wlx = taps(cx_ * (gmx / lx), orgx, wx, 0)
    if local_y:
        wy = stride_y + order + 2 + 2 * ey
        orgy = (dev_y * (ngy * stride_y) + np.arange(ngy) * stride_y
                - order - ey)
        wly = taps(cy_ * (gmy / ly), orgy, wy, 1)
    else:
        wly, orgy, wy = _cell_patch_weights(cy_, ngy, gmy, ly, ey, 1, order,
                                            dtype)
    wlz, orgz, wz = _cell_patch_weights(cz_, ngz, gmz, lz, ez, 2, order,
                                        dtype)
    nc = gxl * ngy * ngz
    qwlx = (qv[..., None] * wlx).reshape(nc, cap, wx)
    patches = _spread_patches(qwlx, wly.reshape(nc, cap, wy),
                              wlz.reshape(nc, cap, wz))
    patches = patches.reshape(gxl, ngy, ngz, wx, wy, wz)
    b = _fold_axis(patches, orgz, gmz, patch_axis=5, cell_axis=2)
    if local_y:
        py = (ngy - 1) * stride_y + wy
        b = _fold_axis(b, np.arange(ngy) * stride_y, py, patch_axis=3,
                       cell_axis=1)
    else:
        b = _fold_axis(b, orgy, gmy, patch_axis=3, cell_axis=1)
    # x onto a local extent with relative origins (never wraps), then
    # wrap-folded onto the mesh and rotated into place
    px = (gxl - 1) * stride + wx
    loc = _fold_axis(b, np.arange(gxl) * stride, px, patch_axis=1,
                     cell_axis=0).permute(2, 1, 0)      # [Px, Py|Gy, Gz]
    out = loc.new_zeros((gmx,) + tuple(loc.shape[1:]))
    for k0 in range(0, px, gmx):
        seg = loc[k0:min(k0 + gmx, px)]
        out = out + torch.nn.functional.pad(
            seg, (0, 0, 0, 0, 0, gmx - seg.shape[0]))
    out = torch.roll(out, dev * (gxl * stride) - (order + ex), dims=0)
    if local_y:
        outy = out.new_zeros((gmx, gmy, gmz))
        for k0 in range(0, py, gmy):
            seg = out[:, k0:min(k0 + gmy, py)]
            outy = outy + torch.nn.functional.pad(
                seg, (0, 0, 0, gmy - seg.shape[1]))
        out = torch.roll(outy, dev_y * (ngy * stride_y) - (order + ey),
                         dims=1)
    return out
