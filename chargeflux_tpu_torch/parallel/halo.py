"""Spatial slab decomposition with halo exchange (torch counterpart of
``chargeflux_tpu.parallel.halo``).

The cell grid is cut into contiguous x-plane slabs, one per rank of the
group (or, by :func:`halo_decomp`, into x-by-y bricks).  Each rank

* bins only its slab's atoms (:func:`_local_bin`, the stable-sort binning
  of ``cells.rank_into_slots`` with an ownership mask),
* gathers its local cell blocks (``cells.gather_rows``: an
  inverse-permutation backward),
* receives one boundary plane of blocks from its +x ring neighbor
  (``shard.ppermute``; the half shell's dx is in {0, 1}, so only the high
  x halo is consumed); a 2-D brick first extends y both ways, then sends
  its y-extended x plane, so the corner cells ride the second stage.  The
  lattice shifts of a plane that crosses the periodic boundary are applied
  when it is exchanged;
* runs the concat tile walk on the extended slab: the 14 half-shell j
  slabs, x by slicing, y and z by rolls with static boundary image
  offsets, joined along the slot axis into one [cap, 14 cap] pair tile,
  under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``).

Forces come from autograd: ``shard.replicated_in`` on the positions sums
the ranks' partial forces, ``shard.sum_out`` assembles the energy, and the
exchange's backward sends the cotangents back.  A binning overflow on any
rank or a box whose cell planes fall below the cutoff poisons the energy
and every force to NaN, as the single-device cell route does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..cells import HALF_SHELL, gather_rows, wrap_offsets
from ..charges import effective_charges
from ..device import constant
from ..energy import dispersion_energy, resolve_recip_method
from ..ewald import reciprocal_energy_from_sf, self_energy, structure_factors
from ..ops.erfc import erf_over_r_eval, erfc_fast
from ..pairs import frac_coords, plane_widths
from ..system import box_widths
from ..units import ONE_4PI_EPS0
from .shard import (_axis, _ceil_to, _excl_chunk_energy, all_reduce_sum,
                    ppermute, replicated_in, sum_out)


def halo_decomp(system, ndev: int):
    """The (Dx, Dy) slab factorization for ``ndev`` ranks, or None if no
    halo decomposition fits: pure x-slabs (Dy = 1, one exchange per
    evaluation) where gx allows, else the 2-D x-by-y bricks (three
    exchanges) with the largest Dx whose complement divides gy."""
    spec = system.spec
    if not (spec.pbc and spec.direct_method == "cell"
            and spec.cell_grid is not None):
        return None
    gx, gy, _ = spec.cell_grid
    for dx in range(min(ndev, gx), 0, -1):
        if ndev % dx:
            continue
        dy = ndev // dx
        if gx % dx == 0 and dy <= gy and gy % dy == 0:
            return (dx, dy)
    return None


def halo_compatible(system, ndev: int) -> bool:
    return halo_decomp(system, ndev) is not None


def _boundary_crossing(axis_len: int, d: int) -> np.ndarray:
    """+1 where a roll by ``d`` crosses the high boundary, -1 across the
    low one, 0 inside ([axis_len])."""
    c = np.arange(axis_len)
    return np.where(c + d >= axis_len, 1.0, np.where(c + d < 0, -1.0, 0.0))


def _local_bin(positions, system, dev_x: int, dev_y: int, gxl: int,
               gyl: int):
    """Bin this rank's slab: (slots [gxl gyl gz, cap] int32, sentinel N;
    slot_of [N] int32, sentinel gxl gyl gz cap for atoms owned elsewhere;
    overflow, the owned atoms past a cell's capacity).  Within a cell the
    atoms sit in increasing id."""
    spec = system.spec
    cap = spec.cell_capacity
    gx, gy, gz = spec.cell_grid
    n = positions.shape[0]
    dev = positions.device
    frac = frac_coords(positions, system.box)
    frac = frac - torch.floor(frac)
    ci = (frac * constant(spec.cell_grid, positions.dtype, dev)).to(
        torch.int32)
    ci = torch.minimum(torch.clamp(ci, min=0),
                       constant((gx - 1, gy - 1, gz - 1), torch.int32, dev))
    lcx = ci[:, 0] - dev_x * gxl
    lcy = ci[:, 1] - dev_y * gyl
    owned = (lcx >= 0) & (lcx < gxl) & (lcy >= 0) & (lcy < gyl)
    n_local = gxl * gyl * gz
    cell = torch.where(owned, (lcx * gyl + lcy) * gz + ci[:, 2],
                       n_local).long()
    order = torch.sort(cell, stable=True).indices
    sorted_cell = cell[order]
    starts = torch.searchsorted(sorted_cell,
                                torch.arange(n_local + 1, device=dev))
    rank = torch.arange(n, device=dev) - starts[sorted_cell]
    mine = sorted_cell < n_local
    ok = (rank < cap) & mine
    sentinel = n_local * cap
    slot = torch.where(ok, sorted_cell * cap + rank, sentinel)
    slots = torch.full((sentinel + 1,), n, dtype=torch.int32, device=dev)
    slots[slot] = order.to(torch.int32)
    slot_of = torch.empty((n,), dtype=torch.int32, device=dev)
    slot_of[order] = slot.to(torch.int32)
    overflow = torch.sum(mine & ~ok).to(torch.int32)
    return slots[:sentinel].reshape(n_local, cap), slot_of, overflow


def make_halo_energy_fn(system, mesh, axis_name: str = "space",
                        decomp=None):
    """``energy(positions [N, 3], box=None) -> scalar``, alike on every
    rank of ``mesh``'s ``axis_name``: direct space on x-slabs (or x-by-y
    bricks, ``decomp=(Dx, Dy)``; default :func:`halo_decomp`) with halo
    exchange.  Differentiable in the positions.

    ``box`` (default the system's) may be a moved box, as the barostat
    makes: slab ownership is fractional, and a box whose cell plane
    spacing falls below the cutoff poisons the energy to NaN; the box
    gets no gradient.  The creation-time box must cover the grid, or this
    raises ``ValueError``."""
    group, rank, ndev = _axis(mesh, axis_name)
    if decomp is None:
        decomp = halo_decomp(system, ndev)
    spec = system.spec
    if (decomp is None or decomp[0] * decomp[1] != ndev
            or spec.cell_grid is None
            or spec.cell_grid[0] % decomp[0]
            or spec.cell_grid[1] % decomp[1]
            or not spec.pbc or spec.direct_method != "cell"):
        raise ValueError(
            f"halo path needs a pbc cell route whose cell grid factors "
            f"over {ndev} ranks (grid {spec.cell_grid}, decomp {decomp})")
    widths = np.asarray(box_widths(
        system.box.detach().cpu().double().numpy()))
    grid = np.asarray(spec.cell_grid)
    if float(np.min(widths / grid)) < spec.cutoff:
        raise ValueError(
            f"system box (plane widths {tuple(widths)}) does not cover "
            f"cell grid {tuple(grid)} at cutoff {spec.cutoff} — the "
            f"creation-time box must be valid; barostat moves at call time "
            f"are guarded (pass box= to the returned energy fn)")
    return _halo_local_energy_builder(system, group, rank, ndev,
                                      decomp=decomp)


def _halo_local_energy_builder(system, group, dev: int, ndev: int,
                               decomp=None):
    """This rank's halo energy program ``energy(positions, box=None)``."""
    spec = system.spec
    gx, gy, gz = spec.cell_grid
    cap = spec.cell_capacity
    ddx, ddy = decomp or halo_decomp(system, ndev)
    gxl, gyl = gx // ddx, gy // ddy
    dev_x, dev_y = dev // ddy, dev % ddy
    n = system.n_atoms
    n_pad = _ceil_to(n, ndev)
    row_chunk = n_pad // ndev
    e_chunk = _ceil_to(max(system.n_exclusions, 1), ndev) // ndev
    alpha, cutoff = spec.alpha, spec.cutoff
    rows = slice(dev * row_chunk, (dev + 1) * row_chunk)
    perm_hi_y = [(x * ddy + y, x * ddy + (y - 1) % ddy)
                 for x in range(ddx) for y in range(ddy)]
    perm_lo_y = [(x * ddy + y, x * ddy + (y + 1) % ddy)
                 for x in range(ddx) for y in range(ddy)]
    ring_x = [(x * ddy + y, ((x - 1) % ddx) * ddy + y)
              for x in range(ddx) for y in range(ddy)]

    def offs_yz(box, dy_, dz_, dtype, device):
        # y/z wrap offsets per coordinate (x: the ext slicing and the halo
        # shift); with ddy > 1 only z (y wraps were applied at exchange)
        cz = constant(_boundary_crossing(gz, dz_).tolist(), dtype,
                      device).reshape(1, 1, gz, 1)
        if ddy > 1:
            cy = torch.zeros((), dtype=dtype, device=device)
        else:
            cy = constant(_boundary_crossing(gy, dy_).tolist(), dtype,
                          device).reshape(1, gy, 1, 1)
        if box.ndim == 2:
            return (cy * box[1, 0] + cz * box[2, 0],
                    cy * box[1, 1] + cz * box[2, 1], cz * box[2, 2])
        return (torch.zeros((), dtype=dtype, device=device), cy * box[1],
                cz * box[2])

    def tile_energy(ext, ids, box):
        dtype, device = ext.dtype, ext.device
        if ddy > 1:
            g8 = ext[:gxl, 1:1 + gyl]
        else:
            g8 = ext[:gxl]
        valid_i = ids < n
        xi = [g8[..., k] for k in range(3)]
        qi, hi_, si = g8[..., 3], g8[..., 4], g8[..., 5]
        slabs = []
        for (dx_, dy_, dz_) in HALF_SHELL:
            if ddy > 1:
                sl = torch.roll(ext[dx_:dx_ + gxl, 1 + dy_:1 + dy_ + gyl],
                                -dz_, 2)
            else:
                sl = torch.roll(ext[dx_:dx_ + gxl], (-dy_, -dz_), (1, 2))
            ox, oy, oz = offs_yz(box, dy_, dz_, dtype, device)
            slabs.append((sl[..., 0] + ox, sl[..., 1] + oy, sl[..., 2] + oz,
                          sl[..., 3], sl[..., 4], sl[..., 5],
                          sl[..., 6] > 0.5))

        def cat(k):
            return torch.cat([s[k] for s in slabs], dim=-1)

        xj = [cat(0), cat(1), cat(2)]
        qj, hj, sj, mj = cat(3), cat(4), cat(5), cat(6)
        # self slab (first cap columns): pairs ordered by global atom id;
        # the other 13 slabs take every in-range pair once
        ordered = torch.cat(
            [ids[..., :, None] < ids[..., None, :],
             torch.ones(ids.shape[:-1] + (cap, 13 * cap), dtype=torch.bool,
                        device=device)], dim=-1)
        r2 = 0.0
        for k in range(3):
            dk = xi[k][..., :, None] - xj[k][..., None, :]
            r2 = r2 + dk * dk
        mask = (valid_i[..., :, None] & mj[..., None, :]
                & (r2 < cutoff * cutoff) & ordered)
        r2s = torch.where(mask, r2, 1.0)
        inv_r = torch.rsqrt(r2s)
        qq = ONE_4PI_EPS0 * (qi[..., :, None] * qj[..., None, :])
        if dtype == torch.float64:
            coul = qq * inv_r * erfc_fast(alpha * (r2s * inv_r))
        else:
            # the f32 walk's exp- and divide-free form (ops/erfc.py)
            coul = qq * (inv_r - erf_over_r_eval(r2s, alpha, cutoff))
        sig2 = ((hi_[..., :, None] + hj[..., None, :]) * inv_r) ** 2
        sig6 = sig2 * sig2 * sig2
        lj = (si[..., :, None] * sj[..., None, :]) * sig6 * (sig6 - 1.0)
        return torch.sum(torch.where(mask, coul + lj, 0.0))

    def local_energy(positions, box=None):
        positions = replicated_in(positions, group)
        dtype, device = positions.dtype, positions.device
        sysb = system if box is None else system.with_box(
            box.detach() if torch.is_tensor(box) else box)
        box = sysb.box
        use_pme = (spec.pme_grid is not None
                   and resolve_recip_method(spec, dtype, device) == "pme")
        q = effective_charges(positions, sysb)
        slots, slot_of, overflow = _local_bin(positions.detach(), sysb,
                                              dev_x, dev_y, gxl, gyl)
        # local blockify (row gather forward, inverse row gather backward)
        pos_w = positions - wrap_offsets(positions.detach(), box)
        table = torch.cat(
            [pos_w, q[:, None], 0.5 * system.sigma.to(dtype)[:, None],
             2.0 * torch.sqrt(system.epsilon.to(dtype))[:, None],
             positions.new_ones((n, 1)), positions.new_zeros((n, 1))],
            dim=1)
        table = torch.cat([table, positions.new_zeros((1, 8))])
        g8 = gather_rows(table, slots.reshape(-1), slot_of).reshape(
            gxl, gyl, gz, cap, 8)

        # halo exchange: y both ways first (2-D), then the (y-extended)
        # x = 0 plane back along the x ring; the global-wrap lattice shift
        # of each plane is applied here, on valid slots only
        if box.ndim == 2:
            lx, by0, by1 = box[0, 0], box[1, 0], box[1, 1]
        else:
            lx, by0, by1 = box[0], torch.zeros((), dtype=dtype,
                                               device=device), box[1]
        if ddy > 1:
            hi_y = ppermute(g8[:, 0], group, dev, perm_hi_y, tag=1)
            lo_y = ppermute(g8[:, gyl - 1], group, dev, perm_lo_y, tag=2)
            s_hi = 1.0 if dev_y == ddy - 1 else 0.0
            s_lo = -1.0 if dev_y == 0 else 0.0

            def y_shift(plane, s):
                valid = plane[..., 6]
                return torch.cat([plane[..., 0:1] + (s * by0 * valid)[..., None],
                                  plane[..., 1:2] + (s * by1 * valid)[..., None],
                                  plane[..., 2:]], dim=-1)

            ext_y = torch.cat([y_shift(lo_y, s_lo)[:, None], g8,
                               y_shift(hi_y, s_hi)[:, None]], dim=1)
        else:
            ext_y = g8
        halo_hi = ppermute(ext_y[0], group, dev, ring_x, tag=3)
        hi_shift = 1.0 if dev_x == ddx - 1 else 0.0
        halo_hi = torch.cat([halo_hi[..., 0:1]
                             + (hi_shift * lx * halo_hi[..., 6])[..., None],
                             halo_hi[..., 1:]], dim=-1)
        ext = torch.cat([ext_y, halo_hi[None]], dim=0)
        ids = slots.reshape(gxl, gyl, gz, cap)
        e_dir = checkpoint(tile_energy, ext, ids, box, use_reentrant=False)

        # overflow on any rank, or a moved box below the cutoff: NaN
        overflow_tot = all_reduce_sum(overflow, group)
        edge = plane_widths(box) / constant(spec.cell_grid, dtype, device)
        bad = (overflow_tot > 0) | torch.any(edge < cutoff)
        e_dir = e_dir + torch.sum(positions) * torch.where(
            bad, torch.nan, 0.0).to(dtype)

        e_excl = _excl_chunk_energy(positions, q, sysb, dev * e_chunk,
                                    e_chunk)
        q_pad = torch.cat([q, q.new_zeros((n_pad - n,))])
        e_self = self_energy(q_pad[rows], alpha)
        if use_pme:
            from ..pme import (influence_function, pme_halo_local_mesh,
                               pme_halo_mesh)

            mesh_grid = pme_halo_mesh(spec, pad_y=ddy > 1)
            q_mesh = sum_out(pme_halo_local_mesh(
                g8, ids, sysb, dev_x, mesh_grid,
                dev_y=dev_y if ddy > 1 else None), group)
            qhat = torch.fft.rfftn(q_mesh)
            d = influence_function(mesh_grid, box, alpha, spec.pme_order,
                                   dtype)
            e_rec = torch.sum(d * (qhat.real * qhat.real
                                   + qhat.imag * qhat.imag))
        else:
            x_pad = torch.cat([positions, positions.new_zeros((n_pad - n,
                                                               3))])
            sc, ss = structure_factors(x_pad[rows], q_pad[rows], box,
                                       spec.kmax, method="xla")
            e_rec = reciprocal_energy_from_sf(sum_out(sc, group),
                                              sum_out(ss, group), box,
                                              alpha, spec.kmax)
        if spec.tail_coeff is not None:
            # replicated (outside the sum), like e_rec: added once
            e_rec = e_rec + dispersion_energy(box, spec, dtype)
        return e_rec + sum_out(e_dir + e_excl + e_self, group)

    return local_energy
