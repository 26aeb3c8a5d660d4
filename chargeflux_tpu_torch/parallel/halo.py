"""Spatial slab decomposition with halo exchange (torch counterpart of
``chargeflux_tpu.parallel.halo``).

The cell grid is cut into contiguous x-plane slabs, one per rank of the
group (or, by :func:`halo_decomp`, into x-by-y bricks).  Each rank

* bins only its slab's atoms (:func:`_local_bin`: ``cells.rank_into_slots``
  with the atoms owned elsewhere binned nowhere),
* gathers its local cell blocks (``cells.gather_rows``: an
  inverse-permutation backward),
* receives the boundary planes of blocks it walks into: the -x plane from
  its -x ring neighbor and the +x plane from its +x one (``shard.ppermute``);
  a 2-D brick first extends y both ways, then exchanges its y-extended x
  planes, so the corner cells ride the second stage.  The lattice shifts of
  a plane that crosses the periodic boundary are applied when it is
  exchanged;
* walks the full 27-cell shell of each owned cell over the extended slab,
  owned blocks first and halo cells after them, through the tables of
  ``cells.slab_shell_tables``: the walk kernel's slab form
  (``ops.direct_walk.direct_walk_slab``) for f32 on the card, its plain
  version (a gather through the same tables) on the CPU and in f64.  The
  JAX package walks a half shell with its concat tile under
  ``jax.checkpoint``; both sum every in-cutoff pair once.

Forces.  The walk returns half of each owned cell's full-shell sum, so a
pair across a slab face counts half on each of its two ranks and
``shard.sum_out`` assembles the exact energy.  It also returns the whole
dE/dx and dE/dq of every owned atom, over all of its pairs, halo partners
included.  :class:`_SlabDirectEnergy` hands those to the owned blocks and
nothing to the halo planes, which are exchanged detached (no backward
exchange).  This is not the derivative of one rank's share, but the sum
over the ranks is the derivative of the sum: every atom is owned by one
rank, which gives it its whole direct-space gradient, and
``shard.replicated_in`` on the positions sums the ranks' partial forces.
The rest (flux charges, exclusions, self, the reciprocal term from the
all-reduced structure factors or charge mesh) differentiates through
autograd as before.  A binning overflow on any rank or a box whose cell
planes fall below the cutoff poisons the energy and every force to NaN,
as the single-device cell route does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cells
from ..cells import gather_rows, wrap_offsets
from ..charges import effective_charges
from ..device import constant
from ..energy import dispersion_energy, resolve_recip_method
from ..ewald import reciprocal_energy_from_sf, self_energy, structure_factors
from ..ops.direct_walk import direct_walk_slab, direct_walk_slab_plain
from ..pairs import plane_widths
from ..system import box_widths
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


def slab_cell_ids(positions, system, dev_x: int, dev_y: int, gxl: int,
                  gyl: int):
    """(cell ids [N] int32, n_local) of the slab of the rank at (dev_x,
    dev_y), [gxl, gyl, gz] cells: an atom's cell in the slab, or n_local
    for an atom another rank owns (``cells.rank_into_slots`` bins it
    nowhere)."""
    gz = system.spec.cell_grid[2]
    ci = cells.cell_ids(positions, system.box, system.spec.cell_grid)
    lcx = ci[:, 0] - dev_x * gxl
    lcy = ci[:, 1] - dev_y * gyl
    owned = (lcx >= 0) & (lcx < gxl) & (lcy >= 0) & (lcy < gyl)
    n_local = gxl * gyl * gz
    return torch.where(owned, (lcx * gyl + lcy) * gz + ci[:, 2],
                       n_local), n_local


def _local_bin(positions, system, dev_x: int, dev_y: int, gxl: int,
               gyl: int):
    """Bin this rank's slab: (slots [gxl gyl gz, cap] int32, sentinel N;
    slot_of [N] int32, sentinel gxl gyl gz cap for atoms owned elsewhere;
    overflow, the owned atoms past a cell's capacity).  Within a cell the
    atoms sit in increasing id (the kernel on the card, the plain sort on
    the CPU and on the plain route)."""
    cell, n_local = slab_cell_ids(positions, system, dev_x, dev_y, gxl, gyl)
    return cells.rank_into_slots(cell, n_local, system.spec.cell_capacity,
                                 plain=not system.uses_kernels)


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


class _SlabDirectEnergy(torch.autograd.Function):
    """This rank's share of the direct-space energy: the slab walk over the
    extended slab (the owned blocks ``own8`` [n_own, cap, 8], then the
    detached halo blocks ``halo8``).  The backward hands the walk's dE/dx
    and dE/dq of the owned atoms to ``own8``'s x, y, z and q columns and
    nothing to the halo (see the module docstring: summed over the ranks,
    that is the gradient of the summed energy)."""

    @staticmethod
    def forward(ctx, own8, halo8, ids, box, n_atoms, alpha, cutoff, grid,
                decomp, plain):
        ext = torch.cat([own8.detach(), halo8])
        cols = [ext[..., k].contiguous() for k in range(6)]
        walk = direct_walk_slab_plain if plain else direct_walk_slab
        e, g, dq = walk(*cols, ids, box, n_atoms, alpha, cutoff, grid,
                        decomp)
        ctx.save_for_backward(g, dq)
        return e

    @staticmethod
    def backward(ctx, g_out):
        g, dq = ctx.saved_tensors
        ct = torch.cat([g.permute(1, 2, 0), dq[..., None],
                        dq.new_zeros(dq.shape + (4,))], dim=-1)
        return (g_out * ct,) + (None,) * 9


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
    n_own = gxl * gyl * gz
    n_pad = _ceil_to(n, ndev)
    row_chunk = n_pad // ndev
    e_chunk = _ceil_to(max(system.n_exclusions, 1), ndev) // ndev
    alpha, cutoff = spec.alpha, spec.cutoff
    rows = slice(dev * row_chunk, (dev + 1) * row_chunk)
    # (source, destination) pairs: the y rows go to the -y and +y
    # neighbors, the x planes to the -x and +x neighbors
    perm_hi_y = [(x * ddy + y, x * ddy + (y - 1) % ddy)
                 for x in range(ddx) for y in range(ddy)]
    perm_lo_y = [(x * ddy + y, x * ddy + (y + 1) % ddy)
                 for x in range(ddx) for y in range(ddy)]
    perm_hi_x = [(x * ddy + y, ((x - 1) % ddx) * ddy + y)
                 for x in range(ddx) for y in range(ddy)]
    perm_lo_x = [(x * ddy + y, ((x + 1) % ddx) * ddy + y)
                 for x in range(ddx) for y in range(ddy)]

    def shifted(plane, s, row):
        # the plane's valid slots moved by s times the lattice row ``row``
        # (a [3] tensor: (L_x, 0, 0), or a triclinic row), sentinels kept
        return torch.cat([plane[..., :3] + s * row * plane[..., 6:7],
                          plane[..., 3:]], dim=-1)

    def exchange(plane, perm, tag, s, row):
        # detached: the walk's backward sends nothing back
        out = ppermute(plane.detach(), group, dev, perm, tag=tag)
        return shifted(out, s, row) if s else out

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

        # halo exchange, every rank in the same order: y both ways first
        # (2-D), then the (y-extended) x planes; the global-wrap lattice
        # shift of each plane is applied here, on valid slots only
        if box.ndim == 2:
            row_x, row_y = box[0], box[1]
        else:
            zero = box.new_zeros(())
            row_x = torch.stack([box[0], zero, zero])
            row_y = torch.stack([zero, box[1], zero])
        halo = []
        if ddy > 1:
            hi_y = exchange(g8[:, 0], perm_hi_y, 1,
                            1.0 if dev_y == ddy - 1 else 0.0, row_y)
            lo_y = exchange(g8[:, gyl - 1], perm_lo_y, 2,
                            -1.0 if dev_y == 0 else 0.0, row_y)
            ext_y = torch.cat([lo_y[:, None], g8.detach(), hi_y[:, None]],
                              dim=1)
            halo += [lo_y, hi_y]
        else:
            ext_y = g8
        halo.append(exchange(ext_y[gxl - 1], perm_lo_x, 3,
                             -1.0 if dev_x == 0 else 0.0, row_x))
        halo.append(exchange(ext_y[0], perm_hi_x, 4,
                             1.0 if dev_x == ddx - 1 else 0.0, row_x))
        halo8 = torch.cat([h.reshape(-1, cap, 8) for h in halo])
        ids = slots.reshape(gxl, gyl, gz, cap)
        # a halo atom's id only says whether its slot holds one
        ids_ext = torch.cat([slots, torch.where(
            halo8[..., 6] > 0.5, 0, n).to(torch.int32)]).contiguous()
        e_dir = _SlabDirectEnergy.apply(
            g8.reshape(n_own, cap, 8), halo8, ids_ext, box, n, alpha, cutoff,
            (gx, gy, gz), (ddx, ddy), not system.uses_kernels)

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
