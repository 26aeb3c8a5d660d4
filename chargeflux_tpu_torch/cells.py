"""Fixed-capacity cell list for the periodic direct-space sum (torch
counterpart of ``chargeflux_tpu.cells``).

* Binning (:func:`build_cell_list_full`) ranks each atom in its cell by
  atom id (``ops/cell_bin.py``: a counting-sort kernel on the card, a
  stable sort in its plain version): within a cell, atoms sit in
  increasing atom id, which is the slot layout of the JAX package's
  one-hot ranking, so the two agree slot for slot whenever no cell
  overflows.  Overflow drops atoms past the capacity and is counted (the
  energy path NaN-poisons on it).
* :func:`blockify` gathers the atom table into cell-major blocks with
  :class:`_GatherRows`, whose backward is the inverse-permutation gather
  (deterministic, no scatter-add).
* :func:`direct_energy_on_blocks` is an autograd function around the fused
  walk (``ops/direct_walk.py``): the forward computes E, dE/dx and dE/dq in
  one pass, the backward is a scale.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .device import constant
from .ops.cell_bin import cell_bin, cell_bin_plain
from .ops.direct_walk import direct_walk, direct_walk_plain
from .pairs import frac_coords, lattice_cart

# Half-shell shift set: (0,0,0) self + 13 lexicographically positive shifts.
HALF_SHELL = [(0, 0, 0)] + [
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) > (0, 0, 0)
]


def wrap_offsets(positions: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Lattice translation [N, 3] that wraps each position into the primary
    cell (``positions - wrap_offsets`` has fractional coordinates in
    [0, 1)): ``box * floor(x / box)`` for an orthorhombic box, ``floor(f)
    @ B`` for a [3, 3] lattice (expanded elementwise)."""
    if box.ndim == 2:
        return lattice_cart(torch.floor(frac_coords(positions, box)), box)
    return box * torch.floor(positions / box)


def _cell_coords(grid):
    gx, gy, gz = grid
    ids = np.arange(gx * gy * gz)
    return ids // (gy * gz), (ids // gz) % gy, ids % gz


def neighbor_cell_table(grid) -> np.ndarray:
    """Static [n_cells, 27] table of wrapped neighbor cell ids (full
    shell, shifts in (dx, dy, dz) lexicographic order)."""
    gx, gy, gz = grid
    cx, cy, cz = _cell_coords(grid)
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                out.append((((cx + dx) % gx) * gy + (cy + dy) % gy) * gz
                           + (cz + dz) % gz)
    return np.stack(out, axis=1).astype(np.int32)


def full_shell_tables(grid):
    """(nbr [C, 27] int32, image_offsets [C, 27, 3] int8): the
    :func:`neighbor_cell_table` and, per entry, the periodic image offset
    of the neighbor cell in lattice units (the kernel adds ``im[a] * L_a``,
    or for a [3, 3] box the lattice rows ``im[a] * B[a]``) — what the
    direct-walk kernel reads."""
    gx, gy, gz = grid
    cx, cy, cz = _cell_coords(grid)
    off = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                off.append(np.stack([(cx + dx) // gx, (cy + dy) // gy,
                                     (cz + dz) // gz], axis=-1))
    return neighbor_cell_table(grid), np.stack(off, axis=1).astype(np.int8)


def slab_halo_cells(grid, decomp) -> int:
    """Halo cells of one rank's extended slab (:func:`slab_shell_tables`):
    the -x and +x planes [gy, gz] of an x slab; for a brick the -y and +y
    rows [gxl, gz] and the -x and +x planes extended in y [gyl + 2, gz]."""
    gx, gy, gz = grid
    ddx, ddy = decomp
    if ddy == 1:
        return 2 * gy * gz
    return 2 * (gx // ddx) * gz + 2 * (gy // ddy + 2) * gz


def slab_shell_tables(grid, decomp):
    """(nbr [n_own, 27] int32, image_offsets [n_own, 27, 3] int8): the
    :func:`full_shell_tables` of one rank of the halo route's (Dx, Dy)
    decomposition of the global cell ``grid``, over its extended slab;
    alike on every rank (what differs between ranks, the lattice shifts
    at the global boundary, rides the exchanged planes).  The extended
    slab holds the owned blocks (lx, ly, z) of the rank's
    [gx / Dx, gy / Dy, gz] slab first, then the halo cells in the
    order :func:`slab_halo_cells` lists them (a plane or row in (y, z) or
    (x, z) order; the y-extended planes run y = -1 .. gyl).  The lattice
    shifts of a halo plane that crosses the periodic boundary in x (and,
    for a brick, in y) are applied when it is exchanged, so the image
    offsets carry only the rest: z wraps, and the y wraps of an x slab."""
    gx, gy, gz = grid
    ddx, ddy = decomp
    gxl, gyl = gx // ddx, gy // ddy
    n_own = gxl * gyl * gz
    ids = np.arange(n_own)
    lx, ly, lz = ids // (gyl * gz), (ids // gz) % gyl, ids % gz
    nbr, off = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                ex, ey, ez = lx + dx, ly + dy, (lz + dz) % gz
                cz = (lz + dz) // gz
                if ddy == 1:
                    cy, ey = ey // gy, ey % gy
                    cell = np.where(
                        ex < 0, n_own + ey * gz + ez,
                        np.where(ex >= gxl, n_own + (gy + ey) * gz + ez,
                                 (ex * gyl + ey) * gz + ez))
                else:
                    cy = np.zeros_like(ey)
                    x_planes = n_own + 2 * gxl * gz
                    inside_x = (ex >= 0) & (ex < gxl)
                    cell = np.where(
                        ex < 0, x_planes + (ey + 1) * gz + ez,
                        np.where(ex >= gxl,
                                 x_planes + (gyl + 2 + ey + 1) * gz + ez,
                                 (ex * gyl + ey) * gz + ez))
                    cell = np.where(inside_x & (ey < 0),
                                    n_own + ex * gz + ez, cell)
                    cell = np.where(inside_x & (ey >= gyl),
                                    n_own + (gxl + ex) * gz + ez, cell)
                nbr.append(cell)
                off.append(np.stack([np.zeros_like(cz), cy, cz], axis=-1))
    return (np.stack(nbr, axis=1).astype(np.int32),
            np.stack(off, axis=1).astype(np.int8))


def half_shell_tables(grid):
    """(nbr_ids [C, 14] int32, image_offsets [C, 14, 3] int8) for the
    half-shell traversal; shift 0 is the self cell."""
    gx, gy, gz = grid
    cx, cy, cz = _cell_coords(grid)
    nbr, off = [], []
    for (dx, dy, dz) in HALF_SHELL:
        nx, ny, nz = cx + dx, cy + dy, cz + dz
        nbr.append(((nx % gx) * gy + ny % gy) * gz + nz % gz)
        off.append(np.stack([nx // gx, ny // gy, nz // gz], axis=-1))
    return (np.stack(nbr, axis=1).astype(np.int32),
            np.stack(off, axis=1).astype(np.int8))


def rank_into_slots(cell: torch.Tensor, n_cells: int, capacity: int,
                    plain: bool = False):
    """Place atom i into a slot of cell ``cell[i]`` (rank = number of
    lower-id atoms in the same cell; an id of ``n_cells`` bins the atom
    nowhere) through ``ops.cell_bin``: the kernel on the card, the plain
    stable sort on the CPU or with ``plain`` (the plain route).  No step
    reads a device value on the host, so a CUDA graph can capture it.

    Returns (slots [n_cells, capacity] int32 atom ids, sentinel N;
    slot_of [N] int32 flat slot per atom, sentinel n_cells*capacity;
    overflow int32 count of atoms dropped past the capacity).
    """
    return (cell_bin_plain if plain else cell_bin)(cell, n_cells, capacity)


def cell_ids(positions: torch.Tensor, box: torch.Tensor, grid) -> torch.Tensor:
    """[N, 3] int32 cell coordinates of ``positions``, computed with the JAX
    package's float ops (fractional coordinate, wrap, scale, truncate,
    clip)."""
    gx, gy, gz = grid
    dev = positions.device
    frac = frac_coords(positions, box)
    frac = frac - torch.floor(frac)
    ci = (frac * constant(grid, positions.dtype, dev)).to(torch.int32)
    return torch.minimum(torch.clamp(ci, min=0),
                         constant((gx - 1, gy - 1, gz - 1), torch.int32, dev))


@torch.no_grad()
def build_cell_list_full(positions: torch.Tensor, box: torch.Tensor, grid,
                         capacity: int, plain: bool = False):
    """Bin atoms into cells.  Returns (slots [n_cells, capacity] int32 with
    sentinel N, inv_slot [N] int32 with sentinel n_cells*capacity, overflow
    [scalar int32]).  ``plain`` takes the plain binning on the card (the
    caller's system on the plain route)."""
    gx, gy, gz = grid
    ci = cell_ids(positions, box, grid)
    cell = (ci[:, 0] * gy + ci[:, 1]) * gz + ci[:, 2]
    return rank_into_slots(cell, gx * gy * gz, capacity, plain=plain)


def build_cell_list(positions: torch.Tensor, box: torch.Tensor, grid,
                    capacity: int, plain: bool = False):
    """Bin atoms into cells: (slots [n_cells, capacity] int32 with sentinel
    N, overflow count [scalar int32]).  Overflow drops atoms; callers
    check the count (see :func:`validate_cell_list`)."""
    slots, _, overflow = build_cell_list_full(positions, box, grid, capacity,
                                              plain=plain)
    return slots, overflow


def validate_cell_list(positions, system) -> int:
    """Host-side overflow check: the count of atoms the system's binning
    drops at ``positions`` (0, or rebuild with a larger
    ``cell_capacity``).  Reads the count back to the host."""
    spec = system.spec
    x = torch.as_tensor(positions, device=system.box.device).to(
        system.box.dtype)
    _, overflow = build_cell_list(x, system.box, spec.cell_grid,
                                  spec.cell_capacity,
                                  plain=not system.uses_kernels)
    return int(overflow)


def suggest_capacity(positions, box, grid, margin: float = 1.25,
                     multiple: int = 8) -> int:
    """Capacity from an actual configuration: max cell occupancy * margin,
    rounded up to ``multiple`` (NumPy, host side)."""
    positions = np.asarray(positions, dtype=np.float64)
    box = np.asarray(box, dtype=np.float64)
    grid = np.asarray(grid)
    frac = positions @ np.linalg.inv(box) if box.ndim == 2 else positions / box
    frac -= np.floor(frac)
    ci = np.clip((frac * grid).astype(np.int64), 0, grid - 1)
    cid = (ci[:, 0] * grid[1] + ci[:, 1]) * grid[2] + ci[:, 2]
    peak = int(np.bincount(cid, minlength=int(np.prod(grid))).max())
    cap = int(math.ceil(peak * margin))
    return ((cap + multiple - 1) // multiple) * multiple


class CellBlocks(NamedTuple):
    """Cell-major block arrays, all [gx, gy, gz, cap] and contiguous:
    wrapped coordinates, effective charges, half-sigma and 2 sqrt(eps)
    LJ prefactors; empty slots hold zeros."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    q: torch.Tensor
    hs: torch.Tensor
    se: torch.Tensor


class _GatherRows(torch.autograd.Function):
    """Row gather ``table[flat]`` whose backward gathers the cotangent rows
    by the inverse permutation ``inv`` (row -> output position, sentinel
    >= len(flat)) instead of scatter-adding; valid because ``flat`` is a
    permutation of the non-pad rows."""

    @staticmethod
    def forward(ctx, table, flat, inv):
        ctx.save_for_backward(inv)
        ctx.nrow = table.shape[0]
        return table[flat]

    @staticmethod
    def backward(ctx, ct):
        (inv,) = ctx.saved_tensors
        s = ct.shape[0]
        ctp = torch.cat([ct, ct.new_zeros((1, ct.shape[1]))])
        pad = torch.full((ctx.nrow - inv.shape[0],), s, dtype=inv.dtype,
                         device=inv.device)
        idx = torch.clamp(torch.cat([inv, pad]), max=s)
        return ctp[idx], None, None


def gather_rows(table, flat, inv):
    """``table[flat]`` with the inverse-permutation backward."""
    return _GatherRows.apply(table, flat, inv)


def blockify(positions: torch.Tensor, q: torch.Tensor, system, slots,
             inv_slot, wrap=None) -> CellBlocks:
    """Gather the padded [N+1, 8] atom table (x y z q hs se 0 0) into cell
    blocks.  With neighbor-state reuse, ``wrap`` is the offset frozen at
    the rebuild, so coordinates stay continuous across the boundary."""
    spec = system.spec
    grid4 = tuple(spec.cell_grid) + (spec.cell_capacity,)
    n = positions.shape[0]
    dtype = positions.dtype
    if wrap is None:
        wrap = wrap_offsets(positions.detach(), system.box)
    pos_w = positions - wrap
    table = torch.cat(
        [pos_w, q[:, None], 0.5 * system.sigma.to(dtype)[:, None],
         2.0 * torch.sqrt(system.epsilon.to(dtype))[:, None],
         positions.new_zeros((n, 2))], dim=1)
    table = torch.cat([table, positions.new_zeros((1, 8))], dim=0)
    g4 = gather_rows(table, slots.reshape(-1), inv_slot).reshape(grid4 + (8,))
    return CellBlocks(*(g4[..., k].contiguous() for k in range(6)))


class _DirectEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, z, q, hs, se, ids, box, n_atoms, alpha, cutoff,
                plain):
        walk = direct_walk_plain if plain else direct_walk
        e, g, dq = walk(x, y, z, q, hs, se, ids, box, n_atoms, alpha, cutoff)
        ctx.save_for_backward(g, dq)
        return e

    @staticmethod
    def backward(ctx, g_out):
        g, dq = ctx.saved_tensors
        return (g_out * g[0], g_out * g[1], g_out * g[2], g_out * dq,
                None, None, None, None, None, None, None, None)


def direct_energy_on_blocks(blocks: CellBlocks, ids: torch.Tensor,
                            system) -> torch.Tensor:
    """Direct-space erfc Coulomb + LJ over every in-cutoff pair of the
    blocks (excluded pairs included; energy.py subtracts them).  The fused
    walk gives dE/dx and dE/dq in the forward pass; LJ prefactors get no
    gradient.  The plain route runs the plain walk on any device."""
    spec = system.spec
    ids = ids.to(torch.int32).contiguous()
    return _DirectEnergy.apply(blocks.x, blocks.y, blocks.z, blocks.q,
                               blocks.hs, blocks.se, ids, system.box,
                               system.n_atoms, spec.alpha, spec.cutoff,
                               not system.uses_kernels)
