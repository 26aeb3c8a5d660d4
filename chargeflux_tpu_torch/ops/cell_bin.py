"""Cell binning: the CUDA kernel wrapper and its plain-PyTorch version.

Counterpart of ``chargeflux_tpu.cells.rank_into_slots`` (and of the
ownership-masked copy in the JAX package's halo route).  Both versions take
the atoms' cell ids (ints in [0, n_cells]; the id ``n_cells`` bins an atom
nowhere, as the halo route does for the atoms another rank owns) and
return, bit for bit alike,

* ``slots`` [n_cells, capacity] int32: the atom ids of each cell, in
  increasing id, sentinel N (the number of atoms given);
* ``slot_of`` [N] int32: each atom's flat slot, sentinel n_cells * capacity
  for an atom binned nowhere or dropped;
* ``overflow``, an int32 scalar on the device: the atoms dropped past a
  cell's capacity (atoms binned nowhere are not counted).

The plain version is a stable sort on the cell id with the cell starts
taken by ``searchsorted``; the kernel (``csrc/cell_bin.cu``) is a
deterministic counting sort in three launches.  Neither reads a device
value on the host, so both capture into a CUDA graph.

:func:`cell_bin` runs the plain version on a CPU tensor and the kernel on a
CUDA tensor, or raises; a caller on the plain route (an f64 system on the
card) calls :func:`cell_bin_plain` itself.
"""

from __future__ import annotations

import torch

from . import native
from .native import INT, INT_OUT, PTR

#: Kernel launches since the last reset (one per call: the count, scan and
#: rank passes of one binning).
LAUNCHES = {"cell_bin": 0}
#: The kernel each counts, as a profiler trace names it (its last pass).
SYMBOLS = {"cell_bin": "cell_bin_rank_kernel"}
native.declare(cf_cell_bin_limits=[INT_OUT] * 2,
               cf_cell_bin=[PTR] + [INT] * 3 + [PTR] * 5)


def cell_bin_plain(cell: torch.Tensor, n_cells: int, capacity: int):
    """The binning in plain tensor ops (any device): (slots, slot_of,
    overflow) of ``cell`` [N] ints in [0, n_cells]."""
    n = cell.shape[0]
    dev = cell.device
    sentinel = n_cells * capacity
    cell = cell.long()
    order = torch.sort(cell, stable=True).indices
    sorted_cell = cell[order]
    # each cell's first sorted position, from the sorted ids themselves
    # (torch.bincount on the card reads the ids' range back to the host)
    starts = torch.searchsorted(sorted_cell,
                                torch.arange(n_cells + 1, device=dev))
    rank = torch.arange(n, device=dev) - starts[sorted_cell]
    mine = sorted_cell < n_cells
    ok = (rank < capacity) & mine
    slot = torch.where(ok, sorted_cell * capacity + rank, sentinel)
    # dropped atoms all write the extra sentinel entry, which is cut off
    slots = torch.full((sentinel + 1,), n, dtype=torch.int32, device=dev)
    slots[slot] = order.to(torch.int32)
    slot_of = torch.empty((n,), dtype=torch.int32, device=dev)
    slot_of[order] = slot.to(torch.int32)
    overflow = torch.sum(mine & ~ok).to(torch.int32)
    return slots[:sentinel].reshape(n_cells, capacity), slot_of, overflow


def _refusal(device, n: int, n_cells: int, capacity: int):
    """Why the kernel cannot bin ``n`` atoms into ``n_cells`` cells of
    ``capacity`` on ``device``: (exception class, message), or None.  It
    reads the device and the sizes only."""
    if torch.device(device).type != "cuda":
        return TypeError, (f"cell binning kernel: the cell ids must be a "
                           f"CUDA tensor (got one on {device}); the CPU "
                           f"takes the plain version")
    max_cells, _ = native.limits("cf_cell_bin_limits")
    if not (1 <= n_cells <= max_cells and capacity >= 1
            and n_cells * capacity < 2 ** 31 and n < 2 ** 31):
        return ValueError, (f"cell binning kernel: needs 1 <= n_cells <= "
                            f"{max_cells}, capacity >= 1 and fewer than "
                            f"2^31 slots and atoms (got {n_cells} cells of "
                            f"{capacity}, {n} atoms)")
    return None


def cell_bin(cell: torch.Tensor, n_cells: int, capacity: int):
    """Binning: the plain version on the CPU, the CUDA kernel on the card."""
    if cell.device.type == "cpu":
        return cell_bin_plain(cell, n_cells, capacity)
    n = cell.shape[0]
    refusal = _refusal(cell.device, n, n_cells, capacity)
    if refusal is not None:
        raise refusal[0](refusal[1])
    if cell.ndim != 1:
        raise ValueError(f"cell binning kernel: cell ids must be [N], got "
                         f"{tuple(cell.shape)}")
    dev = cell.device
    ids = cell.to(torch.int32).contiguous()
    _, chunk = native.limits("cf_cell_bin_limits")
    n_chunks = max(1, -(-n // chunk))
    counts = torch.empty((n_cells * n_chunks,), dtype=torch.int32,
                         device=dev)
    slots = torch.empty((n_cells, capacity), dtype=torch.int32, device=dev)
    slot_of = torch.empty((n,), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    err = native.library().cf_cell_bin(
        ids.data_ptr(), n, n_cells, capacity, counts.data_ptr(),
        slots.data_ptr(), slot_of.data_ptr(), overflow.data_ptr(),
        native.stream_ptr(ids))
    native.check(err, "cf_cell_bin")
    LAUNCHES["cell_bin"] += 1
    return slots, slot_of, overflow
