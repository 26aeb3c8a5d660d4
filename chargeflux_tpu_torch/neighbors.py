"""Neighbor-state reuse with a skin radius (torch counterpart of
``chargeflux_tpu.neighbors``).

The cell edge exceeds the cutoff, and the surplus is a Verlet skin: the
walk's r < cutoff mask keeps results exact while every atom has moved less
than skin/2 since the binning.  Wrap offsets are frozen at the rebuild, so
block coordinates ``x - wrap`` stay continuous across the periodic
boundary and the static per-cell image offsets remain valid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cells import build_cell_list_full, wrap_offsets
from .device import constant
from .pairs import plane_widths
from .system import box_widths
from .utils.profiling import phase_scope


@dataclasses.dataclass(frozen=True)
class NeighborState:
    """Reusable binning state."""

    slots: torch.Tensor     # [n_cells, cap] int32, slot -> atom id
    inv_slot: torch.Tensor  # [N] int32, atom -> flat slot
    wrap: torch.Tensor      # [N, 3] lattice wrap offset at rebuild
    x_ref: torch.Tensor     # [N, 3] positions at rebuild
    overflow: torch.Tensor  # int32 dropped-atom count at rebuild


def skin_radius(system) -> torch.Tensor:
    """Free skin: smallest cell plane spacing minus the cutoff (>= 0)."""
    spec = system.spec
    grid = constant(spec.cell_grid, system.box.dtype, system.box.device)
    return torch.clamp(torch.min(plane_widths(system.box) / grid)
                       - spec.cutoff, min=0.0)


@torch.no_grad()
def build_neighbor_state(positions: torch.Tensor, system) -> NeighborState:
    """The binning at ``positions``, in the stage ``cf_rebuild``
    (``utils.profiling.phase_scope``)."""
    spec = system.spec
    positions = positions.detach()
    with phase_scope("cf_rebuild", positions):
        slots, inv_slot, overflow = build_cell_list_full(
            positions, system.box, spec.cell_grid, spec.cell_capacity,
            plain=not system.uses_kernels)
        return NeighborState(slots=slots, inv_slot=inv_slot,
                             wrap=wrap_offsets(positions, system.box),
                             x_ref=positions.clone(), overflow=overflow)


@torch.no_grad()
def neighbor_state_fresh(state: NeighborState, positions: torch.Tensor,
                         system) -> torch.Tensor:
    """True while every atom has moved <= skin/2 since the rebuild."""
    half_skin = 0.5 * skin_radius(system)
    d = positions - state.x_ref
    max_d2 = torch.max(torch.sum(d * d, dim=-1))
    return max_d2 <= half_skin * half_skin


def suggest_rebuild_interval(system, dt: float, max_speed: float = 8.0,
                             cap: int = 50) -> int:
    """Steps between rebuilds such that atoms moving at ``max_speed``
    (nm/ps) stay within skin/2; at least 1."""
    spec = system.spec
    box = system.box.detach().cpu().double().numpy()
    widths = np.asarray(box_widths(box))
    skin = max(float(np.min(widths / np.asarray(spec.cell_grid)))
               - spec.cutoff, 0.0)
    return int(max(1, min(cap, np.floor(0.5 * skin / (max_speed * dt)))))
