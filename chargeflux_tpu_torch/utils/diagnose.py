"""Host-side helpers for provisioning the cell capacity (torch counterpart
of ``chargeflux_tpu.utils.diagnose``)."""

from __future__ import annotations

import numpy as np
import torch


def max_cell_occupancy(positions, system) -> int:
    """Densest-cell atom count for ``positions`` under the system's cell
    grid (NumPy, the binning's wrap/clip convention)."""
    if isinstance(positions, torch.Tensor):
        positions = positions.detach().cpu().numpy()
    x = np.asarray(positions, dtype=np.float64)
    box = system.box.detach().cpu().double().numpy()
    grid = np.asarray(system.spec.cell_grid)
    frac = x @ np.linalg.inv(box) if box.ndim == 2 else x / box
    frac -= np.floor(frac)
    ci = np.clip((frac * grid).astype(np.int64), 0, grid - 1)
    flat = (ci[:, 0] * grid[1] + ci[:, 1]) * grid[2] + ci[:, 2]
    return int(np.bincount(flat, minlength=int(grid.prod())).max())
