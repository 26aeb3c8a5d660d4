"""Host-side triage for NaN-poisoned trajectories (torch counterpart of
``chargeflux_tpu.utils.diagnose``).

Three conditions poison the energy and forces to NaN on purpose rather
than going silently wrong: a cell-list overflow at a rebuild, a stale
reused neighbor state, and a dynamics blowup (non-finite positions).  From
the outside they look alike; :func:`diagnose_nan` tells, from the last
finite state, which one fired and what to change, and also flags a
(near-)collinear flux angle, where the flux force diverges.  Everything
here reads back to the host: call it off the trajectory path.
"""

from __future__ import annotations

import numpy as np
import torch

from .trajectory import _host


def max_cell_occupancy(positions, system) -> int:
    """Densest-cell atom count for ``positions`` under the system's cell
    grid (NumPy, the binning's wrap/clip convention)."""
    x = _host(positions)
    box = _host(system.box)
    grid = np.asarray(system.spec.cell_grid)
    frac = x @ np.linalg.inv(box) if box.ndim == 2 else x / box
    frac -= np.floor(frac)
    ci = np.clip((frac * grid).astype(np.int64), 0, grid - 1)
    flat = (ci[:, 0] * grid[1] + ci[:, 1]) * grid[2] + ci[:, 2]
    return int(np.bincount(flat, minlength=int(grid.prod())).max())


def diagnose_nan(positions, system, nb=None, dt=None) -> dict:
    """Classify why a trajectory NaN-poisoned, from the last finite state
    (positions and, if the loop reused one, its neighbor state).

    Returns a dict with ``cause`` in {"non_finite_positions",
    "cell_overflow", "stale_neighbor_state", "collinear_flux_angle",
    "none"}, a human-readable ``suggestion`` and the cause's numbers
    (``overflow`` / ``max_occupancy`` / ``cell_capacity``; ``skin``;
    ``min_sin_theta`` / ``angle_index``), checked in that order."""
    x = _host(positions)
    if not np.all(np.isfinite(x)):
        return {
            "cause": "non_finite_positions",
            "suggestion": (
                "the poison already propagated into the coordinates — "
                "diagnose from an earlier (finite) state; if the earlier "
                "state is clean, the integrator step itself diverged: "
                "reduce dt (flexible water needs <=0.5 fs whole-step or "
                "an r-RESPA inner tier), equilibrate with a strong "
                "thermostat before production, or minimize first"),
        }
    xt = torch.as_tensor(x, device=system.box.device).to(system.box.dtype)

    spec = system.spec
    if spec.direct_method == "cell":
        from ..cells import validate_cell_list

        overflow = validate_cell_list(xt, system)
        if overflow > 0:
            occ = max_cell_occupancy(x, system)
            want = -(-max(occ + 8, int(spec.cell_capacity) + 8) // 8) * 8
            return {
                "cause": "cell_overflow",
                "overflow": int(overflow),
                "max_occupancy": occ,
                "cell_capacity": int(spec.cell_capacity),
                "suggestion": (
                    f"a cell holds {occ} atoms but cell_capacity is "
                    f"{spec.cell_capacity}; rebuild the system with "
                    f"create_system(..., cell_capacity={want}).  Molecules "
                    "move as units, so per-cell fluctuations run ~sqrt("
                    "atoms/molecule) above the Poisson estimate the "
                    "default uses — hot/unequilibrated systems need the "
                    "extra headroom"),
            }

    if nb is not None:
        from ..neighbors import (neighbor_state_fresh, skin_radius,
                                 suggest_rebuild_interval)

        if not bool(neighbor_state_fresh(nb, xt, system)):
            hint = ""
            if dt is not None:
                hint = (f"; suggest_rebuild_interval gives "
                        f"{suggest_rebuild_interval(system, dt)} at this dt")
            return {
                "cause": "stale_neighbor_state",
                "skin": float(skin_radius(system)),
                "suggestion": (
                    "an atom moved past skin/2 since the last rebuild: "
                    "lower rebuild_every, enlarge the skin (skin_frac at "
                    "create_system), or slow the dynamics" + hint),
            }

    # collinear flux angles: the energy stays finite (clamped acos) but
    # the force is singular there, |dtheta/dx| ~ 1/sin(theta)
    worst = _min_flux_angle_sine(x, system)
    if worst is not None and worst[0] < 1e-6:
        s, idx = worst
        return {
            "cause": "collinear_flux_angle",
            "min_sin_theta": float(s),
            "angle_index": int(idx),
            "suggestion": (
                f"flux angle #{idx} is (near-)collinear (sin theta = "
                f"{s:.2e}): the flux-angle force diverges as 1/sin(theta) "
                "— a property of the model.  Fix the geometry (minimize "
                "first), stiffen the bonded angle term, or remove the "
                "flux term on this angle"),
        }

    return {
        "cause": "none",
        "suggestion": (
            "this state looks healthy (finite, no overflow, fresh "
            "neighbors) — if a run from here still NaNs, it poisons "
            "mid-chunk: rerun with rebuild_every=1 and guard on, or step "
            "manually to bisect"),
    }


def _min_flux_angle_sine(x, system):
    """(min |sin theta|, argmin) over the flux angles, or None if the
    system has none (NumPy f64, min-image deltas as the engine takes
    them)."""
    idx = system.angle_idx.detach().cpu().numpy()
    if idx.shape[0] == 0:
        return None
    box = _host(system.box) if system.spec.pbc else None

    def delta(a, b):
        d = x[a] - x[b]
        if box is not None:
            if box.ndim == 2:
                for ax in (2, 1, 0):
                    d -= box[ax] * np.floor(
                        d[:, ax:ax + 1] / box[ax, ax] + 0.5)
            else:
                d -= box * np.floor(d / box + 0.5)
        return d

    d21 = delta(idx[:, 0], idx[:, 1])
    d23 = delta(idx[:, 2], idx[:, 1])
    cross = np.cross(d21, d23)
    sin = (np.linalg.norm(cross, axis=1)
           / (np.linalg.norm(d21, axis=1) * np.linalg.norm(d23, axis=1)))
    k = int(np.argmin(sin))
    return float(sin[k]), k
