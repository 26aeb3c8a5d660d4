"""Velocity-Verlet NVE with neighbor-state reuse (torch counterpart of the
``*_nb`` drivers of ``chargeflux_tpu.integrate``).

A trajectory is a Python loop: on the cell route the neighbor state is
rebuilt every ``rebuild_every`` steps, and in between the energy
function's freshness guard NaN-poisons energy and forces if an atom moved
past skin/2.  The dense route has no neighbor state (``nb`` is ``None``)
and no guard.  The step arithmetic is the JAX package's packed-chunk step
(v += f * (dt/2m); x += dt v; f = F(x); v += f * (dt/2m)).
"""

from __future__ import annotations

import dataclasses

import torch

from .bonded import bonded_energy
from .energy import _energy
from .neighbors import build_neighbor_state, neighbor_state_fresh


@dataclasses.dataclass(frozen=True)
class MDStateNB:
    positions: torch.Tensor   # [N, 3] nm
    velocities: torch.Tensor  # [N, 3] nm/ps
    forces: torch.Tensor      # [N, 3] kJ/mol/nm
    potential: torch.Tensor   # scalar kJ/mol
    nb: object                # neighbors.NeighborState, None when dense


def kinetic_energy(velocities, masses) -> torch.Tensor:
    return 0.5 * torch.sum(masses[:, None] * velocities * velocities)


def make_nb_energy_fn(system, bonded=None, plain: bool = False):
    """Returns (e_fn, init_nb): ``e_fn(x, nb) -> (energy, forces, nb)``
    evaluates with a reused neighbor state (charge-flux electrostatics plus
    the optional bonded terms), ``init_nb(x)`` rebuilds one.  A stale state
    poisons energy and forces to NaN.  On the dense route there is nothing
    to reuse: ``init_nb`` returns ``None`` and no guard applies.
    ``plain=True`` runs the kernels' plain-PyTorch versions (the f64
    control and the kernel-vs-plain step timing of ``utils.measure`` use
    it)."""
    has_cells = system.spec.direct_method == "cell"

    def init_nb(x):
        return build_neighbor_state(x, system) if has_cells else None

    def e_fn(x, nb):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            e = _energy(xg, system, nb=nb, plain=plain)
            if bonded is not None:
                e = e + bonded_energy(xg, bonded)
            (g,) = torch.autograd.grad(e, xg)
        if nb is None:
            return e.detach(), -g, nb
        bad = torch.where(neighbor_state_fresh(nb, x, system), 1.0,
                          torch.nan).to(e.dtype)
        return e.detach() * bad, -g * bad, nb

    return e_fn, init_nb


def init_state_nb(positions, velocities, e_fn, init_nb) -> MDStateNB:
    nb = init_nb(positions)
    e, f, nb = e_fn(positions, nb)
    return MDStateNB(positions, velocities, f, e, nb)


def nve_step_nb(state: MDStateNB, e_fn, masses, dt: float) -> MDStateNB:
    """One velocity-Verlet step with the state's neighbor state."""
    half = (0.5 * dt / masses)[:, None]
    v_half = state.velocities + state.forces * half
    x_new = state.positions + dt * v_half
    e, f_new, nb = e_fn(x_new, state.nb)
    v_new = v_half + f_new * half
    return MDStateNB(x_new, v_new, f_new, e, nb)


def nve_trajectory_nb(state: MDStateNB, e_fn, init_nb, masses, dt: float,
                      n_steps: int, rebuild_every: int = 10):
    """``n_steps`` of NVE with the neighbor state rebuilt every
    ``rebuild_every`` steps (at the start of each chunk); returns
    (final_state, per-step total energies [n_steps]).  The final state
    keeps the last step's forces and carries a fresh neighbor state and
    the potential evaluated with it."""
    es = []
    for step in range(n_steps):
        if step % rebuild_every == 0:
            state = dataclasses.replace(state, nb=init_nb(state.positions))
        state = nve_step_nb(state, e_fn, masses, dt)
        es.append(state.potential + kinetic_energy(state.velocities, masses))
    if n_steps == 0:
        return state, state.positions.new_zeros((0,))
    nb = init_nb(state.positions)
    e_pot, _f, nb = e_fn(state.positions, nb)
    return (dataclasses.replace(state, potential=e_pot, nb=nb),
            torch.stack(es))
