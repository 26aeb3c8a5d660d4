"""NVE with neighbor reuse on one card: ``integrate.nve_trajectory_nb``
over the configuration's cell + SPME system and its water bonds, one
call per report interval, each rebuild chunk a CUDA graph replay.

Set-up: the system from the configuration (``cfbench.water``), positions
from the seed, Maxwell velocities at the configuration's temperature from
a card generator seeded with the seed, and a warm start of calls of
``warm_call_steps`` steps with a rebuild every ``warm_rebuild_every``
(the lattice's first relaxation moves atoms fast), the velocities
rescaled to that temperature after each.  The cell capacity and the
rebuild interval are the configuration's, the same for every seed.
After the warm start the capacity is held against the relaxed occupancy
(set-up stops if the cells are fuller than the mix's margin allows); the
fastest atom's speed and the rebuild interval it would allow by the
program's rule of thumb (``rebuild_bound``) are recorded beside it, not
enforced: the program itself poisons a step whose atoms left half the
skin, and a poisoned interval counts as failed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import water

#: Boltzmann's constant, kJ/mol/K
KB = 0.008314462618


def max_occupancy(x: torch.Tensor, box, grid) -> int:
    """The most atoms in one cell of ``grid`` (wrapped positions)."""
    box = torch.as_tensor(box, dtype=x.dtype, device=x.device)
    g = torch.as_tensor(grid, device=x.device)
    frac = x / box
    frac = frac - torch.floor(frac)
    ci = torch.minimum((frac * g).long(), g - 1)
    cid = (ci[:, 0] * g[1] + ci[:, 1]) * g[2] + ci[:, 2]
    return int(torch.bincount(cid, minlength=int(g.prod())).max())


def rebuild_bound(cfg: dict, vmax: float) -> int:
    """Steps between rebuilds that keep every atom within half the skin,
    for a fastest atom of ``vmax`` nm/ps given the configuration's margin
    and floor on that speed."""
    s, d = cfg["system"], cfg["dynamics"]
    skin = (s["lattice_side"] * s["spacing_nm"] / s["cell_grid"][0]
            - s["cutoff_nm"])
    speed = max(d["skin_speed_floor_nm_per_ps"], d["skin_speed_margin"] * vmax)
    return int(math.floor(0.5 * skin / (speed * d["dt_ps"])))


def kinetic_temperature(v, masses) -> float:
    v = v.double()
    m = masses.double()
    return float(torch.sum(m[:, None] * v * v)) / (3 * v.shape[0] * KB)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, device):
        from chargeflux_tpu_torch import make_nb_energy_fn

        self.cfg, self.traffic, self.device = cfg, traffic, device
        d = cfg["dynamics"]
        self.dt_ps = float(d["dt_ps"])
        self.rebuild_every = int(d["rebuild_every"])
        self.steps_per_interval = int(traffic["report_steps"])
        if self.steps_per_interval % self.rebuild_every:
            raise ValueError("report_steps must be a multiple of "
                             "rebuild_every (no remainder chunk)")
        self.replicas = 1
        self.evals_per_interval = self.steps_per_interval + 1
        self.box = water.box_of(cfg)
        self.system = water.port_system(cfg, device)
        self.bonded = water.port_bonded(cfg, device)
        self.masses = torch.tensor(water.masses_of(cfg), dtype=torch.float32,
                                   device=device)
        self.e_fn, self.init_nb = make_nb_energy_fn(self.system,
                                                    bonded=self.bonded)
        self.frames = []
        self.state = None
        self.info = {}

    def _rescale(self, state):
        t = kinetic_temperature(state.velocities, self.masses)
        target = self.cfg["dynamics"]["temperature_K"]
        v = state.velocities * math.sqrt(target / max(t, 1.0))
        return type(state)(state.positions, v, state.forces, state.potential,
                           state.nb)

    def start(self, seed: int):
        """Inputs from ``seed`` and the warm start (which captures the
        chunk graph the window replays)."""
        from chargeflux_tpu_torch import (init_state_nb, maxwell_velocities,
                                          nve_trajectory_nb)

        rng = np.random.default_rng(seed)
        x = torch.tensor(water.lattice_waters(self.cfg, rng),
                         dtype=torch.float32, device=self.device)
        gen = torch.Generator(self.device).manual_seed(seed)
        v = maxwell_velocities(self.masses,
                               self.cfg["dynamics"]["temperature_K"], gen,
                               dtype=torch.float32)
        state = init_state_nb(x, v, self.e_fn, self.init_nb)
        steps = int(self.traffic["warm_start_steps"])
        call = int(self.traffic["warm_call_steps"])
        occ = []
        warm_every = int(self.traffic["warm_rebuild_every"])
        for k in range(steps // call):
            state, es = nve_trajectory_nb(state, self.e_fn, self.init_nb,
                                          self.masses, self.dt_ps, call,
                                          warm_every)
            if not bool(torch.isfinite(es).all()):
                raise RuntimeError(
                    f"the warm start's energies are not finite in call {k} "
                    f"(cell overflow or stale neighbor state; cells hold up "
                    f"to {occ[-1] if occ else 'n/a'} atoms)")
            state = self._rescale(state)
            occ.append(max_occupancy(state.positions, self.box,
                                     self.cfg["system"]["cell_grid"]))
        vmax = float(state.velocities.norm(dim=-1).max())
        cap = int(self.cfg["system"]["cell_capacity"])
        bound = rebuild_bound(self.cfg, vmax)
        self.info = {"occupancy": max(occ), "capacity": cap, "vmax": vmax,
                     "rebuild_bound": bound,
                     "rebuild_every": self.rebuild_every}
        if max(occ) * float(self.traffic["occupancy_margin"]) > cap:
            raise RuntimeError(f"the warm start's cells hold up to "
                               f"{max(occ)} atoms: capacity {cap} leaves "
                               f"less than the configured margin")
        # the production chunk's graph, captured in set-up
        self.state, _es = nve_trajectory_nb(
            state, self.e_fn, self.init_nb, self.masses, self.dt_ps,
            self.rebuild_every, self.rebuild_every)
        self.frames = []

    def interval(self) -> bool:
        """One report interval; the frame copied to the host.  Returns
        whether its energies and frame are finite."""
        from chargeflux_tpu_torch import nve_trajectory_nb

        self.state, es = nve_trajectory_nb(
            self.state, self.e_fn, self.init_nb, self.masses, self.dt_ps,
            self.steps_per_interval, self.rebuild_every)
        frame = {"x": self.state.positions.cpu(),
                 "v": self.state.velocities.cpu(),
                 "f": self.state.forces.cpu(), "es": es.cpu()}
        self.frames.append(frame)
        return all(bool(torch.isfinite(t).all()) for t in frame.values())

    def check_inputs(self) -> dict:
        """What the comparison needs beside the frames (``checks.md``)."""
        return {"masses": self.masses.cpu(), "box": self.box}

    def work(self) -> dict:
        """The problem's sizes for the roofline counts, the pairs counted
        at the last frame."""
        from ..work import pairs_within_cutoff

        s = self.cfg["system"]
        x = self.frames[-1]["x"].to(self.device)
        return {"n_atoms": x.shape[0], "order": int(s["pme_order"]),
                "mesh": tuple(s["pme_grid"]),
                "pairs": pairs_within_cutoff(x, self.box, s["cutoff_nm"])}

    def release(self):
        """Drop the program's state (the chunk graphs live on e_fn)."""
        self.state = self.e_fn = self.init_nb = None
        self.system = self.bonded = None
