"""r-RESPA Langevin with neighbor reuse on one card:
``integrate.respa_langevin_trajectory_nb`` over the configuration's cell +
SPME system (the slow tier) and its water bonds (the fast tier), split by
``make_respa_force_fns``, one call per report interval, each rebuild
chunk a CUDA graph replay.  Steps are outer steps and ``dt_ps`` is the
outer step; each runs the configuration's ``n_inner`` BAOAB substeps.

Set-up: as the NVE driver's (``cfbench.drivers.nve``): positions from the
seed, Maxwell velocities at the configuration's temperature from a card
generator seeded with the seed, and the mix's warm start, velocity Verlet
at the substep (``dt_ps / n_inner``) with the bonds, the velocities
rescaled to that temperature after each call.  The capacity is held
against the relaxed occupancy, and the fastest atom's speed and the
rebuild interval it would allow at the outer step (``rebuild_bound``) are
recorded beside it.  Then the mix's burn-in: ``burn_in_calls`` production
calls of ``report_steps`` outer steps, the velocities rescaled to the
temperature after each, so that the heat the lattice still releases
leaves before the window opens.  The production calls draw the
thermostat's noise from the same generator, continued, and each goes on
from the tier forces the call before left on its state
(``RespaStateNB``): per report interval the slow tier is evaluated once
per outer step in the replays and once eagerly at the call's end.
``start`` may be called again with another seed: the chunk graphs are
kept and replayed.

A frame keeps the positions, velocities, final forces and potential, the
tier forces of the last replayed outer step (``RespaStateNB.f_slow`` and
``f_fast``) and the interval's per-outer-step kinetic energies.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import nve
from .. import water


class Driver(nve.Driver):
    def __init__(self, cfg: dict, traffic: dict, device):
        # a program that keeps no tier forces on its state cannot run this
        from chargeflux_tpu_torch import RespaStateNB  # noqa: F401
        from chargeflux_tpu_torch import make_respa_force_fns

        super().__init__(cfg, traffic, device)
        d = cfg["dynamics"]
        self.n_inner = int(d["n_inner"])
        self.friction = float(d["friction_per_ps"])
        self.slow_fn, self.fast_fn, self.init_slow = make_respa_force_fns(
            self.system, self.bonded)
        self.generator = None

    def _production(self, n_steps: int):
        from chargeflux_tpu_torch import respa_langevin_trajectory_nb

        return respa_langevin_trajectory_nb(
            self.state, self.slow_fn, self.fast_fn, self.init_slow,
            self.masses, self.dt_ps, self.n_inner,
            self.cfg["dynamics"]["temperature_K"], self.friction,
            self.generator, n_steps, self.rebuild_every)

    def start(self, seed: int):
        """Inputs from ``seed``, the warm start, one production chunk
        (which captures the chunk graph the window replays) and the
        burn-in."""
        from chargeflux_tpu_torch import init_state_nb, maxwell_velocities

        rng = np.random.default_rng(seed)
        x = torch.tensor(water.lattice_waters(self.cfg, rng),
                         dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        v = maxwell_velocities(self.masses,
                               self.cfg["dynamics"]["temperature_K"],
                               self.generator, dtype=torch.float32)
        state = init_state_nb(x, v, self.e_fn, self.init_nb)
        self.state = self._warm(state, self.dt_ps / self.n_inner)
        self.state, _kes = self._production(self.rebuild_every)
        for _ in range(int(self.traffic["burn_in_calls"])):
            self.state, _kes = self._production(self.steps_per_interval)
            self.state = self._rescale(self.state)
        self.frames = []

    def _rescale(self, state):
        """The NVE driver's rescale to the configuration's temperature,
        keeping the state's type and its tier forces (the positions do not
        move)."""
        t = nve.kinetic_temperature(state.velocities, self.masses)
        target = self.cfg["dynamics"]["temperature_K"]
        return dataclasses.replace(
            state, velocities=state.velocities * math.sqrt(target
                                                           / max(t, 1.0)))

    def _warm(self, state, dt_ps: float):
        """The NVE driver's warm start at ``dt_ps``; records ``info``."""
        from chargeflux_tpu_torch import nve_trajectory_nb

        steps = int(self.traffic["warm_start_steps"])
        call = int(self.traffic["warm_call_steps"])
        every = int(self.traffic["warm_rebuild_every"])
        occ = []
        for k in range(steps // call):
            state, es = nve_trajectory_nb(state, self.e_fn, self.init_nb,
                                          self.masses, dt_ps, call, every)
            if not bool(torch.isfinite(es).all()):
                raise RuntimeError(
                    f"the warm start's energies are not finite in call {k} "
                    f"(cell overflow or stale neighbor state; cells hold up "
                    f"to {occ[-1] if occ else 'n/a'} atoms)")
            state = self._rescale(state)
            occ.append(nve.max_occupancy(state.positions, self.box,
                                         self.cfg["system"]["cell_grid"]))
        vmax = float(state.velocities.norm(dim=-1).max())
        cap = int(self.cfg["system"]["cell_capacity"])
        self.info = {"occupancy": max(occ), "capacity": cap, "vmax": vmax,
                     "rebuild_bound": nve.rebuild_bound(self.cfg, vmax),
                     "rebuild_every": self.rebuild_every}
        if max(occ) * float(self.traffic["occupancy_margin"]) > cap:
            raise RuntimeError(f"the warm start's cells hold up to "
                               f"{max(occ)} atoms: capacity {cap} leaves "
                               f"less than the configured margin")
        return state

    def interval(self) -> bool:
        """One report interval; the frame copied to the host.  Returns
        whether its records and frame are finite."""
        self.state, kes = self._production(self.steps_per_interval)
        s = self.state
        frame = {"x": s.positions.cpu(), "v": s.velocities.cpu(),
                 "f": s.forces.cpu(), "e": s.potential.cpu(),
                 "f_slow": s.f_slow.cpu(), "f_fast": s.f_fast.cpu(),
                 "ke": kes.cpu()}
        self.frames.append(frame)
        return all(bool(torch.isfinite(t).all()) for t in frame.values())

    def release(self):
        """Drop the program's state (the chunk graphs live on the energy
        functions)."""
        super().release()
        self.slow_fn = self.fast_fn = self.init_slow = None
