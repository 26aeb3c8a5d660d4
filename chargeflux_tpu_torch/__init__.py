"""chargeflux_tpu_torch — the charge-flux engine in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``chargeflux_tpu`` (JAX/TPU), which stays the reference it is
tested against; module names match that package's.  This package imports
torch and never jax.  It runs the periodic cell + PME main path (flux
charges, the fused direct walk (CUDA kernel), the exclusion correction,
the cell-column PME spread (CUDA kernels, forward and backward), cuFFT),
the dense periodic route with classical Ewald (CUDA structure-factor
kernels) and the non-periodic all-pairs route, harmonic water bonds and
angles, and the integrators: NVE, BAOAB Langevin NVT and impulse r-RESPA
(NVE and NVT), with or without neighbor-state reuse, rigid water by
SETTLE / RATTLE (``constraints``) and general distance constraints, the
CSVR (``csvr``) and Nose-Hoover chain (``nosehoover``) thermostats, the
isotropic and anisotropic Monte Carlo barostats with the virial pressure
and pressure tensor (``npt``), and FIRE minimization.  Each trajectory
chunk is replayed as one CUDA graph on the card, its noise drawn there
from the caller's ``torch.Generator``; a barostat's volume move writes the
box the graph reads.
The water boxes, flexible and rigid, are in ``models``.  ROADMAP.md lists
what is still to port.
"""

from .system import ChargeFluxSystem, CoulForce, StaticSpec, system_from_arrays
from .charges import effective_charges
from .energy import energy_and_forces, energy_components
from .bonded import BondedParams, bonded_energy
from .integrate import (MDState, MDStateNB, baoab_coeffs, baoab_pre_force,
                        init_state, init_state_nb, kinetic_energy,
                        langevin_step, langevin_trajectory,
                        langevin_trajectory_nb, make_energy_fn,
                        make_nb_energy_fn, make_respa_force_fns,
                        maxwell_velocities, minimize_fire, nve_step,
                        nve_step_nb, nve_trajectory, nve_trajectory_nb,
                        remove_com_motion, respa_langevin_trajectory_nb,
                        respa_trajectory_nb, temperature)
from .constraints import (DistanceConstraints, RigidWaterParams,
                          constraint_residuals, project_positions,
                          project_velocities, rattle_langevin_trajectory,
                          rattle_langevin_trajectory_nb,
                          rattle_nve_trajectory, rattle_verlet_step,
                          settle_positions)
from .csvr import csvr_scale, csvr_trajectory, csvr_trajectory_nb
from .nosehoover import (NHChain, nhc_conserved, nhc_init, nose_hoover_step,
                         nose_hoover_trajectory, nose_hoover_trajectory_nb)
from .npt import (instantaneous_pressure, molecule_centroids, molecule_index,
                  npt_anisotropic_langevin_trajectory,
                  npt_langevin_trajectory, pressure_tensor)
from .models import rigid_water_box
from .units import BOLTZ, ONE_4PI_EPS0

__all__ = [
    "ChargeFluxSystem", "CoulForce", "StaticSpec", "system_from_arrays",
    "effective_charges", "energy_and_forces", "energy_components",
    "BondedParams", "bonded_energy",
    "MDState", "MDStateNB", "init_state", "init_state_nb", "kinetic_energy",
    "make_energy_fn", "make_nb_energy_fn", "maxwell_velocities", "nve_step",
    "nve_step_nb", "nve_trajectory", "nve_trajectory_nb", "remove_com_motion",
    "temperature", "baoab_coeffs", "baoab_pre_force", "langevin_step",
    "langevin_trajectory", "langevin_trajectory_nb", "make_respa_force_fns",
    "respa_trajectory_nb", "respa_langevin_trajectory_nb", "minimize_fire",
    "DistanceConstraints", "RigidWaterParams", "constraint_residuals",
    "project_positions", "project_velocities", "settle_positions",
    "rattle_verlet_step", "rattle_nve_trajectory",
    "rattle_langevin_trajectory", "rattle_langevin_trajectory_nb",
    "csvr_scale", "csvr_trajectory", "csvr_trajectory_nb",
    "NHChain", "nhc_init", "nhc_conserved", "nose_hoover_step",
    "nose_hoover_trajectory", "nose_hoover_trajectory_nb",
    "molecule_index", "molecule_centroids", "instantaneous_pressure",
    "pressure_tensor", "npt_langevin_trajectory",
    "npt_anisotropic_langevin_trajectory",
    "rigid_water_box", "ONE_4PI_EPS0", "BOLTZ",
]
