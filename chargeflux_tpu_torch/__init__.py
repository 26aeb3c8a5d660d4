"""chargeflux_tpu_torch — the charge-flux engine in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``chargeflux_tpu`` (JAX/TPU), which stays the reference it is
tested against; module names match that package's, and ``__all__`` here,
in ``models``, ``utils``, ``parallel`` (on ``torch.distributed``) and
``runtime`` names what that package's do.  This package imports torch and
never jax.

It runs the periodic cell + PME main path (the cell binning (CUDA
kernel), flux charges, the fused direct walk (CUDA kernel), the exclusion
correction, the cell-column PME spread
(CUDA kernels, forward and backward), cuFFT), the dense periodic route
with classical Ewald (CUDA structure-factor kernels) or the dense-mesh
SPME, and the non-periodic all-pairs route; harmonic bonds and angles,
periodic torsions and position restraints; the manual chain-rule force
path (``forces_manual``); the integrators: NVE, BAOAB Langevin NVT,
impulse r-RESPA, FIRE minimization, rigid water by SETTLE / RATTLE, the
CSVR and Nose-Hoover chain thermostats, the isotropic and anisotropic
Monte Carlo barostats and random batch Ewald NVT (``rbe``).  Each
trajectory chunk is replayed as one CUDA graph on the card, its noise
drawn there from the caller's ``torch.Generator``.  ``models`` builds the
water boxes, the cluster, the solute and salt boxes and systems from PDB
files (``system_from_pdb`` with a residue table); ``utils`` holds the
trajectory formats (XYZ, PDB, DCD), analysis, checkpoints, NaN triage and
profiling scopes.  Names the JAX package does not export (``MDState``,
``system_from_arrays``, ``baoab_coeffs``, ...) are importable here too.
"""

from .system import (ChargeFluxSystem, CoulForce, StaticSpec, ewald_alpha,
                     ewald_kmax, system_from_arrays)
from .charges import (charge_jacobian_values, effective_charges,
                      jacobian_index_layout)
from .energy import (energy, energy_and_forces, energy_components,
                     energy_fixed_charges, forces, forces_manual)
from .bonded import (BondedParams, bonded_energy,
                     flat_bottom_restraint_energy, position_restraint_energy)
from .integrate import (MDState, MDStateNB, RespaStateNB, baoab_coeffs,
                        baoab_pre_force, init_state, init_state_nb,
                        kinetic_energy, langevin_step, langevin_trajectory,
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
from .rbe import (make_rbe_nb_energy_fn, rbe_langevin_trajectory_nb,
                  rbe_reciprocal_energy, rbe_tables)
from .npt import (instantaneous_pressure, molecule_centroids, molecule_index,
                  npt_anisotropic_langevin_trajectory,
                  npt_langevin_trajectory, pressure_tensor)
from .models import rigid_water_box
from .units import BOLTZ, ONE_4PI_EPS0

__version__ = "0.1.0"

__all__ = [
    "ChargeFluxSystem", "CoulForce", "StaticSpec",
    "ewald_alpha", "ewald_kmax",
    "effective_charges", "charge_jacobian_values", "jacobian_index_layout",
    "energy", "energy_and_forces", "energy_components", "energy_fixed_charges",
    "forces", "forces_manual",
    "BondedParams", "bonded_energy", "flat_bottom_restraint_energy",
    "position_restraint_energy",
    "DistanceConstraints", "RigidWaterParams", "project_positions",
    "project_velocities",
    "rattle_verlet_step", "rattle_nve_trajectory",
    "rattle_langevin_trajectory", "rattle_langevin_trajectory_nb",
    "make_energy_fn", "nve_step", "nve_trajectory", "init_state",
    "make_nb_energy_fn", "nve_step_nb", "nve_trajectory_nb",
    "remove_com_motion", "init_state_nb",
    "langevin_step", "langevin_trajectory", "langevin_trajectory_nb",
    "make_respa_force_fns", "respa_trajectory_nb",
    "respa_langevin_trajectory_nb",
    "minimize_fire",
    "kinetic_energy", "temperature", "maxwell_velocities",
    "NHChain", "nhc_init", "nhc_conserved", "nose_hoover_step",
    "nose_hoover_trajectory", "nose_hoover_trajectory_nb",
    "csvr_trajectory", "csvr_trajectory_nb",
    "make_rbe_nb_energy_fn", "rbe_langevin_trajectory_nb",
    "rbe_reciprocal_energy", "rbe_tables",
    "instantaneous_pressure", "molecule_index",
    "npt_anisotropic_langevin_trajectory", "npt_langevin_trajectory",
    "pressure_tensor",
    "ONE_4PI_EPS0", "BOLTZ",
]
