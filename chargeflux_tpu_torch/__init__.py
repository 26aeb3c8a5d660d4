"""chargeflux_tpu_torch — the charge-flux engine in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``chargeflux_tpu`` (JAX/TPU), which stays the reference it is
tested against; module names match that package's.  This package imports
torch and never jax.  It runs the periodic cell + PME main path (flux
charges, the fused direct walk (CUDA kernel), the exclusion correction,
the cell-column PME spread (CUDA kernels, forward and backward), cuFFT),
the dense periodic route with classical Ewald (CUDA structure-factor
kernels) and the non-periodic all-pairs route, harmonic water bonds and
angles, and NVE (with or without neighbor-state reuse), each trajectory
chunk replayed as one CUDA graph on the card.  ROADMAP.md lists what is
still to port.
"""

from .system import ChargeFluxSystem, CoulForce, StaticSpec, system_from_arrays
from .charges import effective_charges
from .energy import energy_and_forces, energy_components
from .bonded import BondedParams, bonded_energy
from .integrate import (MDState, MDStateNB, init_state, init_state_nb,
                        kinetic_energy, make_energy_fn, make_nb_energy_fn,
                        maxwell_velocities, nve_step, nve_step_nb,
                        nve_trajectory, nve_trajectory_nb, remove_com_motion,
                        temperature)
from .units import BOLTZ, ONE_4PI_EPS0

__all__ = [
    "ChargeFluxSystem", "CoulForce", "StaticSpec", "system_from_arrays",
    "effective_charges", "energy_and_forces", "energy_components",
    "BondedParams", "bonded_energy",
    "MDState", "MDStateNB", "init_state", "init_state_nb", "kinetic_energy",
    "make_energy_fn", "make_nb_energy_fn", "maxwell_velocities", "nve_step",
    "nve_step_nb", "nve_trajectory", "nve_trajectory_nb", "remove_com_motion",
    "temperature", "ONE_4PI_EPS0", "BOLTZ",
]
