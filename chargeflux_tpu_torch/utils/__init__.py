"""Utilities (torch counterpart of ``chargeflux_tpu.utils``)."""

from .analysis import (dipole_autocorrelation, infrared_spectrum,
                       mean_squared_displacement, radial_distribution,
                       total_dipole, velocity_autocorrelation)
from .checkpoint import load_checkpoint, save_checkpoint
from .diagnose import diagnose_nan, max_cell_occupancy
from .profiling import phase_scope, step_timer, trace
from .trajectory import (DCDWriter, PDBFile, read_dcd, read_pdb, read_xyz,
                         symbols_from_masses, write_pdb, write_xyz)

__all__ = ["save_checkpoint", "load_checkpoint", "phase_scope", "trace",
           "step_timer", "write_xyz", "read_xyz", "symbols_from_masses",
           "DCDWriter", "read_dcd", "write_pdb", "read_pdb", "PDBFile",
           "radial_distribution", "diagnose_nan", "max_cell_occupancy",
           "mean_squared_displacement", "velocity_autocorrelation",
           "total_dipole", "dipole_autocorrelation", "infrared_spectrum"]
