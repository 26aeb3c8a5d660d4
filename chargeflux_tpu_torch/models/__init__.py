"""Model builders (torch counterpart of ``chargeflux_tpu.models``)."""

from .onramp import ResidueParams, system_from_pdb
from .salt import salt_water_box
from .solute import solvated_chain_box
from .water import (
    WATER_MASSES,
    rigid_water_box,
    water_bonded_params,
    water_box,
    water_cluster,
    water_system_from_pdb,
)

__all__ = ["ResidueParams", "system_from_pdb", "salt_water_box",
           "solvated_chain_box", "rigid_water_box",
           "water_bonded_params", "water_box", "water_cluster",
           "water_system_from_pdb", "WATER_MASSES"]
