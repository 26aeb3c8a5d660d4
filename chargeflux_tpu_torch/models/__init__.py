"""Model builders (torch counterpart of ``chargeflux_tpu.models``)."""

from .salt import salt_water_box
from .solute import solvated_chain_box
from .water import rigid_water_box, water_bonded_params, water_box

__all__ = ["salt_water_box", "solvated_chain_box", "water_box",
           "water_bonded_params", "rigid_water_box"]
