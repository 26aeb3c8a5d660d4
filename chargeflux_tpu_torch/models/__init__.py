"""Model builders (torch counterpart of ``chargeflux_tpu.models``)."""

from .water import rigid_water_box, water_bonded_params, water_box

__all__ = ["water_box", "water_bonded_params", "rigid_water_box"]
