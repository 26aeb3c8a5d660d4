"""Model builders (torch counterpart of ``chargeflux_tpu.models``)."""

from .water import water_bonded_params, water_box

__all__ = ["water_box", "water_bonded_params"]
