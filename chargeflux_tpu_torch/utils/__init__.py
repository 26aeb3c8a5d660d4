"""Utilities (torch counterpart of ``chargeflux_tpu.utils``)."""

from .diagnose import max_cell_occupancy

__all__ = ["max_cell_occupancy"]
