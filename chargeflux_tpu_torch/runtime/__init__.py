"""The native C++ host runtime (counterpart of ``chargeflux_tpu.runtime``):
a host-side f64 oracle and helper, not an accelerator path."""

from .native import (
    cell_histogram,
    native_available,
    native_direct_energy,
    native_flux_chain_forces,
    native_flux_charges,
    native_full_energy_forces,
    native_recip_self_energy,
)

__all__ = ["native_available", "cell_histogram", "native_flux_charges",
           "native_direct_energy", "native_recip_self_energy",
           "native_flux_chain_forces", "native_full_energy_forces"]
