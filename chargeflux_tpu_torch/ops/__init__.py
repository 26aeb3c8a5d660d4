"""Hand-written CUDA kernels of the port, each beside its plain-PyTorch
version: ``pme_spread`` (counterpart of ``chargeflux_tpu.ops.pallas_pme``),
``structure_factor`` (of ``chargeflux_tpu.ops.pallas_recip``),
``direct_walk`` (of the JAX package's fused cell walk), and ``native``,
which builds and loads them."""

from . import direct_walk, pme_spread, structure_factor

_TABLES = (pme_spread.LAUNCHES, direct_walk.LAUNCHES,
           structure_factor.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {k: v for table in _TABLES for k, v in table.items()}


def reset_launch_counts():
    for table in _TABLES:
        for k in table:
            table[k] = 0
