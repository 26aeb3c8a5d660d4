"""Hand-written CUDA kernels of the port, each beside its plain-PyTorch
version: ``pme_spread`` (counterpart of ``chargeflux_tpu.ops.pallas_pme``),
``direct_walk`` (of the JAX package's fused cell walk), and ``native``,
which builds and loads them."""

from . import direct_walk, pme_spread


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {**pme_spread.LAUNCHES, **direct_walk.LAUNCHES}


def reset_launch_counts():
    for table in (pme_spread.LAUNCHES, direct_walk.LAUNCHES):
        for k in table:
            table[k] = 0
