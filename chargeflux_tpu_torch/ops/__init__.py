"""Hand-written CUDA kernels of the port, each beside its plain-PyTorch
version: ``pme_spread`` (counterpart of ``chargeflux_tpu.ops.pallas_pme``),
``structure_factor`` (of ``chargeflux_tpu.ops.pallas_recip``),
``direct_walk`` (of the JAX package's fused cell walk), ``cell_bin`` (of
its cell binning), ``pme_weights`` (of the B-spline patch weights that XLA
fuses), ``exclusion`` (of the templated exclusion rows that XLA fuses),
``bonded_terms`` (of the templated bonds and angles that XLA fuses), and
``native``, which builds and loads them."""

import contextlib

from . import (bonded_terms, cell_bin, direct_walk, exclusion, pme_spread,
               pme_weights, structure_factor)

_MODULES = (pme_spread, direct_walk, structure_factor, cell_bin, pme_weights,
            exclusion, bonded_terms)
_TABLES = tuple(m.LAUNCHES for m in _MODULES)

#: Per launch counter, the kernel its wrapper launches once per call, as a
#: profiler trace names it.
KERNEL_SYMBOLS = {k: v for m in _MODULES for k, v in m.SYMBOLS.items()}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {k: v for table in _TABLES for k, v in table.items()}


def reset_launch_counts():
    _set_counts(dict.fromkeys(launch_counts(), 0))


def _set_counts(counts: dict):
    for table in _TABLES:
        for k in table:
            table[k] = counts[k]


def add_launches(counts: dict):
    """Add ``counts`` (wrapper name -> launches) to the counts: a CUDA graph
    replay launches what its capture counted."""
    _set_counts({k: v + counts.get(k, 0) for k, v in launch_counts().items()})


@contextlib.contextmanager
def captured_launches():
    """For a CUDA graph capture: the wrappers count at capture, where no
    kernel runs.  Yields a dict that holds, on exit, the launches counted
    inside (wrapper name -> launches), and leaves the counts as they were
    before; each replay then adds that dict with :func:`add_launches`."""
    before = launch_counts()
    captured = {}
    try:
        yield captured
    finally:
        captured.update({k: v - before[k]
                         for k, v in launch_counts().items()})
        _set_counts(before)
