"""Replica ensembles over slices, each replica's work over its slice's
ranks (torch counterpart of ``chargeflux_tpu.parallel.multislice``).

A two-level job: within a slice (fast links) one replica's spatial work,
the halo or sharded direct space and the summed structure factors or
charge mesh; across slices, replica ensembles, which need no per-step
communication.  Only ensemble observables (a mean energy, exchange swaps)
cross slices, and only when sampled (:func:`ensemble_mean`).  The mesh is
a 2-D ``DeviceMesh`` with axes ("slice", "space"): lay the slice axis over
the slow links, as ``init_device_mesh`` does for the leading axis.
"""

from __future__ import annotations

import torch

from .replicas import shard_replicas
from .shard import _axis, all_reduce_sum, make_replica_sharded_energy_fn


def make_multislice_energy_fn(system, mesh, slice_axis: str = "slice",
                              space_axis: str = "space"):
    """``energy_batch(x) -> [R_local]`` for this rank's block of replicas
    [R_local, N, 3] (:func:`shard_batch`): replicas over ``slice_axis``, no
    per-step collective; each replica's work over ``space_axis`` (halo
    exchange where the cell grid divides it, work sharding otherwise), the
    replica x space engine of ``shard.make_replica_sharded_energy_fn`` on
    the slice axis.  Differentiable."""
    return make_replica_sharded_energy_fn(system, mesh, slice_axis,
                                          space_axis)


def ensemble_mean(values, mesh, slice_axis: str = "slice"):
    """Mean over the whole ensemble of a replica-sharded observable: this
    rank's block ``values`` [R_local], summed over ``slice_axis`` (the one
    collective that crosses slices, off the step path)."""
    group, _rank, size = _axis(mesh, slice_axis)
    total = all_reduce_sum(torch.sum(values), group)
    return total / (values.shape[0] * size)


def shard_batch(batch, mesh, slice_axis: str = "slice"):
    """This rank's block of a [R, ...] batch sharded over ``slice_axis``."""
    return shard_replicas(batch, mesh, slice_axis)
