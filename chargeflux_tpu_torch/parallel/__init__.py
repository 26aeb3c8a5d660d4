"""Replica ensembles and multi-device routes on ``torch.distributed``
(counterpart of ``chargeflux_tpu.parallel``): batched replicas and REMD
(``replicas``), work sharding over replicated positions and the replica x
space engine (``shard``), the slab and brick halo decomposition (``halo``)
and slices of replicas (``multislice``)."""

from .shard import (
    make_replica_sharded_energy_fn,
    make_sharded_energy_and_forces_fn,
    make_sharded_energy_fn,
)
from .replicas import (remd_langevin_trajectory, replica_energy_and_forces,
                       replica_nve_step, replica_nve_trajectory,
                       shard_replicas)
from .multislice import (
    ensemble_mean,
    make_multislice_energy_fn,
    shard_batch,
)

__all__ = [
    "make_sharded_energy_fn",
    "make_sharded_energy_and_forces_fn",
    "make_replica_sharded_energy_fn",
    "remd_langevin_trajectory",
    "replica_energy_and_forces",
    "replica_nve_trajectory",
    "replica_nve_step",
    "shard_replicas",
    "make_multislice_energy_fn",
    "ensemble_mean",
    "shard_batch",
]
