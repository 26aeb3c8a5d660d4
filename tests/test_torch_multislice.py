"""PyTorch port: ``parallel.multislice`` on a 2 x 2 ("slice", "space")
``DeviceMesh`` of gloo ranks on the CPU in f64: replicas over slices, each
replica's halo work over its slice, against the JAX package's
single-device energies and gradients; ``ensemble_mean`` and
``shard_batch``."""

import numpy as np
import torch

from torch_helpers import dist_worker, port_system, run_ranks

torch.set_num_threads(1)


def test_multislice_replica_energies_match(tmp_path):
    import jax
    import jax.numpy as jnp

    from chargeflux_tpu.energy import _energy
    from chargeflux_tpu.models import water_box

    force, pos, _, box = water_box(n_side=8, flux="bond_angle", cutoff=0.29,
                                   seed=51)
    jsys = force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell")
    assert jsys.spec.cell_grid[0] % 2 == 0
    rng = np.random.default_rng(0)
    batch = np.stack([pos + 0.005 * rng.standard_normal(pos.shape)
                      for _ in range(4)])
    res = run_ranks(4, dist_worker, ("multislice", port_system(jsys),
                                     torch.tensor(batch), {}), tmp_path)
    e_ref = np.array([float(_energy(jnp.asarray(b), jsys)) for b in batch])
    g0 = np.asarray(jax.grad(lambda x: _energy(x, jsys))(
        jnp.asarray(batch[0])))
    for rank, out in enumerate(res):
        block = rank // 2
        np.testing.assert_allclose(out["e"], e_ref[2 * block:2 * block + 2],
                                   rtol=1e-12)
        np.testing.assert_allclose(out["mean"], e_ref.mean(), rtol=1e-12)
        # no per-step collective crosses slices: only the halo's own
        assert out["collectives"]["ppermute"] == 2 * 2
    np.testing.assert_allclose(-res[0]["f"][0], g0, rtol=1e-9, atol=1e-11)
