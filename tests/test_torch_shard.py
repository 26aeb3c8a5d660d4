"""PyTorch port: work sharding (``parallel.shard``) on gloo groups of 2
and 4 ranks on the CPU in f64, against the JAX package's single-device
energy and forces computed in this process: the non-periodic and periodic
dense routes, the cell route (the fallback's cell rows, and the halo
route the constructor picks), the uneven work division of the fallback,
and the 2 x 2 replica x space mesh; and the collectives' autograd
(``replicated_in``, ``sum_out``, ``ppermute``) in a group of one."""

import numpy as np
import pytest
import torch

from chargeflux_tpu_torch.parallel import shard

from torch_helpers import dist_worker, gloo_group, port_system, run_ranks

torch.set_num_threads(1)


def _case(name):
    import jax.numpy as jnp

    from chargeflux_tpu.models import water_box, water_cluster

    if name == "nopbc-dense":
        force, pos, _ = water_cluster(n_side=2, flux="bond_angle", seed=31)
        return force.create_system(dtype=jnp.float64), pos
    if name == "pbc-dense":
        force, pos, _, box = water_box(n_side=2, flux="water", seed=32)
        return force.create_system(box=box, dtype=jnp.float64), pos
    if name == "uneven":
        # 81 atoms, 27 exclusions: nothing divides by 4 ranks
        force, pos, _, box = water_box(n_side=3, flux="bond_angle", seed=34)
        return force.create_system(box=box, dtype=jnp.float64), pos
    # "pbc-cell": tests/test_shard.py's 3^3 cell grid, which no halo
    # decomposition over 2 or 4 ranks takes (the gather-based cell rows of
    # the fallback); "pbc-cell-halo": a 4^3 grid, which the constructor
    # hands to the halo route
    force, pos, _, box = water_box(
        n_side=4, flux="bond_angle", density_spacing=0.62, seed=33,
        cutoff=0.55 if name == "pbc-cell-halo" else 0.62)
    return force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell"), pos


def _scale(jsys, x):
    import chargeflux_tpu as cf

    comps = cf.energy_components(x, jsys)
    return max(max(abs(float(v)) for v in comps.values()), 1.0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["nopbc-dense", "pbc-dense", "pbc-cell",
                                  "pbc-cell-halo", "uneven"])
def test_sharded_energy_and_forces_match_jax(name, world, tmp_path):
    import warnings

    import jax.numpy as jnp

    import chargeflux_tpu as cf
    from chargeflux_tpu_torch.parallel.halo import halo_compatible

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys, pos = _case(name)
    if name.startswith("pbc-cell"):
        assert halo_compatible(port_system(jsys), world) == (
            name == "pbc-cell-halo")
    x = jnp.asarray(pos)
    e_ref = float(cf.energy(x, jsys))
    f_ref = np.asarray(cf.forces(x, jsys))
    scale = _scale(jsys, x)
    res = run_ranks(world, dist_worker, ("sharded", port_system(jsys),
                                         torch.tensor(pos), {}), tmp_path)
    fs = np.abs(f_ref).max()
    for out in res:
        assert abs(float(out["e"]) - e_ref) <= 1e-12 * scale, name
        np.testing.assert_allclose(out["f"] / fs, f_ref / fs, atol=1e-11)


def test_2d_mesh_replica_times_space(tmp_path):
    """Replicas over "replica", each replica's work over "space" (2 x 2):
    each rank's replicas match the JAX package's single-device energies
    and gradients."""
    import jax
    import jax.numpy as jnp

    import chargeflux_tpu as cf
    from chargeflux_tpu.energy import _energy

    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from chargeflux_tpu.models import water_box
        force, pos, _, box = water_box(n_side=2, flux="bond_angle", seed=36)
        jsys = force.create_system(box=box, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    batch = np.stack([pos + 0.01 * rng.standard_normal(pos.shape)
                      for _ in range(4)])
    scale = _scale(jsys, jnp.asarray(batch[0]))
    res = run_ranks(4, dist_worker, ("replica2d", port_system(jsys),
                                     torch.tensor(batch), {}), tmp_path)
    e_ref = [float(cf.energy(jnp.asarray(b), jsys)) for b in batch]
    for rank, out in enumerate(res):
        block = rank // 2              # the replica coordinate of the mesh
        for i, r in enumerate((2 * block, 2 * block + 1)):
            assert abs(float(out["e"][i]) - e_ref[r]) <= 1e-12 * scale
            g_ref = jax.grad(lambda xx: _energy(xx, jsys))(
                jnp.asarray(batch[r]))
            np.testing.assert_allclose(-out["f"][i], np.asarray(g_ref),
                                       rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(out["mean"], np.mean(e_ref), rtol=1e-12)


def test_collectives_in_a_group_of_one():
    """In a group of one the functions are what they stand for: sum_out
    and replicated_in the identity forward and backward, ppermute a copy
    (counted apart), and gradients pass through unchanged."""
    with gloo_group() as group:
        shard.reset_collectives()
        x = torch.arange(6.0, dtype=torch.float64).reshape(2, 3)
        xg = x.clone().requires_grad_(True)
        y = shard.replicated_in(xg, group)
        z = shard.ppermute(y * 2.0, group, 0, [(0, 0)])
        e = shard.sum_out(torch.sum(z * z), group)
        (g,) = torch.autograd.grad(e, xg)
        np.testing.assert_allclose(float(e.detach()),
                                   float(torch.sum(4 * x * x)))
        np.testing.assert_allclose(g.numpy(), (8 * x).numpy())
        assert shard.COLLECTIVES == {"all_reduce": 2, "ppermute": 0,
                                     "ppermute_local": 2}
        assert float(shard.all_reduce_sum(torch.tensor(3.0), group)) == 3.0
