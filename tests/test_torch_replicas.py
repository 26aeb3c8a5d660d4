"""PyTorch port: ``parallel.replicas`` against the JAX package's vmapped
ensemble on the CPU in f64 — batched energies and forces on a dense
periodic water box and a non-periodic cluster, the batched structure
factors against a per-replica loop, replica NVE against JAX's, and the
routing of ``vmap_friendly_system``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chargeflux_tpu_torch import ewald
from chargeflux_tpu_torch.ops import structure_factor as sf
from chargeflux_tpu_torch.parallel import replicas as preps

from torch_helpers import port_system

torch.set_num_threads(2)


def _batch(pos, r, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    return np.stack([pos + scale * rng.standard_normal(pos.shape)
                     for _ in range(r)])


def _box(n_side=2, seed=32, flux="water"):
    from chargeflux_tpu.models import water_box

    force, pos, masses, box = water_box(n_side=n_side, flux=flux, seed=seed)
    jsys = force.create_system(box=box, dtype=jnp.float64)
    return jsys, port_system(jsys), pos, masses


def _cluster(seed=35):
    from chargeflux_tpu.models import water_cluster

    force, pos, masses = water_cluster(n_side=2, flux="bond_angle",
                                       seed=seed)
    jsys = force.create_system(dtype=jnp.float64)
    return jsys, port_system(jsys), pos, masses


@pytest.mark.parametrize("case", ["pbc-dense", "nopbc-dense"])
def test_replica_energy_and_forces_match_jax(case):
    """[R, N, 3] -> ([R], [R, N, 3]) equals JAX's vmapped ensemble: energy
    rel 1e-12, forces 1e-10 (tests/test_shard.py's tolerances)."""
    from chargeflux_tpu.parallel import replica_energy_and_forces as jref

    jsys, psys, pos, _ = _box() if case == "pbc-dense" else _cluster()
    assert preps.batched_route(preps.vmap_friendly_system(psys))
    batch = _batch(pos, 4)
    e_j, f_j = jref(jnp.asarray(batch), jsys)
    e_p, f_p = preps.replica_energy_and_forces(torch.tensor(batch), psys)
    assert e_p.shape == (4,) and f_p.shape == batch.shape
    np.testing.assert_allclose(e_p.numpy(), np.asarray(e_j), rtol=1e-12)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("method", ["xla", "pallas"])
def test_batched_energy_equals_the_single_system_loop(method):
    """The one-pass batch on each reciprocal route (the kernels' plain
    versions on the CPU, in f32 for "pallas") equals a loop of
    single-system evaluations."""
    from chargeflux_tpu_torch.energy import _energy

    jsys, psys, pos, _ = _box(n_side=3, seed=3, flux="bond_angle")
    dtype = torch.float64 if method == "xla" else torch.float32
    if dtype == torch.float32:
        psys = port_system(jsys, torch.float32)
    import dataclasses
    psys = psys._swap(spec=dataclasses.replace(psys.spec,
                                               recip_method=method))
    x = torch.tensor(_batch(pos, 3), dtype=dtype)
    e_b, f_b = preps._forces(preps.replica_energy_fn(psys), x)
    for r in range(3):
        xr = x[r].detach().requires_grad_(True)
        e = _energy(xr, psys)
        (g,) = torch.autograd.grad(e, xr)
        tol = 1e-12 if dtype == torch.float64 else 2e-6
        assert abs(float(e_b[r]) - float(e)) <= tol * abs(float(e))
        np.testing.assert_allclose(f_b[r].numpy(), -g.numpy(),
                                   rtol=tol * 100, atol=tol * 100)


def test_batched_plain_structure_factors_equal_a_loop():
    """sf_*_plain on [R, ...] tables equal the single-system plain versions
    replica by replica (the batched kernels' plain twins)."""
    rng = np.random.default_rng(5)
    r, n, kmax = 3, 24, (3, 4, 3)
    x = torch.tensor(rng.uniform(0, 1.5, (r, n, 3)))
    q = torch.tensor(rng.uniform(-1, 1, (r, n)))
    box = torch.tensor([1.5, 1.6, 1.7], dtype=torch.float64)
    tabs = ewald.kernel_inputs(x, q, box, kmax)
    assert tabs[0].shape == (r, 3, n) and tabs[4].shape == (r, n, 10)
    kk = tabs[0].shape[1] * tabs[2].shape[1]
    abar = torch.tensor(rng.standard_normal((r, kk, 10)))
    bbar = torch.tensor(rng.standard_normal((r, kk, 10)))
    batched = (sf.sf_fwd_plain(*tabs),
               sf.sf_bwd_tables_plain(*tabs, abar, bbar),
               (sf.sf_bwd_zq_plain(*tabs[:4], abar, bbar),))
    for i in range(r):
        one = [t[i] for t in tabs]
        single = (sf.sf_fwd_plain(*one),
                  sf.sf_bwd_tables_plain(*one, abar[i], bbar[i]),
                  (sf.sf_bwd_zq_plain(*one[:4], abar[i], bbar[i]),))
        for bt, st in zip(batched, single):
            for b, s in zip(bt, st):
                np.testing.assert_allclose(b[i].numpy(), s.numpy(),
                                           rtol=1e-13, atol=1e-13)
    # the CPU wrappers take the same plain path, batch included
    a, b = sf.sf_fwd(*tabs)
    np.testing.assert_array_equal(a.numpy(), batched[0][0].numpy())


def test_replica_nve_matches_jax():
    """Five replica NVE steps, stepwise and as a trajectory, against JAX's
    replica_nve_trajectory (1e-10)."""
    from chargeflux_tpu.energy import _energy as j_energy
    from chargeflux_tpu.integrate import MDState as JState
    from chargeflux_tpu.parallel.replicas import (
        replica_nve_trajectory as j_traj)
    from chargeflux_tpu_torch.integrate import MDState

    jsys, psys, pos, masses = _cluster(seed=36)
    batch = _batch(pos, 4, seed=2)
    dt = 5e-5
    j_e = lambda x: j_energy(x, jsys)  # noqa: E731
    xb = jnp.asarray(batch)
    e0, g0 = jax.vmap(jax.value_and_grad(j_e))(xb)
    js = JState(xb, jnp.zeros_like(xb), -g0, e0)
    j_fin, j_es = j_traj(js, j_e, jnp.asarray(masses), dt, 5)

    e_fn = preps.replica_energy_fn(psys)
    x = torch.tensor(batch)
    m = torch.tensor(masses)
    e, f = preps._forces(e_fn, x)
    s0 = MDState(x, torch.zeros_like(x), f, e)
    fin, es = preps.replica_nve_trajectory(s0, e_fn, m, dt, 5)
    assert es.shape == (5, 4)
    np.testing.assert_allclose(fin.positions.numpy(),
                               np.asarray(j_fin.positions), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(fin.velocities.numpy(),
                               np.asarray(j_fin.velocities), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(es.numpy(), np.asarray(j_es), rtol=1e-10)
    s = s0
    for _ in range(5):
        s = preps.replica_nve_step(s, e_fn, m, dt)
    np.testing.assert_allclose(s.positions.numpy(), fin.positions.numpy(),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(s.potential.numpy(), fin.potential.numpy(),
                               rtol=1e-12)


def test_vmap_friendly_system_routing():
    """"auto" on the dense periodic route becomes what it takes for one
    system on the device ("xla" on the CPU; "pallas", the batched
    kernels, for f32 on the card); an explicit method, the cell route and
    a non-periodic system stand; the routes the batch cannot take in one
    pass loop over single systems."""
    import dataclasses

    jsys, psys, pos, _ = _box()
    assert psys.spec.recip_method == "auto"
    assert preps.vmap_friendly_system(psys).spec.recip_method == "xla"
    pinned = psys._swap(spec=dataclasses.replace(psys.spec,
                                                 recip_method="pallas"))
    assert preps.vmap_friendly_system(pinned).spec.recip_method == "pallas"
    _, csys, _, _ = _cluster()
    assert preps.vmap_friendly_system(csys) is csys
    from torch_helpers import water_systems
    _, cell, cpos, _ = water_systems(n_side=4, cutoff=0.35)
    assert preps.vmap_friendly_system(cell) is cell
    assert not preps.batched_route(cell)
    x = torch.tensor(_batch(cpos, 2, seed=4, scale=0.005))
    from chargeflux_tpu_torch.energy import _energy
    e = preps.replica_energy_fn(cell)(x)
    assert e.shape == (2,)
    np.testing.assert_allclose(e.numpy(), [float(_energy(x[r], cell))
                                           for r in range(2)], rtol=1e-13)


def test_shard_replicas_takes_this_ranks_block():
    """``shard_replicas`` on a group: rank k of D gets replicas
    [k R/D, (k+1) R/D) (a one-rank gloo group here)."""
    import torch.distributed as dist

    from torch_helpers import gloo_group

    with gloo_group() as group:
        b = torch.arange(8.0).reshape(4, 2)
        np.testing.assert_array_equal(preps.shard_replicas(b, group).numpy(),
                                      b.numpy())
        with pytest.raises(ValueError):
            preps.shard_replicas(b[:3], _FakeMesh())
    assert not dist.is_initialized()


class _FakeMesh:
    mesh_dim_names = ("replica",)

    def get_group(self, dim):
        return None

    def get_local_rank(self, dim):
        return 1

    def size(self, dim):
        return 2
