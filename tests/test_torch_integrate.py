"""PyTorch port: neighbor-state helpers and the NVE-with-reuse driver held
to the JAX package (f64, same start state, same rebuild schedule)."""

import importlib

import jax.numpy as jnp
import numpy as np
import torch

from chargeflux_tpu import neighbors as jnb
from chargeflux_tpu.models import water_bonded_params as jax_bonded_params
from chargeflux_tpu_torch import integrate, neighbors
from chargeflux_tpu_torch.models import water_bonded_params

from torch_helpers import jax_water, water_systems

jintegrate = importlib.import_module("chargeflux_tpu.integrate")

torch.set_num_threads(2)


def _start(pos, masses, seed=11):
    """Maxwell velocities at 300 K from a NumPy seed (both packages get
    the same numbers)."""
    rng = np.random.default_rng(seed)
    sig = np.sqrt(0.008314462618 * 300.0 / masses)[:, None]
    return pos, rng.standard_normal(pos.shape) * sig


def test_neighbor_helpers_match_jax():
    jsys, sys_t, pos, _ = water_systems(torch.float64)
    assert float(neighbors.skin_radius(sys_t)) == float(jnb.skin_radius(jsys))
    for speed in (8.0, 24.0):
        assert neighbors.suggest_rebuild_interval(sys_t, 5e-4, speed, 40) == \
            jnb.suggest_rebuild_interval(jsys, 5e-4, speed, 40)
    x = torch.as_tensor(pos)
    state = neighbors.build_neighbor_state(x, sys_t)
    jstate = jnb.build_neighbor_state(jnp.asarray(pos), jsys)
    for f in ("slots", "inv_slot", "wrap", "x_ref", "overflow"):
        assert np.array_equal(np.asarray(getattr(state, f)),
                              np.asarray(getattr(jstate, f))), f
    half = 0.5 * float(neighbors.skin_radius(sys_t))
    for step in (0.9 * half, 1.1 * half):
        y = pos.copy()
        y[7, 1] += step
        assert bool(neighbors.neighbor_state_fresh(
            state, torch.as_tensor(y), sys_t)) == bool(
            jnb.neighbor_state_fresh(jstate, jnp.asarray(y), jsys)) == (
            step < half)


def test_nve_trajectory_matches_jax_f64():
    """20 velocity-Verlet steps, rebuild every 5, with the harmonic water
    bonds and angles: positions within 1e-9 nm of the JAX trajectory."""
    jsys, sys_t, pos, masses = water_systems(torch.float64)
    x0, v0 = _start(pos, masses)
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)

    jb = jax_bonded_params(n_w, box=box, dtype=jnp.float64)
    je_fn, jinit = jintegrate.make_nb_energy_fn(jsys, bonded=jb)
    js = jintegrate.init_state_nb(jnp.asarray(x0), jnp.asarray(v0), je_fn,
                                  jinit)
    jfin, jes = jintegrate.nve_trajectory_nb(js, je_fn, jinit,
                                             jnp.asarray(masses), 5e-4, 20,
                                             rebuild_every=5)

    tb = water_bonded_params(n_w, box=box, dtype=torch.float64, device="cpu")
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    assert abs(float(s.potential) - float(js.potential)) <= \
        1e-10 * abs(float(js.potential))
    fin, es = integrate.nve_trajectory_nb(s, e_fn, init_nb,
                                          torch.as_tensor(masses), 5e-4, 20,
                                          rebuild_every=5)
    assert es.shape == (20,) and torch.isfinite(es).all()
    assert np.abs(fin.positions.numpy() - np.asarray(jfin.positions)).max() \
        <= 1e-9
    assert np.abs(fin.velocities.numpy()
                  - np.asarray(jfin.velocities)).max() <= 1e-6
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-9)
    assert abs(float(fin.potential) - float(jfin.potential)) <= \
        1e-9 * abs(float(jfin.potential))


def test_dense_nve_trajectory_matches_jax_f64():
    """The dense route (no neighbor state, classical Ewald): 20 steps from
    Maxwell velocities, positions within 1e-9 nm of the JAX trajectory."""
    jsys, sys_t, pos, masses = jax_water(4, 0.6, direct_method="dense")
    x0, v0 = _start(pos, masses)
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)

    jb = jax_bonded_params(n_w, box=box, dtype=jnp.float64)
    je_fn, jinit = jintegrate.make_nb_energy_fn(jsys, bonded=jb)
    js = jintegrate.init_state_nb(jnp.asarray(x0), jnp.asarray(v0), je_fn,
                                  jinit)
    jfin, jes = jintegrate.nve_trajectory_nb(js, je_fn, jinit,
                                             jnp.asarray(masses), 5e-4, 20,
                                             rebuild_every=10)

    tb = water_bonded_params(n_w, box=box, dtype=torch.float64, device="cpu")
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    assert init_nb(torch.as_tensor(x0)) is None
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    fin, es = integrate.nve_trajectory_nb(s, e_fn, init_nb,
                                          torch.as_tensor(masses), 5e-4, 20,
                                          rebuild_every=10)
    assert fin.nb is None and es.shape == (20,) and torch.isfinite(es).all()
    assert np.abs(fin.positions.numpy() - np.asarray(jfin.positions)).max() \
        <= 1e-9
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-9)


def test_bonded_energy_and_grad_match_jax():
    import jax

    from chargeflux_tpu.bonded import bonded_energy as jax_bonded_energy
    from chargeflux_tpu_torch.bonded import bonded_energy

    _, _, pos, _ = water_systems(torch.float64)
    n_w = pos.shape[0] // 3
    box = np.full(3, 7 * 0.3107)
    x = pos + np.random.default_rng(3).normal(0.0, 0.005, pos.shape)
    jb = jax_bonded_params(n_w, box=box, dtype=jnp.float64)
    e_j, g_j = jax.value_and_grad(jax_bonded_energy)(jnp.asarray(x), jb)
    tb = water_bonded_params(n_w, box=box, dtype=torch.float64, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    e_t = bonded_energy(xt, tb)
    (g_t,) = torch.autograd.grad(e_t, xt)
    assert tb.template is not None
    assert abs(float(e_t.detach()) - float(e_j)) <= 1e-12 * abs(float(e_j))
    assert np.abs(g_t.numpy() - np.asarray(g_j)).max() <= \
        1e-10 * np.abs(np.asarray(g_j)).max()


def test_stale_neighbor_state_poisons_energy_and_forces():
    """An atom past skin/2 since the rebuild: the freshness guard turns
    energy and every force to NaN."""
    _, sys_t, pos, _ = water_systems(torch.float64)
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t)
    x = torch.as_tensor(pos)
    nb = init_nb(x)
    e, f, _ = e_fn(x, nb)
    assert torch.isfinite(e) and torch.isfinite(f).all()
    y = x.clone()
    y[3, 2] += 0.6 * float(neighbors.skin_radius(sys_t))
    e, f, _ = e_fn(y, nb)
    assert torch.isnan(e) and torch.isnan(f).all()
