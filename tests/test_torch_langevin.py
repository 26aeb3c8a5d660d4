"""PyTorch port: the BAOAB Langevin drivers and FIRE, held to the JAX
package in f64 on the CPU.

The port draws its noise from a ``torch.Generator``, the JAX package from
its key chain, so the comparisons hand the port the JAX package's normals
(``torch_helpers.inject_noise``), in the order the JAX driver draws them.
The port's own contract, resuming with the generator carried on, is held
bit for bit; the thermostat's target temperature, by statistics."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.models import water_bonded_params as jax_bonded_params
from chargeflux_tpu_torch import integrate
from chargeflux_tpu_torch.models import water_bonded_params

from torch_helpers import (inject_noise, jax_chunk_normals, jax_normals,
                           jax_water, maxwell_start, water_systems)

jintegrate = importlib.import_module("chargeflux_tpu.integrate")

torch.set_num_threads(2)

DT, TEMP, FRICTION = 5e-4, 300.0, 20.0
# n_side 6 at cutoff 0.55: 3 cells per axis, a 0.07 nm skin
BOX = dict(n_side=6, cutoff=0.55)


def _rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _flexible(dense=False):
    """(jax system, port system, x0, v0, masses, jax bonded, port bonded)
    of the small cell + SPME water box (or, ``dense``, a 192-atom box on
    the dense route with classical Ewald), Maxwell velocities at 300 K."""
    jsys, sys_t, pos, masses = (
        jax_water(4, 0.6, direct_method="dense") if dense
        else water_systems(torch.float64, **BOX))
    x0, v0 = maxwell_start(pos, masses)
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)
    jb = jax_bonded_params(n_w, box=box, dtype=jnp.float64)
    tb = water_bonded_params(n_w, box=box, dtype=torch.float64, device="cpu")
    return jsys, sys_t, x0, v0, masses, jb, tb


def test_baoab_coeffs_match_jax():
    """The O-step's coefficients in f64: to the last bit or two (rtol
    1e-15)."""
    for dt, fr, t in ((5e-4, 20.0, 300.0), (2e-3, 5.0, 250.0)):
        c = integrate.baoab_coeffs(dt, fr, t)
        jc = jintegrate.baoab_coeffs(dt, fr, t, jnp.float64)
        np.testing.assert_allclose(c, [float(v) for v in jc], rtol=1e-15)


def test_langevin_step_and_trajectory_match_jax(monkeypatch):
    """langevin_step, then langevin_trajectory over 12 steps (a chunk of
    10 and a remainder of 2) on the dense route with the JAX package's
    normals: positions within 1e-12 relative after the step, positions
    and kinetic energies within 1e-9 relative after the trajectory; the
    final potential within 1e-9 relative."""
    jsys, sys_t, x0, v0, masses, jb, tb = _flexible(dense=True)
    je_fn = jintegrate.make_energy_fn(jsys, bonded=jb)
    e_fn = integrate.make_energy_fn(sys_t, bonded=tb)
    jm, m = jnp.asarray(masses), torch.as_tensor(masses)
    js = jintegrate.init_state(jnp.asarray(x0), jnp.asarray(v0), je_fn)
    s = integrate.init_state(torch.as_tensor(x0), torch.as_tensor(v0), e_fn)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(3)

    j1 = jintegrate.langevin_step(js, je_fn, jm, DT, TEMP, FRICTION, key)
    inject_noise(monkeypatch, jax_normals([key], x0.shape))
    s1 = integrate.langevin_step(s, e_fn, m, DT, TEMP, FRICTION, gen)
    assert _rel(s1.positions, j1.positions) <= 1e-12
    assert _rel(s1.velocities, j1.velocities) <= 1e-12

    n = 12
    keys, k = [], key
    for _ in range(n):
        k, sub = jax.random.split(k)
        keys.append(sub)
    jfin, jkes = jintegrate.langevin_trajectory(js, je_fn, jm, DT, TEMP,
                                                FRICTION, key, n)
    inject_noise(monkeypatch, jax_normals(keys, x0.shape))
    fin, kes = integrate.langevin_trajectory(s, e_fn, m, DT, TEMP, FRICTION,
                                             gen, n)
    assert kes.shape == (n,) and torch.isfinite(kes).all()
    assert _rel(fin.positions, jfin.positions) <= 1e-9
    assert _rel(kes, jkes) <= 1e-9
    np.testing.assert_allclose(float(fin.potential), float(jfin.potential),
                               rtol=1e-9)


def test_langevin_trajectory_nb_matches_jax(monkeypatch):
    """20 steps rebuilt every 5 with the JAX package's normals (its key
    chain: one split per chunk, one key per step): positions, velocities
    and kinetic energies within 1e-9 relative; the final state keeps the
    carry forces (within 1e-9 relative of JAX's) and a fresh neighbor
    state equal to JAX's."""
    jsys, sys_t, x0, v0, masses, jb, tb = _flexible()
    je_fn, jinit = jintegrate.make_nb_energy_fn(jsys, bonded=jb)
    js = jintegrate.init_state_nb(jnp.asarray(x0), jnp.asarray(v0), je_fn,
                                  jinit)
    key = jax.random.PRNGKey(7)
    jfin, jkes = jintegrate.langevin_trajectory_nb(
        js, je_fn, jinit, jnp.asarray(masses), DT, TEMP, FRICTION, key, 20,
        rebuild_every=5)

    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    left = inject_noise(monkeypatch, jax_chunk_normals(key, 4, 5, x0.shape))
    fin, kes = integrate.langevin_trajectory_nb(
        s, e_fn, init_nb, torch.as_tensor(masses), DT, TEMP, FRICTION,
        torch.Generator().manual_seed(0), 20, rebuild_every=5)
    assert next(left, None) is None          # every normal drawn, in order
    assert kes.shape == (20,) and torch.isfinite(kes).all()
    assert _rel(fin.positions, jfin.positions) <= 1e-9
    assert _rel(fin.velocities, jfin.velocities) <= 1e-9
    assert _rel(fin.forces, jfin.forces) <= 1e-9
    assert _rel(kes, jkes) <= 1e-9
    np.testing.assert_allclose(float(fin.potential), float(jfin.potential),
                               rtol=1e-9)
    for f in ("slots", "inv_slot", "overflow"):
        assert np.array_equal(getattr(fin.nb, f).numpy(),
                              np.asarray(getattr(jfin.nb, f))), f


@pytest.mark.parametrize("split", [(4, 4), (2, 6)],
                         ids=["half", "one_chunk_first"])
def test_langevin_trajectory_nb_resumes_bit_for_bit(split):
    """One call of 8 steps (rebuilt every 2) equals two calls of whole
    chunks that add up to 8 with the generator carried from the first to
    the second, bit for
    bit (positions, velocities, forces, kinetic energies, potential): a
    generator continues where it stopped, where the JAX package needs
    advance_key."""
    _, sys_t, x0, v0, masses, _, tb = _flexible()
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    m = torch.as_tensor(masses)

    def run(state, n, gen):
        return integrate.langevin_trajectory_nb(
            state, e_fn, init_nb, m, DT, TEMP, FRICTION, gen, n,
            rebuild_every=2)

    whole, kes = run(s, 8, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    half, kes_a = run(s, split[0], gen)
    both, kes_b = run(half, split[1], gen)
    assert torch.isfinite(kes).all()
    assert torch.equal(torch.cat([kes_a, kes_b]), kes)
    for f in ("positions", "velocities", "forces", "potential"):
        assert torch.equal(getattr(both, f), getattr(whole, f)), f


def test_successive_calls_draw_new_noise():
    """Two calls from the same state with one generator draw different
    normals: their kinetic energies differ; a generator seeded alike
    gives the first call's bits."""
    _, sys_t, x0, v0, masses, _, tb = _flexible()
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    m = torch.as_tensor(masses)
    gen = torch.Generator().manual_seed(9)
    runs = [integrate.langevin_trajectory_nb(
        s, e_fn, init_nb, m, DT, TEMP, FRICTION, g, 5, rebuild_every=5)[1]
        for g in (gen, gen, torch.Generator().manual_seed(9))]
    assert not torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], runs[2])


def test_generator_of_another_device_raises():
    """A generator must live where the state does."""
    import types

    _, sys_t, x0, v0, masses, _, tb = _flexible()
    e_fn = integrate.make_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state(torch.as_tensor(x0), torch.as_tensor(v0), e_fn)
    gen = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError):
        integrate.langevin_trajectory(s, e_fn, torch.as_tensor(masses), DT,
                                      TEMP, FRICTION, gen, 3)


def test_minimize_fire_matches_jax():
    """30 FIRE steps from the lattice on the dense route: positions
    within 1e-9 relative of the JAX package's, final energies within 1e-9
    relative, and the energy went down."""
    jsys, sys_t, pos, _ = jax_water(4, 0.6, direct_method="dense")
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)
    je_fn = jintegrate.make_energy_fn(
        jsys, bonded=jax_bonded_params(n_w, box=box, dtype=jnp.float64))
    e_fn = integrate.make_energy_fn(
        sys_t, bonded=water_bonded_params(n_w, box=box, dtype=torch.float64,
                                          device="cpu"))
    jx, je = jintegrate.minimize_fire(jnp.asarray(pos), je_fn, n_steps=30)
    x, e = integrate.minimize_fire(torch.as_tensor(pos), e_fn, n_steps=30)
    assert _rel(x, jx) <= 1e-9
    np.testing.assert_allclose(float(e), float(je), rtol=1e-9)
    with torch.no_grad():
        assert float(e) < float(e_fn(torch.as_tensor(pos)))


def test_flexible_box_thermalizes_to_the_target():
    """A flexible 81-atom box (dense route, bonded water) from rest under
    BAOAB at 0.5 fs, friction 50/ps: over the last 300 of 600 steps the
    mean kinetic temperature (3N degrees of freedom) is within 30 % of
    300 K, the window of the JAX package's rigid-water test."""
    jsys, sys_t, pos, masses = jax_water(3, 0.45, direct_method="dense")
    n_w = pos.shape[0] // 3
    e_fn = integrate.make_energy_fn(
        sys_t, bonded=water_bonded_params(n_w, box=np.asarray(jsys.box),
                                          dtype=torch.float64, device="cpu"))
    x = torch.as_tensor(pos)
    s = integrate.init_state(x, torch.zeros_like(x), e_fn)
    m = torch.as_tensor(masses)
    fin, kes = integrate.langevin_trajectory(
        s, e_fn, m, DT, TEMP, 50.0, torch.Generator().manual_seed(2), 600)
    assert torch.isfinite(kes).all()
    temps = 2.0 * kes[300:] / (3 * x.shape[0] * integrate.BOLTZ)
    assert 0.7 * TEMP < float(temps.mean()) < 1.3 * TEMP
    np.testing.assert_allclose(
        float(integrate.temperature(fin.velocities, m)),
        float(2.0 * integrate.kinetic_energy(fin.velocities, m)
              / (3 * x.shape[0] * integrate.BOLTZ)), rtol=1e-12)


def _port_drivers():
    """Per stochastic ``*_nb`` driver, ``run(n, generator)`` on a port-only
    small box (cell + SPME, f64, CPU): flexible water for the Langevin and
    RESPA drivers, rigid water for the RATTLE one; chunks of 2."""
    from chargeflux_tpu_torch import constraints as con
    from chargeflux_tpu_torch.models import rigid_water_box, water_box

    force, pos, masses, box = water_box(**BOX)
    sys_f = force.create_system(box=box, dtype=torch.float64,
                                direct_method="cell", recip_method="pme",
                                device="cpu")
    tb = water_bonded_params(len(masses) // 3, box=box, dtype=torch.float64,
                             device="cpu")
    rforce, rpos, rmasses, rbox, params = rigid_water_box(
        n_side=6, cutoff=0.5, device="cpu")
    sys_r = rforce.create_system(box=rbox, dtype=torch.float64,
                                 direct_method="cell", recip_method="pme",
                                 device="cpu")
    nb = integrate.make_nb_energy_fn(sys_f, bonded=tb)
    respa = integrate.make_respa_force_fns(sys_f, tb)
    rnb = integrate.make_nb_energy_fn(sys_r)
    x, m = torch.as_tensor(pos), torch.as_tensor(masses)
    xr, mr = torch.as_tensor(rpos), torch.as_tensor(rmasses)
    s = integrate.init_state_nb(x, torch.zeros_like(x), *nb)
    sr = integrate.init_state_nb(xr, torch.zeros_like(xr), *rnb)
    return {
        "langevin_nb": lambda n, g: integrate.langevin_trajectory_nb(
            s, *nb, m, DT, TEMP, FRICTION, g, n, 2),
        "respa_langevin_nb": lambda n, g:
            integrate.respa_langevin_trajectory_nb(
                s, *respa, m, 2 * DT, 2, TEMP, FRICTION, g, n, 2),
        "rattle_langevin_nb": lambda n, g:
            con.rattle_langevin_trajectory_nb(
                sr, *rnb, mr, 2e-3, TEMP, FRICTION, g, n, params, 2),
    }


@pytest.mark.parametrize("driver", ["langevin_nb", "respa_langevin_nb",
                                    "rattle_langevin_nb"])
def test_a_noise_chunk_makes_no_host_copy_and_reads_nothing_back(
        driver, monkeypatch):
    """The CPU stand-in for the capture of a chunk that draws noise (and,
    rigid, projects): after a warm-up call, host copies and host reads
    raise (``torch_helpers.forbid_host_traffic``) and two chunks still
    run, giving the bits of the same chunks run unpatched from the same
    generator state."""
    from torch_helpers import forbid_host_traffic

    run = _port_drivers()[driver]
    run(2, torch.Generator().manual_seed(1))
    want = run(4, torch.Generator().manual_seed(6))
    with monkeypatch.context() as patch:
        forbid_host_traffic(patch)
        got = run(4, torch.Generator().manual_seed(6))
    assert torch.isfinite(got[1]).all()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].positions, want[0].positions)
