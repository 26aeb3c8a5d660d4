"""PyTorch port: the impulse r-RESPA drivers (NVE and BAOAB NVT), held to
the JAX package in f64 on the CPU, the NVT one with the JAX package's
normals handed to the port (``torch_helpers.inject_noise``); with one
inner substep each reproduces its single-timestep driver."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.models import water_bonded_params as jax_bonded_params
from chargeflux_tpu_torch import integrate
from chargeflux_tpu_torch.models import water_bonded_params

from torch_helpers import (inject_noise, jax_chunk_normals, maxwell_start,
                           water_systems)

jintegrate = importlib.import_module("chargeflux_tpu.integrate")

torch.set_num_threads(2)

# n_side 6 at cutoff 0.55: 3 cells per axis, a 0.07 nm skin
BOX = dict(n_side=6, cutoff=0.55)
DT_OUT, N_INNER, N_STEPS, EVERY = 1e-3, 2, 8, 4


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def box():
    """(jax system, port system, x0, v0, masses, jax bonded, port bonded)
    of the small cell + SPME flexible water box, Maxwell at 300 K."""
    jsys, sys_t, pos, masses = water_systems(torch.float64, **BOX)
    x0, v0 = maxwell_start(pos, masses, seed=21)
    n_w = pos.shape[0] // 3
    b = np.asarray(jsys.box)
    return (jsys, sys_t, x0, v0, masses,
            jax_bonded_params(n_w, box=b, dtype=jnp.float64),
            water_bonded_params(n_w, box=b, dtype=torch.float64,
                                device="cpu"))


def _port(box):
    """The port's (state, slow_fn, fast_fn, init_nb, masses)."""
    _, sys_t, x0, v0, masses, _, tb = box
    slow_fn, fast_fn, init_nb = integrate.make_respa_force_fns(sys_t, tb)
    e_fn, _ = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    return s, slow_fn, fast_fn, init_nb, torch.as_tensor(masses)


def _jax(box):
    jsys, _, x0, v0, masses, jb, _ = box
    slow_fn, fast_fn, init_nb = jintegrate.make_respa_force_fns(jsys, jb)
    e_fn, _ = jintegrate.make_nb_energy_fn(jsys, bonded=jb)
    s = jintegrate.init_state_nb(jnp.asarray(x0), jnp.asarray(v0), e_fn,
                                 init_nb)
    return s, slow_fn, fast_fn, init_nb, jnp.asarray(masses)


def _same_final(fin, jfin, es, jes):
    assert es.shape == (N_STEPS,) and torch.isfinite(es).all()
    for f in ("positions", "velocities", "forces"):
        assert _rel(getattr(fin, f), getattr(jfin, f)) <= 1e-9, f
    assert _rel(es, jes) <= 1e-9
    np.testing.assert_allclose(float(fin.potential), float(jfin.potential),
                               rtol=1e-9)


def test_respa_force_fns_match_jax(box):
    """The two tiers at the start positions: slow and fast energies and
    forces within 1e-10 relative of the JAX package's."""
    s, slow_fn, fast_fn, init_nb, _ = _port(box)
    js, jslow, jfast, jinit, _ = _jax(box)
    e, f, _ = slow_fn(s.positions, init_nb(s.positions))
    je, jf, _ = jslow(js.positions, jinit(js.positions))
    assert abs(float(e) - float(je)) <= 1e-10 * abs(float(je))
    assert _rel(f, jf) <= 1e-10
    e, f = fast_fn(s.positions)
    je, jf = jfast(js.positions)
    assert abs(float(e) - float(je)) <= 1e-10 * abs(float(je))
    assert _rel(f, jf) <= 1e-10


def test_respa_trajectory_nb_matches_jax(box):
    """8 outer steps of 1 fs, 2 bonded substeps each, rebuilt every 4:
    positions, velocities, final forces, per-outer-step total energies and
    the final potential within 1e-9 relative."""
    s, slow_fn, fast_fn, init_nb, m = _port(box)
    js, jslow, jfast, jinit, jm = _jax(box)
    jfin, jes = jintegrate.respa_trajectory_nb(
        js, jslow, jfast, jinit, jm, DT_OUT, N_INNER, N_STEPS, EVERY)
    fin, es = integrate.respa_trajectory_nb(
        s, slow_fn, fast_fn, init_nb, m, DT_OUT, N_INNER, N_STEPS, EVERY)
    _same_final(fin, jfin, es, jes)


def test_respa_langevin_trajectory_nb_matches_jax(box, monkeypatch):
    """The NVT driver, same schedule, 300 K and 20/ps, with the JAX
    package's normals (one key per outer step, split once more per inner
    substep): positions, velocities, final forces, per-outer-step kinetic
    energies and the final potential within 1e-9 relative."""
    s, slow_fn, fast_fn, init_nb, m = _port(box)
    js, jslow, jfast, jinit, jm = _jax(box)
    key = jax.random.PRNGKey(8)
    jfin, jkes = jintegrate.respa_langevin_trajectory_nb(
        js, jslow, jfast, jinit, jm, DT_OUT, N_INNER, 300.0, 20.0, key,
        N_STEPS, EVERY)
    left = inject_noise(monkeypatch, jax_chunk_normals(
        key, N_STEPS // EVERY, EVERY, s.positions.shape, N_INNER))
    fin, kes = integrate.respa_langevin_trajectory_nb(
        s, slow_fn, fast_fn, init_nb, m, DT_OUT, N_INNER, 300.0, 20.0,
        torch.Generator().manual_seed(0), N_STEPS, EVERY)
    assert next(left, None) is None
    _same_final(fin, jfin, kes, jkes)


def test_respa_n_inner_1_is_velocity_verlet(box):
    """One substep: the impulse splitting is velocity Verlet on the total
    force (nve_trajectory_nb), up to the order of the force sums:
    positions within 1e-9 nm, velocities within 1e-7 nm/ps, as the JAX
    package's test holds."""
    s, slow_fn, fast_fn, init_nb, m = _port(box)
    _, sys_t, *_rest, tb = box
    e_fn, init_nb_t = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    ref, _ = integrate.nve_trajectory_nb(s, e_fn, init_nb_t, m, 5e-4, 20,
                                         rebuild_every=5)
    got, etots = integrate.respa_trajectory_nb(s, slow_fn, fast_fn, init_nb,
                                               m, 5e-4, 1, 20,
                                               rebuild_every=5)
    assert etots.shape == (20,)
    assert float((got.positions - ref.positions).abs().max()) <= 1e-9
    assert float((got.velocities - ref.velocities).abs().max()) <= 1e-7


def test_respa_langevin_n_inner_1_is_baoab(box):
    """One substep with the same generator state: the RESPA BAOAB driver
    is langevin_trajectory_nb (the same draws in the same order), up to
    the order of the force sums: positions within 1e-9 nm, kinetic
    energies within 1e-7 relative."""
    s, slow_fn, fast_fn, init_nb, m = _port(box)
    _, sys_t, *_rest, tb = box
    e_fn, init_nb_t = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    ref, kes_ref = integrate.langevin_trajectory_nb(
        s, e_fn, init_nb_t, m, 5e-4, 200.0, 20.0,
        torch.Generator().manual_seed(5), 20, rebuild_every=5)
    got, kes = integrate.respa_langevin_trajectory_nb(
        s, slow_fn, fast_fn, init_nb, m, 5e-4, 1, 200.0, 20.0,
        torch.Generator().manual_seed(5), 20, rebuild_every=5)
    assert float((got.positions - ref.positions).abs().max()) <= 1e-9
    np.testing.assert_allclose(kes.numpy(), kes_ref.numpy(), rtol=1e-7)
