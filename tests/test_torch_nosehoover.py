"""PyTorch port: the Nose-Hoover chain thermostat, held to the JAX package
in f64 on the CPU.  The thermostat is deterministic, so every function is
compared directly (within 1e-10), and a run resumed by handing the chain
back equals one run bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import integrate as jintegrate
from chargeflux_tpu import nosehoover as jnh
from chargeflux_tpu.models import water_bonded_params as jax_bonded_params
from chargeflux_tpu_torch import integrate, nosehoover as nh
from chargeflux_tpu_torch.models import water_bonded_params
from chargeflux_tpu_torch.units import BOLTZ

from torch_helpers import jax_water, maxwell_start, water_systems

torch.set_num_threads(2)

DT, TEMP, TAU = 5e-4, 300.0, 0.02


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _chains(n_dof=240, m=3):
    jc = jnh.nhc_init(n_dof, TEMP, TAU, m, jnp.float64)
    tc = nh.nhc_init(n_dof, TEMP, TAU, m, torch.float64, device="cpu")
    return jc, tc


def _water(dense=False):
    jsys, sys_t, pos, masses = (jax_water(4, 0.6, direct_method="dense")
                                if dense else
                                water_systems(torch.float64, n_side=6,
                                              cutoff=0.55))
    x0, v0 = maxwell_start(pos, masses, temp=450.0)
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)
    jb = jax_bonded_params(n_w, box=box, dtype=jnp.float64)
    tb = water_bonded_params(n_w, box=box, dtype=torch.float64, device="cpu")
    return jsys, sys_t, x0, v0, masses, jb, tb


@pytest.mark.parametrize("m", [2, 3, 5])
def test_nhc_init_matches_jax(m):
    jc, tc = _chains(m=m)
    for a, b in zip(tc, jc):
        assert np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        nh.nhc_init(10, TEMP, TAU, 1, device="cpu")


@pytest.mark.parametrize("n_sy", [1, 3])
def test_nhc_half_matches_jax(n_sy):
    """Three successive half updates from a moving chain, at kinetic
    energies above and below the target: the scale factors and the chain
    within 1e-13 relative."""
    jc, tc = _chains()
    rng = np.random.default_rng(1)
    v = rng.standard_normal(3) * 20.0
    jc = jnh.NHChain(jc.xi + 0.1, jnp.asarray(v), jc.q)
    tc = nh.NHChain(tc.xi + 0.1, torch.tensor(v), tc.q)
    kt = BOLTZ * TEMP
    for ke2 in (240 * kt * 1.4, 240 * kt * 0.7, 240 * kt):
        js, jc = jnh._nhc_half(jc, jnp.asarray(ke2), 240, kt, 0.5 * DT, n_sy)
        s, tc = nh._nhc_half(tc, torch.tensor(ke2, dtype=torch.float64), 240,
                             kt, 0.5 * DT, n_sy)
        np.testing.assert_allclose(float(s), float(js), rtol=1e-13)
        for a, b in zip(tc, jc):
            assert _rel(a, b) <= 1e-13


def test_step_and_conserved_match_jax():
    """nose_hoover_step on the dense route (two steps) and nhc_conserved:
    positions, velocities, forces, the chain and the invariant within
    1e-10 relative."""
    jsys, sys_t, x0, v0, masses, jb, tb = _water(dense=True)
    je_fn = jintegrate.make_energy_fn(jsys, bonded=jb)
    e_fn = integrate.make_energy_fn(sys_t, bonded=tb)
    js = jintegrate.init_state(jnp.asarray(x0), jnp.asarray(v0), je_fn)
    s = integrate.init_state(torch.as_tensor(x0), torch.as_tensor(v0), e_fn)
    n_dof = 3 * x0.shape[0] - 3
    jc, tc = _chains(n_dof)
    jm, m = jnp.asarray(masses), torch.as_tensor(masses)
    for _ in range(2):
        js, jc = jnh.nose_hoover_step(js, jc, je_fn, jm, DT, TEMP, n_dof)
        s, tc = nh.nose_hoover_step(s, tc, e_fn, m, DT, TEMP, n_dof)
    for f in ("positions", "velocities", "forces"):
        assert _rel(getattr(s, f), getattr(js, f)) <= 1e-10, f
    for a, b in zip(tc, jc):
        assert _rel(a, b) <= 1e-10
    jh = float(jnh.nhc_conserved(js, jc, jm, n_dof, TEMP))
    h = float(nh.nhc_conserved(s, tc, m, n_dof, TEMP))
    assert abs(h - jh) <= 1e-10 * abs(jh)


def test_trajectory_matches_jax():
    """12 dense steps (a chunk of 10 and a remainder of 2) from the default
    chain: positions, velocities, kinetic energies, the chain and the final
    potential within 1e-10 relative."""
    jsys, sys_t, x0, v0, masses, jb, tb = _water(dense=True)
    je_fn = jintegrate.make_energy_fn(jsys, bonded=jb)
    e_fn = integrate.make_energy_fn(sys_t, bonded=tb)
    js = jintegrate.init_state(jnp.asarray(x0), jnp.asarray(v0), je_fn)
    s = integrate.init_state(torch.as_tensor(x0), torch.as_tensor(v0), e_fn)
    jfin, jc, jkes = jnh.nose_hoover_trajectory(js, je_fn, jnp.asarray(masses),
                                                DT, TEMP, TAU, 12)
    fin, tc, kes = nh.nose_hoover_trajectory(s, e_fn, torch.as_tensor(masses),
                                             DT, TEMP, TAU, 12)
    assert kes.shape == (12,)
    assert _rel(fin.positions, jfin.positions) <= 1e-10
    assert _rel(fin.velocities, jfin.velocities) <= 1e-10
    assert _rel(kes, jkes) <= 1e-10
    for a, b in zip(tc, jc):
        assert _rel(a, b) <= 1e-10
    np.testing.assert_allclose(float(fin.potential), float(jfin.potential),
                               rtol=1e-10)


def test_trajectory_nb_matches_jax():
    """20 steps rebuilt every 5 on the cell + SPME box with a chain of 4:
    as the dense comparison, the final state's forces within 1e-10 and its
    fresh neighbor state equal to the JAX package's."""
    jsys, sys_t, x0, v0, masses, jb, tb = _water()
    je_fn, jinit = jintegrate.make_nb_energy_fn(jsys, bonded=jb)
    js = jintegrate.init_state_nb(jnp.asarray(x0), jnp.asarray(v0), je_fn,
                                  jinit)
    jfin, jc, jkes = jnh.nose_hoover_trajectory_nb(
        js, je_fn, jinit, jnp.asarray(masses), DT, TEMP, TAU, 20,
        rebuild_every=5, chain_length=4)
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    fin, tc, kes = nh.nose_hoover_trajectory_nb(
        s, e_fn, init_nb, torch.as_tensor(masses), DT, TEMP, TAU, 20,
        rebuild_every=5, chain_length=4)
    for f in ("positions", "velocities", "forces"):
        assert _rel(getattr(fin, f), getattr(jfin, f)) <= 1e-10, f
    assert _rel(kes, jkes) <= 1e-10
    for a, b in zip(tc, jc):
        assert _rel(a, b) <= 1e-10
    for f in ("slots", "inv_slot", "overflow"):
        assert np.array_equal(getattr(fin.nb, f).numpy(),
                              np.asarray(getattr(jfin.nb, f))), f


def test_resume_by_handing_the_chain_back_is_bit_for_bit():
    """One call of 20 steps (rebuilt every 5) equals a call of 10 and a
    second of 10 from its final state and chain, bit for bit: positions,
    velocities, forces, kinetic energies and the chain."""
    _, sys_t, x0, v0, masses, _, tb = _water()
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    m = torch.as_tensor(masses)

    def run(state, n, chain=None):
        return nh.nose_hoover_trajectory_nb(state, e_fn, init_nb, m, DT, TEMP,
                                            TAU, n, rebuild_every=5,
                                            chain=chain)

    whole, wc, kes = run(s, 20)
    half, hc, kes_a = run(s, 10)
    both, bc, kes_b = run(half, 10, hc)
    assert torch.equal(torch.cat([kes_a, kes_b]), kes)
    for f in ("positions", "velocities", "forces"):
        assert torch.equal(getattr(both, f), getattr(whole, f)), f
    for a, b in zip(bc, wc):
        assert torch.equal(a, b)
