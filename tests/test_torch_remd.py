"""PyTorch port: temperature replica exchange
(``parallel.remd_langevin_trajectory``) on the CPU in f64 — the JAX
package's three REMD properties (tests/test_remd.py) on the port's driver:
the swaps permute configurations (dt = 0), each slot samples its own
temperature with exchanges on, a flat ladder accepts every valid pair; the
exchange sweep against JAX's driver on pairs whose outcome no draw can
change; and the per-slot O-step coefficient against JAX's
``baoab_coeffs``."""

import numpy as np
import pytest
import torch

from chargeflux_tpu_torch.integrate import MDState
from chargeflux_tpu_torch.parallel import remd_langevin_trajectory
from chargeflux_tpu_torch.parallel.replicas import (pairing_tables,
                                                    slot_coefficients,
                                                    vmap_energy_fn, _forces)
from chargeflux_tpu_torch.units import BOLTZ

K_SPRING = 1000.0  # kJ/mol/nm^2


def _harmonic(x):
    return 0.5 * K_SPRING * torch.sum(x * x)


E_FN = vmap_energy_fn(_harmonic)


def _init_states(seed, r, n=1, spread=0.05):
    g = torch.Generator().manual_seed(seed)
    x = spread * torch.randn((r, n, 3), generator=g, dtype=torch.float64)
    pot, f = _forces(E_FN, x)
    return MDState(x, torch.zeros_like(x), f, pot)


def test_remd_swaps_are_a_permutation():
    """dt = 0: the BAOAB steps are the identity (c1 = 1, c2 = 0), so only
    the sweeps act and the multiset of configurations is kept exactly."""
    r = 4
    states = _init_states(0, r)
    m = torch.ones((1,), dtype=torch.float64)
    final, pots, accepts = remd_langevin_trajectory(
        states, E_FN, m, dt=0.0, temperatures=[100.0, 150.0, 225.0, 340.0],
        friction=1.0, generator=torch.Generator().manual_seed(3),
        n_steps=40, exchange_every=2)
    assert pots.shape == (20, 4) and accepts.shape == (20, 2)
    assert accepts.any()
    before = np.sort(states.positions.numpy().reshape(r, -1), axis=0)
    after = np.sort(final.positions.numpy().reshape(r, -1), axis=0)
    np.testing.assert_array_equal(before, after)
    np.testing.assert_allclose(np.sort(final.potential.numpy()),
                               np.sort(states.potential.numpy()),
                               rtol=1e-12)


def test_remd_equipartition_per_slot():
    """Each slot samples its own canonical ensemble while configurations
    move: <PE> = (3/2) kT per slot in a 3-D harmonic well (15 %)."""
    r = 4
    temps = np.array([100.0, 180.0, 320.0, 580.0])
    states = _init_states(1, r)
    m = torch.ones((1,), dtype=torch.float64)
    _final, pots, accepts = remd_langevin_trajectory(
        states, E_FN, m, dt=2e-3, temperatures=temps, friction=20.0,
        generator=torch.Generator().manual_seed(7), n_steps=30000,
        exchange_every=10)
    pots = pots.numpy()
    mean_pe = pots[len(pots) // 3:].mean(axis=0)
    acc = accepts.double().mean().item()
    assert 0.05 < acc < 1.0
    np.testing.assert_allclose(mean_pe, 1.5 * BOLTZ * temps, rtol=0.15)


def test_remd_equal_temperatures_accept_everything():
    """A flat ladder has delta = 0: every valid attempt accepts, and the
    padded pair of the odd sweeps never does."""
    r = 4
    states = _init_states(2, r)
    m = torch.ones((1,), dtype=torch.float64)
    _final, _pots, accepts = remd_langevin_trajectory(
        states, E_FN, m, dt=1e-3, temperatures=[200.0] * r, friction=10.0,
        generator=torch.Generator().manual_seed(5), n_steps=40,
        exchange_every=2)
    accepts = accepts.numpy()
    assert accepts[0::2].all()
    assert accepts[1::2, 0].all()
    assert not accepts[1::2, 1].any()


@pytest.mark.parametrize("r", [4, 5])
def test_remd_sweep_matches_jax_on_decided_pairs(r):
    """The exchange sweep against JAX's on the same states, free of the
    random draws: at dt = 0 only the sweeps act, and on a doubling ladder
    with configuration energies 2000 kJ/mol apart every attempted pair
    has delta > 0 (accepted whatever u) or delta < -150 (log u, with
    u >= 2^-53, never falls below -37).  So the Metropolis sign, the permutation and the
    sqrt(T_dest / T_src) velocity rescale must agree with JAX's, sweep by
    sweep: both accepts and rejects occur, as the configurations sort
    themselves down the ladder."""
    import jax
    import jax.numpy as jnp

    from chargeflux_tpu.integrate import MDState as JState
    from chargeflux_tpu.parallel import remd_langevin_trajectory as j_remd

    n = 2
    rng = np.random.default_rng(11)
    temps = 100.0 * 2.0 ** np.arange(r)
    energies = 10.0 + 2000.0 * rng.permutation(r)
    d = rng.normal(size=(r, n, 3))
    scale = np.sqrt(2.0 * energies / (K_SPRING * np.sum(d * d, axis=(1, 2))))
    x = d * scale[:, None, None]
    v = rng.normal(size=(r, n, 3))
    m = np.full((n,), 2.0)
    kw = dict(dt=0.0, temperatures=temps, friction=5.0, n_steps=12,
              exchange_every=2)

    xt = torch.tensor(x)
    pot, f = _forces(E_FN, xt)
    final, pots, accepts = remd_langevin_trajectory(
        MDState(xt, torch.tensor(v), f, pot), E_FN, torch.tensor(m),
        generator=torch.Generator().manual_seed(3), **kw)

    def j_harmonic(y):
        return 0.5 * K_SPRING * jnp.sum(y * y)

    xj = jnp.asarray(x)
    j_final, j_pots, j_accepts = j_remd(
        JState(xj, jnp.asarray(v), -jax.vmap(jax.grad(j_harmonic))(xj),
               jax.vmap(j_harmonic)(xj)),
        j_harmonic, jnp.asarray(m), key=jax.random.PRNGKey(3), **kw)

    j_acc = np.asarray(j_accepts)
    valid = np.array([pairing_tables(r)[s % 2][2]
                      for s in range(len(j_acc))])
    assert j_acc[valid].any() and not j_acc[valid].all()
    np.testing.assert_array_equal(accepts.numpy(), j_acc)
    np.testing.assert_array_equal(final.positions.numpy(),
                                  np.asarray(j_final.positions))
    np.testing.assert_allclose(final.velocities.numpy(),
                               np.asarray(j_final.velocities), rtol=1e-15)
    np.testing.assert_allclose(final.forces.numpy(),
                               np.asarray(j_final.forces), rtol=1e-15)
    np.testing.assert_allclose(pots.numpy(), np.asarray(j_pots), rtol=1e-14)
    np.testing.assert_allclose(final.potential.numpy(),
                               np.sort(energies), rtol=1e-12)


def test_slot_coefficients_match_jax_baoab_coeffs():
    """c2 per slot is JAX's ``baoab_coeffs(dt, friction, T)[1]``; the
    pairing tables are JAX's even-odd ones."""
    import jax
    import jax.numpy as jnp

    from chargeflux_tpu.integrate import baoab_coeffs as j_coeffs

    temps = 300.0 * (450.0 / 300.0) ** (np.arange(6) / 5)
    like = torch.zeros((), dtype=torch.float64)
    t, c2 = slot_coefficients(5e-4, 5.0, temps, like)
    want = [float(j_coeffs(5e-4, 5.0, float(x), jnp.float64)[1])
            for x in temps]
    np.testing.assert_allclose(t.numpy(), temps, rtol=0)
    np.testing.assert_allclose(c2.numpy(), want, rtol=1e-14)
    assert pairing_tables(4) == (([0, 2], [1, 3], [True, True]),
                                 ([1, 0], [2, 0], [True, False]))
    assert pairing_tables(5) == (([0, 2], [1, 3], [True, True]),
                                 ([1, 3], [2, 4], [True, True]))
    assert jax.devices()[0].platform == "cpu"


def test_remd_rejects_a_bad_call():
    states = _init_states(3, 4)
    m = torch.ones((1,), dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="multiple"):
        remd_langevin_trajectory(states, E_FN, m, 1e-3, [300.0] * 4, 1.0, g,
                                 15, exchange_every=10)
    with pytest.raises(ValueError, match="temperatures"):
        remd_langevin_trajectory(states, E_FN, m, 1e-3, [300.0] * 3, 1.0, g,
                                 20, exchange_every=10)
