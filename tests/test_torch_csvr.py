"""PyTorch port: the CSVR (Bussi velocity-rescaling) thermostat, held to the
JAX package in f64 on the CPU.

The port draws each rescale's normal and chi-squared variate from a
``torch.Generator`` (``csvr.scalar_normal``, ``csvr.chi_squared``), the JAX
package from its key chain, so the comparisons hand the port the JAX
package's draws in its order (and the BAOAB-free drivers draw nothing
else).  The port's own draws are held to the canonical statistics of an
ideal gas, and resuming with the generator carried on, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import csvr as jcsvr
from chargeflux_tpu import integrate as jintegrate
from chargeflux_tpu.models import water_bonded_params as jax_bonded_params
from chargeflux_tpu_torch import csvr, integrate
from chargeflux_tpu_torch.models import water_bonded_params
from chargeflux_tpu_torch.units import BOLTZ

from torch_helpers import jax_water, maxwell_start, water_systems

torch.set_num_threads(2)

DT, TEMP, TAU = 5e-4, 300.0, 0.1


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_draws(keys, n_dof):
    """The (R1, S) of ``csvr_scale`` for each key: ``k1, k2 = split(key)``,
    a normal of k1 and 2 Gamma((n_dof - 1) / 2) of k2, in f64."""
    out = []
    for key in keys:
        k1, k2 = jax.random.split(key)
        out.append((float(jax.random.normal(k1, dtype=jnp.float64)),
                    float(2.0 * jax.random.gamma(
                        k2, jnp.asarray(0.5 * (n_dof - 1), jnp.float64),
                        dtype=jnp.float64))))
    return out


def _inject(monkeypatch, draws):
    """Make the port's two draw functions hand out ``draws`` in order."""
    it = iter(draws)
    cur = {}

    def normal(like, generator):
        cur["s"] = next(it)
        return torch.tensor(cur["s"][0], dtype=like.dtype)

    def chi2(dof, like, generator):
        return torch.tensor(cur.pop("s")[1], dtype=like.dtype)

    monkeypatch.setattr(csvr, "scalar_normal", normal)
    monkeypatch.setattr(csvr, "chi_squared", chi2)
    return it


def _water(dense=False):
    jsys, sys_t, pos, masses = (jax_water(4, 0.6, direct_method="dense")
                                if dense else
                                water_systems(torch.float64, n_side=6,
                                              cutoff=0.55))
    x0, v0 = maxwell_start(pos, masses)
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)
    jb = jax_bonded_params(n_w, box=box, dtype=jnp.float64)
    tb = water_bonded_params(n_w, box=box, dtype=torch.float64, device="cpu")
    return jsys, sys_t, x0, v0, masses, jb, tb


@pytest.mark.parametrize("kin", [1e-13, 0.7, 250.0])
def test_csvr_scale_matches_jax(kin, monkeypatch):
    """(alpha, dK) from the same draws within 1e-14 relative, including a
    kinetic energy below the 1e-12 guard."""
    key = jax.random.PRNGKey(5)
    n_dof = 243
    ja, jdk = jcsvr.csvr_scale(jnp.asarray(kin, jnp.float64), n_dof, DT, TAU,
                               TEMP, key, jnp.float64)
    _inject(monkeypatch, _jax_draws([key], n_dof))
    a, dk = csvr.csvr_scale(torch.tensor(kin, dtype=torch.float64), n_dof,
                            DT, TAU, TEMP, torch.Generator())
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-14)
    np.testing.assert_allclose(float(dk), float(jdk), rtol=1e-14)


def test_csvr_trajectory_nb_matches_jax(monkeypatch):
    """20 steps rebuilt every 5 on the cell + SPME box with the JAX
    package's draws (one split per chunk, one key per step): positions,
    velocities and the etot / kinetic / work series within 1e-9."""
    jsys, sys_t, x0, v0, masses, jb, tb = _water()
    je_fn, jinit = jintegrate.make_nb_energy_fn(jsys, bonded=jb)
    js = jintegrate.init_state_nb(jnp.asarray(x0), jnp.asarray(v0), je_fn,
                                  jinit)
    key = jax.random.PRNGKey(6)
    jfin, jdiag = jcsvr.csvr_trajectory_nb(js, je_fn, jinit,
                                           jnp.asarray(masses), DT, TEMP, TAU,
                                           key, 20, rebuild_every=5)
    keys, k = [], key
    for _ in range(4):
        k, sub = jax.random.split(k)
        keys.extend(jax.random.split(sub, 5))
    left = _inject(monkeypatch, _jax_draws(keys, 3 * x0.shape[0]))
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    fin, diag = csvr.csvr_trajectory_nb(
        s, e_fn, init_nb, torch.as_tensor(masses), DT, TEMP, TAU,
        torch.Generator().manual_seed(0), 20, rebuild_every=5)
    assert next(left, None) is None
    assert _rel(fin.positions, jfin.positions) <= 1e-9
    assert _rel(fin.velocities, jfin.velocities) <= 1e-9
    for name in ("etot", "kinetic", "work"):
        assert diag[name].shape == (20,)
        assert _rel(diag[name], jdiag[name]) <= 1e-9, name
    np.testing.assert_allclose(float(fin.potential), float(jfin.potential),
                               rtol=1e-9)


def test_csvr_trajectory_matches_jax(monkeypatch):
    """12 steps on the dense route (a chunk of 10 and a remainder of 2),
    one key split per step, with the JAX package's draws and 3 constrained
    degrees of freedom taken off: as the nb comparison, and the final
    potential within 1e-9."""
    jsys, sys_t, x0, v0, masses, jb, tb = _water(dense=True)
    je_fn = jintegrate.make_energy_fn(jsys, bonded=jb)
    js = jintegrate.init_state(jnp.asarray(x0), jnp.asarray(v0), je_fn)
    key = jax.random.PRNGKey(8)
    jfin, jdiag = jcsvr.csvr_trajectory(js, je_fn, jnp.asarray(masses), DT,
                                        TEMP, TAU, key, 12, n_constraints=3)
    keys, k = [], key
    for _ in range(12):
        k, kk = jax.random.split(k)
        keys.append(kk)
    _inject(monkeypatch, _jax_draws(keys, 3 * x0.shape[0] - 3))
    e_fn = integrate.make_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state(torch.as_tensor(x0), torch.as_tensor(v0), e_fn)
    fin, diag = csvr.csvr_trajectory(s, e_fn, torch.as_tensor(masses), DT,
                                     TEMP, TAU, torch.Generator(), 12,
                                     n_constraints=3)
    assert _rel(fin.positions, jfin.positions) <= 1e-9
    for name in ("etot", "kinetic", "work"):
        assert _rel(diag[name], jdiag[name]) <= 1e-9, name
    np.testing.assert_allclose(float(fin.potential), float(jfin.potential),
                               rtol=1e-9)


def test_resume_with_the_generator_carried_is_bit_for_bit():
    """One call of 20 steps (rebuilt every 5) equals two calls of 10 with
    the generator carried from the first to the second, bit for bit:
    positions, velocities, forces and the kinetic series (the work
    restarts at 0 with each call, as in the JAX package)."""
    _, sys_t, x0, v0, masses, _, tb = _water()
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    m = torch.as_tensor(masses)

    def run(state, n, gen):
        return csvr.csvr_trajectory_nb(state, e_fn, init_nb, m, DT, TEMP,
                                       TAU, gen, n, rebuild_every=5)

    whole, d = run(s, 20, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    half, d_a = run(s, 10, gen)
    both, d_b = run(half, 10, gen)
    assert torch.equal(torch.cat([d_a["kinetic"], d_b["kinetic"]]),
                       d["kinetic"])
    for f in ("positions", "velocities", "forces"):
        assert torch.equal(getattr(both, f), getattr(whole, f)), f
    fresh, d_c = run(half, 10, gen)
    assert not torch.equal(d_c["kinetic"], d_b["kinetic"])


def test_ideal_gas_canonical_statistics():
    """The port's own draws on an ideal gas (81 free particles, where
    velocity-Verlet is exact and the thermostat is the only physics): the
    mean kinetic energy within 6 % of N_f kT / 2, its relative spread
    within 40 % of sqrt(2 / N_f), and etot - work conserved to round-off."""
    n = 81
    m = torch.full((n,), 10.0, dtype=torch.float64)
    gen = torch.Generator().manual_seed(2)
    v = integrate.maxwell_velocities(m, TEMP, gen, dtype=torch.float64)
    x = torch.zeros((n, 3), dtype=torch.float64)

    def e_fn(xx):
        return torch.sum(xx) * 0.0

    s0 = integrate.init_state(x, v, e_fn)
    _, diag = csvr.csvr_trajectory(s0, e_fn, m, 1e-3, TEMP, 0.02, gen, 4000)
    n_dof = 3 * n
    k_target = 0.5 * n_dof * BOLTZ * TEMP
    ks = diag["kinetic"][500:].numpy()
    assert abs(ks.mean() - k_target) < 0.06 * k_target
    expected = np.sqrt(2.0 / n_dof)
    assert 0.6 * expected < ks.std() / ks.mean() < 1.4 * expected
    h = (diag["etot"] - diag["work"]).numpy()
    assert np.max(np.abs(h - h[0])) < 1e-9 * k_target


def test_chi_squared_draws_have_its_moments():
    """``chi_squared(k)`` over 20,000 draws: mean k and variance 2k within
    5 standard errors."""
    gen = torch.Generator().manual_seed(7)
    like = torch.zeros((), dtype=torch.float64)
    k = 95
    s = torch.stack([csvr.chi_squared(k, like, gen) for _ in range(20000)])
    assert abs(float(s.mean()) - k) < 5 * np.sqrt(2 * k / 20000)
    assert abs(float(s.var()) / (2 * k) - 1.0) < 0.05
