"""PyTorch port: rigid-water SETTLE / RATTLE and general distance
constraints with their drivers, held to the JAX package in f64 on the CPU.

Single projections agree within 1e-12, trajectories within 1e-9 (the
stochastic ones with the JAX package's normals handed to the port,
``torch_helpers.inject_noise``).  Degenerate or unreachable projections
NaN-poison, as in the JAX package; the rigid thermostat reaches its target
with the constrained degrees of freedom counted."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import constraints as jcon
from chargeflux_tpu.integrate import (init_state_nb as jinit_state_nb,
                                      make_energy_fn as jmake_energy_fn,
                                      make_nb_energy_fn as jmake_nb_energy_fn)
from chargeflux_tpu.models import rigid_water_box as jax_rigid_water_box
from chargeflux_tpu_torch import constraints as con
from chargeflux_tpu_torch import integrate
from chargeflux_tpu_torch.models import rigid_water_box

from torch_helpers import (inject_noise, jax_chunk_normals, jax_dtype,
                           jax_normals, maxwell_start, port_system)

torch.set_num_threads(2)

DT = 2e-3
_BONDS = ((0, 1), (0, 2), (1, 2))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _boxes(n_side=2, seed=31, cutoff=0.45):
    """(jax params, port params, positions, masses, jax force, box) of the
    rigid box both packages build from one seed."""
    jforce, pos, masses, box, jp = jax_rigid_water_box(
        n_side=n_side, cutoff=cutoff, seed=seed, dtype=jnp.float64)
    *_, tp = rigid_water_box(n_side=n_side, cutoff=cutoff, seed=seed,
                             device="cpu")
    return jp, tp, pos, np.asarray(masses), jforce, box


def _systems(jforce, box, **kw):
    """(jax system, port system) in f64 from the force the JAX package made."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = jforce.create_system(box=box, dtype=jax_dtype(torch.float64),
                                    **kw)
    return jsys, port_system(jsys)


def test_rigid_water_box_matches_jax():
    """Same seed, same positions bit for bit (both draw through NumPy),
    same masses, box and constraint parameters; the force builds the
    same system."""
    jforce, jpos, jm, jbox, jp = jax_rigid_water_box(n_side=3, cutoff=0.45,
                                                     seed=5)
    force, pos, m, box, p = rigid_water_box(n_side=3, cutoff=0.45, seed=5,
                                            device="cpu")
    assert np.array_equal(pos, jpos) and np.array_equal(m, jm)
    assert np.array_equal(box, jbox)
    assert np.array_equal(p.targets2.numpy(), np.asarray(jp.targets2))
    assert np.array_equal(p.inv_m.numpy(), np.asarray(jp.inv_m))
    assert (p.offset, p.count, p.n_constraints) == (jp.offset, jp.count,
                                                    jp.n_constraints)
    assert p.targets2.dtype == torch.float64
    assert force.getNumParticles() == jforce.getNumParticles()
    assert force.getNumExceptions() == jforce.getNumExceptions()
    assert force.getNumFluxBonds() == 0 and force.getNumFluxAngles() == 0
    if not torch.cuda.is_available():       # the card by default
        with pytest.raises(RuntimeError):
            rigid_water_box(n_side=2)


@pytest.mark.parametrize("what", ["settle", "newton", "velocities",
                                  "residuals"])
def test_projections_match_jax(what):
    """SETTLE and Newton position projections, the velocity projection
    and the residuals on a perturbed rigid box against the JAX package's:
    within 1e-12 (nm, nm/ps, nm^2; relative to the largest entry)."""
    jp, tp, pos, masses, _, _ = _boxes()
    rng = np.random.default_rng(32)
    x_unc = pos + 0.005 * rng.standard_normal(pos.shape)
    v = rng.standard_normal(pos.shape)
    x, xu = torch.as_tensor(pos), torch.as_tensor(x_unc)
    if what in ("settle", "newton"):
        got = con.project_positions(x, xu, tp, method=what)
        want = jcon.project_positions(jnp.asarray(pos), jnp.asarray(x_unc),
                                      jp, method=what)
        res = con.constraint_residuals(got, tp)
        assert float(res.abs().max()) <= 1e-12
    elif what == "velocities":
        got = con.project_velocities(x, torch.as_tensor(v), tp)
        want = jcon.project_velocities(jnp.asarray(pos), jnp.asarray(v), jp)
    else:
        got = con.constraint_residuals(xu, tp)
        want = jcon.constraint_residuals(jnp.asarray(x_unc), jp)
        assert got.shape == (tp.count, 3)
    assert _rel(got, want) <= 1e-12


def test_settle_matches_newton_and_keeps_momentum():
    """SETTLE is the closed-form solution of the equations Newton
    iterates: the two agree within 1e-12 nm; SETTLE's correction is a pure
    internal impulse (per-molecule momentum kept within 1e-12)."""
    _, tp, pos, _, _, _ = _boxes()
    rng = np.random.default_rng(35)
    x = torch.as_tensor(pos)
    xu = x + torch.as_tensor(0.005 * rng.standard_normal(pos.shape))
    x_newton = con.project_positions(x, xu, tp, n_iter=8, method="newton")
    x_settle = con.settle_positions(x, xu, tp)
    assert float((x_settle - x_newton).abs().max()) <= 1e-12
    assert torch.equal(con.project_positions(x, xu, tp), x_settle)
    dm = (x_settle - xu).reshape(-1, 3, 3)
    mass = torch.tensor([15.999, 1.008, 1.008], dtype=torch.float64)
    assert float((mass[None, :, None] * dm).sum(1).abs().max()) <= 1e-12


@pytest.mark.parametrize("method", ["settle", "newton"])
def test_degenerate_proposal_poisons(method):
    """A proposal so wild no rotation restores the triangle NaN-poisons
    (SETTLE: the molecule; Newton: every position), never a quietly wrong
    geometry."""
    _, tp, pos, _, _, _ = _boxes()
    rng = np.random.default_rng(36)
    x = torch.as_tensor(pos)
    wild = x + torch.as_tensor(5.0 * rng.standard_normal(pos.shape))
    assert not torch.isfinite(
        con.project_positions(x, wild, tp, method=method)).all()


def test_velocity_projection_zeroes_bond_rates():
    """J v = 0 after the projection within 1e-12, total momentum kept."""
    _, tp, pos, masses, _, _ = _boxes(seed=34)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(pos.shape))
    x = torch.as_tensor(pos)
    v_new = con.project_velocities(x, v, tp)
    xm, vm = x.reshape(-1, 3, 3), v_new.reshape(-1, 3, 3)
    for i, j in _BONDS:
        rate = ((xm[:, i] - xm[:, j]) * (vm[:, i] - vm[:, j])).sum(-1)
        assert float(rate.abs().max()) <= 1e-12
    m = torch.as_tensor(masses)[:, None]
    assert float(((v_new - v) * m).sum(0).abs().max()) <= 1e-10


def _general(tp, masses):
    pairs, lengths = [], []
    t = np.sqrt(tp.targets2.numpy())
    for mol in range(tp.count):
        for k, (i, j) in enumerate(_BONDS):
            pairs.append((3 * mol + i, 3 * mol + j))
            lengths.append(t[k])
    return pairs, lengths


def test_distance_constraints_match_rigid_water_and_jax():
    """The Jacobi SHAKE / RATTLE route against the closed-form rigid-water
    route (within 1e-9, as the JAX package's test) and against the JAX
    package's own Jacobi route (within 1e-12), positions and velocities;
    momentum kept."""
    jp, tp, pos, masses, _, _ = _boxes()
    pairs, lengths = _general(tp, masses)
    gen = con.DistanceConstraints.create(pairs, lengths, masses, device="cpu")
    jgen = jcon.DistanceConstraints.create(pairs, lengths, masses)
    assert gen.n_constraints == jgen.n_constraints == 3 * tp.count
    rng = np.random.default_rng(5)
    x = torch.as_tensor(pos)
    xu = x + torch.as_tensor(rng.normal(0, 0.004, pos.shape))
    x_a = con.project_positions(x, xu, tp)
    x_b = con.project_positions(x, xu, gen)
    assert float((x_b - x_a).abs().max()) <= 1e-9
    assert _rel(x_b, jcon.project_positions(jnp.asarray(pos),
                                            jnp.asarray(xu.numpy()),
                                            jgen)) <= 1e-12
    v = torch.as_tensor(rng.normal(0, 1.0, pos.shape))
    v_a = con.project_velocities(x_a, v, tp)
    v_b = con.project_velocities(x_a, v, gen)
    assert float((v_b - v_a).abs().max()) <= 1e-9
    assert _rel(v_b, jcon.project_velocities(jnp.asarray(x_a.numpy()),
                                             jnp.asarray(v.numpy()),
                                             jgen)) <= 1e-12
    res = con.constraint_residuals(x_b, gen)
    jres = jcon.constraint_residuals(jnp.asarray(x_b.numpy()), jgen)
    assert np.abs(res.numpy() - np.asarray(jres)).max() <= 1e-14
    m = torch.as_tensor(masses)[:, None]
    np.testing.assert_allclose((m * v_b).sum(0).numpy(),
                               (m * v).sum(0).numpy(), rtol=1e-12)


def test_distance_constraints_chain_and_poison():
    """A chain of shared-atom constraints (what the 3-site closed form
    cannot express) is restored within 1e-10 nm^2 with its bond rates
    zeroed within 1e-9; an unreachable projection (the new bond
    perpendicular to the old) NaN-poisons every position."""
    rng = np.random.default_rng(7)
    n = 12
    x0 = np.cumsum(rng.normal(0, 1, (n, 3)), axis=0)
    pairs = [(i, i + 1) for i in range(n - 1)]
    lengths = [float(np.linalg.norm(x0[i + 1] - x0[i])) for i in range(n - 1)]
    gen = con.DistanceConstraints.create(pairs, lengths,
                                         rng.uniform(1.0, 16.0, n),
                                         device="cpu")
    x0 = torch.as_tensor(x0)
    x_new = con.project_positions(
        x0, x0 + torch.as_tensor(rng.normal(0, 0.02, (n, 3))), gen)
    assert float(con.constraint_residuals(x_new, gen).abs().max()) < 1e-10
    v = con.project_velocities(x_new, torch.as_tensor(
        rng.normal(0, 1.0, (n, 3))), gen)
    d, dv = x_new[1:] - x_new[:-1], v[1:] - v[:-1]
    assert float((d * dv).sum(-1).abs().max()) < 1e-9

    bad = con.DistanceConstraints.create([(0, 1)], [1.0], [1.0, 1.0],
                                         n_iter=8, device="cpu")
    x_old = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                         dtype=torch.float64)
    x_unc = torch.tensor([[0.0, 0.0, 0.0], [0.0, 3.0, 0.0]],
                         dtype=torch.float64)
    assert torch.isnan(con.project_positions(x_old, x_unc, bad)).all()


def _dense_rigid(n_side=3, seed=35):
    jp, tp, pos, masses, jforce, box = _boxes(n_side=n_side, seed=seed)
    jsys, tsys = _systems(jforce, box, direct_method="dense")
    return (jp, tp, pos, masses, jmake_energy_fn(jsys),
            integrate.make_energy_fn(tsys))


def test_rattle_nve_trajectory_matches_jax():
    """12 constrained velocity-Verlet steps at 2 fs (a chunk of 10 and a
    remainder) on the dense route from Maxwell velocities: positions,
    velocities, per-step total energies and the final potential within
    1e-9 relative; rattle_verlet_step alike within 1e-12; bonds held."""
    jp, tp, pos, masses, je_fn, e_fn = _dense_rigid()
    x0, v0 = maxwell_start(pos, masses, seed=1)
    jm, m = jnp.asarray(masses), torch.as_tensor(masses)
    x, v = torch.as_tensor(x0), torch.as_tensor(v0)
    (jx, jv, jf, je), jes = jcon.rattle_nve_trajectory(
        jnp.asarray(x0), jnp.asarray(v0), je_fn, jm, DT, 12, jp)
    (tx, tv, tf, te), es = con.rattle_nve_trajectory(x, v, e_fn, m, DT, 12,
                                                     tp)
    assert es.shape == (12,) and torch.isfinite(es).all()
    for got, want in ((tx, jx), (tv, jv), (es, jes)):
        assert _rel(got, want) <= 1e-9
    np.testing.assert_allclose(float(te), float(je), rtol=1e-9)
    assert float(con.constraint_residuals(tx, tp).abs().max()) <= 1e-10

    f0 = integrate.init_state(x, v, e_fn).forces
    vp = con.project_velocities(x, v, tp)
    jvp = jcon.project_velocities(jnp.asarray(x0), jnp.asarray(v0), jp)
    got = con.rattle_verlet_step(x, vp, f0, e_fn, m, DT, tp)
    want = jcon.rattle_verlet_step(jnp.asarray(x0), jvp,
                                   jnp.asarray(f0.numpy()), je_fn, jm, DT, jp)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12


def test_rattle_langevin_trajectory_matches_jax(monkeypatch):
    """12 constrained BAOAB steps on the dense route with the JAX
    package's normals (its one upfront split of the key): positions and
    kinetic energies within 1e-9 relative, bonds held."""
    jp, tp, pos, masses, je_fn, e_fn = _dense_rigid(seed=36)
    x0, v0 = maxwell_start(pos, masses, seed=2)
    key = jax.random.PRNGKey(2)
    (jx, jv, _jf, je), jkes = jcon.rattle_langevin_trajectory(
        jnp.asarray(x0), jnp.asarray(v0), je_fn, jnp.asarray(masses), DT,
        300.0, 20.0, key, 12, jp)
    inject_noise(monkeypatch, jax_normals(jax.random.split(key, 12),
                                          pos.shape))
    (tx, tv, _tf, te), kes = con.rattle_langevin_trajectory(
        torch.as_tensor(x0), torch.as_tensor(v0), e_fn,
        torch.as_tensor(masses), DT, 300.0, 20.0,
        torch.Generator().manual_seed(0), 12, tp)
    assert _rel(tx, jx) <= 1e-9 and _rel(tv, jv) <= 1e-9
    assert _rel(kes, jkes) <= 1e-9
    np.testing.assert_allclose(float(te), float(je), rtol=1e-9)
    assert float(con.constraint_residuals(tx, tp).abs().max()) <= 1e-10


def _cell_rigid():
    """The rigid 648-atom box on the cell + SPME route (3 cells per axis
    at cutoff 0.5, a 0.12 nm skin), from rest."""
    jp, tp, pos, masses, jforce, box = _boxes(n_side=6, seed=37, cutoff=0.5)
    jsys, tsys = _systems(jforce, box, direct_method="cell",
                          recip_method="pme")
    return jp, tp, pos, masses, jsys, tsys


def test_rattle_langevin_trajectory_nb_matches_jax(monkeypatch):
    """8 constrained BAOAB steps rebuilt every 2 (the lattice start heats
    fast) on the cell route with
    the JAX package's normals: positions, velocities, kinetic energies and
    the carry forces within 1e-9 relative; bonds held within 1e-10
    nm^2."""
    jp, tp, pos, masses, jsys, tsys = _cell_rigid()
    je_fn, jinit = jmake_nb_energy_fn(jsys)
    js = jinit_state_nb(jnp.asarray(pos), jnp.zeros(pos.shape), je_fn, jinit)
    key = jax.random.PRNGKey(4)
    jfin, jkes = jcon.rattle_langevin_trajectory_nb(
        js, je_fn, jinit, jnp.asarray(masses), DT, 300.0, 20.0, key, 8, jp,
        rebuild_every=2)

    e_fn, init_nb = integrate.make_nb_energy_fn(tsys)
    x = torch.as_tensor(pos)
    s = integrate.init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    left = inject_noise(monkeypatch, jax_chunk_normals(key, 4, 2, pos.shape))
    fin, kes = con.rattle_langevin_trajectory_nb(
        s, e_fn, init_nb, torch.as_tensor(masses), DT, 300.0, 20.0,
        torch.Generator().manual_seed(0), 8, tp, rebuild_every=2)
    assert next(left, None) is None
    assert kes.shape == (8,) and torch.isfinite(kes).all()
    for f in ("positions", "velocities", "forces"):
        assert _rel(getattr(fin, f), getattr(jfin, f)) <= 1e-9, f
    assert _rel(kes, jkes) <= 1e-9
    np.testing.assert_allclose(float(fin.potential), float(jfin.potential),
                               rtol=1e-9)
    assert float(con.constraint_residuals(fin.positions, tp).abs().max()) \
        <= 1e-10


def test_rattle_langevin_nb_resumes_to_round_off():
    """One call of 8 steps against two of 4 with the generator carried:
    the second call projects its initial velocities again, so the two
    agree to round-off (positions within 1e-12 nm), not bit for bit."""
    _, tp, pos, masses, _, tsys = _cell_rigid()
    e_fn, init_nb = integrate.make_nb_energy_fn(tsys)
    x = torch.as_tensor(pos)
    s = integrate.init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    m = torch.as_tensor(masses)

    def run(state, n, gen):
        return con.rattle_langevin_trajectory_nb(
            state, e_fn, init_nb, m, DT, 300.0, 20.0, gen, n, tp,
            rebuild_every=2)

    whole, kes = run(s, 8, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    half, kes_a = run(s, 4, gen)
    both, kes_b = run(half, 4, gen)
    assert torch.isfinite(kes).all()
    assert float((both.positions - whole.positions).abs().max()) <= 1e-12
    np.testing.assert_allclose(torch.cat([kes_a, kes_b]).numpy(),
                               kes.numpy(), rtol=1e-9)


def test_rigid_box_thermalizes_with_constraints_counted():
    """The 81-atom rigid box (dense route) from rest under constrained
    BAOAB at 2 fs, friction 50/ps: over the last 200 of 400 steps the mean
    kinetic temperature with 3N - n_constraints degrees of freedom is
    within 30 % of 300 K, as in the JAX package's test; temperature()
    with n_constraints agrees with that count; bonds held."""
    _, tp, pos, masses, _, e_fn = _dense_rigid(seed=36)
    x = torch.as_tensor(pos)
    m = torch.as_tensor(masses)
    (xf, vf, _f, _e), kes = con.rattle_langevin_trajectory(
        x, torch.zeros_like(x), e_fn, m, DT, 300.0, 50.0,
        torch.Generator().manual_seed(2), 400, tp)
    assert torch.isfinite(kes).all()
    n_dof = 3 * x.shape[0] - tp.n_constraints
    temps = 2.0 * kes[200:] / (n_dof * integrate.BOLTZ)
    assert 0.7 * 300.0 < float(temps.mean()) < 1.3 * 300.0
    np.testing.assert_allclose(
        float(integrate.temperature(vf, m, n_constraints=tp.n_constraints)),
        float(2.0 * integrate.kinetic_energy(vf, m)
              / (n_dof * integrate.BOLTZ)), rtol=1e-12)
    assert float(con.constraint_residuals(xf, tp).abs().max()) <= 1e-10
