"""PyTorch port: constant pressure (``npt``) and the system's ``with_box`` /
``with_particle_parameters``, held to the JAX package in f64 on the CPU.

The barostats draw their uniforms (and the anisotropic one its axis) from
a ``torch.Generator`` where the JAX package splits keys, so the trajectory
comparisons hand the port the JAX package's draws in the order it draws
them (``npt.uniform_draw``, ``npt.axis_draw``, ``integrate.normal_noise``).
Energies, forces and pressures agree within 1e-10 relative; the NPT runs'
boxes, accepts, energies and positions within 1e-9."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chargeflux_tpu as jcf
from chargeflux_tpu import npt as jnpt
from chargeflux_tpu.models import water_bonded_params as jax_bonded_params
from chargeflux_tpu.models import water_box as jax_water_box
from chargeflux_tpu_torch import npt
from chargeflux_tpu_torch.energy import energy_and_forces
from chargeflux_tpu_torch.models import water_bonded_params

from torch_helpers import (forbid_host_traffic, inject_noise, jax_water,
                           maxwell_start, port_system, untemplated,
                           water_systems)

torch.set_num_threads(2)

DT, TEMP, FRICTION = 2e-4, 300.0, 5.0
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _dense(n_side=3, cutoff=0.42):
    return jax_water(n_side, cutoff, direct_method="dense")


def _cell():
    # n_side 6 at cutoff 0.55: 3 cells per axis, a 0.07 nm skin
    return water_systems(F64, n_side=6, cutoff=0.55)


def _bonded(jsys):
    n_w = jsys.n_atoms // 3
    box = np.asarray(jsys.box)
    return (jax_bonded_params(n_w, box=box, dtype=jnp.float64),
            water_bonded_params(n_w, box=box, dtype=F64, device="cpu"))


def _sheared(box):
    L = np.asarray(box, np.float64)
    return np.array([[L[0], 0.0, 0.0], [0.15 * L[0], L[1], 0.0],
                     [0.10 * L[0], -0.12 * L[1], L[2]]])


ROUTES = pytest.mark.parametrize("route", ["dense", "cell"])


# ---------------------------------------------------------------------------
# with_box, with_particle_parameters
# ---------------------------------------------------------------------------


@ROUTES
@pytest.mark.parametrize("scale", [0.97, 1.03])
def test_with_box_matches_jax(route, scale, monkeypatch):
    """Energy and forces of the scaled configuration on ``with_box`` of the
    scaled box within 1e-10 of the JAX package's; the copy keeps the
    system's row plans and kernel route (the same objects) and is made
    with no host traffic (``torch_helpers.forbid_host_traffic``)."""
    jsys, sys_t, pos, _ = _dense(4, 0.55) if route == "dense" else _cell()
    sys_t = untemplated(sys_t)             # remainder rows: plans to carry
    je, jf = jcf.energy_and_forces(jnp.asarray(pos) * scale,
                                   jsys.with_box(jsys.box * scale))
    box = sys_t.box * scale
    with monkeypatch.context() as m:
        forbid_host_traffic(m)
        moved = sys_t.with_box(box)
    assert moved.box is box and moved.spec is sys_t.spec
    assert moved.flux_plan is sys_t.flux_plan is not None
    assert moved.excl_plan is sys_t.excl_plan is not None
    assert moved.kernel_route == sys_t.kernel_route
    e, f = energy_and_forces(torch.as_tensor(pos) * scale, moved)
    assert abs(float(e) - float(je)) <= 1e-10 * abs(float(je))
    assert _rel(f, jf) <= 1e-10


def test_with_box_shapes_follow_jax():
    """A [3] box given to a triclinic-built system is diagonalised; a
    [3, 3] lattice given to an orthorhombic one is taken as it is, and its
    energy is the JAX package's within 1e-10."""
    from chargeflux_tpu.models import water_box as jwb

    force, pos, _, box = jwb(n_side=3, cutoff=0.42)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtri = force.create_system(box=_sheared(box), dtype=jnp.float64)
        jort = force.create_system(box=box, dtype=jnp.float64)
    tri, ort = port_system(jtri), port_system(jort)
    b3 = torch.tensor(np.asarray(box) * 1.01)
    assert torch.equal(tri.with_box(b3).box, torch.diag(b3))
    lat = torch.tensor(_sheared(np.asarray(box) * 0.99))
    moved = ort.with_box(lat)
    assert moved.box.shape == (3, 3)
    je = float(jcf.energy(jnp.asarray(pos),
                          jort.with_box(jnp.asarray(lat.numpy()))))
    e, _ = energy_and_forces(torch.as_tensor(pos), moved)
    assert abs(float(e) - je) <= 1e-10 * abs(je)


def test_with_particle_parameters_matches_jax():
    """New charges, sigmas and epsilons on a system with the dispersion
    tail: the tail coefficient is recomputed as the JAX package does, and
    the energy agrees within 1e-10; a wrong shape raises."""
    force, pos, _, box = jax_water_box(n_side=4, cutoff=0.55)
    force.setUseDispersionCorrection(True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=box, dtype=jnp.float64)
    sys_t = port_system(jsys)
    rng = np.random.default_rng(4)
    q0 = np.asarray(jsys.q0) * (1.0 + 0.05 * rng.standard_normal(
        jsys.n_atoms))
    sig = np.asarray(jsys.sigma) * 1.02
    eps = np.asarray(jsys.epsilon) * 0.9
    jnew = jsys.with_particle_parameters(q0=q0, sigma=sig, epsilon=eps)
    new = sys_t.with_particle_parameters(q0=torch.tensor(q0), sigma=sig,
                                         epsilon=torch.tensor(eps))
    assert new.spec.tail_coeff != sys_t.spec.tail_coeff
    np.testing.assert_allclose(new.spec.tail_coeff, jnew.spec.tail_coeff,
                               rtol=1e-14)
    je = float(jcf.energy(jnp.asarray(pos), jnew))
    e, _ = energy_and_forces(torch.as_tensor(pos), new)
    assert abs(float(e) - je) <= 1e-10 * abs(je)
    only_q = sys_t.with_particle_parameters(q0=q0)
    assert only_q.spec is sys_t.spec
    with pytest.raises(ValueError):
        sys_t.with_particle_parameters(sigma=sig[:-1])


# ---------------------------------------------------------------------------
# molecules and centroids
# ---------------------------------------------------------------------------


def _mol_case(case):
    """(jax system, port system, extra index arrays) of a molecule case."""
    if case == "salt":
        from chargeflux_tpu.models.salt import salt_water_box
        force, _, _, box = salt_water_box(n_side=3, n_ion_pairs=2)
        extra = ()
    elif case == "solute":
        from chargeflux_tpu.models import solvated_chain_box
        force, _, _, box, kw = solvated_chain_box(n_side=3, n_solute_sites=4,
                                                  cutoff=0.42)
        extra = (kw["bond_idx"], kw["angle_idx"])
    else:
        force, _, _, box = jax_water_box(n_side=3)
        extra = ((np.zeros((0, 2), np.int64),) if case == "empty_extras"
                 else ())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=box, dtype=jnp.float64)
    return jsys, port_system(jsys), extra


@pytest.mark.parametrize("case", ["waters", "salt", "empty_extras",
                                  "solute"])
def test_molecule_index_matches_jax(case):
    """The union-find assignment, first atoms and counts equal the JAX
    package's exactly (waters, salt with its singleton ions, an empty
    extra index array, a chain solute with its bonded rows as extras)."""
    jsys, sys_t, extra = _mol_case(case)
    got = npt.molecule_index(sys_t, tuple(torch.as_tensor(e) for e in extra))
    want = jnpt.molecule_index(jsys, extra)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b)) and a.dtype == b.dtype
    if case == "salt":
        assert sorted(got[2].tolist()).count(1.0) == 4


def test_molecule_centroids_match_jax():
    """Centroids of molecules moved across the periodic boundary (the
    positions shifted by half a box, unwrapped) within 1e-12 of the JAX
    package's, with the fixed-order plan and without it."""
    jsys, sys_t, pos, _ = _cell()
    box = np.asarray(jsys.box)
    x = pos + 0.5 * box + 0.07
    mol_id, first_idx, counts = jnpt.molecule_index(jsys)
    want = np.asarray(jnpt.molecule_centroids(jnp.asarray(x), jsys.box,
                                              mol_id, first_idx, counts))
    mols = npt.molecules(sys_t)
    got = npt.molecule_centroids(torch.as_tensor(x), sys_t.box, mols.mol_id,
                                 mols.first_idx, mols.counts, mols.plan)
    assert _rel(got, want) <= 1e-12
    again = npt.molecule_centroids(torch.as_tensor(x), sys_t.box, mol_id,
                                   first_idx, counts)
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# pressure
# ---------------------------------------------------------------------------


@ROUTES
def test_pressures_match_jax(route):
    """instantaneous_pressure and pressure_tensor (with the bonded terms)
    within 1e-10 relative of the JAX package's; the tensor is symmetric
    and its trace / 3 is the scalar pressure within 1e-12."""
    jsys, sys_t, pos, masses = _dense() if route == "dense" else _cell()
    jb, tb = _bonded(jsys)
    x, v = maxwell_start(pos, masses)
    jargs = (jnp.asarray(x), jnp.asarray(v), jsys, jnp.asarray(masses))
    targs = (torch.as_tensor(x), torch.as_tensor(v), sys_t,
             torch.as_tensor(masses))
    jp = float(jnpt.instantaneous_pressure(*jargs, bonded=jb))
    jt = np.asarray(jnpt.pressure_tensor(*jargs, bonded=jb))
    p = float(npt.instantaneous_pressure(*targs, bonded=tb))
    t = npt.pressure_tensor(*targs, bonded=tb)
    assert abs(p - jp) <= 1e-10 * abs(jp)
    assert _rel(t, jt) <= 1e-10
    assert torch.equal(t, t.T)
    assert abs(float(torch.trace(t)) / 3.0 - p) <= 1e-12 * abs(p)


# ---------------------------------------------------------------------------
# the barostats
# ---------------------------------------------------------------------------


def _jax_draws(key, n_outer, interval, shape, n_axes=None):
    """The JAX barostat's draws in draw order: per attempt ``k, kb, kc =
    split(k, 3)``; the attempt's axis (anisotropic: ``kx, ku, ka =
    split(kb, 3)``) and two uniforms; one normal per step of
    ``split(kc, interval)``."""
    uniforms, axes, normals = [], [], []
    k = key
    for _ in range(n_outer):
        k, kb, kc = jax.random.split(k, 3)
        if n_axes is None:
            ku, ka = jax.random.split(kb)
        else:
            kx, ku, ka = jax.random.split(kb, 3)
            axes.append(int(jax.random.randint(kx, (), 0, n_axes)))
        uniforms += [float(jax.random.uniform(q, dtype=jnp.float64))
                     for q in (ku, ka)]
        normals += [np.asarray(jax.random.normal(q, shape, jnp.float64))
                    for q in jax.random.split(kc, interval)]
    return uniforms, axes, normals


def _inject_draws(monkeypatch, uniforms, axes, normals):
    left = [iter(uniforms), iter(axes), inject_noise(monkeypatch, normals)]
    monkeypatch.setattr(npt, "uniform_draw", lambda like, g: torch.tensor(
        next(left[0]), dtype=like.dtype))
    monkeypatch.setattr(npt, "axis_draw", lambda n, like, g: torch.tensor(
        next(left[1])))
    return left


def _compare(port, jax_out, tol=1e-9):
    x, v, box, diag = port
    jx, jv, jbox, jdiag = jax_out
    assert torch.isfinite(diag["energies"]).all()
    assert np.array_equal(diag["accepts"].numpy(),
                          np.asarray(jdiag["accepts"]))
    assert np.array_equal(diag["poisoned"].numpy(),
                          np.asarray(jdiag["poisoned"]))
    assert _rel(diag["boxes"], jdiag["boxes"]) <= tol
    assert _rel(box, jbox) <= tol
    assert _rel(diag["energies"], jdiag["energies"]) <= tol
    assert _rel(diag["dv"], jdiag["dv"]) <= tol
    assert _rel(x, jx) <= tol and _rel(v, jv) <= tol
    if "axes" in jdiag:
        assert np.array_equal(diag["axes"].numpy(), np.asarray(jdiag["axes"]))


def _run_both(monkeypatch, jsys, sys_t, pos, masses, n_outer, interval,
              aniso=None, bonded=True, constraints=None, dt=DT, v0=None,
              seed=7, **kw):
    """The JAX driver and the port's with the JAX package's draws; returns
    (port result, jax result)."""
    jb, tb = _bonded(jsys) if bonded else (None, None)
    x0, v_ = maxwell_start(pos, masses)
    v0 = v_ if v0 is None else v0
    key = jax.random.PRNGKey(seed)
    common = dict(barostat_interval=interval, **kw)
    if aniso is None:
        jrun, run = jnpt.npt_langevin_trajectory, npt.npt_langevin_trajectory
    else:
        jrun = jnpt.npt_anisotropic_langevin_trajectory
        run = npt.npt_anisotropic_langevin_trajectory
        common["scale_axes"] = aniso
    jout = jrun(jnp.asarray(x0), jnp.asarray(v0), jsys, jnp.asarray(masses),
                dt, TEMP, FRICTION, 1.0, key, n_outer * interval, bonded=jb,
                constraints=None if constraints is None else constraints[0],
                **common)
    n_axes = None if aniso is None else sum(aniso)
    left = _inject_draws(monkeypatch, *_jax_draws(
        key, n_outer, interval, x0.shape, n_axes))
    out = run(torch.as_tensor(x0), torch.as_tensor(v0), sys_t,
              torch.as_tensor(masses), dt, TEMP, FRICTION, 1.0,
              torch.Generator().manual_seed(0), n_outer * interval,
              bonded=tb,
              constraints=None if constraints is None else constraints[1],
              **common)
    assert all(next(it, None) is None for it in left)   # every draw used
    return out, jout


@ROUTES
def test_npt_langevin_matches_jax(route, monkeypatch):
    """Three isotropic attempts of 5 steps each (dense: 81 atoms; cell:
    the 648-atom box on 3^3 cells, rebuilt at each attempt): boxes,
    accepts, poisoned flags, per-step energies, the final width, positions
    and velocities within 1e-9 of the JAX package's."""
    jsys, sys_t, pos, masses = _dense() if route == "dense" else _cell()
    out, jout = _run_both(monkeypatch, jsys, sys_t, pos, masses, 3, 5)
    _compare(out, jout)
    assert out[3]["boxes"].shape == (3, 3)
    assert out[3]["accepts"].any()


@pytest.mark.parametrize("case", ["semi_isotropic", "triclinic_rows"])
def test_npt_anisotropic_matches_jax(case, monkeypatch):
    """Four anisotropic attempts of 5 steps: semi-isotropic (z fixed) on
    the orthorhombic box, and every axis on a sheared lattice (whole rows
    scaled): as the isotropic comparison, plus the attempted axes; z never
    moves in the semi-isotropic run, and the lattice stays lower
    triangular."""
    force, pos, masses, box = jax_water_box(n_side=3, cutoff=0.42, seed=9)
    b = _sheared(box) if case == "triclinic_rows" else box
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=b, dtype=jnp.float64)
    axes = (True, True, False) if case == "semi_isotropic" else (True,) * 3
    out, jout = _run_both(monkeypatch, jsys, port_system(jsys), pos,
                          np.asarray(masses), 4, 5, aniso=axes, seed=3)
    _compare(out, jout)
    boxes = out[3]["boxes"]
    if case == "semi_isotropic":
        assert torch.all(boxes[:, 2] == float(box[2]))
        assert set(out[3]["axes"].tolist()) <= {0, 1}
    else:
        assert boxes.shape == (4, 3, 3)
        assert torch.all(boxes[:, 0, 1:] == 0) and torch.all(
            boxes[:, 1, 2] == 0)
    assert out[3]["dv"].shape == (3,)


def test_npt_rigid_water_matches_jax(monkeypatch):
    """Rigid water (fixed charges, RATTLE-projected BAOAB at 2 fs) with two
    isotropic attempts of 5 steps: as the isotropic comparison, and the
    constraints hold through the volume moves (residual below 1e-9)."""
    from chargeflux_tpu.models import rigid_water_box as jax_rigid
    from chargeflux_tpu_torch.constraints import constraint_residuals
    from chargeflux_tpu_torch.models import rigid_water_box

    force, pos, masses, box, jp = jax_rigid(n_side=3, cutoff=0.42,
                                            dtype=jnp.float64)
    *_, tp = rigid_water_box(n_side=3, cutoff=0.42, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=box, dtype=jnp.float64)
    out, jout = _run_both(monkeypatch, jsys, port_system(jsys), pos,
                          np.asarray(masses), 2, 5, bonded=False,
                          constraints=(jp, tp), dt=2e-3)
    _compare(out, jout)
    assert float(constraint_residuals(out[0], tp).abs().max()) < 1e-9


def test_a_poisoned_proposal_is_recorded(monkeypatch):
    """A first proposal that shrinks the cell box by 40 % in volume leaves
    a cell plane below the cutoff: its energy NaN-poisons, ``poisoned``
    records it, the NaN weight compares False (rejected even with a zero
    acceptance draw) and the run goes on at the old box, finite."""
    _, sys_t, pos, masses = _cell()
    x0, v0 = maxwell_start(pos, masses)
    draws = iter([0.0, 0.0] + [0.5] * 4)
    monkeypatch.setattr(npt, "uniform_draw", lambda like, g: torch.tensor(
        next(draws), dtype=like.dtype))
    x, v, box, diag = npt.npt_langevin_trajectory(
        torch.as_tensor(x0), torch.as_tensor(v0), sys_t,
        torch.as_tensor(masses), DT, TEMP, FRICTION, 1.0,
        torch.Generator().manual_seed(1), 15, barostat_interval=5,
        dv_frac=0.4)
    assert diag["poisoned"].tolist() == [True, False, False]
    assert not diag["accepts"][0]
    assert torch.equal(diag["boxes"][0], sys_t.box)
    assert torch.isfinite(diag["energies"]).all()
    assert torch.isfinite(x).all() and torch.isfinite(box).all()


def test_a_warm_npt_call_reads_nothing_back(monkeypatch):
    """The CPU stand-in for the card's sync check: once the molecule
    assignment and the interval check are kept on the system, a second
    call makes no host copy or read (``forbid_host_traffic``) and gives the
    first call's bits from the same generator state."""
    _, sys_t, pos, masses = _cell()
    x0, v0 = (torch.as_tensor(a) for a in maxwell_start(pos, masses))
    m = torch.as_tensor(masses)

    def run():
        return npt.npt_langevin_trajectory(
            x0, v0, sys_t, m, DT, TEMP, FRICTION, 1.0,
            torch.Generator().manual_seed(5), 10, barostat_interval=5)

    first = run()
    with monkeypatch.context() as mp:
        forbid_host_traffic(mp)
        again = run()
    assert torch.equal(first[0], again[0])
    assert torch.equal(first[3]["energies"], again[3]["energies"])


def test_the_molecule_assignment_keeps_one_slot_per_system():
    """Calls naming the same index arrays in fresh tuples share one
    molecule assignment; fresh arrays of equal content replace it (one
    slot on the system, never a growing cache) and assign the same
    molecules; the run's bits do not depend on which arrays were named."""
    jsys, sys_t, pos, masses = _cell()
    _, tb = _bonded(jsys)
    x0, v0 = (torch.as_tensor(a) for a in maxwell_start(pos, masses))
    m = torch.as_tensor(masses)

    def run(extra):
        out = npt.npt_langevin_trajectory(
            x0, v0, sys_t, m, DT, TEMP, FRICTION, 1.0,
            torch.Generator().manual_seed(5), 5, bonded=tb,
            barostat_interval=5, extra_mol_idx=extra)
        return out, sys_t.__dict__["npt_molecules"][2]

    a, mols_a = run((tb.bond_idx, tb.angle_idx))
    b, mols_b = run((tb.bond_idx, tb.angle_idx))
    assert mols_b is mols_a
    c, mols_c = run((tb.bond_idx.clone(), tb.angle_idx.clone()))
    assert mols_c is not mols_a
    assert all(torch.equal(u, w) for u, w in zip(mols_c, mols_a))
    for other in (b, c):
        assert torch.equal(other[0], a[0])
        assert torch.equal(other[3]["energies"], a[3]["energies"])


def test_npt_rejects_a_partial_interval():
    _, sys_t, pos, masses = _dense()
    with pytest.raises(ValueError):
        npt.npt_langevin_trajectory(
            torch.as_tensor(pos), torch.zeros(pos.shape, dtype=F64), sys_t,
            torch.as_tensor(masses), DT, TEMP, FRICTION, 1.0,
            torch.Generator(), 7, barostat_interval=5)
