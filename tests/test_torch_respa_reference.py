"""PyTorch port: the r-RESPA force tiers and drivers held to the
benchmark's plain float64 reference (``cfbench.reference.respa``, written
from the published splitting), on the plain route at the benchmark's
small 64-water box (``cfbench.tests.small``).  The Langevin driver gets
the reference's normals (``torch_helpers.inject_noise``).  This file
imports no JAX."""

import numpy as np
import pytest
import torch

from cfbench import water
from cfbench.reference import respa as ref
from cfbench.reference.water import Model
from cfbench.tests.small import small_cell
from chargeflux_tpu_torch import integrate

from torch_helpers import inject_noise

torch.set_num_threads(2)

# the cell's outer step and substeps; the 0.064 nm skin of the small box
# wants a rebuild every outer step
N_STEPS, EVERY = 8, 1
FRICTION = 20.0          # the noise weighs more than at the cell's 1/ps


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def box():
    """The small cell's configuration, f64 port system and tiers,
    reference model, lattice positions and Maxwell velocities at 300 K."""
    cfg = small_cell("water96k.respa")["config"]
    system = water.port_system(cfg, "cpu", torch.float64)
    bonded = water.port_bonded(cfg, "cpu", torch.float64)
    masses = torch.tensor(water.masses_of(cfg), dtype=torch.float64)
    x = torch.tensor(water.lattice_waters(cfg, np.random.default_rng(11)))
    v = integrate.maxwell_velocities(masses, 300.0,
                                     torch.Generator().manual_seed(3),
                                     dtype=torch.float64)
    model = Model(cfg["water"], cfg["system"], water.box_of(cfg), "f64",
                  "cpu")
    return {"cfg": cfg, "system": system, "bonded": bonded, "m": masses,
            "x": x, "v": v, "model": model,
            "fns": integrate.make_respa_force_fns(system, bonded)}


def _dynamics(box):
    d = box["cfg"]["dynamics"]
    return float(d["dt_ps"]), int(d["n_inner"]), float(d["temperature_K"])


def _state(box):
    slow_fn, _fast_fn, init_nb = box["fns"]
    e_fn, _ = integrate.make_nb_energy_fn(box["system"],
                                          bonded=box["bonded"])
    return integrate.init_state_nb(box["x"], box["v"], e_fn, init_nb)


def _port_run(box, driver, monkeypatch):
    """(final state, records, reference normals or None) of N_STEPS outer
    steps of ``driver`` ("nve" or "langevin")."""
    slow_fn, fast_fn, init_nb = box["fns"]
    dt, n_inner, temp = _dynamics(box)
    if driver == "nve":
        fin, es = integrate.respa_trajectory_nb(
            _state(box), slow_fn, fast_fn, init_nb, box["m"], dt, n_inner,
            N_STEPS, EVERY)
        return fin, es, None
    rng = np.random.default_rng(5)
    normals = rng.standard_normal((N_STEPS, n_inner) + box["x"].shape)
    left = inject_noise(monkeypatch, list(normals.reshape(
        (-1,) + box["x"].shape)))
    fin, kes = integrate.respa_langevin_trajectory_nb(
        _state(box), slow_fn, fast_fn, init_nb, box["m"], dt, n_inner, temp,
        FRICTION, torch.Generator().manual_seed(0), N_STEPS, EVERY)
    assert next(left, None) is None
    return fin, kes, torch.tensor(normals)


def _reference_run(box, normals):
    dt, n_inner, temp = _dynamics(box)
    model, m = box["model"], box["m"]
    t = ref.tiers(model, box["x"])
    x, v, f_slow, f_fast = box["x"], box["v"], t["f_slow"], t["f_fast"]
    kes = []
    for k in range(N_STEPS):
        if normals is None:
            x, v, f_slow, f_fast = ref.verlet_i_step(
                model, x, v, f_slow, f_fast, m, dt, n_inner)
        else:
            x, v, f_slow, f_fast = ref.langevin_step(
                model, x, v, f_slow, f_fast, m, dt, n_inner, temp, FRICTION,
                normals[k])
        kes.append(float(0.5 * torch.sum(m[:, None] * v * v)))
    return x, v, kes


def test_the_tiers_match_the_reference(box):
    """make_respa_force_fns' slow and fast tiers at the lattice: energies
    and forces within 1e-10 relative of the reference's slow tier (direct,
    exclusion, self, reciprocal) and bonded terms."""
    slow_fn, fast_fn, init_nb = box["fns"]
    x = box["x"]
    want = ref.tiers(box["model"], x)
    e_slow, f_slow, _nb = slow_fn(x, init_nb(x))
    e_fast, f_fast = fast_fn(x)
    assert _rel(f_slow, want["f_slow"]) <= 1e-10
    assert _rel(f_fast, want["f_fast"]) <= 1e-10
    for e, w in ((e_slow, want["e_slow"]), (e_fast, want["e_fast"])):
        assert abs(float(e) - float(w)) <= 1e-10 * abs(float(w))


@pytest.mark.parametrize("driver", ["nve", "langevin"])
def test_the_drivers_match_the_reference(box, driver, monkeypatch):
    """Eight outer steps of 2 fs, 4 substeps each, rebuilt every one:
    respa_trajectory_nb against Verlet-I and respa_langevin_trajectory_nb
    against BAOAB-RESPA with the same normals; positions, velocities and
    the Langevin driver's kinetic energies within 1e-9 relative, the final
    forces and potential within 1e-10 of the reference's at the final
    positions."""
    fin, records, normals = _port_run(box, driver, monkeypatch)
    x, v, kes = _reference_run(box, normals)
    assert _rel(fin.positions, x) <= 1e-9
    assert _rel(fin.velocities, v) <= 1e-9
    if normals is not None:
        assert _rel(records, kes) <= 1e-9
    want = ref.tiers(box["model"], fin.positions)
    assert _rel(fin.forces, want["f_slow"] + want["f_fast"]) <= 1e-10
    e_ref = float(want["e_slow"] + want["e_fast"])
    assert abs(float(fin.potential) - e_ref) <= 1e-10 * abs(e_ref)


@pytest.mark.parametrize("driver", ["nve", "langevin"])
def test_the_exposed_tier_forces_are_the_tiers_at_the_final_positions(
        box, driver, monkeypatch):
    """The final state's f_slow and f_fast (the last replayed outer step's
    carry) against both tiers recomputed at its positions, within 1e-10
    relative; they sum to its forces."""
    fin, _records, _normals = _port_run(box, driver, monkeypatch)
    assert isinstance(fin, integrate.RespaStateNB)
    slow_fn, fast_fn, init_nb = box["fns"]
    x = fin.positions
    _e, f_slow, _nb = slow_fn(x, init_nb(x))
    _e, f_fast = fast_fn(x)
    assert _rel(fin.f_slow, f_slow) <= 1e-10
    assert _rel(fin.f_fast, f_fast) <= 1e-10
    assert _rel(fin.f_slow + fin.f_fast, fin.forces) <= 1e-10
    assert fin.f_slow.data_ptr() != fin.forces.data_ptr()


@pytest.mark.parametrize("driver", ["nve", "langevin"])
def test_a_call_handed_its_final_state_goes_on_bit_for_bit(box, driver):
    """Two calls of four outer steps, the second handed the first's
    RespaStateNB (and the generator carried on), give one call of eight
    bit for bit; the second call evaluates the slow tier once per outer
    step and once at its end, nothing at its start."""
    fns, (slow_fn, fast_fn, init_nb) = [], box["fns"]
    dt, n_inner, temp = _dynamics(box)

    def counted(x, nb):
        fns.append(1)
        return slow_fn(x, nb)

    def run(state, n, gen, slow):
        if driver == "nve":
            return integrate.respa_trajectory_nb(
                state, slow, fast_fn, init_nb, box["m"], dt, n_inner, n,
                EVERY)
        return integrate.respa_langevin_trajectory_nb(
            state, slow, fast_fn, init_nb, box["m"], dt, n_inner, temp,
            FRICTION, gen, n, EVERY)

    n = N_STEPS // 2
    whole, rec = run(_state(box), 2 * n, torch.Generator().manual_seed(4),
                     slow_fn)
    gen = torch.Generator().manual_seed(4)
    half, rec_a = run(_state(box), n, gen, slow_fn)
    both, rec_b = run(half, n, gen, counted)
    assert len(fns) == n + 1
    assert torch.equal(torch.cat([rec_a, rec_b]), rec)
    for f in ("positions", "velocities", "forces", "potential", "f_slow",
              "f_fast"):
        assert torch.equal(getattr(both, f), getattr(whole, f)), f
