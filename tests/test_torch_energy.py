"""PyTorch port: energy components, energy_and_forces and the NaN poisons,
held to the JAX package.  The cell + PME route is pinned to
direct_method="cell", recip_method="pme" (on the CPU the JAX package's
cell-blocked XLA spread stands in for the Pallas kernel, which
tests/test_pme.py holds equal to it); the other routes — recip_method
"auto" on the CPU, dense and non-periodic direct space, classical Ewald
through the plain factorized product and through the structure-factor
kernel's plain version against the JAX Pallas kernel in interpret mode —
follow."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.neighbors import build_neighbor_state

from torch_helpers import jax_water, port_system, water_systems

jenergy = importlib.import_module("chargeflux_tpu.energy")
# the module: the package attribute "energy" is the function, as in JAX
energy = importlib.import_module("chargeflux_tpu_torch.energy")

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[torch.float64, torch.float32],
                ids=["f64", "f32"])
def both(request):
    dtype = request.param
    jsys, sys_t, pos, _ = water_systems(dtype)
    x_j = jnp.asarray(pos, jsys.box.dtype)
    x_t = torch.as_tensor(pos).to(dtype)
    comps_j = {k: float(v) for k, v in
               jenergy._energy_components(x_j, jsys).items()}
    e_j, f_j = jenergy.energy_and_forces(x_j, jsys)
    return dict(dtype=dtype, sys_t=sys_t, x_t=x_t, comps_j=comps_j,
                e_j=float(e_j), f_j=np.asarray(f_j, np.float64))


def test_energy_components_match_jax(both):
    """Each component: f64 rel <= 1e-10; f32 rel <= 1e-5."""
    comps_t = energy.energy_components(both["x_t"], both["sys_t"])
    assert list(comps_t) == list(both["comps_j"])
    tol = 1e-10 if both["dtype"] == torch.float64 else 1e-5
    for k, v in comps_t.items():
        ref = both["comps_j"][k]
        assert abs(float(v) - ref) <= tol * abs(ref), k


def test_energy_and_forces_match_jax(both):
    """f64: energy rel <= 1e-10, max|dF| <= 1e-8 max|F|.  f32: the total
    is a ~1e-4 cancellation of ~1e5 components, so its error is held to
    1e-5 of sum |E_c|; force RMS rel <= 1e-4."""
    e_t, f_t = energy.energy_and_forces(both["x_t"], both["sys_t"])
    assert e_t.dtype == both["dtype"] and f_t.shape == both["x_t"].shape
    f_t = f_t.double().numpy()
    f_j = both["f_j"]
    if both["dtype"] == torch.float64:
        assert abs(float(e_t) - both["e_j"]) <= 1e-10 * abs(both["e_j"])
        assert np.abs(f_t - f_j).max() <= 1e-8 * np.abs(f_j).max()
    else:
        scale = sum(abs(v) for v in both["comps_j"].values())
        assert abs(float(e_t) - both["e_j"]) <= 1e-5 * scale
        rms = np.sqrt(np.mean((f_t - f_j) ** 2) / np.mean(f_j ** 2))
        assert rms <= 1e-4


def test_reused_neighbor_state_is_exact_within_the_skin():
    """With atoms moved < skin/2 the reused binning (frozen wrap offsets)
    gives the energy and forces of a fresh binning."""
    _, system, pos, _ = water_systems(torch.float64)
    x0 = torch.as_tensor(pos)
    nb = build_neighbor_state(x0, system)
    rng = np.random.default_rng(5)
    x1 = x0 + torch.as_tensor(rng.uniform(-0.01, 0.01, pos.shape))
    e_r, f_r = energy.energy_and_forces(x1, system, nb=nb)
    e_f, f_f = energy.energy_and_forces(x1, system)
    assert abs(float(e_r - e_f)) <= 1e-10 * abs(float(e_f))
    assert float((f_r - f_f).abs().max()) <= 1e-8 * float(f_f.abs().max())


def _all_nan(e, f):
    return bool(torch.isnan(e)) and bool(torch.isnan(f).all())


def test_overflow_poisons_energy_and_forces():
    force, pos, _, box = water_box(n_side=7, cutoff=0.65)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", recip_method="pme",
                                 cell_capacity=24, device="cpu")
    e, f = energy.energy_and_forces(torch.as_tensor(pos), system)
    assert _all_nan(e, f)


def test_pme_slack_drift_poisons_energy_and_forces():
    """An atom drifting past the PME patch slack since the rebuild would
    lose B-spline support silently; the energy path poisons instead."""
    _, system, pos, _ = water_systems(torch.float64)
    x0 = torch.as_tensor(pos)
    nb = build_neighbor_state(x0, system)
    h = float(system.box[0]) / system.spec.pme_grid[0]
    x1 = x0.clone()
    x1[5, 0] += 1.05 * system.spec.pme_slack[0] * h
    assert _all_nan(*energy.energy_and_forces(x1, system, nb=nb))
    x1[5, 0] = x0[5, 0] + 0.5 * system.spec.pme_slack[0] * h
    assert not _all_nan(*energy.energy_and_forces(x1, system, nb=nb))


def test_shrunken_box_poisons_energy_and_forces():
    """Cells whose plane spacing falls below the cutoff would miss pairs."""
    import dataclasses

    _, system, pos, _ = water_systems(torch.float64)
    small = dataclasses.replace(system, box=system.box * 0.85)
    assert _all_nan(*energy.energy_and_forces(torch.as_tensor(pos) * 0.85,
                                              small))


def test_pme_slack_poison_is_gated_on_the_pme_route():
    """The same drift on classical Ewald (no patches) is not poisoned."""
    force, pos, _, box = water_box(n_side=7, cutoff=0.65)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", recip_method="xla",
                                 device="cpu")
    x0 = torch.as_tensor(pos)
    nb = build_neighbor_state(x0, system)
    x1 = x0.clone()
    x1[5, 0] += 1.05 * system.spec.pme_slack[0] * (
        float(system.box[0]) / system.spec.pme_grid[0])
    assert not _all_nan(*energy.energy_and_forces(x1, system, nb=nb))


def test_auto_recip_on_the_cpu_matches_jax():
    """recip_method="auto" on the CPU in f64 takes classical Ewald in both
    packages (the port once took SPME here: 1.03e-4 off the JAX reciprocal
    energy).  Each package builds the n_side 7 cell system with its own
    builder; every component within 1e-10 relative."""
    from chargeflux_tpu.models import water_box as jax_water_box

    force_j, pos, _, box = jax_water_box(n_side=7, cutoff=0.65)
    jsys = force_j.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell", recip_method="auto")
    force_t, pos_t, _, box_t = water_box(n_side=7, cutoff=0.65)
    sys_t = force_t.create_system(box=box_t, dtype=torch.float64,
                                  direct_method="cell", recip_method="auto",
                                  device="cpu")
    assert np.array_equal(pos, pos_t)
    comps_j = jenergy._energy_components(jnp.asarray(pos), jsys)
    comps_t = energy.energy_components(torch.as_tensor(pos_t), sys_t)
    assert list(comps_t) == list(comps_j)
    for k, v in comps_t.items():
        ref = float(comps_j[k])
        assert abs(float(v) - ref) <= 1e-10 * abs(ref), k


@pytest.mark.parametrize("n_side, cutoff, pbc, kw", [
    (3, 0.9, True, dict(direct_method="dense")),
    (6, 0.9, True, dict(direct_method="dense")),
    (3, 0.9, False, {}),
    (7, 0.65, True, dict(direct_method="cell", recip_method="xla")),
], ids=["dense-n3", "dense-n6", "nonperiodic-n3", "cell-xla-n7"])
def test_routes_match_jax_f64(n_side, cutoff, pbc, kw):
    """Dense PBC, non-periodic and cell + classical Ewald, f64: every
    component and the total within 1e-10 relative (the total of the
    periodic routes is a cancellation of components ~1e2x larger, so it is
    held to 1e-10 of sum |E_c|), forces within 1e-10 of max |F|."""
    jsys, sys_t, pos, _ = jax_water(n_side, cutoff, pbc=pbc, **kw)
    x_j = jnp.asarray(pos)
    comps_j = {k: float(v) for k, v in
               jenergy._energy_components(x_j, jsys).items()}
    e_j, f_j = jenergy.energy_and_forces(x_j, jsys)
    x = torch.as_tensor(pos)
    comps_t = energy.energy_components(x, sys_t)
    assert list(comps_t) == list(comps_j)
    for k, v in comps_t.items():
        assert abs(float(v) - comps_j[k]) <= 1e-10 * abs(comps_j[k]), k
    e_t, f_t = energy.energy_and_forces(x, sys_t)
    scale = sum(abs(v) for v in comps_j.values())
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * scale
    f_j = np.asarray(f_j)
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()


def test_structure_factor_kernel_route_matches_jax_pallas_f32():
    """The bench.py 216 system with recip_method="pallas" in f32: the
    port's plain structure-factor version against the JAX Pallas kernel in
    interpret mode — energy within 1e-4 relative, forces within 2e-5 of
    max |F| (tests/test_pallas_recip.py's full-engine tolerances)."""
    jsys, sys_t, pos, _ = jax_water(6, 0.9, dtype=torch.float32,
                                    direct_method="dense",
                                    recip_method="pallas")
    e_j, f_j = jenergy.energy_and_forces(jnp.asarray(pos, jnp.float32), jsys)
    e_t, f_t = energy.energy_and_forces(torch.as_tensor(pos).float(), sys_t)
    assert abs(float(e_t) - float(e_j)) <= 1e-4 * abs(float(e_j))
    f_j = np.asarray(f_j, np.float64)
    assert np.abs(f_t.double().numpy() - f_j).max() <= \
        2e-5 * np.abs(f_j).max()


def test_dispersion_tail_matches_jax():
    """setUseDispersionCorrection(True): the tail term C / V in f64 within
    1e-10 relative of the JAX package's, on the cell + PME route."""
    from chargeflux_tpu.models import water_box as jax_water_box

    force, pos, _, box = jax_water_box(n_side=7, cutoff=0.65)
    force.setUseDispersionCorrection(True)
    jsys = force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell", recip_method="pme")
    sys_t = port_system(jsys)
    force_t, _, _, box_t = water_box(n_side=7, cutoff=0.65)
    force_t.setUseDispersionCorrection(True)
    assert force_t.create_system(box=box_t, device="cpu").spec.tail_coeff == \
        pytest.approx(jsys.spec.tail_coeff, rel=1e-12)
    ref = float(jenergy.dispersion_energy(jsys.box, jsys.spec, jnp.float64))
    comps = energy.energy_components(torch.as_tensor(pos), sys_t)
    assert list(comps)[:2] == ["self", "dispersion"]
    assert ref < 0 and abs(float(comps["dispersion"]) - ref) <= \
        1e-10 * abs(ref)


@pytest.mark.parametrize("kw", [
    dict(direct_method="dense", recip_method="pme"),
    dict(direct_method="dense", recip_method="pme", triclinic=True),
], ids=["dense-pme", "triclinic"])
def test_unported_routes_raise(kw):
    """The dense-mesh SPME route, on an orthorhombic box and on a sheared
    one, raised until the route was ported; it now runs and agrees with
    the JAX package's in f64 within 1e-10."""
    force, pos, _, box = water_box(n_side=7, cutoff=0.65)
    if kw.pop("triclinic", False):
        L = box[0]
        box = np.array([[L, 0.0, 0.0], [0.15 * L, L, 0.0],
                        [0.10 * L, -0.12 * L, L]])
    system = force.create_system(box=box, dtype=torch.float64, device="cpu",
                                 **kw)
    e_t, f_t = energy.energy_and_forces(torch.as_tensor(pos), system)
    jforce = importlib.import_module("chargeflux_tpu.system").CoulForce
    jsys = jforce.from_dict(force.to_dict()).create_system(
        box=box, dtype=jnp.float64, **kw)
    e_j, f_j = jenergy.energy_and_forces(jnp.asarray(pos), jsys)
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j),
                               atol=1e-10 * float(np.abs(f_j).max()))
