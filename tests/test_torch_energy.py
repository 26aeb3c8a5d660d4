"""PyTorch port: energy components, energy_and_forces and the NaN poisons
on the cell + PME route, held to the JAX package (pinned to
direct_method="cell", recip_method="pme"; on the CPU its cell-blocked
XLA spread stands in for the Pallas kernel, which tests/test_pme.py holds
equal to it)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu_torch import energy
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.neighbors import build_neighbor_state

from torch_helpers import water_systems

jenergy = importlib.import_module("chargeflux_tpu.energy")

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
                                 direct_method="cell", cell_capacity=24)
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


@pytest.mark.parametrize("kw", [dict(direct_method="dense"),
                                dict(direct_method="cell", recip_method="xla"),
                                dict(pbc=False)])
def test_unported_routes_raise(kw):
    force, pos, _, box = water_box(n_side=7, cutoff=0.65)
    if kw.pop("pbc", True) is False:
        force.setUsesPeriodicBoundaryConditions(False)
        box = None
    system = force.create_system(box=box, dtype=torch.float64, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        energy.energy_and_forces(torch.as_tensor(pos), system)
