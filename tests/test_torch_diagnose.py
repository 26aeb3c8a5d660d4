"""NaN triage of the port (``utils.diagnose.diagnose_nan``) held against
the JAX package's: for each cause (non-finite positions, cell overflow,
stale neighbor state, collinear flux angle) and for a healthy state, the
same cause and the same numbers."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.neighbors import build_neighbor_state as j_build_nb
from chargeflux_tpu.utils import diagnose as jdiag
from chargeflux_tpu_torch.cells import build_cell_list, validate_cell_list
from chargeflux_tpu_torch.neighbors import build_neighbor_state, skin_radius
from chargeflux_tpu_torch.utils import diagnose as pdiag

from torch_helpers import port_system


def _systems(cap=None):
    from chargeflux_tpu.models import water_box

    force, pos, _, box = water_box(n_side=7, seed=9, cutoff=0.6)
    kw = dict(direct_method="cell")
    if cap is not None:
        kw["cell_capacity"] = cap
    jsys = force.create_system(box=box, dtype=jnp.float64, **kw)
    return jsys, port_system(jsys), pos


def _same(rep_j, rep_p):
    assert rep_j["cause"] == rep_p["cause"]
    assert set(rep_j) == set(rep_p)
    for key, v in rep_j.items():
        if isinstance(v, float):
            assert abs(rep_p[key] - v) <= 1e-12 * max(1.0, abs(v)), key
        else:
            assert rep_p[key] == v, key


def test_healthy_and_non_finite_equal_jax():
    jsys, psys, pos = _systems()
    _same(jdiag.diagnose_nan(jnp.asarray(pos), jsys),
          pdiag.diagnose_nan(torch.tensor(pos), psys))
    bad = pos.copy()
    bad[3, 1] = np.nan
    rep = pdiag.diagnose_nan(torch.tensor(bad), psys)
    _same(jdiag.diagnose_nan(jnp.asarray(bad), jsys), rep)
    assert rep["cause"] == "non_finite_positions"


@pytest.mark.parametrize("margin", [3, None])
def test_cell_overflow_equals_jax(margin):
    """``margin`` 3: a capacity 3 below the densest cell, so a few cells
    overflow and every number agrees.  None: capacity 8, where whole cell
    columns overflow; the JAX package's two-stage ranking then also counts
    the atoms its column stage drops (cells.rank_into_slots), so only its
    ``overflow`` differs from the port's, which counts the atoms past each
    cell's capacity."""
    _, probe, pos = _systems()
    occ = pdiag.max_cell_occupancy(pos, probe)
    cap = 8 if margin is None else occ - margin
    jsys, psys, pos = _systems(cap=cap)
    rep = pdiag.diagnose_nan(torch.tensor(pos), psys)
    rep_j = jdiag.diagnose_nan(jnp.asarray(pos), jsys)
    if margin is None:
        assert rep_j["overflow"] >= rep["overflow"] > 0
        rep_j = dict(rep_j, overflow=rep["overflow"])
    _same(rep_j, rep)
    assert rep["cause"] == "cell_overflow" and rep["overflow"] > 0
    assert rep["max_occupancy"] == occ
    assert validate_cell_list(torch.tensor(pos), psys) == rep["overflow"]
    slots, overflow = build_cell_list(torch.tensor(pos), psys.box,
                                      psys.spec.cell_grid, cap)
    assert slots.shape == (int(np.prod(psys.spec.cell_grid)), cap)
    assert int(overflow) == rep["overflow"]


@pytest.mark.parametrize("dt", [None, 5e-4])
def test_stale_neighbor_state_equals_jax(dt):
    jsys, psys, pos = _systems()
    moved = pos.copy()
    moved[0, 0] += 0.6 * float(skin_radius(psys)) + 1e-3
    rep = pdiag.diagnose_nan(torch.tensor(moved), psys,
                             nb=build_neighbor_state(torch.tensor(pos), psys),
                             dt=dt)
    _same(jdiag.diagnose_nan(jnp.asarray(moved), jsys,
                             nb=j_build_nb(jnp.asarray(pos), jsys), dt=dt),
          rep)
    assert rep["cause"] == "stale_neighbor_state"
    assert ("suggest_rebuild_interval" in rep["suggestion"]) == (
        dt is not None)


@pytest.mark.parametrize("pbc", [False, True])
def test_collinear_flux_angle_equals_jax(pbc):
    from chargeflux_tpu.system import CoulForce as JCoulForce
    from chargeflux_tpu_torch.system import CoulForce

    forces = []
    for cls in (JCoulForce, CoulForce):
        f = cls()
        for q in (-0.8, 0.4, 0.4, 0.1, -0.1):
            f.addParticle(q, 0.3, 0.5)
        f.addFluxAngle(3, 0, 4, 0.1, 1.9)
        f.addFluxAngle(0, 1, 2, 0.15, 1.9)
        if pbc:
            f.setUsesPeriodicBoundaryConditions(True)
            f.setCutoffDistance(0.4)
        forces.append(f)
    box = np.full(3, 1.5) if pbc else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = forces[0].create_system(box=box, dtype=jnp.float64,
                                       direct_method="dense")
    psys = forces[1].create_system(box=box, dtype=torch.float64,
                                   device="cpu", direct_method="dense")
    x = np.array([[0.0, 0, 0], [0.1, 0, 0], [0.2, 0, 0], [0.0, 0.1, 0.0],
                  [0.1, 0.1, 0.05]])
    if pbc:
        x[2] += [1.5, 0.0, 0.0]          # the same angle across the box
    rep = pdiag.diagnose_nan(torch.tensor(x), psys)
    _same(jdiag.diagnose_nan(jnp.asarray(x), jsys), rep)
    assert rep["cause"] == "collinear_flux_angle" and rep["angle_index"] == 1
