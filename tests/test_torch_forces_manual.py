"""The manual chain-rule force path of the port (``charges``'
``jacobian_index_layout`` / ``charge_jacobian_values`` /
``apply_chain_rule`` and ``energy.forces_manual``) held against the JAX
package's: the COO index layout exactly, the Jacobian values within
1e-12, and ``forces_manual`` against the port's autograd forces and JAX's
``forces_manual`` within 1e-10 in f64, with bond/angle fluxes, the
combined water flux, and on a periodic, a non-periodic and the on-ramp's
mixed system."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chargeflux_tpu as jcf
from chargeflux_tpu import charges as jcharges
from chargeflux_tpu_torch import charges as pcharges
from chargeflux_tpu_torch.energy import forces, forces_manual

from torch_helpers import port_system


def _water(flux, pbc, n_side=4, cutoff=0.45, **kw):
    from chargeflux_tpu.models import water_box as jwater_box

    force, pos, _, box = jwater_box(n_side=n_side, flux=flux, cutoff=cutoff)
    if not pbc:
        force.setUsesPeriodicBoundaryConditions(False)
        box = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=box, dtype=jnp.float64, **kw)
    return jsys, port_system(jsys), pos


def _onramp(tmp_path):
    from chargeflux_tpu.models import ResidueParams as JResidueParams
    from chargeflux_tpu.models import system_from_pdb
    from chargeflux_tpu_torch.utils.measure import (peptide_tables,
                                                    write_peptide_pdb)

    path = str(tmp_path / "pep.pdb")
    write_peptide_pdb(path, n_res=3, n_side=5)
    force, pos, _, box, _ = system_from_pdb(
        path, peptide_tables(JResidueParams), cutoff=0.45)
    # one combined water term as well, on the first water's atoms
    force.addFluxWater(9, 10, 11, 0.9, 0.3, -0.2, 0.0957, 0.1514)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=box, dtype=jnp.float64,
                                   direct_method="cell", recip_method="pme")
    return jsys, port_system(jsys), pos


CASES = {
    "bond_angle periodic cell": lambda tmp: _water(
        "bond_angle", True, n_side=5, direct_method="cell",
        recip_method="pme"),
    "water periodic dense": lambda tmp: _water(
        "water", True, direct_method="dense"),
    "bond_angle vacuum": lambda tmp: _water("bond_angle", False, n_side=3),
    "on-ramp peptide in water": _onramp,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobian_layout_and_values_equal_jax(tmp_path, case):
    jsys, psys, pos = CASES[case](tmp_path)
    dq_j, dx_j = jcharges.jacobian_index_layout(jsys)
    dq_p, dx_p = pcharges.jacobian_index_layout(psys)
    np.testing.assert_array_equal(np.asarray(dq_j), dq_p.numpy())
    np.testing.assert_array_equal(np.asarray(dx_j), dx_p.numpy())
    n_expect = (4 * psys.bond_idx.shape[0] + 9 * psys.angle_idx.shape[0]
                + 9 * psys.water_idx.shape[0])
    assert dq_p.shape == (n_expect,)
    v_j = np.asarray(jcharges.charge_jacobian_values(jnp.asarray(pos), jsys))
    v_p = pcharges.charge_jacobian_values(torch.tensor(pos), psys).numpy()
    np.testing.assert_allclose(v_p, v_j, atol=1e-12 * np.abs(v_j).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_forces_manual_equals_autograd_and_jax(tmp_path, case):
    jsys, psys, pos = CASES[case](tmp_path)
    x = torch.tensor(pos)
    f_m = forces_manual(x, psys)
    f_a = forces(x, psys)
    scale = float(f_a.abs().max())
    np.testing.assert_allclose(f_m.numpy(), f_a.numpy(), atol=1e-10 * scale)
    f_j = np.asarray(jcf.forces_manual(jnp.asarray(pos), jsys))
    np.testing.assert_allclose(f_m.numpy(), f_j, atol=1e-10 * scale)


def test_jacobian_matches_autograd_of_the_charges():
    """The analytic COO Jacobian, scattered dense, equals the autograd
    Jacobian of ``effective_charges`` (the JAX package's jacfwd check)."""
    jsys, psys, pos = _water("water", True, n_side=2, cutoff=0.25,
                             direct_method="dense")
    x = torch.tensor(pos)
    dq, dx = pcharges.jacobian_index_layout(psys)
    vals = pcharges.charge_jacobian_values(x, psys)
    n = x.shape[0]
    dense = torch.zeros((n, n, 3), dtype=torch.float64)
    dense.index_put_((dq, dx), vals, accumulate=True)
    auto = torch.autograd.functional.jacobian(
        lambda xx: pcharges.effective_charges(xx, psys), x)
    np.testing.assert_allclose(dense.numpy(), auto.numpy(), atol=1e-12)
