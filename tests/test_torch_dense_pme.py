"""Dense-mesh SPME of the port (``pme.pme_reciprocal_energy``, the
reciprocal of ``direct_method="dense"`` with ``recip_method="pme"``) held
against the JAX package's in f64 within 1e-10, on an orthorhombic and a
triclinic box, with its gradients; the dense + PME route of
``energy_and_forces`` against JAX; and the energy helpers this slice adds
(``include_recip=False``, ``dispersion_energy``, ``energy``, ``forces``)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chargeflux_tpu as jcf
from chargeflux_tpu import pme as jpme
from chargeflux_tpu.energy import dispersion_energy as j_dispersion_energy
from chargeflux_tpu.energy import (
    energy_components_fixed_charges as j_components_fixed)
from chargeflux_tpu_torch import pme as ppme
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.energy import (dispersion_energy, energy,
                                         energy_and_forces,
                                         energy_components_fixed_charges,
                                         forces)

from torch_helpers import jax_water

BOXES = {
    "ortho": np.array([1.9, 2.1, 2.3]),
    "triclinic": np.array([[2.0, 0.0, 0.0], [0.5, 2.1, 0.0],
                           [0.3, -0.4, 2.2]]),
}


@pytest.mark.parametrize("grid,order", [((16, 18, 20), 8), ((12, 12, 15), 6),
                                        ((10, 9, 8), 4)])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_pme_reciprocal_energy_equals_jax_f64(name, grid, order):
    rng = np.random.default_rng(31)
    box = BOXES[name]
    x = rng.uniform(-0.5, 2.5, (40, 3))
    q = rng.uniform(-1.0, 1.0, 40)
    q -= q.mean()
    alpha = 3.1
    (e_j, (gx_j, gq_j)) = jax.value_and_grad(
        lambda xx, qq: jpme.pme_reciprocal_energy(
            xx, qq, jnp.asarray(box), alpha, grid, order), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(q))
    xt = torch.tensor(x, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    e_p = ppme.pme_reciprocal_energy(xt, qt, torch.tensor(box), alpha, grid,
                                     order)
    gx_p, gq_p = torch.autograd.grad(e_p, (xt, qt))
    assert abs(float(e_p.detach()) - float(e_j)) <= 1e-10 * abs(float(e_j))
    np.testing.assert_allclose(gx_p.numpy(), np.asarray(gx_j),
                               atol=1e-10 * float(np.abs(gx_j).max()))
    np.testing.assert_allclose(gq_p.numpy(), np.asarray(gq_j),
                               atol=1e-10 * float(np.abs(gq_j).max()))


def test_spread_weights_equal_jax():
    rng = np.random.default_rng(2)
    u = rng.uniform(0.0, 16.0, 30)
    u[:3] = [0.0, 15.999999, 7.0]
    w_j = np.asarray(jpme.spread_weights(jnp.asarray(u), 16, 8))
    w_p = ppme.spread_weights(torch.tensor(u), 16, 8).numpy()
    np.testing.assert_allclose(w_p, w_j, atol=1e-15)
    np.testing.assert_allclose(w_p.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("tri", [False, True])
def test_dense_pme_route_equals_jax_f64(tri):
    """water_box(n_side=4) on direct_method="dense", recip_method="pme"
    (the route that raised before this slice), sheared when ``tri``."""
    from chargeflux_tpu.models import water_box as jwater_box
    from chargeflux_tpu_torch.utils.measure import shear_box

    from torch_helpers import port_system

    force, pos, _, box = jwater_box(n_side=4, flux="bond_angle", cutoff=0.55)
    if tri:
        box = shear_box(box)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=box, dtype=jnp.float64,
                                   direct_method="dense", recip_method="pme")
    psys = port_system(jsys)
    e_j, f_j = jcf.energy_and_forces(jnp.asarray(pos), jsys)
    e_p, f_p = energy_and_forces(torch.tensor(pos), psys)
    assert abs(float(e_p) - float(e_j)) <= 1e-10 * abs(float(e_j))
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j),
                               atol=1e-10 * float(np.abs(f_j).max()))
    np.testing.assert_array_equal(forces(torch.tensor(pos), psys), f_p)
    assert float(energy(torch.tensor(pos), psys)) == float(e_p)


@pytest.mark.parametrize("direct", ["dense", "cell"])
def test_include_recip_false_drops_the_reciprocal_as_jax(direct):
    jsys, psys, pos, _ = jax_water(5, 0.45, direct_method=direct,
                                   recip_method="pme")
    x = torch.tensor(pos)
    q = effective_charges(x, psys)
    full = energy_components_fixed_charges(x, q, psys)
    part = energy_components_fixed_charges(x, q, psys, include_recip=False)
    assert set(full) - set(part) == {"reciprocal"}
    for key, v in part.items():
        assert float(v) == float(full[key])
    jpart = j_components_fixed(jnp.asarray(pos), jnp.asarray(q.numpy()), jsys,
                               include_recip=False)
    assert set(jpart) == set(part)
    for key, v in part.items():
        assert abs(float(v) - float(jpart[key])) <= 1e-10 * max(
            1.0, abs(float(jpart[key])))


def test_dispersion_energy_equals_jax():
    from chargeflux_tpu.models import water_box as jwater_box

    from torch_helpers import port_system

    force, pos, _, box = jwater_box(n_side=4, cutoff=0.55)
    force.setUseDispersionCorrection(True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=box, dtype=jnp.float64,
                                   direct_method="dense")
    psys = port_system(jsys)
    e_j = float(j_dispersion_energy(jsys.box, jsys.spec, jnp.float64))
    e_p = float(dispersion_energy(psys.box, psys.spec, torch.float64))
    assert e_j != 0.0 and abs(e_p - e_j) <= 1e-14 * abs(e_j)
