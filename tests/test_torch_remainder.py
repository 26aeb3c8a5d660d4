"""PyTorch port: the remainder rows (terms no molecule template covers)
go through one gather and one scatter-add whose sums run in a fixed order
(``rows.gather_planned`` / ``scatter_add_planned`` on the plans the system
and ``BondedParams`` make once), so that a run on the card gives the same
bits twice.  Here, on the CPU: the helpers against advanced indexing and
``index_add`` in value and gradient, and a water box whose every term is
remainder against the JAX package and against its templated twin."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.models import water_bonded_params as jax_bonded_params
from chargeflux_tpu_torch import rows
from chargeflux_tpu_torch.bonded import bonded_energy
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.models import water_bonded_params

from torch_helpers import untemplated, water_systems

jenergy = importlib.import_module("chargeflux_tpu.energy")
jbonded = importlib.import_module("chargeflux_tpu.bonded")
jcharges = importlib.import_module("chargeflux_tpu.charges")
# the module: the package attribute "energy" is the function, as in JAX
energy = importlib.import_module("chargeflux_tpu_torch.energy")

torch.set_num_threads(2)


# (id, index count, rows, source rows): repeated rows, rows never hit, and
# a source longer than the plan's rows (rows past the largest index)
PLANS = [("repeats", 40, 9, 9), ("sparse", 12, 30, 30),
         ("short-plan", 25, 6, 11)]


@pytest.mark.parametrize("case", PLANS, ids=[c[0] for c in PLANS])
def test_planned_helpers_match_index_ops_f64(case):
    _, m, n, nsrc = case
    rng = np.random.default_rng(m + n)
    idx = rng.integers(0, n, m)
    plan = rows.row_plan(idx, "cpu")
    it = torch.as_tensor(idx)
    src = torch.tensor(rng.standard_normal((nsrc, 3)), requires_grad=True)
    ct = torch.as_tensor(rng.standard_normal((m, 3)))
    got = rows.gather_planned(src, plan)
    assert torch.equal(got, src[it])
    (g_got,) = torch.autograd.grad(got, src, ct)
    (g_ref,) = torch.autograd.grad(src[it], src, ct)
    assert torch.allclose(g_got, g_ref, rtol=1e-14, atol=1e-14)

    base = torch.tensor(rng.standard_normal(nsrc), requires_grad=True)
    vals = torch.tensor(rng.standard_normal(m), requires_grad=True)
    out = rows.scatter_add_planned(base, vals, plan)
    ref = base.index_add(0, it, vals)
    assert torch.allclose(out, ref, rtol=1e-14, atol=1e-14)
    cq = torch.as_tensor(rng.standard_normal(nsrc))
    got_g = torch.autograd.grad(out, (base, vals), cq)
    ref_g = torch.autograd.grad(ref, (base, vals), cq)
    for u, v in zip(got_g, ref_g):
        assert torch.equal(u, v)


@pytest.fixture(scope="module")
def remainder_box():
    jsys, sys_t, pos, _ = water_systems(torch.float64)
    rem = untemplated(sys_t)
    assert sys_t.flux_plan is None and sys_t.excl_plan is None
    assert rem.flux_plan is not None and rem.excl_plan is not None
    return jsys, sys_t, rem, pos


def test_remainder_charges_match_jax_f64(remainder_box):
    """q(x) through the remainder path: within 1e-12 of the JAX package's
    (templated) charges and of the port's templated twin."""
    jsys, sys_t, rem, pos = remainder_box
    q_j = np.asarray(jcharges.effective_charges(jnp.asarray(pos), jsys))
    q_r = effective_charges(torch.as_tensor(pos), rem).numpy()
    q_t = effective_charges(torch.as_tensor(pos), sys_t).numpy()
    assert np.abs(q_r - q_j).max() <= 1e-12 * np.abs(q_j).max()
    assert np.abs(q_r - q_t).max() <= 1e-12 * np.abs(q_t).max()


def test_remainder_system_matches_jax_and_templated_f64(remainder_box):
    """Energy and forces of the all-remainder water box: against the
    templated twin within 1e-12 relative (summation order only), against
    the JAX package within the parity contract (1e-10)."""
    jsys, sys_t, rem, pos = remainder_box
    x = torch.as_tensor(pos)
    e_r, f_r = energy.energy_and_forces(x, rem)
    e_t, f_t = energy.energy_and_forces(x, sys_t)
    e_j, f_j = jenergy.energy_and_forces(jnp.asarray(pos), jsys)
    scale = sum(abs(float(v)) for v in
                energy.energy_components(x, sys_t).values())
    assert abs(float(e_r - e_t)) <= 1e-12 * scale
    assert float((f_r - f_t).abs().max()) <= 1e-12 * float(f_t.abs().max())
    f_j = np.asarray(f_j)
    assert abs(float(e_r) - float(e_j)) <= 1e-10 * scale
    assert np.abs(f_r.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()


def test_remainder_bonded_matches_jax_f64():
    """Harmonic bonds and angles with no template (every row through the
    planned gather): energy and gradient against the templated terms and
    the JAX package."""
    n_w = 40
    box = np.full(3, 1.6)
    rng = np.random.default_rng(7)
    pos = rng.uniform(0.0, 1.6, (3 * n_w, 3))
    tb = water_bonded_params(n_w, box=box, dtype=torch.float64, device="cpu")
    rb = dataclasses.replace(tb, template=None)
    assert tb.plan is None and rb.plan is not None
    x = torch.tensor(pos, requires_grad=True)
    e_r = bonded_energy(x, rb)
    (g_r,) = torch.autograd.grad(e_r, x)
    e_t = bonded_energy(x, tb)
    (g_t,) = torch.autograd.grad(e_t, x)
    jb = jax_bonded_params(n_w, box=box, dtype=jnp.float64)
    e_j = float(jbonded.bonded_energy(jnp.asarray(pos), jb))
    assert abs(float(e_r) - float(e_t)) <= 1e-12 * abs(float(e_t))
    assert float((g_r - g_t).abs().max()) <= 1e-12 * float(g_t.abs().max())
    assert abs(float(e_r) - e_j) <= 1e-10 * abs(e_j)
