"""PyTorch port: classical Ewald (ewald.py) held to the JAX package —
the k grid, the factorized structure factors and the reciprocal energy with
its gradients in f64 — and the resolution of recip_method="auto"."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.charges import effective_charges as jax_charges
from chargeflux_tpu_torch import ewald
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.energy import resolve_recip_method
from chargeflux_tpu_torch.models import water_box

from torch_helpers import fake_kernel_limits, jax_water, rel_err

jewald = importlib.import_module("chargeflux_tpu.ewald")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def box216():
    """The bench.py 216 system (dense, kmax (7, 7, 7)) from the JAX builder,
    both packages' copies, f64."""
    return jax_water(6, 0.9, direct_method="dense")[:3]


@pytest.mark.parametrize("kmax", [(1, 1, 1), (3, 5, 7), (7, 7, 7)])
def test_kvector_grid_matches_jax(kmax):
    for a, b in zip(ewald.kvector_grid(kmax), jewald.kvector_grid(kmax)):
        np.testing.assert_array_equal(a, b)


def test_structure_factors_and_energy_match_jax_f64(box216):
    """S(k) within 1e-10 of its max; E_rec within 1e-10 relative; dE/dx and
    dE/dq within 1e-10 of their max."""
    jsys, sys_t, pos = box216
    spec = jsys.spec
    x_j = jnp.asarray(pos)
    q_j = jax_charges(x_j, jsys)

    @jax.jit
    def j_all(x, q):
        sc, ss = jewald.structure_factors(x, q, jsys.box, spec.kmax)
        e, g = jax.value_and_grad(
            lambda xx, qq: jewald.reciprocal_energy(
                xx, qq, jsys.box, spec.alpha, spec.kmax), argnums=(0, 1))(x, q)
        return sc, ss, e, g

    sc_j, ss_j, e_j, (gx_j, gq_j) = j_all(x_j, q_j)

    x = torch.as_tensor(pos).requires_grad_(True)
    q = torch.tensor(np.asarray(q_j), requires_grad=True)
    sc, ss = ewald.structure_factors(x, q, sys_t.box, spec.kmax)
    assert rel_err(sc.detach(), sc_j) <= 1e-10
    assert rel_err(ss.detach(), ss_j) <= 1e-10
    e = ewald.reciprocal_energy(x, q, sys_t.box, spec.alpha, spec.kmax)
    gx, gq = torch.autograd.grad(e, (x, q))
    assert abs(float(e.detach()) - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert rel_err(gx, gx_j) <= 1e-10
    assert rel_err(gq, gq_j) <= 1e-10


def test_kernel_route_plain_matches_xla_route_f32():
    """f32, n_side 6: the "pallas" route (plain version on the CPU) against
    the "xla" route of the port: S(k) within 1e-5 of its max, E_rec within
    2e-5 relative and dE/dx within 2e-5 of its max (tests/test_pallas_recip.py's
    tolerances)."""
    force, pos, _, box = water_box(n_side=6, cutoff=0.9)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="dense", device="cpu")
    spec = system.spec
    x = torch.tensor(pos, dtype=torch.float32, requires_grad=True)
    q = effective_charges(x, system)
    out = {}
    for method in ("xla", "pallas"):
        s = ewald.structure_factors(x, q, system.box, spec.kmax, method=method)
        e = ewald.reciprocal_energy_from_sf(*s, system.box, spec.alpha,
                                            spec.kmax)
        (g,) = torch.autograd.grad(e, x, retain_graph=True)
        out[method] = (s, e.detach(), g)
    (sx, ex, gx), (sp, ep, gp) = out["xla"], out["pallas"]
    for a, b in zip(sp, sx):
        assert rel_err(a.detach(), b.detach()) <= 1e-5
    assert abs(float(ep - ex)) <= 2e-5 * abs(float(ex))
    assert rel_err(gp, gx) <= 2e-5


def test_kernel_route_refuses_f64(box216):
    _, sys_t, pos = box216
    x = torch.as_tensor(pos)
    with pytest.raises(ValueError, match="f32"):
        ewald.structure_factors(x, sys_t.q0, sys_t.box, sys_t.spec.kmax,
                                method="pallas")


@pytest.mark.parametrize("direct, n_side, device, dtype, want", [
    ("dense", 6, "cuda", torch.float32, "pallas"),   # n_k 1183 < 4000
    ("dense", 11, "cuda", torch.float32, "xla"),     # n_k 13*25*25 = 8125
    ("cell", 11, "cuda", torch.float32, "pme"),
    ("dense", 6, "cuda", torch.float64, "xla"),
    ("dense", 6, "cpu", torch.float32, "xla"),
    ("cell", 11, "cpu", torch.float32, "xla"),
    ("cell", 11, "cpu", torch.float64, "xla"),
])
def test_auto_resolves_as_the_jax_package(direct, n_side, device, dtype,
                                           want, monkeypatch):
    """energy.py:282-299 of the JAX package, with a CUDA device in f32
    standing where JAX has the TPU in f32.  (torch.device("cuda") needs no
    card; the structure-factor kernels' k-grid limits, which "auto" also
    asks, are the compiled-in values.)"""
    fake_kernel_limits(monkeypatch)
    force, _, _, box = water_box(n_side=n_side, cutoff=0.9)
    spec = force.create_system(box=box, direct_method=direct,
                               device="cpu").spec
    assert resolve_recip_method(spec, dtype, torch.device(device)) == want
    pinned = dataclasses.replace(spec, recip_method="pme")
    assert resolve_recip_method(pinned, dtype, torch.device(device)) == "pme"
