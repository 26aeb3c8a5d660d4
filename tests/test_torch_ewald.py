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


def _reciprocal_energy_uncached(positions, q, box, alpha, kmax, method):
    """reciprocal_energy as it was before the k grid's tensors were kept:
    every constant built from the NumPy grid inside the call (the "xla"
    product through ``device.ieee_matmul``, as the port forms it)."""
    import math

    from chargeflux_tpu_torch.device import ieee_matmul
    from chargeflux_tpu_torch.ops.structure_factor import (structure_factor,
                                                           xy_tables)
    from chargeflux_tpu_torch.pairs import (box_volume, frac_coords,
                                            reciprocal_metric)
    from chargeflux_tpu_torch.units import ONE_4PI_EPS0

    dtype = positions.dtype
    nx, ny, nz, w = ewald.kvector_grid(kmax)
    frac = frac_coords(positions, box)
    frac = frac - torch.floor(frac).detach()
    tabs = []
    for axis, n in enumerate((nx, ny, nz)):
        ph = (2.0 * math.pi * frac[:, axis:axis + 1]
              * torch.as_tensor(n, dtype=dtype)[None, :])
        tabs += [torch.cos(ph), torch.sin(ph)]
    cx, sx, cy, sy, cz, sz = tabs
    cz_sz = torch.cat([cz, sz], dim=1)
    if method == "pallas":
        a, b = structure_factor(cx.T.contiguous(), sx.T.contiguous(),
                                cy.T.contiguous(), sy.T.contiguous(),
                                (q[:, None] * cz_sz).contiguous())
    else:
        cxy, sxy = xy_tables(cx.T, sx.T, cy.T, sy.T)
        a, b = ieee_matmul(cxy * q, cz_sz), ieee_matmul(sxy * q, cz_sz)
    s_cos, s_sin = ewald.assemble(a, b, len(nz))
    g = torch.diagonal(reciprocal_metric(box, dtype))

    def sq(v):
        return torch.as_tensor(v * v, dtype=dtype)

    k2 = (g[0] * sq(nx)[:, None, None] + g[1] * sq(ny)[None, :, None]
          + g[2] * sq(nz)[None, None, :]).reshape(len(nx) * len(ny), len(nz))
    k2_safe = torch.where(k2 > 0, k2, 1.0)
    eak = torch.exp(-k2_safe * (0.25 / (alpha * alpha))) / k2_safe
    wk = torch.as_tensor(w.reshape(k2.shape), dtype=dtype) * eak
    const = 4.0 * math.pi * ONE_4PI_EPS0 / box_volume(box)
    return const * torch.sum(wk * (s_cos * s_cos + s_sin * s_sin))


@pytest.mark.parametrize("dtype, method", [(torch.float64, "xla"),
                                           (torch.float32, "xla"),
                                           (torch.float32, "pallas")],
                         ids=["f64-xla", "f32-xla", "f32-pallas"])
def test_kept_k_grid_tensors_change_no_bit(dtype, method, monkeypatch):
    """reciprocal_energy with the k grid's tensors kept per (kmax, dtype,
    device) equals, bit for bit, the form that built them from the NumPy
    grid in every call, in the energy and in dE/dx, dE/dq on seeded inputs;
    and only the first call reads the NumPy grid."""
    rng = np.random.default_rng(11)
    n, kmax, alpha = 60, (3, 4, 5), 2.7
    box = torch.tensor([1.7, 1.9, 2.1], dtype=dtype)
    pos = torch.as_tensor(rng.uniform(-0.5, 2.5, (n, 3))).to(dtype)
    charge = torch.as_tensor(rng.standard_normal(n)).to(dtype)

    def run(fn, **kw):
        x = pos.clone().requires_grad_(True)
        q = charge.clone().requires_grad_(True)
        e = fn(x, q, box, alpha, kmax, method=method, **kw)
        return (e.detach(), *torch.autograd.grad(e, (x, q)))

    want = run(_reciprocal_energy_uncached)
    ewald._kgrid_cached.cache_clear()
    calls = []
    grid_fn = ewald.kvector_grid
    monkeypatch.setattr(ewald, "kvector_grid",
                        lambda k: calls.append(k) or grid_fn(k))
    first, second = run(ewald.reciprocal_energy), run(ewald.reciprocal_energy)
    assert calls == [kmax]
    for got in (first, second):
        for u, v in zip(got, want):
            assert torch.equal(u, v)
    kept = ewald.kgrid_tensors(kmax, dtype, "cpu")
    assert kept is ewald.kgrid_tensors(list(kmax), dtype, torch.device("cpu"))
    assert kept.w.shape == (kmax[0] * (2 * kmax[1] - 1), 2 * kmax[2] - 1)
    assert all(t.dtype == dtype for t in (*kept.n, *kept.sq, kept.w))


PRODUCTS = ["xla", "spread_plain", "sf_plain"]


@pytest.mark.parametrize("product", PRODUCTS)
def test_f32_products_run_at_ieee_f32_whatever_the_tf32_switch(
        product, monkeypatch):
    """With the caller's TF32 switch on, every product of an accuracy path
    (the "xla" structure-factor product and the plain versions' products
    of the spread and of the structure-factor kernels), forward and
    backward through ``torch.autograd.grad``, runs with the switch off
    (a spy on ``torch.matmul`` reads it at each call), and the caller's
    switch reads True again afterwards."""
    from chargeflux_tpu_torch.ops import pme_spread
    from chargeflux_tpu_torch.ops import structure_factor as sf

    real = torch.matmul
    seen = []

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **k)

    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            requires_grad=True)

    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_tf32", True)
    monkeypatch.setattr(torch, "matmul", spy)
    if product == "xla":
        x = torch.tensor(rng.uniform(0, 2.0, (20, 3)), dtype=torch.float32,
                         requires_grad=True)
        q = t(20)
        e = ewald.reciprocal_energy(x, q, torch.tensor([2.0, 2.1, 2.2]), 3.0,
                                    (3, 3, 3))
        inputs = (x, q)
    elif product == "spread_plain":
        qwlxt, wlyt, wzt = t(4, 6, 10), t(4, 8, 10), t(4, 8, 10)
        zorg = torch.tensor(rng.integers(0, 12, (4, 1, 10)), dtype=torch.int32)
        offsets = ((0, 0, 3, 3), (0, 3, 0, 3))
        out = pme_spread.spread_columns(qwlxt, wlyt, wzt, zorg, offsets,
                                        (9, 11, 12))
        e = torch.sum(out * out)
        inputs = (qwlxt, wlyt, wzt)
    else:
        tabs = (t(3, 15), t(3, 15), t(5, 15), t(5, 15), t(15, 10))
        a, b = sf.structure_factor(*tabs)
        e = torch.sum(a * a) + torch.sum(b * b)
        inputs = tabs
    grads = torch.autograd.grad(e, inputs)
    assert all(torch.isfinite(g).all() for g in grads)
    assert seen and not any(seen)
    assert matmul.allow_tf32 is True
