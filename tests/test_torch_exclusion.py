"""PyTorch port: the exclusion correction (``ops.exclusion``): its plain
chain against the chain as ``energy._exclusion_correction`` ran it before
the kernels and against the JAX package, the route that sends template
blocks to the kernels, and the paths that stay plain.  The kernels run on
the card only (tests/test_torch_kernels_cuda.py); here the kernel route is
taken by a CPU system whose ``kernel_route`` is set to "cuda", so the
wrappers run their plain versions and launch nothing."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.energy import _exclusion_correction as jax_exclusion
from chargeflux_tpu.models import solvated_chain_box as jax_chain
from chargeflux_tpu_torch import npt, ops
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.ops import exclusion as ex
from chargeflux_tpu_torch.ops.erfc import erfc_fast
from chargeflux_tpu_torch.pairs import displacement
from chargeflux_tpu_torch.rows import gather_planned
from chargeflux_tpu_torch.units import ONE_4PI_EPS0
from chargeflux_tpu_torch.utils.measure import (exclusion_inputs,
                                                exclusion_scale, shear_box)

from torch_helpers import jax_dtype, jax_water, port_system

# the module: the package attribute "energy" is the function, as in JAX
energy = importlib.import_module("chargeflux_tpu_torch.energy")

torch.set_num_threads(2)

#: tests/test_heterogeneous.py's chain box: a 15-bead chain (remainder
#: rows) and 211 templated waters at an offset
CHAIN = dict(n_side=6, n_solute_sites=5, cutoff=0.58, seed=7)


def _chain_before(positions, q, system, subtract_direct):
    """``energy._exclusion_correction`` as it was before the kernels: every
    templated row by static slices, then the remainder rows by a gather."""
    spec = system.spec
    dtype = positions.dtype
    sig, eps = system.sigma.to(dtype), system.epsilon.to(dtype)

    def pairs(p1, p2, q1, q2, s1, s2, e1, e2, template):
        d = displacement(p1, p2, system.box, spec.pbc)
        r2 = torch.sum(d * d, dim=-1)
        if template:
            inv_r = torch.rsqrt(r2)
            r = r2 * inv_r
        else:
            r = torch.sqrt(r2)
            inv_r = 1.0 / r
        qq, half_sig = q1 * q2, 0.5 * (s1 + s2)
        ep = 4.0 * torch.sqrt(e1 * e2)
        erfc_ar = erfc_fast(spec.alpha * r)
        e = -ONE_4PI_EPS0 * qq * inv_r * (1.0 - erfc_ar)
        if subtract_direct:
            sig2 = (half_sig * inv_r) ** 2
            sig6 = sig2 * sig2 * sig2
            direct = (ONE_4PI_EPS0 * qq * inv_r * erfc_ar
                      + ep * sig6 * (sig6 - 1.0))
            e = e - torch.where(r < spec.cutoff, direct, 0.0)
        return torch.sum(e, dim=-1)

    total = torch.zeros((), dtype=dtype)
    lead = positions.shape[:-2]
    for tpl in spec.excl_template.templates:
        off, s, c = tpl.offset, tpl.stride, tpl.count
        sl = slice(off, off + c * s)
        pos_m = positions[..., sl, :].reshape(lead + (c, s, 3))
        q_m = q[..., sl].reshape(lead + (c, s))
        sig_m, eps_m = sig[sl].reshape(c, s), eps[sl].reshape(c, s)
        for (l1, l2) in tpl.local_rows("exclusions"):
            total = total + pairs(
                pos_m[..., l1, :], pos_m[..., l2, :], q_m[..., l1],
                q_m[..., l2], sig_m[:, l1], sig_m[:, l2], eps_m[:, l1],
                eps_m[:, l2], True)
    if system.excl_plan is not None:
        table = torch.cat([positions, q[:, None], sig[:, None],
                           eps[:, None]], dim=1)
        ge = gather_planned(table, system.excl_plan).reshape(-1, 2, 6)
        a, b = ge[:, 0], ge[:, 1]
        total = total + pairs(a[:, 0:3], b[:, 0:3], a[:, 3], b[:, 3],
                              a[:, 4], b[:, 4], a[:, 5], b[:, 5], False)
    return total


def _systems(box_name, dtype):
    """(JAX system, port system) of the water box or the chain box on the
    cell route."""
    if box_name == "water":
        jsys, sys_t, _, _ = jax_water(7, 0.65, dtype, direct_method="cell",
                                      recip_method="pme")
        return jsys, sys_t
    force, _, _, box = jax_chain(**CHAIN)[:4]
    jsys = force.create_system(box=box, dtype=jax_dtype(dtype),
                               direct_method="cell", recip_method="pme")
    return jsys, port_system(jsys, dtype)


def _inputs(box_name, dtype, seed=3):
    """(JAX system, port system, positions, charges): the lattice shifted,
    drifted and wrapped atom by atom into the box (molecules straddle its
    faces), the effective charges there."""
    jsys, sys_t = _systems(box_name, dtype)
    if box_name == "water":
        pos = water_box(n_side=7, cutoff=0.65)[1]
    else:
        pos = jax_chain(**CHAIN)[1]
    x, q = exclusion_inputs(sys_t, torch.as_tensor(np.asarray(pos),
                                                   dtype=dtype), seed=seed)[:2]
    return jsys, sys_t, x, q


def _grads(fn, x, q):
    xg, qg = x.clone().requires_grad_(True), q.clone().requires_grad_(True)
    with torch.enable_grad():
        e = fn(xg, qg)
        return (e.detach(), *torch.autograd.grad(e, (xg, qg)))


def _kernel_route(system):
    """The system with the kernel route taken (on the CPU the wrappers run
    their plain versions)."""
    fake = system._swap()
    object.__setattr__(fake, "kernel_route", "cuda")
    return fake


CASES = [(b, d, s) for b in ("water", "chain")
         for d in (torch.float64, torch.float32) for s in (True, False)]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{b}-{str(d)[6:]}-{'sub' if s else 'nosub'}" for b, d, s in CASES])
def test_plain_twin_matches_the_chain_before_and_jax(case):
    """Energy, dE/dx and dE/dq of the plain route and of the kernel route's
    plain versions equal the chain before the kernels bit for bit; against
    the JAX package's exclusion correction: energy within 1e-12 (f64) or
    1e-6 (f32) of the sum of the pair terms' magnitudes, gradients within
    1e-12 or 1e-5 of their max (1e-4 in f32 without subtract_direct: the
    derivative of erf(alpha r) / r cancels to ~1/30 at the O-H distance,
    and the two packages round it some 1e-5 of the max apart)."""
    box_name, dtype, sub = case
    jsys, sys_t, x, q = _inputs(box_name, dtype)
    assert sys_t.spec.excl_template is not None
    assert (sys_t.excl_plan is not None) == (box_name == "chain")
    before = _grads(lambda a, b: _chain_before(a, b, sys_t, sub), x, q)
    for system in (sys_t, _kernel_route(sys_t)):
        got = _grads(lambda a, b: energy._exclusion_correction(
            a, b, system, sub), x, q)
        for u, v in zip(got, before):
            assert torch.equal(u, v)
    e_j, (gx_j, gq_j) = jax.value_and_grad(
        lambda a, b: jax_exclusion(a, b, jsys, sub), argnums=(0, 1))(
        jnp.asarray(x.numpy()), jnp.asarray(q.numpy()))
    scale = sum(exclusion_scale((x, q, sys_t.sigma, sys_t.epsilon,
                                 sys_t.box), tpl, sys_t.spec, sub)
                for tpl in sys_t.spec.excl_template.templates)
    e_tol, g_tol = ((1e-12, 1e-12) if dtype == torch.float64
                    else (1e-6, 1e-5 if sub else 1e-4))
    assert abs(float(before[0]) - float(e_j)) <= e_tol * scale
    for u, w in zip(before[1:], (gx_j, gq_j)):
        w = np.asarray(w, np.float64)
        assert np.abs(u.double().numpy() - w).max() <= g_tol * np.abs(w).max()


def test_a_pair_beyond_the_cutoff_takes_no_direct_subtraction():
    """One water with both H stretched past the cutoff from O and from each
    other: its correction and gradients are the same with and without
    subtract_direct; moved back inside, they differ."""
    _, sys_t, x, q = _inputs("water", torch.float64)
    tpl = dataclasses.replace(sys_t.spec.excl_template.templates[0], count=1)
    cut = sys_t.spec.cutoff
    far = x.clone()
    far[1] = far[0] + torch.tensor([1.1 * cut, 0.0, 0.0], dtype=x.dtype)
    far[2] = far[0] + torch.tensor([0.0, 1.1 * cut, 0.0], dtype=x.dtype)
    args = (sys_t.sigma, sys_t.epsilon, sys_t.box, tpl, sys_t.spec)
    for pos, same in ((far, True), (x, False)):
        with_sub, without = (_grads(lambda a, b: ex.template_exclusion_energy(
            a, b, *args, sub), pos, q) for sub in (True, False))
        assert all(torch.equal(u, v) for u, v in zip(with_sub, without)) \
            == same


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_a_nan_position_poisons_the_energy_and_its_molecule(route):
    """A NaN coordinate gives a NaN correction and NaN dE/dx and dE/dq on
    every atom of its molecule, the same entries as the chain before; the
    other atoms' gradients stay finite."""
    _, sys_t, x, q = _inputs("water", torch.float64)
    system = sys_t if route == "plain" else _kernel_route(sys_t)
    bad = x.clone()
    bad[3 * 40 + 2, 1] = float("nan")
    got = _grads(lambda a, b: energy._exclusion_correction(a, b, system,
                                                          True), bad, q)
    want = _grads(lambda a, b: _chain_before(a, b, sys_t, True), bad, q)
    assert torch.isnan(got[0])
    for u, w in zip(got[1:], want[1:]):
        nan = torch.isnan(u)
        assert torch.equal(nan, torch.isnan(w))
        assert bool(nan.reshape(x.shape[0], -1)[120:123].all())
        assert int(nan.reshape(x.shape[0], -1).any(dim=1).sum()) == 3


def _route_cases():
    """(name, system, positions, charges, kernel route expected): the
    kernel route's system with a [3] box, a box that requires grad, a
    [3, 3] lattice and a leading replica axis, and the plain route."""
    _, sys_t, x, q = _inputs("water", torch.float64)
    kern = _kernel_route(sys_t)
    force, pos, _, box = water_box(n_side=7, cutoff=0.65)
    tri = force.create_system(box=shear_box(box), dtype=torch.float64,
                              direct_method="cell", recip_method="pme",
                              device="cpu")
    x_tri = torch.as_tensor(np.asarray(pos))
    q_tri = energy.effective_charges(x_tri, tri)
    return [
        ("box [3]", kern, x, q, True),
        ("box requires grad", kern.with_box(
            kern.box.clone().requires_grad_(True)), x, q, False),
        ("[3, 3] lattice", _kernel_route(tri), x_tri, q_tri, False),
        ("replica axis", kern, torch.stack([x, x + 0.01]),
         torch.stack([q, q]), False),
        ("plain route", sys_t, x, q, False),
    ]


def test_the_kernel_route_is_taken_only_where_the_kernels_apply(
        monkeypatch):
    """Template blocks go to ``ops.exclusion.template_exclusion_energy``
    only on the kernel route with a [3] box that does not require grad and
    no replica axes, once per template; the system's copy on the plain
    route never; every case equals the chain before bit for bit; no
    launch is counted on the CPU."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[5])
        return ex.template_exclusion_energy(*args, **kw)

    monkeypatch.setattr(energy, "template_exclusion_energy", spy)
    ops.reset_launch_counts()
    for name, kern, x, q, kernel in _route_cases():
        for plain in (False, True):
            system = kern.with_kernel_route("plain") if plain else kern
            calls.clear()
            assert energy._excl_kernel_route(x, system) == (
                kernel and not plain), name
            e = energy._exclusion_correction(x, q, system, True)
            n_tpl = len(system.spec.excl_template.templates)
            assert len(calls) == (n_tpl if kernel and not plain else 0), name
            assert torch.equal(e, _chain_before(x, q, system, True)), name
    assert not any(ops.launch_counts().values())


def test_the_kernel_route_refuses_sigma_epsilon_and_box_cotangents():
    """The template function has no cotangent for sigma, epsilon or the
    box: asking for one raises."""
    _, sys_t, x, q = _inputs("water", torch.float64)
    tpl = sys_t.spec.excl_template.templates[0]
    for i in (2, 3, 4):
        args = [x, q, sys_t.sigma, sys_t.epsilon, sys_t.box]
        args[i] = args[i].clone().requires_grad_(True)
        with torch.enable_grad():
            e = ex.template_exclusion_energy(*args, tpl, sys_t.spec, True)
            with pytest.raises(RuntimeError, match="no cotangent"):
                torch.autograd.grad(e, args[i])


@pytest.mark.parametrize("which", ["instantaneous", "tensor"])
def test_the_pressure_is_unchanged_on_the_kernel_route(which):
    """``npt.instantaneous_pressure`` and ``npt.pressure_tensor``
    differentiate through a box that requires grad (and the tensor through a
    [3, 3] lattice), so their exclusions take the plain chain: the kernel
    route's system gives the plain route's bits."""
    _, sys_t, x, q = _inputs("water", torch.float64)
    n = x.shape[0]
    masses = torch.tensor([15.999, 1.008, 1.008] * (n // 3),
                          dtype=torch.float64)
    v = 0.1 * torch.randn(x.shape, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(5))
    fn = (npt.instantaneous_pressure if which == "instantaneous"
          else npt.pressure_tensor)
    p_plain = fn(x, v, sys_t, masses)
    p_kernel = fn(x, v, _kernel_route(sys_t), masses)
    assert torch.isfinite(p_plain).all()
    assert torch.equal(p_plain, p_kernel)
