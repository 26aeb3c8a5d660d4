"""PyTorch port: the CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU (sm_90a), nvcc and a CUDA build of PyTorch; every test
here is marked ``cuda`` and skips without a card.  This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

from chargeflux_tpu_torch import cells, ewald, ops, pme
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.device import constant
from chargeflux_tpu_torch.energy import energy_and_forces, energy_components
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.neighbors import build_neighbor_state
from chargeflux_tpu_torch.bonded import bonded_energy
from chargeflux_tpu_torch.ops import bonded_terms as bt
from chargeflux_tpu_torch.ops import cell_bin as cb
from chargeflux_tpu_torch.ops import direct_walk as dw
from chargeflux_tpu_torch.ops import exclusion as ex
from chargeflux_tpu_torch.ops import native
from chargeflux_tpu_torch.ops import pme_spread as ps
from chargeflux_tpu_torch.ops import pme_weights as pw
from chargeflux_tpu_torch.ops import structure_factor as sf
from chargeflux_tpu_torch.ops.erfc import erf_over_r_coeffs
from chargeflux_tpu_torch.utils.measure import (bench_path, bonded_inputs,
                                                bonded_scale, dense_path,
                                                exclusion_inputs,
                                                exclusion_scale,
                                                patch_weight_inputs)

from torch_helpers import KERNEL_LIMITS, lattice_blocks, untemplated

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    force, pos, _, box = water_box(n_side=9, cutoff=0.65)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="cell", recip_method="pme",
                                 device=dev)
    x = torch.tensor(pos, dtype=torch.float32, device=dev)
    with torch.no_grad():
        nb = build_neighbor_state(x, system)
        b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                           nb.inv_slot, wrap=nb.wrap)
    return dict(system=system, x=x, blocks=b,
                ids=nb.slots.reshape(b.x.shape))


def _max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _on_route(system, plain):
    """``system``, or with ``plain`` its copy on the plain route."""
    return system.with_kernel_route("plain") if plain else system


def test_spread_kernels_match_plain_and_repeat_bitwise(setup):
    s = setup
    args = pme.column_spread_inputs(s["blocks"], s["ids"], s["system"])
    ct = torch.randn(args[5], device=s["x"].device,
                     generator=torch.Generator(s["x"].device).manual_seed(0))
    n0 = dict(ops.launch_counts())
    a, b = ps.spread_fwd(*args), ps.spread_fwd(*args)
    assert torch.equal(a, b)
    assert _max_rel(a, ps.spread_fwd_plain(*args)) <= 1e-6
    k1 = ps.spread_bwd(*args[:5], ct)
    k2 = ps.spread_bwd(*args[:5], ct)
    for u, v, w in zip(k1, k2, ps.spread_bwd_plain(*args[:5], ct)):
        assert torch.equal(u, v)
        assert _max_rel(u, w) <= 2e-5
    counts = ops.launch_counts()
    assert counts["spread_fwd"] == n0["spread_fwd"] + 2
    assert counts["spread_bwd"] == n0["spread_bwd"] + 2


@pytest.fixture(scope="module")
def weights_96k(setup):
    """The B-spline patch weights' inputs at the shapes of the benchmark's
    98k-atom water box (32^3 waters, 8^3 cells of 256 slots, 64^3 mesh,
    order 8, slack 1) on blocks drifted up to 0.05 nm from where the cells
    were binned, with the reciprocal energy's weight cotangents."""
    dev = setup["x"].device
    force, pos, _, box = water_box(n_side=32, cutoff=1.0)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="cell", recip_method="pme",
                                 cell_grid=(8, 8, 8), cell_capacity=256,
                                 pme_grid=(64, 64, 64), device=dev)
    spec = system.spec
    assert (spec.pme_order, spec.pme_slack) == (8, (1, 1, 1))
    x = torch.tensor(pos, dtype=torch.float32, device=dev)
    g = torch.Generator(dev).manual_seed(96)
    with torch.no_grad():
        nb = build_neighbor_state(x, system)
        assert int(nb.overflow) == 0
        x = x + 0.05 * (2.0 * torch.rand(x.shape, device=dev, generator=g)
                        - 1.0)
        b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                           nb.inv_slot, wrap=nb.wrap)
    args, cts = patch_weight_inputs(b, nb.slots.reshape(b.x.shape), system)
    return dict(system=system, args=args, cts=cts)


def test_patch_weights_kernels_match_plain_at_the_96k_shapes(weights_96k):
    """Forward: the weights within 1e-6 absolute of the plain version, the
    z origins equal; backward on the real cotangents: dE/dx, dE/dy, dE/dz
    and dE/dq within 2e-5 of their max (chip_smoke phase 3's tolerance);
    two calls bit-equal; each wrapper counts one launch a call."""
    args, cts = weights_96k["args"], weights_96k["cts"]
    n0 = dict(ops.launch_counts())
    k1, k2 = pw.patch_weights_fwd(*args), pw.patch_weights_fwd(*args)
    plain = pw.patch_weights_fwd_plain(*args)
    for u, v, w in zip(k1, k2, plain):
        assert u.shape == w.shape and u.dtype == w.dtype
        assert torch.equal(u, v)
    for u, w in zip(k1[:3], plain[:3]):
        assert float((u - w).abs().max()) <= 1e-6
    assert torch.equal(k1[3], plain[3])
    assert float(k1[1][:, 20:].abs().max()) == 0.0       # Wy 20 of Wyp 24
    g1, g2 = pw.patch_weights_bwd(*args, *cts), pw.patch_weights_bwd(*args,
                                                                       *cts)
    for u, v, w in zip(g1, g2, pw.patch_weights_bwd_plain(*args, *cts)):
        assert torch.equal(u, v)
        assert _max_rel(u, w) <= 2e-5
    counts = ops.launch_counts()
    assert counts["patch_weights_fwd"] == n0["patch_weights_fwd"] + 2
    assert counts["patch_weights_bwd"] == n0["patch_weights_bwd"] + 2


def test_patch_weights_kernels_on_a_sheared_lattice(tri_setup):
    """The fractional coordinates against ones: the kernels against the
    plain version on the sheared box (weights 1e-6 absolute, gradients
    2e-5 of their max), and the cell route's reciprocal energy and its
    gradients through the fractional transform against the plain
    route."""
    s = tri_setup
    args, cts = patch_weight_inputs(s["blocks"], s["ids"], s["system"])
    for u, w in zip(pw.patch_weights_fwd(*args),
                    pw.patch_weights_fwd_plain(*args)):
        assert float((u.double() - w.double()).abs().max()) <= 1e-6
    for u, w in zip(pw.patch_weights_bwd(*args, *cts),
                    pw.patch_weights_bwd_plain(*args, *cts)):
        assert _max_rel(u, w) <= 2e-5
    grads = []
    for plain in (False, True):
        leaves = [getattr(s["blocks"], f).clone().requires_grad_(True)
                  for f in ("x", "y", "z", "q")]
        e = pme.pme_cell_column_reciprocal_energy(
            cells.CellBlocks(*leaves, s["blocks"].hs, s["blocks"].se),
            s["ids"], _on_route(s["system"], plain))
        grads.append((e, torch.autograd.grad(e, leaves)))
    (e_k, g_k), (e_p, g_p) = grads
    assert abs(float(e_k - e_p)) <= 1e-5 * abs(float(e_p))
    for u, w in zip(g_k, g_p):
        assert _max_rel(u, w) <= 1e-4


def test_an_evaluation_launches_the_weights_once_each_way(setup):
    """energy_and_forces on the kernel route: one forward and one backward
    weights launch; its copy on the plain route none."""
    s = setup
    ops.reset_launch_counts()
    energy_and_forces(s["x"], s["system"])
    counts = ops.launch_counts()
    assert (counts["patch_weights_fwd"], counts["patch_weights_bwd"]) == (1, 1)
    ops.reset_launch_counts()
    energy_and_forces(s["x"], s["system"].with_kernel_route("plain"))
    assert not any(ops.launch_counts().values())


def test_patch_weights_wrappers_refuse_what_the_kernels_do_not_take(
        weights_96k):
    """An order outside the built instantiations, float64 coordinates, a
    non-contiguous coordinate or a cotangent of the wrong shape raises."""
    args, cts = weights_96k["args"], weights_96k["cts"]
    for order in (3, 9):
        bad = (*args[:-1], args[-1]._replace(order=order))
        with pytest.raises(ValueError, match="order"):
            pw.patch_weights_fwd(*bad)
        with pytest.raises(ValueError, match="order"):
            pw.patch_weights_bwd(*bad, *cts)
    with pytest.raises(TypeError):
        pw.patch_weights_fwd(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        pw.patch_weights_fwd(args[0].transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="d_wzt"):
        pw.patch_weights_bwd(*args, *cts[:2], cts[2][:, :4].contiguous())


def test_patch_weights_kernel_poisons_a_non_finite_row(weights_96k):
    """A NaN coordinate: NaN on every tap of its row's x patch and on its
    dE/dx, as the plain version; the other rows finite."""
    args, cts = weights_96k["args"], weights_96k["cts"]
    x = args[0].clone()
    x[3, 4, 5, 6] = float("nan")
    bad = (x, *args[1:])
    qwlxt = pw.patch_weights_fwd(*bad)[0]
    col, row = 3 * x.shape[1] + 4, 5 * x.shape[3] + 6
    assert bool(torch.isnan(qwlxt[col, :, row]).all())
    assert bool(torch.isnan(pw.patch_weights_fwd_plain(*bad)[0][
        col, :, row]).all())
    assert int(torch.isnan(qwlxt).sum()) == qwlxt.shape[1]
    g_x = pw.patch_weights_bwd(*bad, *cts)[0]
    assert bool(torch.isnan(g_x[3, 4, 5, 6]))
    assert int(torch.isnan(g_x).sum()) == 1


@pytest.fixture(scope="module")
def excl_boxes(weights_96k):
    """The exclusion kernels' inputs on the benchmark's 98k-atom water box
    and on bench.py's hetero30k box (a chain in water: templates and
    remainder rows), each drifted up to 0.05 nm and wrapped atom by atom
    into the box (molecules straddle its faces)."""
    dev = weights_96k["args"][0].device
    _, pos, _, _ = water_box(n_side=32, cutoff=1.0)
    s96 = weights_96k["system"]
    x96 = torch.tensor(pos, dtype=torch.float32, device=dev)
    _f, x_h, _m, _b, _bd, s_h = bench_path("hetero30k", dev)
    assert s_h.excl_plan is not None             # remainder rows as well
    return {name: (system, exclusion_inputs(system, x, seed=22), x)
            for name, system, x in (("98k", s96, x96),
                                    ("hetero30k", s_h, x_h))}


def _template_cases(excl_boxes):
    for name, (system, args, _) in excl_boxes.items():
        for tpl in system.spec.excl_template.templates:
            for sub in (True, False):
                yield f"{name} {tpl.count}x{tpl.stride} sub={sub}", \
                    system, args, tpl, sub


# the gradients' limit, of their max, with and without subtract_direct:
# without it a pair's gradient is the derivative of erf(alpha r) / r, whose
# two terms cancel to ~1/30 at the O-H distance, so either f32 version lies
# some 3e-5 of the max from the same formula in f64 (the CPU, 10^4 waters)
EXCL_GRAD_TOLS = {True: 1e-5, False: 1e-4}


def test_exclusion_kernels_match_plain(excl_boxes):
    """Each template of both boxes, with and without subtract_direct: E
    within 1e-6 of the sum of the pair terms' magnitudes, ct dE/dx and
    ct dE/dq (ct 1.5) within EXCL_GRAD_TOLS of their max; two launches
    bit-equal; each wrapper counts one launch a call."""
    n0 = dict(ops.launch_counts())
    calls = 0
    for name, system, args, tpl, sub in _template_cases(excl_boxes):
        spec = system.spec
        e1 = ex.exclusion_fwd(*args, tpl, spec, sub)
        e2 = ex.exclusion_fwd(*args, tpl, spec, sub)
        e_p = ex.exclusion_fwd_plain(*args, tpl, spec, sub)
        assert torch.equal(e1, e2), name
        scale = exclusion_scale(args, tpl, spec, sub)
        assert abs(float(e1) - float(e_p)) <= 1e-6 * scale, name
        ct = torch.tensor(1.5, device=e1.device)
        g1 = ex.exclusion_bwd(*args, tpl, spec, sub, ct)
        g2 = ex.exclusion_bwd(*args, tpl, spec, sub, ct)
        for u, v, w in zip(g1, g2, ex.exclusion_bwd_plain(*args, tpl, spec,
                                                            sub, ct)):
            assert torch.equal(u, v), name
            assert _max_rel(u, w) <= EXCL_GRAD_TOLS[sub], name
        calls += 2
    counts = ops.launch_counts()
    assert counts["exclusion_fwd"] == n0["exclusion_fwd"] + calls
    assert counts["exclusion_bwd"] == n0["exclusion_bwd"] + calls


def test_exclusion_kernels_poison_a_nan_position_as_plain(excl_boxes):
    """A NaN coordinate: E NaN, and NaN on the same gradients as the plain
    chain (every atom of its molecule), the rest within 1e-5."""
    system, args, _ = excl_boxes["98k"]
    tpl = system.spec.excl_template.templates[0]
    x = args[0].clone()
    x[3 * 1000 + 1, 2] = float("nan")
    bad = (x, *args[1:])
    assert torch.isnan(ex.exclusion_fwd(*bad, tpl, system.spec, True))
    ct = torch.tensor(1.0, device=x.device)
    g_k = ex.exclusion_bwd(*bad, tpl, system.spec, True, ct)
    g_p = ex.exclusion_bwd_plain(*bad, tpl, system.spec, True, ct)
    for u, w in zip(g_k, g_p):
        assert torch.equal(torch.isnan(u), torch.isnan(w))
        assert bool(torch.isnan(u.reshape(x.shape[0], -1)[3000:3003]).all())
        ok = ~torch.isnan(w)
        assert _max_rel(u[ok], w[ok]) <= 1e-5


def test_exclusion_kernels_replay_in_a_cuda_graph(excl_boxes):
    """Both wrappers captured into one CUDA graph replay the eager calls'
    bits; new positions copied into the captured input give their own."""
    system, args, _ = excl_boxes["98k"]
    tpl, spec = system.spec.excl_template.templates[0], system.spec
    other = exclusion_inputs(system, args[0], seed=23, drift=0.01)[0]
    static = args[0].clone()
    ct = torch.tensor(1.0, device=static.device)
    ex.exclusion_fwd(static, *args[1:], tpl, spec, True)         # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        e = ex.exclusion_fwd(static, *args[1:], tpl, spec, True)
        g = ex.exclusion_bwd(static, *args[1:], tpl, spec, True, ct)
    for x in (args[0], other, args[0]):
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(e, ex.exclusion_fwd(x, *args[1:], tpl, spec,
                                               True))
        for u, v in zip(g, ex.exclusion_bwd(x, *args[1:], tpl, spec, True,
                                            ct)):
            assert torch.equal(u, v)


def test_an_evaluation_launches_the_exclusion_kernels_once_each_way(
        setup, excl_boxes, monkeypatch):
    """energy_and_forces on the kernel route: one forward and one backward
    exclusion launch per template (the water box has one; hetero30k's
    chain rows take the plain remainder path); its plain copy none.  On
    hetero30k, against the same route with the exclusions' plain chain:
    |dE| <= 1e-6 of the components' magnitudes, force RMS <= 1e-5
    relative (the other kernels against the plain route: 1e-5 and
    1e-4)."""
    s = setup
    ops.reset_launch_counts()
    energy_and_forces(s["x"], s["system"])
    counts = ops.launch_counts()
    assert (counts["exclusion_fwd"], counts["exclusion_bwd"]) == (1, 1)
    system, _, x = excl_boxes["hetero30k"]
    n_tpl = len(system.spec.excl_template.templates)
    ops.reset_launch_counts()
    e_k, f_k = energy_and_forces(x, system)
    counts = ops.launch_counts()
    assert (counts["exclusion_fwd"], counts["exclusion_bwd"]) == (n_tpl,
                                                                  n_tpl)
    ops.reset_launch_counts()
    e_p, f_p = energy_and_forces(x, system.with_kernel_route("plain"))
    assert not any(ops.launch_counts().values())
    energy_module = importlib.import_module("chargeflux_tpu_torch.energy")
    monkeypatch.setattr(energy_module, "_excl_kernel_route",
                        lambda *args: False)
    e_c, f_c = energy_and_forces(x, system)
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in energy_components(
            x, system.with_kernel_route("plain")).values())
    for e, f, e_tol, f_tol in ((e_c, f_c, 1e-6, 1e-5),
                               (e_p, f_p, 1e-5, 1e-4)):
        assert abs(float(e_k - e)) <= e_tol * scale
        rms = torch.sqrt(torch.mean((f_k - f) ** 2) / torch.mean(f ** 2))
        assert float(rms) <= f_tol


@pytest.fixture(scope="module")
def bonded_boxes(weights_96k):
    """The bonded kernels' arguments, per template, on the benchmark's
    98k-atom water box and on bench.py's hetero30k box (a chain in water:
    a template and remainder rows), each shifted, drifted up to 0.01 nm and
    wrapped atom by atom into the box (molecules straddle its faces); with
    each box's bonded terms and lattice positions."""
    from chargeflux_tpu_torch.models import water_bonded_params

    dev = weights_96k["args"][0].device
    _f, pos, masses, box = water_box(n_side=32, cutoff=1.0)
    b96 = water_bonded_params(len(masses) // 3, box=box, device=dev)
    x96 = torch.tensor(pos, dtype=torch.float32, device=dev)
    _f, x_h, _m, _b, b_h, _s = bench_path("hetero30k", dev)
    assert b_h.plan is not None                  # remainder rows as well
    return {name: (bonded, bonded_inputs(bonded, x, seed=22), x)
            for name, bonded, x in (("98k", b96, x96),
                                    ("hetero30k", b_h, x_h))}


def test_bonded_kernels_match_plain(bonded_boxes):
    """Each template of both boxes: E within 1e-6 of the sum of the rows'
    |energy|, ct dE/dx (ct 1.5) within 1e-5 of its max, zero outside the
    template's atoms; two launches bit-equal; each wrapper counts one
    launch a call."""
    n0 = dict(ops.launch_counts())
    calls = 0
    for name, (bonded, cases, _) in bonded_boxes.items():
        assert bonded.uses_kernels
        for args in cases:
            tpl = args[6]
            label = f"{name} {tpl.count}x{tpl.stride}"
            e1, e2 = bt.bonded_fwd(*args), bt.bonded_fwd(*args)
            e_p = bt.bonded_fwd_plain(*args)
            assert torch.equal(e1, e2), label
            assert abs(float(e1) - float(e_p)) <= 1e-6 * bonded_scale(args), \
                label
            ct = torch.tensor(1.5, device=e1.device)
            g1, g2 = bt.bonded_bwd(*args, ct), bt.bonded_bwd(*args, ct)
            g_p = bt.bonded_bwd_plain(*args, ct)
            assert torch.equal(g1, g2), label
            assert _max_rel(g1, g_p) <= 1e-5, label
            outside = torch.ones(g1.shape[0], dtype=torch.bool,
                                 device=g1.device)
            outside[tpl.offset:tpl.offset + tpl.count * tpl.stride] = False
            assert not g1[outside].any(), label
            calls += 2
    counts = ops.launch_counts()
    assert counts["bonded_fwd"] == n0["bonded_fwd"] + calls
    assert counts["bonded_bwd"] == n0["bonded_bwd"] + calls


def test_bonded_kernels_poison_a_nan_position_as_plain(bonded_boxes):
    """A NaN coordinate: E NaN, and NaN on the same gradients as the plain
    chain (every atom of its molecule), the rest within 1e-5."""
    _, (args,), _ = bonded_boxes["98k"]
    x = args[0].clone()
    x[3 * 1000 + 1, 2] = float("nan")
    bad = (x, *args[1:])
    assert torch.isnan(bt.bonded_fwd(*bad))
    ct = torch.tensor(1.0, device=x.device)
    g_k, g_p = bt.bonded_bwd(*bad, ct), bt.bonded_bwd_plain(*bad, ct)
    assert torch.equal(torch.isnan(g_k), torch.isnan(g_p))
    assert bool(torch.isnan(g_k[3000:3003]).all())
    assert int(torch.isnan(g_k).any(dim=1).sum()) == 3
    ok = ~torch.isnan(g_p)
    assert _max_rel(g_k[ok], g_p[ok]) <= 1e-5


def test_bonded_kernels_replay_in_a_cuda_graph(bonded_boxes):
    """Both wrappers captured into one CUDA graph replay the eager calls'
    bits; new positions copied into the captured input give their own."""
    bonded, (args,), x0 = bonded_boxes["98k"]
    other = bonded_inputs(bonded, x0, seed=23)[0][0]
    static = args[0].clone()
    ct = torch.tensor(1.0, device=static.device)
    bt.bonded_fwd(static, *args[1:])                          # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        e = bt.bonded_fwd(static, *args[1:])
        g = bt.bonded_bwd(static, *args[1:], ct)
    for x in (args[0], other, args[0]):
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(e, bt.bonded_fwd(x, *args[1:]))
        assert torch.equal(g, bt.bonded_bwd(x, *args[1:], ct))


def test_an_evaluation_launches_the_bonded_kernels_once_each_way(
        bonded_boxes):
    """bonded_energy and its gradient on the kernel route: one forward and
    one backward bonded launch per template, and no other counted kernel
    (the water box has one template; hetero30k's chain rows take the
    gather); the f32 terms on the card record "cuda", their f64 cast and
    their plain copy "plain" and launch none.  Against the plain copy:
    |dE| <= 1e-6 of the rows' summed |energy|, dE/dx <= 1e-5 of its
    max."""
    for name, (bonded, cases, _) in bonded_boxes.items():
        x = cases[0][0]
        out = {}
        for route in ("cuda", "plain"):
            b = bonded.with_kernel_route(route)
            assert b.kernel_route == route
            xg = x.clone().requires_grad_(True)
            ops.reset_launch_counts()
            e = bonded_energy(xg, b)
            (g,) = torch.autograd.grad(e, xg)
            torch.cuda.synchronize()
            out[route] = (ops.launch_counts(), e.detach(), g)
        counts, e_k, g_k = out["cuda"]
        n_tpl = len(bonded.template.templates)
        assert {k: v for k, v in counts.items() if v} == {
            "bonded_fwd": n_tpl, "bonded_bwd": n_tpl}, name
        counts, e_p, g_p = out["plain"]
        assert not any(counts.values()), name
        scale = sum(bonded_scale(a) for a in cases)
        assert abs(float(e_k - e_p)) <= 1e-6 * scale, name
        assert _max_rel(g_k, g_p) <= 1e-5, name
        assert bonded.astype(torch.float64).kernel_route == "plain"


# (id, n_col, Wx, Wyp, rows, order, Gz, zorg layout, one column all q = 0)
SPREAD_EDGES = [
    ("random-zorg-gz16", 9, 6, 8, 128, 8, 16, "random", False),
    ("random-zorg-gz64", 9, 6, 24, 256, 8, 64, "random", False),
    ("zorg-57-63", 4, 20, 24, 704, 8, 64, "wrap", False),
    ("sentinel-column", 4, 20, 24, 704, 8, 64, "cells", True),
    ("rows-100", 4, 20, 24, 100, 8, 64, "cells", False),
    ("rows-77-order4", 4, 7, 8, 77, 4, 32, "random", False),
    ("wyp8-order4", 4, 20, 8, 704, 4, 64, "cells", False),
    ("wyp24-order4", 4, 9, 24, 352, 4, 64, "cells", False),
    ("order16", 4, 20, 24, 128, 16, 64, "cells", False),
    ("limits-wx36-wyp32-order5", 4, 36, 32, 130, 5, 32, "random", False),
]


def _edge_inputs(case):
    """Seeded NumPy inputs of one SPREAD_EDGES case on the card: (qwlxt,
    wlyt, wzt, zorg, offsets, pad).  "cells" lays the rows out
    z-cell-major like the main path (88 slots a cell, a third of them
    sentinel: q = 0, zorg 57, and w_y zero outside column 0, as a sentinel
    at the origin has support only in the cy = 0 columns), each row's x
    weights on ``order`` consecutive x, so each block's x rows see their
    own subset of the rows."""
    name, n_col, wx, wyp, rows, order, gz, layout, empty = case
    rng = np.random.default_rng(sum(map(ord, name)))
    qwlxt = rng.standard_normal((n_col, wx, rows))
    wlyt = rng.random((n_col, wyp, rows))
    wlyt[:, wyp - 2:] = 0.0                      # zero Wy pad rows
    wzt = rng.random((n_col, order, rows))
    if layout == "random":
        zorg = rng.integers(0, gz, (n_col, 1, rows))
    elif layout == "wrap":
        zorg = rng.integers(57, 64, (n_col, 1, rows))
    else:
        cz = np.arange(rows) // 88
        zorg = (8 * cz - 7 + rng.integers(0, 10, (n_col, 1, rows))) % gz
        sentinel = rng.random((n_col, 1, rows)) < 1 / 3
        sx = rng.integers(0, wx - order + 1, (n_col, 1, rows))
        xs = np.arange(wx)[None, :, None]
        qwlxt = np.where(sentinel | (xs < sx) | (xs >= sx + order), 0.0,
                         qwlxt)
        zorg = np.where(sentinel, 57 % gz, zorg)
        wlyt[1:] = np.where(sentinel[1:], 0.0, wlyt[1:])
    if empty:
        qwlxt[1] = 0.0
        zorg[1] = 57
    ncy = 2 if n_col == 4 else 3
    offsets = (tuple(8 * (c // ncy) for c in range(n_col)),
               tuple(8 * (c % ncy) for c in range(n_col)))
    pad = (8 * (n_col // ncy - 1) + wx, 8 * (ncy - 1) + wyp, gz)
    dev = torch.device("cuda", 0)
    args = [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (qwlxt, wlyt, wzt)]
    return (*args, torch.tensor(zorg, dtype=torch.int32, device=dev), offsets,
            pad)


@pytest.mark.parametrize("case", SPREAD_EDGES,
                         ids=[c[0] for c in SPREAD_EDGES])
def test_spread_fwd_kernel_edge_cases(case):
    """The forward kernel's z windows at their edges, against the plain
    version within 1e-6 of max (phase 3's tolerance) and two launches
    bitwise equal: zorg uniform in [0, Gz) (wide windows that wrap, several
    window tiles, Gz 16 below the 32-column tile), every zorg in 57-63
    (every window wraps), a column whose rows are all sentinel slots
    (q = 0), rows not a multiple of the 64-row segment (100; 77 and 130,
    which also take the single-word copies), Wyp 8, 24 and 32, order 4, 5,
    8 and 16, Wx up to its limit 36 (:func:`_edge_inputs`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = _edge_inputs(case)
    k1, k2 = ps.spread_fwd(*args), ps.spread_fwd(*args)
    plain = ps.spread_fwd_plain(*args)
    assert k1.shape == plain.shape == args[5]
    assert torch.equal(k1, k2)
    assert _max_rel(k1, plain) <= 1e-6


@pytest.mark.parametrize("case", SPREAD_EDGES,
                         ids=[c[0] for c in SPREAD_EDGES])
def test_spread_bwd_kernel_edge_cases(case):
    """The backward kernel on the forward's edge cases (dense random w_y
    in the "random" layouts: no support to exploit; windows wider than a
    32-column tile; a column of sentinel rows; rows whose q w_x and w_y
    are all zero, which the kernel skips) for a seeded mesh cotangent:
    each output within 2e-5 of its max of the plain version (phase 3's
    tolerance), two launches bitwise equal, and every output element
    written: a direct ``cf_spread_bwd`` call into outputs filled with NaN
    gives the wrapper's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    qw, wy, wz, zo, offsets, pad = _edge_inputs(case)
    rng = np.random.default_rng(len(case[0]))
    ct = torch.tensor(rng.standard_normal(pad), dtype=torch.float32,
                      device=qw.device)
    k1 = ps.spread_bwd(qw, wy, wz, zo, offsets, ct)
    k2 = ps.spread_bwd(qw, wy, wz, zo, offsets, ct)
    plain = ps.spread_bwd_plain(qw, wy, wz, zo, offsets, ct)
    outs = [torch.full_like(t, float("nan")) for t in (qw, wy, wz)]
    n_col, wx, rows = qw.shape
    err = native.library().cf_spread_bwd(
        *(t.data_ptr() for t in (qw, wy, wz, zo,
                                 constant(offsets, torch.int32, qw.device), ct,
                                 *outs)),
        n_col, wx, wy.shape[1], wz.shape[1], rows, pad[1], pad[2],
        native.stream_ptr(qw))
    native.check(err, "cf_spread_bwd")
    torch.cuda.synchronize()
    for u, v, w, o in zip(k1, k2, plain, outs):
        assert u.shape == w.shape
        assert torch.equal(u, v) and torch.equal(u, o)
        assert _max_rel(u, w) <= 2e-5


def test_spread_fwd_refuses_gz_below_8():
    """A window tile's columns must be distinct mesh points: the forward
    kernel refuses Gz < 8 (its 8-column warp tiles) before launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    args = [torch.ones((1, w, 8), device=dev) for w in (4, 8, 4)]
    args += [torch.zeros((1, 1, 8), dtype=torch.int32, device=dev),
             ((0,), (0,)), (4, 8, 4)]
    with pytest.raises(ValueError, match="Gz >= 8"):
        ps.spread_fwd(*args)


def test_spread_wx_past_the_backward_limit():
    """Wx 40: the forward kernel, which has no Wx limit, launches and
    matches its plain version; the backward kernel's tile holds every x,
    so it refuses Wx > 36 before launching, as the wrapper says."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    case = ("wx-40", 4, 40, 24, 128, 8, 64, "random", False)
    args = _edge_inputs(case)
    out = ps.spread_fwd(*args)
    assert _max_rel(out, ps.spread_fwd_plain(*args)) <= 1e-6
    ct = torch.ones(args[5], device=out.device)
    with pytest.raises(ValueError, match="Wx <= 36"):
        ps.spread_bwd(*args[:5], ct)


def test_direct_walk_kernel_matches_plain_and_repeats_bitwise(setup):
    s = setup
    b, system = s["blocks"], s["system"]
    args = (*b, s["ids"], system.box, system.n_atoms, system.spec.alpha,
            system.spec.cutoff)
    k1, k2, p = dw.direct_walk(*args), dw.direct_walk(*args), \
        dw.direct_walk_plain(*args)
    for u, v in zip(k1, k2):
        assert torch.equal(u, v)
    assert abs(float(k1[0] - p[0])) <= 1e-5 * abs(float(p[0]))
    assert _max_rel(k1[1], p[1]) <= 1e-4 and _max_rel(k1[2], p[2]) <= 1e-4


# (id, grid, capacity, atoms per cell (cycled over the cells), cell edge,
#  lattice sites per side, scattered slots, (shift, drift)); cutoff 0.65
WALK_EDGES = [
    ("grid-3-3-3", (3, 3, 3), 40, [27, 30, 22], 0.7, None, False, None),
    ("grid-3-4-5", (3, 4, 5), 40, [27, 30, 22, 35], 0.7, None, False, None),
    ("cap-8", (4, 3, 3), 8, [5, 8, 3], 0.7, None, False, None),
    ("cap-33", (3, 3, 3), 33, [33, 20, 27], 0.7, None, False, None),
    ("cap-88", (4, 4, 4), 88, [62, 70, 55], 0.7, None, False, None),
    ("cap-160", (3, 3, 3), 160, [125, 160, 40], 0.7, 6, False, None),
    ("cap-1024", (3, 3, 3), 1024, [600, 729, 500], 0.7, 9, False, None),
    ("empty-cell", (3, 3, 4), 40, [27, 0, 30, 0, 0], 0.7, None, False, None),
    ("no-sentinel", (3, 3, 3), 27, [27], 0.7, None, False, None),
    ("scattered-sentinels", (3, 3, 4), 64, [27, 9, 64, 1, 40], 0.7, None,
     True, None),
    ("dense-lists-overflow", (3, 3, 3), 88, [88], 0.66, 5, False, None),
    ("drifted", (4, 3, 3), 88, [62, 70, 55, 1], 0.7, None, True,
     ((0.08, -0.06, 0.05), 0.01)),
]


@pytest.mark.parametrize("case", WALK_EDGES, ids=[c[0] for c in WALK_EDGES])
def test_direct_walk_kernel_edge_cases(case):
    """The walk kernel where its bookkeeping has edges, on hand-made
    blocks (``torch_helpers.lattice_blocks``): 3 cells per axis and a
    non-cubic grid; capacities of a quarter warp, a warp and one slot, the
    main path's 88, 160 (the large instantiation with several thread
    groups) and 1024 (one thread group, lists of 32 that fill dozens of
    times); cells with no atom, with no
    sentinel, with sentinels scattered among the real slots; a dense box
    at a cell edge just over the cutoff, whose lists of 64 overflow; atoms
    moved out of their cells' nominal bounds (all by one vector, each by
    a little more).  Energy within 1e-5 and
    dE/dx, dE/dq within 1e-4 of their max of the plain version; the
    wrapper twice and a direct ``cf_direct_walk`` call into outputs filled
    with NaN give the same bits, so every slot is written; sentinel slots
    hold exactly 0; the 16-coefficient instantiation agrees on the
    polynomial padded with zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _, grid, cap, counts, edge, per_side, scattered, moved = case
    shift, drift = moved or ((0.0, 0.0, 0.0), 0.0)
    dev = torch.device("cuda", 0)
    *cols, ids, box, n_atoms = lattice_blocks(
        grid, cap, counts, edge, seed=sum(map(ord, case[0])),
        dtype=torch.float32, device=dev, scattered=scattered, drift=drift,
        shift=shift, per_side=per_side)
    alpha, cutoff = 3.4, 0.65
    args = (*cols, ids, box, n_atoms, alpha, cutoff)
    k1, k2 = dw.direct_walk(*args), dw.direct_walk(*args)
    p = dw.direct_walk_plain(*args)
    n_cells = grid[0] * grid[1] * grid[2]
    nbr, img = dw._tables(tuple(grid), dev)
    coef = constant(erf_over_r_coeffs(alpha, cutoff), torch.float32, dev)
    e_part = torch.full((n_cells,), float("nan"), device=dev)
    g = torch.full((3, *ids.shape), float("nan"), device=dev)
    dq = torch.full(ids.shape, float("nan"), device=dev)
    err = native.library().cf_direct_walk(
        *(t.data_ptr() for t in (*cols, ids, nbr, img, box, coef)),
        coef.numel(), 2.0 / (cutoff * cutoff), cutoff * cutoff, n_atoms,
        n_cells, cap, 0, e_part.data_ptr(), g.data_ptr(), dq.data_ptr(),
        native.stream_ptr(ids))
    native.check(err, "cf_direct_walk")
    torch.cuda.synchronize()
    for u, v, w in zip(k1, k2, (torch.sum(e_part), g, dq)):
        assert torch.equal(u, v) and torch.equal(u, w)
    assert abs(float(k1[0] - p[0])) <= 1e-5 * abs(float(p[0]))
    assert _max_rel(k1[1], p[1]) <= 1e-4 and _max_rel(k1[2], p[2]) <= 1e-4
    sentinel = ids >= n_atoms
    assert not k1[1][:, sentinel].any() and not k1[2][sentinel].any()
    # the same polynomial zero-padded to 16 coefficients takes the
    # kernel's 16-coefficient instantiation: the same result to roundoff
    coef16 = torch.cat([coef, coef.new_zeros(16 - coef.numel())])
    err = native.library().cf_direct_walk(
        *(t.data_ptr() for t in (*cols, ids, nbr, img, box, coef16)), 16,
        2.0 / (cutoff * cutoff), cutoff * cutoff, n_atoms, n_cells, cap, 0,
        e_part.data_ptr(), g.data_ptr(), dq.data_ptr(),
        native.stream_ptr(ids))
    native.check(err, "cf_direct_walk")
    torch.cuda.synchronize()
    assert abs(float(torch.sum(e_part) - k1[0])) <= 1e-6 * abs(float(k1[0]))
    assert _max_rel(g, k1[1]) <= 1e-6 and _max_rel(dq, k1[2]) <= 1e-6


def test_wrappers_refuse_what_the_kernels_do_not_take(setup):
    s = setup
    b, system = s["blocks"], s["system"]
    args = [*b, s["ids"], system.box, system.n_atoms, system.spec.alpha,
            system.spec.cutoff]
    with pytest.raises(TypeError):
        dw.direct_walk(*[a.double() if i < 6 else a
                         for i, a in enumerate(args)])
    with pytest.raises(ValueError, match="contiguous"):
        dw.direct_walk(b.x.transpose(0, 1), *args[1:])
    sp = list(pme.column_spread_inputs(b, s["ids"], system))
    sp[0] = sp[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ps.spread_fwd(*sp)


def test_energy_and_forces_kernel_path_matches_plain(setup):
    s = setup
    e_k, f_k = energy_and_forces(s["x"], s["system"])
    e_p, f_p = energy_and_forces(s["x"],
                                 s["system"].with_kernel_route("plain"))
    assert torch.isfinite(f_k).all()
    rms = torch.sqrt(torch.mean((f_k - f_p) ** 2) / torch.mean(f_p ** 2))
    assert float(rms) <= 1e-4
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in energy_components(
            s["x"], s["system"].with_kernel_route("plain")).values())
    assert abs(float(e_k - e_p)) <= 1e-5 * scale


def test_the_plain_copy_launches_no_kernel():
    """bench.py's 30k system in f32 and its copy from
    ``with_kernel_route("plain")``, each through ``make_nb_energy_fn``: the
    system's ``init_nb`` launches the binning kernel alone and its
    evaluation the walk, weights, spread, exclusion and bonded kernels; the
    copy's ``init_nb`` and evaluation launch no kernel, the binning
    included; energy and forces within phase 4's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from chargeflux_tpu_torch.integrate import make_nb_energy_fn

    _f, x, _m, _b, bonded, system = bench_path("30k", torch.device("cuda", 0))
    out = {}
    for plain in (False, True):
        e_fn, init_nb = make_nb_energy_fn(_on_route(system, plain),
                                          bonded=bonded)
        ops.reset_launch_counts()
        nb = init_nb(x)
        binned = ops.launch_counts()
        e, f, _ = e_fn(x, nb)
        torch.cuda.synchronize()
        out[plain] = (binned, ops.launch_counts(), e, f)
    binned, counts, e_k, f_k = out[False]
    assert binned["cell_bin"] == 1 and sum(binned.values()) == 1
    assert all(counts[k] >= 1 for k in (
        "direct_walk", "patch_weights_fwd", "patch_weights_bwd",
        "spread_fwd", "spread_bwd", "exclusion_fwd", "exclusion_bwd",
        "bonded_fwd", "bonded_bwd"))
    binned, counts, e_p, f_p = out[True]
    assert not any(counts.values())
    rms = torch.sqrt(torch.mean((f_k - f_p) ** 2) / torch.mean(f_p ** 2))
    assert float(rms) <= 1e-4
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in energy_components(
            x, system.with_kernel_route("plain")).values())
    assert abs(float(e_k - e_p)) <= 1e-5 * scale


@pytest.fixture(scope="module", params=[(6, 0.9), (11, 0.8)],
                ids=["216", "4k"])
def sf_inputs(request):
    """Structure-factor tables at the 216-water path's shapes (Kx 7, Ky 13,
    2Kz 26, N 648) and at a 4k box's (13, 25, 50, 3993), from the real
    positions and flux charges, with seeded cotangents."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    n_side, cutoff = request.param
    force, pos, _, box = water_box(n_side=n_side, cutoff=cutoff)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="dense", device=dev)
    x = torch.tensor(pos, dtype=torch.float32, device=dev)
    with torch.no_grad():
        tabs = ewald.kernel_inputs(x, effective_charges(x, system),
                                   system.box, system.spec.kmax)
    g = torch.Generator(dev).manual_seed(n_side)
    rows, kz2 = tabs[0].shape[0] * tabs[2].shape[0], tabs[4].shape[1]
    bars = [torch.randn((rows, kz2), device=dev, generator=g)
            for _ in range(2)]
    return tabs, bars


def test_structure_factor_kernels_match_plain_and_repeat_bitwise(sf_inputs):
    """Forward within 1e-5 of max, each backward output within 2e-5 of its
    max (tests/test_pallas_recip.py's tolerances); two launches equal."""
    tabs, (abar, bbar) = sf_inputs
    n0 = dict(ops.launch_counts())
    cases = [(lambda: sf.sf_fwd(*tabs), sf.sf_fwd_plain(*tabs), 1e-5),
             (lambda: sf.sf_bwd_tables(*tabs, abar, bbar),
              sf.sf_bwd_tables_plain(*tabs, abar, bbar), 2e-5),
             (lambda: (sf.sf_bwd_zq(*tabs[:4], abar, bbar),),
              (sf.sf_bwd_zq_plain(*tabs[:4], abar, bbar),), 2e-5)]
    for kern, plain, tol in cases:
        k1, k2 = kern(), kern()
        for u, v, w in zip(k1, k2, plain):
            assert torch.equal(u, v)
            assert _max_rel(u, w) <= tol
    counts = ops.launch_counts()
    for name in ("sf_fwd", "sf_bwd_tables", "sf_bwd_zq"):
        assert counts[name] == n0[name] + 2


@pytest.mark.parametrize(
    "kx, ky, kz2, n",
    [(3, 5, 2, 5), (7, 13, 26, 647), (1, 3, 6, 40), (4, 1, 10, 33),
     (5, 64, 128, 100), (2, 3, 5, 17)],
    ids=["n5-2kz2", "n647-2kz26", "kx1", "ky1", "ky64-2kz128", "2kz5"])
def test_structure_factor_backward_kernels_at_tile_edges(kx, ky, kz2, n):
    """The two backward kernels against their plain versions where their
    tiles have ragged edges (N not a multiple of the 16-atom tile, 2Kz of
    the 4 columns a slab row is padded to, Ky of the tables kernel's
    2-row groups), at Kx 1 and Ky 1, at the Ky / 2Kz limits (shared memory
    above 48 KB), and at an odd 2Kz (the slabs copy in single floats, not
    pairs): each output within 2e-5 of its max, two launches equal.
    Seeded random tables in [-1, 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(1000 * kx + n)

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=g) * 2.0 - 1.0

    tabs = (rand(kx, n), rand(kx, n), rand(ky, n), rand(ky, n),
            rand(n, kz2))
    abar, bbar = rand(kx * ky, kz2), rand(kx * ky, kz2)
    cases = [(lambda: sf.sf_bwd_tables(*tabs, abar, bbar),
              sf.sf_bwd_tables_plain(*tabs, abar, bbar)),
             (lambda: (sf.sf_bwd_zq(*tabs[:4], abar, bbar),),
              (sf.sf_bwd_zq_plain(*tabs[:4], abar, bbar),))]
    for kern, plain in cases:
        k1, k2 = kern(), kern()
        for u, v, w in zip(k1, k2, plain):
            assert u.shape == w.shape
            assert torch.equal(u, v)
            assert _max_rel(u, w) <= 2e-5


def _sf_edge_tables(kx, ky, kz2, n, dev, offset=0):
    """Seeded random tables in [-1, 1); with ``offset`` each is a view
    ``offset`` floats into its allocation (contiguous, but its pointer only
    4-byte aligned)."""
    g = torch.Generator(dev).manual_seed(1000 * kx + 7 * ky + n)

    def rand(rows, cols):
        flat = torch.rand(rows * cols + offset, device=dev, generator=g)
        return (flat * 2.0 - 1.0)[offset:].view(rows, cols)

    return (rand(kx, n), rand(kx, n), rand(ky, n), rand(ky, n),
            rand(n, kz2))


# (id, Kx, Ky, 2Kz, N, pointer offset); Kx 140 and Kx 70 put 140 and 70
# tiles against the plan's target of 132 blocks: one split and two
SF_FWD_EDGES = [
    ("kx1", 1, 13, 26, 100, 0),
    ("ky1", 4, 1, 10, 33, 0),
    ("limits-ky63-2kz126", 3, 63, 126, 200, 0),
    ("limits-ky64-2kz128", 2, 64, 128, 70, 0),
    ("2kz2", 3, 5, 2, 50, 0),
    ("n1", 3, 5, 6, 1, 0),
    ("n5", 7, 13, 26, 5, 0),
    ("chunk-minus-1", 140, 13, 26, 127, 0),
    ("chunk-plus-1", 140, 13, 26, 129, 0),
    ("split-minus-1", 7, 13, 26, 2431, 0),
    ("split-exact", 7, 13, 26, 2432, 0),
    ("split-plus-1", 7, 13, 26, 2433, 0),
    ("one-split-6-chunks", 140, 13, 26, 648, 0),
    ("one-split-by-tiles", 70, 63, 126, 70, 0),
    ("two-splits", 70, 13, 26, 648, 0),
    ("tall-narrow-tile", 20, 63, 6, 900, 0),
    ("n-even-pairs", 3, 5, 6, 34, 0),
    ("2kz-odd", 2, 3, 5, 17, 0),
    ("misaligned-n648", 7, 13, 26, 648, 1),
    ("misaligned-by-8", 7, 13, 26, 648, 2),
]


@pytest.mark.parametrize("case", SF_FWD_EDGES, ids=[c[0] for c in SF_FWD_EDGES])
def test_structure_factor_forward_kernel_edge_cases(case):
    """The forward kernel against its plain version at the edges of its
    launch plan: Kx 1, Ky 1, the Ky / 2Kz limits (ky rows in groups), 2Kz 2,
    one atom, fewer atoms than splits could take, one atom under and over
    a chunk and a split boundary (2432 = 8 splits of 304), plans of one
    split (a long chunk loop; enough tiles), of two and of eight, the
    tallest tile a block takes (32 ky rows), copies of 16, 8 and 4 bytes (N a multiple of 4, of 2, odd; odd 2Kz; table
    pointers off 16-byte alignment).  A and B within 1e-5 of max |plain|;
    three launches in a row give equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    name, kx, ky, kz2, n, offset = case
    dev = torch.device("cuda", 0)
    tabs = _sf_edge_tables(kx, ky, kz2, n, dev, offset)
    assert all(t.is_contiguous() for t in tabs)
    if offset:
        assert all(t.data_ptr() % 16 != 0 for t in tabs)
    plan = sf.plan_forward(kx, ky, kz2, n, sf.forward_limits())
    if name.startswith(("one-split", "chunk-")):
        assert plan.n_splits == 1
    if name.startswith("split-"):
        assert plan.n_splits == 8 and plan.split_len in (304, 308)
    if name == "two-splits":
        assert plan.n_splits == 2
    n0 = ops.launch_counts()["sf_fwd"]
    k1, k2, k3 = (sf.sf_fwd(*tabs) for _ in range(3))
    torch.cuda.synchronize()
    assert ops.launch_counts()["sf_fwd"] == n0 + 3
    for u, v, w, want in zip(k1, k2, k3, sf.sf_fwd_plain(*tabs)):
        assert u.shape == want.shape
        assert torch.equal(u, v) and torch.equal(u, w)
        assert _max_rel(u, want) <= 1e-5


def test_kernel_limits_table_matches_the_built_library():
    """The limits the CPU tests plan and gate with (the sum order they
    replay is the built kernel's only while these agree) are the ones the
    CUDA sources compile in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for name, want in KERNEL_LIMITS.items():
        assert native.limits(name, len(want)) == want


def test_structure_factor_forward_replays_in_a_cuda_graph(sf_inputs):
    """The wrapper captured into a CUDA graph and replayed three times
    gives the eager call's bits each time (the launch keeps no state and
    needs no scratch; the outputs are cleared between replays)."""
    tabs, _ = sf_inputs
    eager = sf.sf_fwd(*tabs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sf.sf_fwd(*tabs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sf.sf_fwd(*tabs)
    for _ in range(3):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for u, v in zip(out, eager):
            assert torch.equal(u, v)
    again = sf.sf_fwd(*tabs)
    for u, v in zip(again, eager):
        assert torch.equal(u, v)


def test_structure_factor_wrappers_refuse_what_the_kernels_do_not_take(
        sf_inputs):
    tabs, _ = sf_inputs
    with pytest.raises(TypeError):
        sf.sf_fwd(*(t.double() for t in tabs))
    with pytest.raises(ValueError, match="contiguous"):
        sf.sf_fwd(tabs[0].T.contiguous().T, *tabs[1:])
    with pytest.raises(ValueError, match="zq"):
        sf.sf_fwd(*tabs[:4], tabs[4][:-1])


SF_BATCHES = [("r3-216", 3, 7, 13, 26, 648), ("r4-odd", 4, 3, 5, 5, 17),
              ("r2-4k", 2, 13, 25, 50, 3993), ("r5-n33", 5, 4, 9, 10, 33),
              ("r64-216", 64, 7, 13, 26, 648)]


@pytest.mark.parametrize("case", SF_BATCHES, ids=[c[0] for c in SF_BATCHES])
def test_batched_structure_factor_kernels(case):
    """The three kernels over a replica batch ([R, ...] tables, one launch
    each): within phase 3b's tolerances of their batched plain versions,
    and each replica's slice equal to the single-system launch on it, bit
    for bit (odd N and 2Kz give replica strides off 16-byte alignment)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _name, r, kx, ky, kz2, n = case
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(97 * r + n)

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=g) * 2.0 - 1.0

    tabs = (rand(r, kx, n), rand(r, kx, n), rand(r, ky, n), rand(r, ky, n),
            rand(r, n, kz2))
    abar, bbar = rand(r, kx * ky, kz2), rand(r, kx * ky, kz2)
    n0 = dict(ops.launch_counts())
    batched = [sf.sf_fwd(*tabs), sf.sf_bwd_tables(*tabs, abar, bbar),
               (sf.sf_bwd_zq(*tabs[:4], abar, bbar),)]
    counts = ops.launch_counts()
    for name in ("sf_fwd", "sf_bwd_tables", "sf_bwd_zq"):
        assert counts[name] == n0[name] + 1
    plain = [sf.sf_fwd_plain(*tabs), sf.sf_bwd_tables_plain(*tabs, abar, bbar),
             (sf.sf_bwd_zq_plain(*tabs[:4], abar, bbar),)]
    for bt, pt, tol in zip(batched, plain, (1e-5, 2e-5, 2e-5)):
        for u, w in zip(bt, pt):
            assert u.shape == w.shape
            assert _max_rel(u, w) <= tol
    for i in range(r):
        one = [t[i] for t in tabs]
        single = [sf.sf_fwd(*one), sf.sf_bwd_tables(*one, abar[i], bbar[i]),
                  (sf.sf_bwd_zq(*one[:4], abar[i], bbar[i]),)]
        for bt, st in zip(batched, single):
            for u, v in zip(bt, st):
                assert torch.equal(u[i], v)


def test_batched_structure_factor_wrappers_refuse_mixed_batches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    tabs = [torch.zeros(s, device=dev) for s in
            ((2, 3, 8), (2, 3, 8), (2, 5, 8), (2, 5, 8), (2, 8, 6))]
    with pytest.raises(ValueError, match="replica axis"):
        sf.sf_fwd(tabs[0], tabs[1][0], *tabs[2:])
    with pytest.raises(ValueError, match="zq"):
        sf.sf_fwd(*tabs[:4], tabs[4][0])


def test_dense_path_kernel_route_matches_plain():
    """The bench.py 216 system ("auto" resolves to the structure-factor
    kernel): kernel path against the plain path, |dE| <= 1e-5 sum |E_c|,
    force RMS rel <= 1e-4; one launch of each kernel per evaluation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _, x, _, _, _, system = dense_path(torch.device("cuda", 0))
    ops.reset_launch_counts()
    e_k, f_k = energy_and_forces(x, system)
    counts = ops.launch_counts()
    assert all(counts[k] == 1 for k in ("sf_fwd", "sf_bwd_tables",
                                        "sf_bwd_zq"))
    e_p, f_p = energy_and_forces(x, system.with_kernel_route("plain"))
    assert torch.isfinite(f_k).all()
    rms = torch.sqrt(torch.mean((f_k - f_p) ** 2) / torch.mean(f_p ** 2))
    assert float(rms) <= 1e-4
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in energy_components(
            x, system.with_kernel_route("plain")).values())
    assert abs(float(e_k - e_p)) <= 1e-5 * scale


def test_f64_on_the_card_takes_the_plain_versions(setup):
    """An f64 cell + SPME system on the card records the plain route when
    it is built (the f32 one the kernels'), so the walk and the spread run
    their plain versions (no kernel launches), and energy_and_forces
    equals its plain copy within 1e-12 relative."""
    s = setup
    sys64 = s["system"].astype(torch.float64)
    assert s["system"].kernel_route == "cuda"
    assert sys64.kernel_route == "plain"
    x = s["x"].double()
    ops.reset_launch_counts()
    e, f = energy_and_forces(x, sys64)
    assert not any(ops.launch_counts().values())
    e_p, f_p = energy_and_forces(x, sys64.with_kernel_route("plain"))
    assert torch.isfinite(f).all() and bool(torch.isfinite(e))
    assert abs(float(e - e_p)) <= 1e-12 * abs(float(e_p))
    assert float((f - f_p).abs().max()) <= 1e-12 * float(f_p.abs().max())


def test_remainder_nve_runs_repeat_bitwise(setup):
    """A water box whose flux, exclusion and bonded terms all take the
    remainder path (no templates): two 20-step NVE runs on the card give
    the same bits, and the kernels ran in them.  The box starts from the
    unrelaxed lattice, so its atoms outrun the PME slack within 8 steps:
    the neighbor state is rebuilt every 4."""
    import dataclasses

    from chargeflux_tpu_torch.integrate import (init_state_nb,
                                                make_nb_energy_fn,
                                                nve_trajectory_nb)
    from chargeflux_tpu_torch.models import water_bonded_params
    from chargeflux_tpu_torch.utils.measure import DT_PS

    s = setup
    system = untemplated(s["system"])
    x = s["x"]
    n_w = x.shape[0] // 3
    bonded = dataclasses.replace(
        water_bonded_params(n_w, box=system.box.cpu().numpy(),
                            device=x.device), template=None)
    assert system.flux_plan is not None and system.excl_plan is not None
    assert bonded.plan is not None
    masses = torch.tensor([15.999, 1.008, 1.008] * n_w, device=x.device)
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)
        s0 = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
        final, es = nve_trajectory_nb(s0, e_fn, init_nb, masses, DT_PS, 20,
                                      rebuild_every=4)
        torch.cuda.synchronize()
        assert all(ops.launch_counts()[k] > 0
                   for k in ("spread_fwd", "spread_bwd", "direct_walk"))
        runs.append((final.positions, final.velocities, final.forces, es))
    assert torch.isfinite(runs[0][3]).all()
    for u, v in zip(*runs):
        assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# trajectory chunks as CUDA graphs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def md_paths(setup):
    """Per path, (system, bonded, start state, masses, rebuild_every): the
    small cell + SPME box of ``setup`` from its unrelaxed lattice at rest
    (its atoms outrun the PME slack within 8 steps, so it is rebuilt every
    4), and the 216 dense + classical-Ewald path from its lattice at rest,
    10-step chunks."""
    from chargeflux_tpu_torch.integrate import init_state_nb, make_nb_energy_fn
    from chargeflux_tpu_torch.models import water_bonded_params

    s = setup
    x = s["x"]
    n_w = x.shape[0] // 3
    bonded = water_bonded_params(n_w, box=s["system"].box.cpu().numpy(),
                                 device=x.device)
    masses = torch.tensor([15.999, 1.008, 1.008] * n_w, device=x.device)
    _, x_d, m_d, _, bonded_d, sys_d = dense_path(x.device)
    out = {}
    for name, system, b, xx, m, every in (
            ("cell", s["system"], bonded, x, masses, 4),
            ("dense", sys_d, bonded_d, x_d, m_d, 10)):
        s0 = init_state_nb(xx, torch.zeros_like(xx),
                           *make_nb_energy_fn(system, bonded=b))
        out[name] = (system, b, s0, m, every)
    return out


def _trajectory(path, n_steps, graph, e_fns=None, state=None, every=None):
    from chargeflux_tpu_torch.integrate import (make_nb_energy_fn,
                                                nve_trajectory_nb)
    from chargeflux_tpu_torch.utils.measure import DT_PS

    system, bonded, s0, masses, rebuild_every = path
    e_fn, init_nb = e_fns or make_nb_energy_fn(system, bonded=bonded)
    return nve_trajectory_nb(state or s0, e_fn, init_nb, masses, DT_PS,
                             n_steps, every or rebuild_every, graph=graph)


def _same_bits(a, b):
    (fa, ea), (fb, eb) = a, b
    torch.cuda.synchronize()
    assert torch.equal(ea, eb)
    for f in ("positions", "velocities", "forces", "potential"):
        assert torch.equal(getattr(fa, f), getattr(fb, f)), f


#: (path, driver) of the chunk tests: nve_trajectory_nb on both paths, and
#: nve_trajectory, whose steps on the cell route each bin anew.
DRIVERS = pytest.mark.parametrize(
    "name,driver", [("cell", "nb"), ("dense", "nb"), ("cell", "plain"),
                    ("dense", "plain")],
    ids=["cell", "dense", "cell-nve_trajectory", "dense-nve_trajectory"])


def _energy_fns(path, driver):
    from chargeflux_tpu_torch.integrate import (make_energy_fn,
                                                make_nb_energy_fn)

    make = make_nb_energy_fn if driver == "nb" else make_energy_fn
    return make(path[0], bonded=path[1])


def _drive(path, driver, n_steps, graph, fns):
    """``n_steps`` from the path's start state through nve_trajectory_nb
    (``fns`` = (e_fn, init_nb)) or nve_trajectory (``fns`` = energy_fn)."""
    from chargeflux_tpu_torch.integrate import MDState, nve_trajectory
    from chargeflux_tpu_torch.utils.measure import DT_PS

    if driver == "nb":
        return _trajectory(path, n_steps, graph, fns)
    s0, masses = path[2], path[3]
    state = MDState(s0.positions, s0.velocities, s0.forces, s0.potential)
    return nve_trajectory(state, fns, masses, DT_PS, n_steps, graph=graph)


def _chunk_length(path, driver):
    from chargeflux_tpu_torch.integrate import STEPS_PER_CHUNK

    return path[4] if driver == "nb" else STEPS_PER_CHUNK


@DRIVERS
def test_chunk_replays_give_the_eager_chunks_bits(md_paths, name, driver):
    """Two chunks and a remainder chunk: replays (the first call captures,
    the second replays only) give the per-step energies and the final
    state of graph=False bit for bit, and finite."""
    path = md_paths[name]
    every = _chunk_length(path, driver)
    n = 2 * every + every // 2 + 1
    fns = _energy_fns(path, driver)
    eager = _drive(path, driver, n, False, fns)
    first = _drive(path, driver, n, True, fns)
    again = _drive(path, driver, n, True, fns)
    assert torch.isfinite(eager[1]).all() and eager[1].shape == (n,)
    e_fn = fns[0] if driver == "nb" else fns
    assert len(e_fn.nve_chunks) == 2
    assert all(c.graph is not None for c in e_fn.nve_chunks.values())
    _same_bits(eager, first)
    _same_bits(eager, again)


@DRIVERS
def test_a_warm_eager_chunk_makes_no_host_sync(md_paths, name, driver):
    """Once warm, a whole eager trajectory of two chunks and a remainder
    runs under ``set_sync_debug_mode("error")``: no step, rebuild or final
    evaluation reads a device value on the host or copies from it."""
    path = md_paths[name]
    n = 2 * _chunk_length(path, driver) + 1
    fns = _energy_fns(path, driver)
    _drive(path, driver, n, False, fns)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, es = _drive(path, driver, n, False, fns)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(es).all()


def test_maxwell_velocities_are_made_where_the_masses_are(md_paths):
    """Masses on the card with a CPU generator raise; with a generator of
    the card, the velocities are made on the card, drift-free."""
    from chargeflux_tpu_torch.integrate import maxwell_velocities

    masses = md_paths["cell"][3]
    with pytest.raises(ValueError):
        maxwell_velocities(masses, 300.0, torch.Generator().manual_seed(1))
    gen = torch.Generator(masses.device).manual_seed(1)
    v = maxwell_velocities(masses, 300.0, gen, dtype=torch.float64)
    assert v.device == masses.device and v.shape == (masses.shape[0], 3)
    p = torch.sum(masses.double()[:, None] * v, dim=0)
    assert float(p.abs().max()) <= 1e-10


def test_poisons_reach_energy_and_forces_inside_a_replay(md_paths):
    """Inside a replay, as eagerly: a rebuild interval too long for the
    unrelaxed box (20 steps; atoms outrun the PME slack within 8) turns the
    later energies and the last forces to NaN; a capacity below the
    occupancy (binning overflow) poisons every energy from the first
    step."""
    from chargeflux_tpu_torch.models import water_box as water_box_t

    path = md_paths["cell"]
    for graph in (False, True):
        fin, es = _trajectory(path, 20, graph, every=20)
        assert torch.isfinite(es[0]) and torch.isnan(es[-1])
        assert torch.isnan(fin.forces).all()

    force, _, _, box = water_box_t(n_side=9, cutoff=0.65)
    small = force.create_system(box=box, dtype=torch.float32,
                                direct_method="cell", recip_method="pme",
                                cell_capacity=16, device=path[2].positions.device)
    tight = (small, *path[1:])
    for graph in (False, True):
        fin, es = _trajectory(tight, 6, graph)
        assert int(fin.nb.overflow) > 0
        assert torch.isnan(es).all() and torch.isnan(fin.forces).all()


def test_a_graph_is_reused_across_calls_with_the_state_changed(md_paths):
    """The burn-in's pattern: chunk-long calls with the velocities rescaled
    in between.  Replays of the one captured chunk give the bits of the
    same calls made eagerly, and no call after the first captures."""
    import dataclasses

    from chargeflux_tpu_torch.integrate import make_nb_energy_fn

    path = md_paths["cell"]
    every = path[4]
    runs = {}
    for graph in (False, True):
        e_fns = make_nb_energy_fn(path[0], bonded=path[1])
        state, out = path[2], []
        for k in range(4):
            state, es = _trajectory(path, every, graph, e_fns, state)
            out.append((state, es))
            state = dataclasses.replace(
                state, velocities=state.velocities * (1.0 + 0.05 * k))
            if graph:
                chunks = list(e_fns[0].nve_chunks.values())
                assert len(chunks) == 1
                if k == 0:
                    graph0 = chunks[0].graph
                assert chunks[0].graph is graph0
        runs[graph] = out
    for a, b in zip(runs[False], runs[True]):
        _same_bits(a, b)


@pytest.mark.parametrize("name", ["cell", "dense"])
def test_launch_counts_equal_the_profilers_kernel_counts(md_paths, name):
    """Over a trajectory whose chunks replay captured graphs (plus the
    eager final evaluation), each wrapper's count equals the number of its
    kernel's device events in one torch.profiler window, and is the
    captured launches per chunk times the replays plus the final
    evaluation's."""
    from torch.profiler import ProfilerActivity, profile

    from chargeflux_tpu_torch.integrate import make_nb_energy_fn
    from chargeflux_tpu_torch.utils.measure import traced_launches

    path = md_paths[name]
    every = path[4]
    e_fns = make_nb_energy_fn(path[0], bonded=path[1])
    _trajectory(path, 2 * every, True, e_fns)
    (chunk,) = e_fns[0].nve_chunks.values()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _trajectory(path, 2 * every, True, e_fns)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    traced = traced_launches(prof.events())
    names = [k for k, c in chunk.captured.items() if c > 0]
    assert names, "the chunk captured no kernel launch"
    for k in names:
        assert counts[k] == 2 * chunk.captured[k] + 1, k
        assert traced[k] == counts[k], (k, traced, counts)


# ---------------------------------------------------------------------------
# stochastic and constrained drivers: noise drawn inside the CUDA graphs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nvt_paths(md_paths):
    """Per driver, ``run(n_steps, graph, generator, state=None) ->
    (final_state, records)`` and its chunk length, on the small cell +
    SPME box of ``setup`` (flexible, from its lattice at rest, 0.5 fs
    steps) and on a rigid box (rigid_water_box(n_side=9, cutoff=0.6),
    fixed charges, from rest, 1 fs steps: the lattice start heats fast);
    rebuilt every 4 steps (RESPA and rigid, whose steps are longer: every
    2)."""
    from chargeflux_tpu_torch import constraints as con
    from chargeflux_tpu_torch import integrate as it
    from chargeflux_tpu_torch.models import rigid_water_box

    system, bonded, s0, masses, _ = md_paths["cell"]
    dev = s0.positions.device
    force, pos, m_r, box, params = rigid_water_box(
        n_side=9, cutoff=0.6, dtype=torch.float32, device=dev)
    rsys = force.create_system(box=box, dtype=torch.float32,
                               direct_method="cell", recip_method="pme",
                               device=dev)
    xr = torch.tensor(pos, dtype=torch.float32, device=dev)
    mr = torch.tensor(m_r, dtype=torch.float32, device=dev)
    fns = dict(nb=it.make_nb_energy_fn(system, bonded=bonded),
               plain=it.make_energy_fn(system, bonded=bonded),
               respa=it.make_respa_force_fns(system, bonded),
               rnb=it.make_nb_energy_fn(rsys),
               rplain=it.make_energy_fn(rsys))
    r0 = it.init_state_nb(xr, torch.zeros_like(xr), *fns["rnb"])
    dt, t, fr = 5e-4, 300.0, 20.0
    dt_r = 1e-3

    def plain_state(s):
        return it.MDState(s.positions, s.velocities, s.forces, s.potential)

    runs = {
        "langevin_nb": (lambda n, g, gen, s: it.langevin_trajectory_nb(
            s or s0, *fns["nb"], masses, dt, t, fr, gen, n, 4, graph=g), 4),
        "langevin": (lambda n, g, gen, s: it.langevin_trajectory(
            plain_state(s or s0), fns["plain"], masses, dt, t, fr, gen, n,
            graph=g), it.STEPS_PER_CHUNK),
        "respa_nb": (lambda n, g, gen, s: it.respa_trajectory_nb(
            s or s0, *fns["respa"], masses, 2 * dt, 2, n, 2, graph=g), 2),
        "respa_langevin_nb": (
            lambda n, g, gen, s: it.respa_langevin_trajectory_nb(
                s or s0, *fns["respa"], masses, 2 * dt, 2, t, fr, gen, n, 2,
                graph=g), 2),
        "rattle_langevin_nb": (
            lambda n, g, gen, s: con.rattle_langevin_trajectory_nb(
                s or r0, *fns["rnb"], mr, dt_r, t, fr, gen, n, params, 2,
                graph=g), 2),
        "rattle_langevin": (
            lambda n, g, gen, s: con.rattle_langevin_trajectory(
                (s or r0).positions, (s or r0).velocities, fns["rplain"], mr,
                dt_r, t, fr, gen, n, params, graph=g), it.STEPS_PER_CHUNK),
        "rattle_nve": (lambda n, g, gen, s: con.rattle_nve_trajectory(
            (s or r0).positions, (s or r0).velocities, fns["rplain"], mr,
            dt_r, n, params, graph=g), it.STEPS_PER_CHUNK),
    }
    owners = dict(langevin_nb=fns["nb"][0], langevin=fns["plain"],
                  respa_nb=fns["respa"][0], respa_langevin_nb=fns["respa"][0],
                  rattle_langevin_nb=fns["rnb"][0],
                  rattle_langevin=fns["rplain"], rattle_nve=fns["rplain"])
    return dict(runs=runs, owners=owners, params=params, device=dev)


NOISY = ["langevin_nb", "langevin", "respa_langevin_nb", "rattle_langevin_nb",
         "rattle_langevin"]
NVT_DRIVERS = pytest.mark.parametrize("driver", NOISY + ["respa_nb",
                                                         "rattle_nve"])


def _records(out):
    """(positions, velocities, records) of an integrate or a constraints
    driver's result."""
    final, rec = out
    if isinstance(final, tuple):
        return final[0], final[1], rec
    return final.positions, final.velocities, rec


@NVT_DRIVERS
def test_noise_chunk_replays_give_the_eager_chunks_bits(nvt_paths, driver):
    """Two chunks and a remainder from one generator state (re-seeded
    before each run): the replays of the first call (which captures) and
    of a second call give graph=False's positions, velocities and
    per-step records bit for bit; the noise is drawn inside the graph
    (the generator is registered with it), each chunk is one graph."""
    run, every = nvt_paths["runs"][driver]
    gen = torch.Generator(nvt_paths["device"])
    n = 2 * every + 1
    owner = nvt_paths["owners"][driver]
    before = set(owner.__dict__.get("nve_chunks", {}))
    outs = []
    for graph in (False, True, True):
        gen.manual_seed(12)
        outs.append(_records(run(n, graph, gen, None)))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0][2]).all() and outs[0][2].shape == (n,)
    new = [c for k, c in owner.nve_chunks.items() if k not in before]
    assert len(new) == 2 and all(c.graph is not None for c in new)
    for got in outs[1:]:
        for u, v in zip(outs[0], got):
            assert torch.equal(u, v)


@pytest.mark.parametrize("driver", NOISY)
def test_successive_calls_draw_new_noise_on_the_card(nvt_paths, driver):
    """Two replayed calls from the same state with the generator carried
    on draw different normals (their records differ); the generator moved
    on as far as the eager run moves it."""
    run, every = nvt_paths["runs"][driver]
    gen = torch.Generator(nvt_paths["device"]).manual_seed(3)
    a = _records(run(every, True, gen, None))[2]
    b = _records(run(every, True, gen, None))[2]
    offset = gen.get_offset()
    gen.manual_seed(3)
    run(every, False, gen, None)
    run(every, False, gen, None)
    torch.cuda.synchronize()
    assert not torch.equal(a, b)
    assert gen.get_offset() == offset


@pytest.mark.parametrize("driver", ["langevin_nb", "rattle_langevin_nb"])
def test_resume_with_the_generator_carried_on_the_card(nvt_paths, driver):
    """Replayed, one call of 4 chunks equals two calls of 2 with the
    generator carried across: bit for bit for langevin_trajectory_nb, to
    round-off for the rattle driver (it projects the initial velocities
    of each call again): positions within 1e-5 nm in f32."""
    run, every = nvt_paths["runs"][driver]
    gen = torch.Generator(nvt_paths["device"]).manual_seed(8)
    whole = run(4 * every, True, gen, None)
    gen.manual_seed(8)
    half = run(2 * every, True, gen, None)
    both = run(2 * every, True, gen, half[0])
    torch.cuda.synchronize()
    recs = torch.cat([half[1], both[1]])
    if driver == "langevin_nb":
        assert torch.equal(recs, whole[1])
        for f in ("positions", "velocities", "forces"):
            assert torch.equal(getattr(both[0], f), getattr(whole[0], f)), f
    else:
        assert torch.isfinite(recs).all()
        assert float((both[0].positions - whole[0].positions).abs().max()) \
            <= 1e-5


@NVT_DRIVERS
def test_a_warm_eager_noise_chunk_makes_no_host_sync(nvt_paths, driver):
    """Once warm, a whole eager run of two chunks and a remainder (noise,
    projections, rebuilds, the final evaluation) runs under
    ``set_sync_debug_mode("error")``."""
    run, every = nvt_paths["runs"][driver]
    gen = torch.Generator(nvt_paths["device"]).manual_seed(5)
    n = 2 * every + 1
    run(n, False, gen, None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, rec = _records(run(n, False, gen, None))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(rec).all()


def test_a_new_generator_captures_anew(nvt_paths):
    """A graph no longer belongs to the generator it captured: a call with
    another generator captures nothing new and replays the one graph from
    that generator's state, giving that generator's eager bits and moving
    it on as far as the eager run does; the first generator's graph is the
    one replayed."""
    run, every = nvt_paths["runs"]["langevin_nb"]
    owner = nvt_paths["owners"]["langevin_nb"]
    dev = nvt_paths["device"]
    g1, g2 = (torch.Generator(dev).manual_seed(s) for s in (1, 2))
    run(every, True, g1, None)
    before = {k: c.graph for k, c in owner.nve_chunks.items()}
    got = run(every, True, g2, None)[1]
    offset = g2.get_offset()
    assert {k: c.graph for k, c in owner.nve_chunks.items()} == before
    assert all(c.generator is not g2 for c in owner.nve_chunks.values())
    g2.manual_seed(2)
    want = run(every, False, g2, None)[1]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert g2.get_offset() == offset


def test_a_dropped_chunk_collected_during_a_capture_does_not_break_it(
        md_paths):
    """A chunk kept on an energy function sits in a reference cycle, so
    once dropped its graph waits for the cyclic collector.  With the
    collector made to run at almost every allocation, a capture that
    follows such a drop still succeeds (the chunk collects first and holds
    the collector off while it captures) and replays the eager bits."""
    import gc

    from chargeflux_tpu_torch.integrate import make_nb_energy_fn

    path = md_paths["dense"]
    every = path[4]
    dropped = make_nb_energy_fn(path[0], bonded=path[1])
    _trajectory(path, every + 1, True, dropped)
    assert all(c.graph is not None for c in dropped[0].nve_chunks.values())
    del dropped
    fns = make_nb_energy_fn(path[0], bonded=path[1])
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        got = _trajectory(path, every + 1, True, fns)
    finally:
        gc.set_threshold(*thresholds)
    _same_bits(_trajectory(path, every + 1, False, fns), got)


def test_fresh_generators_and_masses_replay_one_chunk_graph(md_paths):
    """Chunks are keyed by what they compute, not by the identity of the
    masses tensor or the generator: three calls of
    langevin_trajectory_nb on one energy function, each with a fresh
    generator of the same seed and a freshly built masses tensor, capture
    in the first call only (the count of kept chunks does not grow), and
    each equals graph=False from the same generator state bit for bit,
    with the caller's generator moved on as far; a fourth call with other
    masses values replays the same graphs on those masses."""
    from chargeflux_tpu_torch.integrate import (langevin_trajectory_nb,
                                                make_nb_energy_fn)

    system, bonded, s0, masses, _ = md_paths["cell"]
    dev = s0.positions.device
    e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)
    every, n = 4, 9
    kept = None
    for scale in (1.0, 1.0, 1.0, 1.05):
        outs = []
        for graph in (True, False):
            gen = torch.Generator(dev).manual_seed(21)
            m = masses.cpu().clone().to(dev) * scale
            out = langevin_trajectory_nb(s0, e_fn, init_nb, m, 5e-4, 300.0,
                                         20.0, gen, n, every, graph=graph)
            outs.append((out, gen.get_offset()))
            if graph:
                if kept is None:
                    kept = {k: c.graph for k, c in e_fn.nve_chunks.items()}
                assert len(kept) == 2
                assert {k: c.graph for k, c in
                        e_fn.nve_chunks.items()} == kept
        torch.cuda.synchronize()
        (got, off_g), (want, off_e) = outs
        assert torch.isfinite(want[1]).all()
        assert torch.equal(got[1], want[1]) and off_g == off_e
        for f in ("positions", "velocities", "forces"):
            assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f


def test_chunk_capture_reports_its_memory_and_time(md_paths):
    """A captured chunk records the device memory its capture took and
    the capture's time, for PERF.md's account of the graphs kept."""
    path = md_paths["cell"]
    from chargeflux_tpu_torch.integrate import make_nb_energy_fn

    e_fns = make_nb_energy_fn(path[0], bonded=path[1])
    _trajectory(path, path[4], True, e_fns)
    (chunk,) = e_fns[0].nve_chunks.values()
    assert chunk.capture_bytes > 0 and chunk.capture_seconds > 0.0


def test_tf32_switched_on_leaves_the_xla_route_at_ieee_f32():
    """With TF32 switched on globally (``allow_tf32`` and
    ``set_float32_matmul_precision("high")``), the "xla" classical-Ewald
    route's f32 forces on the bench.py 216 box stay within the 1e-4 RMS
    budget of the f64 plain path, their energy within 1e-5 of sum |E_c|,
    and the caller's switches read as they were set afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from chargeflux_tpu_torch.models import water_box as water_box_t

    dev = torch.device("cuda", 0)
    force, pos, _, box = water_box_t(n_side=6, flux="bond_angle", cutoff=0.9)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="dense", recip_method="xla",
                                 device=dev)
    x = torch.tensor(pos, dtype=torch.float32, device=dev)
    sys64 = system.astype(torch.float64)
    e64, f64 = energy_and_forces(x.double(),
                                 sys64.with_kernel_route("plain"))
    matmul = torch.backends.cuda.matmul
    try:
        torch.set_float32_matmul_precision("high")
        matmul.allow_tf32 = True
        e32, f32 = energy_and_forces(x, system)
        assert matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
        matmul.allow_tf32 = False
    rms = torch.sqrt(torch.mean((f32.double() - f64) ** 2)
                     / torch.mean(f64 ** 2))
    assert float(rms) <= 1e-4
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in energy_components(
            x.double(), sys64.with_kernel_route("plain")).values())
    assert abs(float(e32) - float(e64)) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# triclinic boxes: the walk kernel's triclinic instantiation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tri_setup():
    """A small water box on bench.py's sheared lattice
    (``utils.measure.shear_box``), f32 cell + SPME on the card, with its
    blocks and a start state at rest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from chargeflux_tpu_torch.integrate import init_state_nb, make_nb_energy_fn
    from chargeflux_tpu_torch.models import water_bonded_params
    from chargeflux_tpu_torch.utils.measure import shear_box

    dev = torch.device("cuda", 0)
    force, pos, masses, box = water_box(n_side=9, cutoff=0.65)
    lattice = shear_box(box)
    system = force.create_system(box=lattice, dtype=torch.float32,
                                 direct_method="cell", recip_method="pme",
                                 device=dev)
    assert system.box.shape == (3, 3)
    x = torch.tensor(pos, dtype=torch.float32, device=dev)
    with torch.no_grad():
        nb = build_neighbor_state(x, system)
        b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                           nb.inv_slot, wrap=nb.wrap)
    bonded = water_bonded_params(x.shape[0] // 3, box=lattice, device=dev)
    s0 = init_state_nb(x, torch.zeros_like(x),
                       *make_nb_energy_fn(system, bonded=bonded))
    return dict(system=system, x=x, blocks=b, ids=nb.slots.reshape(b.x.shape),
                bonded=bonded, s0=s0,
                masses=torch.tensor(masses, dtype=torch.float32, device=dev))


def test_triclinic_walk_kernel_matches_plain_and_repeats_bitwise(tri_setup):
    """On the sheared box the wrapper launches the triclinic instantiation
    (counted as ``direct_walk_tri``, not ``direct_walk``): energy within
    1e-5, dE/dx and dE/dq within 1e-4 of their max of the plain version
    (lattice-row image offsets), two launches bit-equal, sentinel slots
    exactly 0."""
    s = tri_setup
    b, system = s["blocks"], s["system"]
    args = (*b, s["ids"], system.box, system.n_atoms, system.spec.alpha,
            system.spec.cutoff)
    ops.reset_launch_counts()
    k1, k2 = dw.direct_walk(*args), dw.direct_walk(*args)
    counts = ops.launch_counts()
    assert counts["direct_walk_tri"] == 2 and counts["direct_walk"] == 0
    p = dw.direct_walk_plain(*args)
    for u, v in zip(k1, k2):
        assert torch.equal(u, v)
    assert abs(float(k1[0] - p[0])) <= 1e-5 * abs(float(p[0]))
    assert _max_rel(k1[1], p[1]) <= 1e-4 and _max_rel(k1[2], p[2]) <= 1e-4
    sentinel = s["ids"] >= system.n_atoms
    assert not k1[1][:, sentinel].any() and not k1[2][sentinel].any()


def test_triclinic_kernel_path_matches_plain_and_f64(tri_setup):
    """energy_and_forces on the sheared box: the f32 kernel path against
    the f32 plain path and the f64 plain path, force RMS rel <= 1e-4 and
    |dE| <= 1e-5 sum |E_c|."""
    s = tri_setup
    system, x = s["system"], s["x"]
    e_k, f_k = energy_and_forces(x, system)
    sys64 = system.astype(torch.float64)
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in energy_components(
            x.double(), sys64.with_kernel_route("plain")).values())
    for ref_sys, xx in ((system, x), (sys64, x.double())):
        e_p, f_p = energy_and_forces(xx, ref_sys.with_kernel_route("plain"))
        rms = torch.sqrt(torch.mean((f_k.double() - f_p.double()) ** 2)
                         / torch.mean(f_p.double() ** 2))
        assert float(rms) <= 1e-4
        assert abs(float(e_k) - float(e_p)) <= 1e-5 * scale


def test_triclinic_chunk_replays_give_the_eager_bits(tri_setup):
    """nve_trajectory_nb on the sheared box: two chunks and a remainder
    replayed (first call and second call) equal graph=False bit for bit."""
    from chargeflux_tpu_torch.integrate import (make_nb_energy_fn,
                                                nve_trajectory_nb)
    from chargeflux_tpu_torch.utils.measure import DT_PS

    s = tri_setup
    fns = make_nb_energy_fn(s["system"], bonded=s["bonded"])
    runs = [nve_trajectory_nb(s["s0"], *fns, s["masses"], DT_PS, 9, 4,
                              graph=g) for g in (False, True, True)]
    assert torch.isfinite(runs[0][1]).all()
    for got in runs[1:]:
        _same_bits(runs[0], got)


# ---------------------------------------------------------------------------
# NPT and the CSVR / Nose-Hoover thermostats: the box an input of the graph
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ensemble_paths(md_paths):
    """Per driver, ``run(n_steps, graph, generator, **kw) -> (positions,
    velocities, records)``, its owner (where its chunks are kept) and its
    chunk length, on the small cell + SPME box of ``setup`` from its
    lattice at rest (0.5 fs steps, rebuilt every 4): isotropic NPT at
    1 bar (records: energies, then the boxes, accepts and poisoned flags
    per attempt), CSVR (records: kinetic energies and work) and a
    Nose-Hoover chain (records: kinetic energies)."""
    from chargeflux_tpu_torch import csvr, npt
    from chargeflux_tpu_torch import integrate as it
    from chargeflux_tpu_torch import nosehoover as nh

    system, bonded, s0, masses, _ = md_paths["cell"]
    fns = it.make_nb_energy_fn(system, bonded=bonded)
    dt, t = 5e-4, 300.0

    def run_npt(n, g, gen, pressure=1.0, **kw):
        x, v, box, d = npt.npt_langevin_trajectory(
            s0.positions, s0.velocities, system, masses, dt, t, 5.0,
            pressure, gen, n, bonded=bonded, barostat_interval=4, graph=g,
            **kw)
        return x, v, (d["energies"], d["boxes"], d["accepts"],
                      d["poisoned"], box)

    def run_csvr(n, g, gen):
        fin, d = csvr.csvr_trajectory_nb(s0, *fns, masses, dt, t, 0.1, gen,
                                         n, 4, graph=g)
        return fin.positions, fin.velocities, (d["kinetic"], d["work"])

    def run_nhc(n, g, gen):
        fin, ch, kes = nh.nose_hoover_trajectory_nb(s0, *fns, masses, dt, t,
                                                    0.02, n, 4, graph=g)
        return fin.positions, fin.velocities, (kes, *ch)

    return {"npt": (run_npt, system, 4), "csvr": (run_csvr, fns[0], 4),
            "nhc": (run_nhc, fns[0], 4)}


def _all_equal(a, b):
    for u, v in zip(a, b):
        if isinstance(u, tuple):
            _all_equal(u, v)
        else:
            assert torch.equal(u, v)


@pytest.mark.parametrize("driver", ["npt", "csvr", "nhc"])
def test_ensemble_chunk_replays_give_the_eager_bits(ensemble_paths, driver):
    """Two chunks (NPT: two barostat intervals; the thermostats also a
    remainder) from one generator state: the first replayed call (which
    captures) and a second give graph=False's positions, velocities and
    records bit for bit (NPT: energies, boxes, accepts, poisoned flags and
    the final box), one graph per chunk length, drawn inside the graph."""
    run, owner, every = ensemble_paths[driver]
    n = 2 * every + (0 if driver == "npt" else 1)
    gen = torch.Generator(torch.device("cuda", 0))
    before = set(owner.__dict__.get("nve_chunks", {}))
    outs = []
    for graph in (False, True, True):
        gen.manual_seed(21)
        outs.append(run(n, graph, gen))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0][2][0]).all()
    new = [c for k, c in owner.nve_chunks.items() if k not in before]
    assert len(new) == (1 if driver == "npt" else 2)
    assert all(c.graph is not None for c in new)
    for got in outs[1:]:
        _all_equal(outs[0], got)


@pytest.mark.parametrize("driver", ["npt", "csvr"])
def test_a_second_ensemble_call_draws_new_noise(ensemble_paths, driver):
    """Two replayed calls with the generator carried on differ; the
    generator moved as far as two eager calls move it."""
    run, owner, every = ensemble_paths[driver]
    gen = torch.Generator(torch.device("cuda", 0)).manual_seed(3)
    a = run(every, True, gen)[2][0]
    b = run(every, True, gen)[2][0]
    offset = gen.get_offset()
    gen.manual_seed(3)
    run(every, False, gen)
    run(every, False, gen)
    torch.cuda.synchronize()
    assert not torch.equal(a, b)
    assert gen.get_offset() == offset


@pytest.mark.parametrize("driver", ["npt", "csvr", "nhc"])
def test_a_warm_eager_ensemble_chunk_makes_no_host_sync(ensemble_paths,
                                                        driver):
    """Once warm, a whole eager call (NPT: the start energy, the attempts
    with their binning, the rebuilds and steps) runs under
    ``set_sync_debug_mode("error")``."""
    run, owner, every = ensemble_paths[driver]
    gen = torch.Generator(torch.device("cuda", 0)).manual_seed(5)
    run(2 * every, False, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = run(2 * every, False, gen)[2]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(rec[0]).all()


def test_npt_calls_with_fresh_equal_arguments_share_one_graph(
        ensemble_paths, md_paths):
    """Replayed NPT calls that name the molecules' index arrays in fresh
    tuples, or as fresh arrays of equal content, replay the graphs already
    kept on the system (the molecules ride in the carry; only their
    shapes key the chunk); an ``energy_fn``'s chunk is kept on that
    function, and the system gains none."""
    from chargeflux_tpu_torch.energy import _energy

    run, system, every = ensemble_paths["npt"]
    _, bonded, *_ = md_paths["cell"]
    gen = torch.Generator(torch.device("cuda", 0)).manual_seed(13)
    run(every, True, gen, extra_mol_idx=(bonded.bond_idx, bonded.angle_idx))
    graphs = {k: c.graph for k, c in system.nve_chunks.items()}
    for extra in ((bonded.bond_idx, bonded.angle_idx),
                  (bonded.bond_idx.clone(), bonded.angle_idx.clone())):
        es = run(every, True, gen, extra_mol_idx=extra)[2][0]
    torch.cuda.synchronize()
    assert torch.isfinite(es).all()
    assert {k: c.graph for k, c in system.nve_chunks.items()} == graphs

    def e_fn(x, box):
        return _energy(x, system.with_box(box))

    for _ in range(2):
        es = run(every, True, gen, energy_fn=e_fn)[2][0]
    torch.cuda.synchronize()
    assert torch.isfinite(es).all()
    assert {k: c.graph for k, c in system.nve_chunks.items()} == graphs
    assert len(e_fn.nve_chunks) == 1
    assert next(iter(e_fn.nve_chunks.values())).graph is not None


def test_the_npt_profiles_proposal_timing_captures(setup):
    """The NPT profile times one barostat attempt (``measure.proposal_work``,
    the driver's ``npt.isotropic_attempt``) inside a CUDA graph
    (``measure.call_graph``): its draws come from a generator that the
    capture registers, and a replay gives a finite potential."""
    from chargeflux_tpu_torch.utils import measure

    path = measure.npt_path(torch.device("cuda", 0), n_side=6, cutoff=0.55,
                            grid=(3, 3, 3), burn_steps=40)
    work = measure.proposal_work(path)
    graph = measure.call_graph(work)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.isfinite(work())


def test_kernels_agree_with_plain_after_replayed_volume_moves(
        ensemble_paths, md_paths):
    """Six replayed NPT attempts at 5000 bar move the box (some accepted,
    the replayed graph reading the box buffer the attempts wrote, never
    recaptured); at the final box the spread and walk kernels agree with
    their plain versions within phase 3's tolerances (spread 1e-6 and
    2e-5, walk 1e-5 / 1e-4 / 1e-4), and the kernel path's energy and
    forces with the plain path's."""
    from chargeflux_tpu_torch.utils.measure import spread_inputs

    run, system, every = ensemble_paths["npt"]
    gen = torch.Generator(torch.device("cuda", 0)).manual_seed(11)
    run(every, True, gen, pressure=5000.0)
    graphs = {k: c.graph for k, c in system.nve_chunks.items()}
    x, _v, (es, boxes, accepts, poisoned, box) = run(6 * every, True, gen,
                                                     pressure=5000.0)
    torch.cuda.synchronize()
    assert {k: c.graph for k, c in system.nve_chunks.items()} == graphs
    assert torch.isfinite(es).all() and bool(accepts.any())
    assert not bool(poisoned.any())
    assert not torch.equal(box, system.box)
    moved = system.with_box(box)
    with torch.no_grad():
        args, b, ids = spread_inputs(x, moved)
        ct = torch.randn(args[5], device=x.device,
                         generator=torch.Generator(x.device).manual_seed(0))
        assert _max_rel(ps.spread_fwd(*args), ps.spread_fwd_plain(*args)) \
            <= 1e-6
        for u, w in zip(ps.spread_bwd(*args[:5], ct),
                        ps.spread_bwd_plain(*args[:5], ct)):
            assert _max_rel(u, w) <= 2e-5
        wargs = (*b, ids.to(torch.int32).contiguous(), moved.box,
                 moved.n_atoms, moved.spec.alpha, moved.spec.cutoff)
        k, p = dw.direct_walk(*wargs), dw.direct_walk_plain(*wargs)
        assert abs(float(k[0] - p[0])) <= 1e-5 * abs(float(p[0]))
        assert _max_rel(k[1], p[1]) <= 1e-4 and _max_rel(k[2], p[2]) <= 1e-4
    e_k, f_k = energy_and_forces(x, moved)
    e_p, f_p = energy_and_forces(x, moved.with_kernel_route("plain"))
    assert abs(float(e_k - e_p)) <= 1e-5 * abs(float(e_p))
    assert _max_rel(f_k, f_p) <= 1e-3


def _kernel_vs_plain(energy_fn, x):
    """(kernel, plain) energy and forces of ``energy_fn(x, plain)`` checked
    within phase 4's limits: |dE| <= 1e-5 sum |E_c|-scale, force RMS rel
    <= 1e-4."""
    (e_k, f_k), (e_p, f_p) = energy_fn(x, False), energy_fn(x, True)
    assert torch.isfinite(f_k).all() and bool(torch.isfinite(e_k))
    rms = torch.sqrt(torch.mean((f_k - f_p) ** 2) / torch.mean(f_p ** 2))
    assert float(rms) <= 1e-4
    return e_k, e_p


def test_onramp_first_evaluation_kernel_route_matches_plain(tmp_path):
    """onramp30k's system (the peptide-in-water PDB written and read back
    at 31,926 atoms, backbone torsions) at its first evaluation: the
    kernel route against the plain route in f32, within phase 4's limits;
    the walk and both spread kernels launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from chargeflux_tpu_torch.bonded import bonded_energy
    from chargeflux_tpu_torch.utils.measure import (onramp_system,
                                                    write_peptide_pdb)

    dev = torch.device("cuda", 0)
    path = str(tmp_path / "pep.pdb")
    write_peptide_pdb(path)
    _, x, _, _, bonded, system = onramp_system(path, dev)
    assert system.n_atoms == 31926 and system.kernel_route == "cuda"
    assert bonded.torsion_idx.shape == (45, 4)
    ops.reset_launch_counts()
    e_k, e_p = _kernel_vs_plain(
        lambda xx, plain: energy_and_forces(xx, _on_route(system, plain)),
        x)
    counts = ops.launch_counts()
    assert all(counts[k] >= 1 for k in ("direct_walk", "spread_fwd",
                                        "spread_bwd"))
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in energy_components(
            x, system.with_kernel_route("plain")).values())
    assert abs(float(e_k - e_p)) <= 1e-5 * scale
    assert bool(torch.isfinite(bonded_energy(x, bonded)))


def test_rbe_energy_function_kernel_route_matches_plain(setup):
    """The RBE energy function on the walk kernel against its plain route
    on the same k-vector draw (one generator state), f32; no spread
    kernel runs (the estimator replaces the mesh)."""
    from chargeflux_tpu_torch.neighbors import build_neighbor_state
    from chargeflux_tpu_torch.rbe import make_rbe_nb_energy_fn

    s = setup
    dev = s["x"].device
    fns = {p: make_rbe_nb_energy_fn(_on_route(s["system"], p), 64)[0]
           for p in (False, True)}
    nb = build_neighbor_state(s["x"], s["system"])
    gen = torch.Generator(dev)

    def run(xx, plain):
        gen.manual_seed(5)
        e, f, _ = fns[plain](xx, nb, gen)
        return e, f

    ops.reset_launch_counts()
    e_k, e_p = _kernel_vs_plain(run, s["x"])
    counts = ops.launch_counts()
    assert counts["direct_walk"] >= 1 and counts["spread_fwd"] == 0
    assert abs(float(e_k - e_p)) <= 1e-5 * abs(float(e_p))


# ---------------------------------------------------------------------------
# the halo route: the walk kernel's slab form, in an NCCL world of one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def halo_world():
    """An NCCL group of one rank on the card (tcp on localhost), and the
    30k box of ``bench.py 30k`` in f32 with a start state whose
    Maxwell velocities at 300 K drifted its blocks for 11 steps on one
    neighbor state (``utils.measure.drifted_blocks``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import socket

    import torch.distributed as dist

    from chargeflux_tpu_torch.integrate import (init_state_nb,
                                                make_nb_energy_fn,
                                                maxwell_velocities)
    from chargeflux_tpu_torch.utils.measure import bench_path, drifted_blocks

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    _f, x, m, _b, bonded, system = bench_path("30k", dev)
    e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)
    v = maxwell_velocities(m, 300.0, torch.Generator(dev).manual_seed(3),
                           dtype=torch.float32)
    s0 = init_state_nb(x, v, e_fn, init_nb)
    walk_args, info = drifted_blocks(system, s0, e_fn, m, 11)
    assert info["outside"] > 0
    yield dict(system=system, x=x, masses=m, bonded=bonded,
               walk_args=walk_args, drifted_x=info["positions"])
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tri_walk_args(halo_world):
    """bench.py's tri30k box in f32 (the 30k box on the sheared lattice),
    its blocks drifted as the 30k box's are in ``halo_world``."""
    from chargeflux_tpu_torch.integrate import (init_state_nb,
                                                make_nb_energy_fn,
                                                maxwell_velocities)
    from chargeflux_tpu_torch.utils.measure import bench_path, drifted_blocks

    dev = torch.device("cuda", 0)
    _f, x, m, _b, bonded, system = bench_path("tri30k", dev)
    e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)
    v = maxwell_velocities(m, 300.0, torch.Generator(dev).manual_seed(3),
                           dtype=torch.float32)
    s0 = init_state_nb(x, v, e_fn, init_nb)
    walk_args, info = drifted_blocks(system, s0, e_fn, m, 11)
    assert info["outside"] > 0 and walk_args[7].ndim == 2
    return walk_args


@pytest.mark.parametrize("box", ["30k", "tri30k"])
@pytest.mark.parametrize("decomp,rank", [((1, 1), 0), ((4, 1), 1),
                                         ((2, 2), 2)], ids=str)
def test_slab_walk_kernel_matches_plain_on_drifted_blocks(
        halo_world, request, box, decomp, rank):
    """The slab kernel (counted as ``direct_walk_halo`` only) against the
    plain slab walk on a rank's extended slab cut from drifted 30k
    blocks, orthorhombic and triclinic (the kernel's ``TRICLINIC`` form):
    energy within 1e-5, dE/dx and dE/dq within 1e-4 of their max, two
    launches bit-equal."""
    from chargeflux_tpu_torch.utils.measure import slab_walk_args

    walk_args = (halo_world["walk_args"] if box == "30k"
                 else request.getfixturevalue("tri_walk_args"))
    slab = slab_walk_args(walk_args, decomp, rank)
    n0 = dict(ops.launch_counts())
    with torch.no_grad():
        k1, k2 = dw.direct_walk_slab(*slab), dw.direct_walk_slab(*slab)
        p = dw.direct_walk_slab_plain(*slab)
    counts = ops.launch_counts()
    assert counts["direct_walk_halo"] == n0["direct_walk_halo"] + 2
    assert counts["direct_walk"] == n0["direct_walk"]
    assert counts["direct_walk_tri"] == n0["direct_walk_tri"]
    for u, v in zip(k1, k2):
        assert torch.equal(u, v)
    assert abs(float(k1[0] - p[0])) <= 1e-5 * abs(float(p[0]))
    assert _max_rel(k1[1], p[1]) <= 1e-4 and _max_rel(k1[2], p[2]) <= 1e-4


def _halo_system(system, recip="pme"):
    import dataclasses

    from chargeflux_tpu_torch.pme import pme_halo_mesh

    return system._swap(spec=dataclasses.replace(
        system.spec, recip_method=recip, pme_grid=pme_halo_mesh(system.spec)))


def test_halo_route_runs_the_slab_kernel_and_no_periodic_walk(halo_world):
    """The 30k f32 halo energy and forces in a world of one against the
    single-system kernel route (|dE| <= 1e-5 of sum|E_c|, force RMS
    within 1e-5), with one slab kernel launch an evaluation and no
    periodic walk launch; a capacity past the kernel's limit raises
    rather than taking the plain walk."""
    import dataclasses

    from chargeflux_tpu_torch.parallel.halo import make_halo_energy_fn

    system = _halo_system(halo_world["system"])
    x = halo_world["x"]
    e_ref, f_ref = energy_and_forces(x, system)
    e_fn = make_halo_energy_fn(system, None)
    xg = x.clone().requires_grad_(True)
    ops.reset_launch_counts()
    e = e_fn(xg)
    (g,) = torch.autograd.grad(e, xg)
    counts = ops.launch_counts()
    assert counts["direct_walk_halo"] == 1
    assert counts["direct_walk"] == 0 and counts["direct_walk_tri"] == 0
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in energy_components(
            x, system).values())
    assert abs(float(e.detach()) - float(e_ref)) <= 1e-5 * scale
    rms = torch.sqrt(torch.mean((-g.double() - f_ref.double()) ** 2)
                     / torch.mean(f_ref.double() ** 2))
    assert float(rms) <= 1e-5
    big = system._swap(spec=dataclasses.replace(system.spec,
                                                cell_capacity=1100))
    with pytest.raises(ValueError, match="capacity"):
        make_halo_energy_fn(big, None)(x)


@pytest.mark.parametrize("case", ["30k_f32", "4k_f64"])
def test_halo_nve_replays_give_the_eager_bits(halo_world, case):
    """NVE over the halo energy with the NCCL all-reduces captured in the
    chunk graphs: the 30k f32 box (slab kernel, halo PME mesh) with the
    water bonds, and a 4k f64 box on classical Ewald (the plain slab
    walk); a capture and a replay give graph=False's energies, positions
    and velocities bit for bit."""
    from chargeflux_tpu_torch.bonded import bonded_energy
    from chargeflux_tpu_torch.integrate import init_state, nve_trajectory
    from chargeflux_tpu_torch.models import water_box
    from chargeflux_tpu_torch.parallel.halo import make_halo_energy_fn
    from chargeflux_tpu_torch.utils.measure import DT_PS

    if case == "30k_f32":
        halo = make_halo_energy_fn(_halo_system(halo_world["system"]), None)

        def e_fn(xx):
            return halo(xx) + bonded_energy(xx, halo_world["bonded"])

        x, masses, dt = halo_world["x"], halo_world["masses"], DT_PS
    else:
        force, pos, _m, box = water_box(n_side=11, flux="bond_angle",
                                        cutoff=0.8)
        system = force.create_system(box=box, dtype=torch.float64,
                                     direct_method="cell",
                                     recip_method="xla", device="cuda")
        e_fn = make_halo_energy_fn(_halo_system(system, "xla"), None)
        x = torch.tensor(pos, dtype=torch.float64, device="cuda")
        masses = torch.full((x.shape[0],), 10.0, dtype=torch.float64,
                            device="cuda")
        dt = 2e-5
    s0 = init_state(x, torch.zeros_like(x), e_fn)
    runs = [nve_trajectory(s0, e_fn, masses, dt, 12, graph=g)
            for g in (False, True, True)]
    for fin, es in runs[1:]:
        assert torch.equal(es, runs[0][1])
        assert torch.equal(fin.positions, runs[0][0].positions)
        assert torch.equal(fin.velocities, runs[0][0].velocities)
    assert bool(torch.isfinite(runs[0][1]).all())


@pytest.fixture(scope="module")
def binning_inputs(halo_world):
    """The binning kernel's cases (``utils.measure.binning_cases``): the
    30k box's start and drifted positions, each on its 8^3 grid at the
    system's capacity and at 8 (cells overflow) and on every rank's slab
    of (4, 1) and (2, 2); the start positions halved (7/8 of the cells
    empty), its first 2049 atoms (N not a multiple of the kernel's 1024
    chunk), and bench.py's 100k box on its 11^3 grid."""
    from chargeflux_tpu_torch.utils.measure import (bench_path,
                                                    binning_cases,
                                                    binning_cells)

    s = halo_world
    system, x = s["system"], s["x"]
    cases = {**binning_cases(system, x, "30k start"),
             **binning_cases(system, s["drifted_x"], "30k drifted")}
    cell, n_cells = binning_cells(system, 0.5 * x)
    cap = int(torch.bincount(cell.long(), minlength=n_cells).max())
    cases["30k halved"] = (cell, n_cells, cap)
    cases["2049 atoms"] = (*binning_cells(system, x[:2049]),
                           system.spec.cell_capacity)
    _f, x100, _m, _b, _bd, s100 = bench_path("100k", x.device)
    assert s100.spec.cell_grid == (11, 11, 11)
    cases["100k"] = (*binning_cells(s100, x100), s100.spec.cell_capacity)
    return cases


def test_cell_bin_kernel_matches_plain_bit_for_bit(binning_inputs):
    """Slots, inverse slots and the overflow count of the kernel equal the
    plain version's in every case, and two launches repeat bit for bit;
    each call counts one launch."""
    n0 = ops.launch_counts()["cell_bin"]
    seen = {"overflow": 0, "empty": 0, "nowhere": 0}
    for name, (cell, n_cells, cap) in binning_inputs.items():
        k1 = cb.cell_bin(cell, n_cells, cap)
        k2 = cb.cell_bin(cell, n_cells, cap)
        p = cb.cell_bin_plain(cell, n_cells, cap)
        for u, v, w in zip(k1, k2, p):
            assert torch.equal(u, v) and torch.equal(u, w), name
        seen["overflow"] += int(k1[2]) > 0
        seen["empty"] += bool((k1[0][:, 0] == cell.shape[0]).any())
        seen["nowhere"] += bool((cell == n_cells).any())
    assert ops.launch_counts()["cell_bin"] == n0 + 2 * len(binning_inputs)
    assert all(seen.values()), seen


def test_cell_bin_replays_in_a_cuda_graph(binning_inputs):
    """Captured into a CUDA graph (a fixed grid, no host read), the binning
    replays the eager call's bits; new ids copied into the captured input
    give their own binning."""
    cell, n_cells, cap = binning_inputs["30k start"]
    other = binning_inputs["30k drifted"][0]
    static = cell.clone()
    cb.cell_bin(static, n_cells, cap)              # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cb.cell_bin(static, n_cells, cap)
    for ids in (cell, other, cell):
        static.copy_(ids)
        graph.replay()
        torch.cuda.synchronize()
        for u, v in zip(out, cb.cell_bin_plain(ids, n_cells, cap)):
            assert torch.equal(u, v)


def test_a_binning_overflow_poisons_the_kernel_route(halo_world):
    """At capacity 8 the 30k box's cells overflow on the kernel route: the
    binning kernel launched, and energy and every force are NaN."""
    import dataclasses

    s = halo_world
    tiny = s["system"]._swap(spec=dataclasses.replace(s["system"].spec,
                                                      cell_capacity=8))
    n0 = ops.launch_counts()["cell_bin"]
    e, f = energy_and_forces(s["x"], tiny)
    assert ops.launch_counts()["cell_bin"] == n0 + 1
    assert torch.isnan(e) and torch.isnan(f).all()
