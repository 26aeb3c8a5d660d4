"""PyTorch port: the templated bonds and angles (``ops.bonded_terms``): the
plain chain against the chain as ``bonded.bonded_energy`` ran it before the
kernels and against the JAX package, the route that sends template blocks
to the kernels, the energy-function builders that put the bonded terms on
the system's route, and the paths that stay plain.  The kernels run on the
card only (tests/test_torch_kernels_cuda.py); here the kernel route is
taken by CPU terms whose ``kernel_route`` is set to "cuda", so the wrappers
run their plain versions and launch nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import bonded as jbonded
from chargeflux_tpu.models import water_bonded_params as jax_water_bonded
from chargeflux_tpu_torch import bonded as pbonded
from chargeflux_tpu_torch import integrate, npt, ops, rbe
from chargeflux_tpu_torch.bonded import BondedParams, follow_route
from chargeflux_tpu_torch.models import water_bonded_params, water_box
from chargeflux_tpu_torch.ops import bonded_terms as bt
from chargeflux_tpu_torch.pairs import displacement
from chargeflux_tpu_torch.parallel import replicas
from chargeflux_tpu_torch.rows import gather_planned
from chargeflux_tpu_torch.utils.measure import (bonded_inputs, bonded_scale,
                                                shear_box)

torch.set_num_threads(2)

WATER = np.array([[0.0, 0.0, 0.0], [0.0957, 0.0, 0.0],
                  [-0.024, 0.0927, 0.0]])
# a bent triatomic whose vertex is its middle atom: a second template
BENT = np.array([[0.0, 0.0, 0.0], [0.116, 0.0, 0.0],
                 [0.17, 0.1, 0.0]])


def _chain_before(positions, bonded):
    """``bonded.bonded_energy``'s arithmetic as it was before the kernels:
    every templated row by static slices from zero, then the gathered
    rows."""
    box, pbc = bonded.box, bonded.pbc

    def bond(p1, p2, k, r0):
        d = displacement(p1, p2, box, pbc)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        return 0.5 * torch.sum(k * (r - r0) ** 2, dim=-1)

    def angle(p1, p2, p3, k, theta0):
        d21 = displacement(p2, p1, box, pbc)
        d23 = displacement(p2, p3, box, pbc)
        r21 = torch.sqrt(torch.sum(d21 * d21, dim=-1))
        r23 = torch.sqrt(torch.sum(d23 * d23, dim=-1))
        cost = torch.sum(d21 * d23, dim=-1) / (r21 * r23)
        theta = torch.arccos(torch.clamp(cost, -1.0, 1.0))
        return 0.5 * torch.sum(k * (theta - theta0) ** 2, dim=-1)

    e = torch.zeros((), dtype=positions.dtype)
    lead = positions.shape[:-2]
    b0 = a0 = 0
    for tpl in bonded.template.templates:
        off, s, c = tpl.offset, tpl.stride, tpl.count
        pos_m = positions[..., off:off + c * s, :].reshape(lead + (c, s, 3))
        p = [pos_m[..., l, :] for l in range(s)]
        rows = tpl.local_rows("bonds")
        if rows:
            m = len(rows)
            k = bonded.bond_k[b0:b0 + c * m].reshape(c, m)
            r0 = bonded.bond_r0[b0:b0 + c * m].reshape(c, m)
            b0 += c * m
            for t, (l1, l2) in enumerate(rows):
                e = e + bond(p[l1], p[l2], k[:, t], r0[:, t])
        rows = tpl.local_rows("angles")
        if rows:
            m = len(rows)
            k = bonded.angle_k[a0:a0 + c * m].reshape(c, m)
            t0 = bonded.angle_theta0[a0:a0 + c * m].reshape(c, m)
            a0 += c * m
            for t, (l1, l2, l3) in enumerate(rows):
                e = e + angle(p[l1], p[l2], p[l3], k[:, t], t0[:, t])
    n_b = bonded.bond_idx.shape[0] - b0
    n_a = bonded.angle_idx.shape[0] - a0
    n_t = 0 if bonded.torsion_idx is None else bonded.torsion_idx.shape[0]
    if n_b + n_a + n_t:
        p_all = gather_planned(positions, bonded.plan)
        if n_b:
            pb = p_all[:2 * n_b].reshape(n_b, 2, 3)
            e = e + bond(pb[:, 0], pb[:, 1], bonded.bond_k[b0:],
                         bonded.bond_r0[b0:])
        if n_a:
            pa = p_all[2 * n_b:2 * n_b + 3 * n_a].reshape(n_a, 3, 3)
            e = e + angle(pa[:, 0], pa[:, 1], pa[:, 2], bonded.angle_k[a0:],
                          bonded.angle_theta0[a0:])
        if n_t:
            pt = p_all[2 * n_b + 3 * n_a:].reshape(n_t, 4, 3)
            e = e + pbonded._torsion_e(
                pt[:, 0], pt[:, 1], pt[:, 2], pt[:, 3], bonded.torsion_k,
                bonded.torsion_n, bonded.torsion_phi0, box, pbc)
    return e


def _mixed_arrays(seed=5):
    """A periodic box of 20 waters, 6 bent triatomics (a second template)
    and a 9-bead chain with torsions (remainder rows), each copy with its
    own constants, molecules straddling the box's faces: (positions,
    BondedParams.create keywords)."""
    rng = np.random.default_rng(seed)
    box = np.array([1.6, 1.5, 1.7])
    mols, bonds, angles, bk, br0, ak, at0 = [], [], [], [], [], [], []
    start = 0
    for geom, bond_rows, angle_rows, count in (
            (WATER, [(0, 1), (0, 2)], [(1, 0, 2)], 20),
            (BENT, [(0, 1), (1, 2)], [(0, 1, 2)], 6)):
        for _ in range(count):
            rot = np.linalg.qr(rng.standard_normal((3, 3)))[0]
            mols.append(rng.uniform(0, 1, 3) * box + geom @ rot.T
                        + 0.004 * rng.standard_normal(geom.shape))
            bonds += [(start + a, start + b) for a, b in bond_rows]
            angles += [(start + a, start + b, start + c)
                       for a, b, c in angle_rows]
            bk += list(rng.uniform(3e5, 5e5, len(bond_rows)))
            br0 += list(rng.uniform(0.09, 0.12, len(bond_rows)))
            ak += list(rng.uniform(300.0, 400.0, len(angle_rows)))
            at0 += list(rng.uniform(1.7, 2.0, len(angle_rows)))
            start += len(geom)
    n_chain = 9
    chain = (rng.uniform(0, 1, 3) * box
             + np.cumsum(0.15 * rng.standard_normal((n_chain, 3)), axis=0))
    mols.append(chain)
    idx = start + np.arange(n_chain)
    bonds += list(zip(idx[:-1], idx[1:]))
    angles += list(zip(idx[:-2], idx[1:-1], idx[2:]))
    bk += list(rng.uniform(2e5, 3e5, n_chain - 1))
    br0 += list(rng.uniform(0.14, 0.16, n_chain - 1))
    ak += list(rng.uniform(400.0, 500.0, n_chain - 2))
    at0 += list(rng.uniform(1.8, 2.0, n_chain - 2))
    tors = np.stack([idx[:-3], idx[1:-2], idx[2:-1], idx[3:]], axis=1)
    pos = np.concatenate(mols)
    pos = pos - box * np.floor(pos / box)
    kw = dict(bond_idx=np.array(bonds), bond_k=np.array(bk),
              bond_r0=np.array(br0), angle_idx=np.array(angles),
              angle_k=np.array(ak), angle_theta0=np.array(at0), box=box,
              pbc=True, n_atoms=len(pos), torsion_idx=tors,
              torsion_k=rng.uniform(1.0, 3.0, len(tors)),
              torsion_n=np.full(len(tors), 3.0),
              torsion_phi0=rng.uniform(0.0, 3.0, len(tors)))
    return pos, kw


def _boxes(name, dtype=torch.float64):
    """(JAX bonded terms, port bonded terms, positions [N, 3]) in f64."""
    if name == "mixed":
        pos, kw = _mixed_arrays()
        jb = jbonded.BondedParams.create(dtype=jnp.float64, **kw)
        pb = BondedParams.create(dtype=dtype, device="cpu", **kw)
        return jb, pb, torch.as_tensor(pos, dtype=dtype)
    pbc = name == "water"
    _force, pos, masses, box = water_box(n_side=5, cutoff=0.5)
    n_w = len(masses) // 3
    jb = jax_water_bonded(n_w, box=box if pbc else None, dtype=jnp.float64)
    pb = water_bonded_params(n_w, box=box if pbc else None, dtype=dtype,
                             device="cpu")
    x = torch.as_tensor(np.asarray(pos), dtype=dtype)
    if pbc:
        x = bonded_inputs(pb, x, seed=3)[0][0]
    return jb, pb, x


def _kernel_route(bonded):
    """The terms with the kernel route taken (on the CPU the wrappers run
    their plain versions)."""
    return bonded._swap(kernel_route="cuda")


def _grads(fn, x):
    xg = x.clone().requires_grad_(True)
    with torch.enable_grad():
        e = fn(xg)
        (g,) = torch.autograd.grad(e, xg)
    return e.detach(), g


BOXES = ["water", "water-open", "mixed"]


@pytest.mark.parametrize("name", BOXES)
def test_plain_twin_matches_the_chain_before_and_jax(name):
    """Energy and dE/dx of the plain route and of the kernel route's plain
    versions equal the chain before the kernels bit for bit; against the
    JAX package's ``bonded_energy`` in f64 within 1e-10 (energy relative to
    the sum of the rows' |energy|, dE/dx to its max)."""
    jb, pb, x = _boxes(name)
    assert pb.template is not None
    if name == "mixed":
        assert len(pb.template.templates) == 2 and pb.plan is not None
    before = _grads(lambda a: _chain_before(a, pb), x)
    for bonded in (pb, _kernel_route(pb)):
        got = _grads(lambda a: pbonded.bonded_energy(a, bonded), x)
        for u, v in zip(got, before):
            assert torch.equal(u, v)
    e_j, g_j = jax.value_and_grad(
        lambda a: jbonded.bonded_energy(a, jb))(jnp.asarray(x.numpy()))
    scale = sum(bonded_scale((x, *a[1:])) for a in bonded_inputs(pb, x))
    assert abs(float(before[0]) - float(e_j)) <= 1e-10 * scale
    g_j = np.asarray(g_j)
    assert np.abs(before[1].numpy() - g_j).max() <= 1e-10 * np.abs(g_j).max()


@pytest.mark.parametrize("name", BOXES)
def test_the_wrappers_plain_versions_are_the_template_chain(name):
    """Per template, the wrappers on CPU tensors: the forward is
    ``bonded_fwd_plain``'s bits, the backward ct dE/dx of it by autograd
    (ct 1.5), [N, 3] with zeros outside the template's atoms; nothing is
    launched."""
    _, pb, x = _boxes(name)
    ops.reset_launch_counts()
    ct = torch.tensor(1.5, dtype=x.dtype)
    for args in bonded_inputs(pb, x, drift=0.0):
        tpl = args[6]
        assert torch.equal(bt.bonded_fwd(*args), bt.bonded_fwd_plain(*args))
        g = bt.bonded_bwd(*args, ct)
        xg = args[0].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(bt.bonded_fwd_plain(xg, *args[1:]), xg,
                                      ct)
        assert g.shape == args[0].shape and torch.equal(g, want)
        block = torch.zeros(g.shape[0], dtype=torch.bool)
        block[tpl.offset:tpl.offset + tpl.count * tpl.stride] = True
        assert not g[~block].any() and g[block].abs().sum() > 0
    assert not any(ops.launch_counts().values())


def _route_cases():
    """(name, bonded terms, positions, kernel route expected)."""
    _, pb, x = _boxes("water")
    kern = _kernel_route(pb)
    _, open_b, x_open = _boxes("water-open")
    return [
        ("box [3]", kern, x, True),
        ("no periodicity", _kernel_route(open_b), x_open, True),
        ("box requires grad",
         kern.with_box(kern.box.clone().requires_grad_(True)), x, False),
        ("[3, 3] lattice", kern.with_box(torch.as_tensor(
            shear_box(pb.box.numpy()))), x, False),
        ("replica axes", kern, torch.stack([x, x + 0.01]), False),
        ("plain copy", kern.with_kernel_route("plain"), x, False),
        ("f64 on the CPU as built", pb, x, False),
        ("f32 on the CPU as built", pb.astype(torch.float32),
         x.to(torch.float32), False),
    ]


@pytest.mark.parametrize("case", range(8), ids=[
    "box3", "open", "box-grad", "lattice", "replicas", "plain-copy", "f64",
    "f32-cpu"])
def test_the_kernel_route_is_taken_only_where_the_kernels_apply(
        monkeypatch, case):
    """Template blocks go to ``ops.bonded_terms.template_bonded_energy``
    only on the kernel route with a [3] box that does not require grad (or
    none) and no replica axes, once per template; every case equals the
    chain before bit for bit, energy and dE/dx; no launch is counted on the
    CPU."""
    name, bonded, x, kernel = _route_cases()[case]
    calls = []

    def spy(*args):
        calls.append(args[6])
        return bt.template_bonded_energy(*args)

    monkeypatch.setattr(pbonded, "template_bonded_energy", spy)
    ops.reset_launch_counts()
    assert pbonded._kernel_route(x, bonded) == kernel, name
    got = _grads(lambda a: torch.sum(pbonded.bonded_energy(a, bonded)), x)
    want = _grads(lambda a: torch.sum(_chain_before(a, bonded)), x)
    assert len(calls) == (len(bonded.template.templates) if kernel else 0)
    for u, v in zip(got, want):
        assert torch.equal(u, v), name
    assert not any(ops.launch_counts().values())


def test_astype_and_with_box_keep_or_rederive_the_route():
    """Terms record "plain" on the CPU at either type; ``astype`` records
    the cast terms' own route, ``with_box`` keeps the route it is handed,
    ``with_kernel_route`` returns the terms themselves on their route and
    refuses "cuda" off the card; ``follow_route`` takes the plain copy for
    a system on the plain route and keeps the terms for one on the
    kernel route."""
    _, pb, _ = _boxes("water")
    assert pb.kernel_route == "plain" and not pb.uses_kernels
    kern = _kernel_route(pb)
    assert kern.uses_kernels and kern.with_box(kern.box * 1.01).uses_kernels
    assert kern.with_box(kern.box).plan is kern.plan
    for dtype in (torch.float32, torch.float64):
        assert kern.astype(dtype).kernel_route == "plain"
    assert pb.with_kernel_route("plain") is pb
    plain = kern.with_kernel_route("plain")
    assert plain.kernel_route == "plain" and plain.bond_k is kern.bond_k
    for b in (pb, pb.astype(torch.float32)):
        with pytest.raises(ValueError, match="kernel route"):
            b.with_kernel_route("cuda")
    system = water_box(n_side=3, cutoff=0.4)[0].create_system(
        box=pb.box.numpy(), dtype=torch.float64, device="cpu")
    kern_sys = system._swap(kernel_route="cuda")
    assert follow_route(kern, system).kernel_route == "plain"
    assert follow_route(kern, kern_sys) is kern
    assert follow_route(None, system) is None


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["folded", "straight"])
def test_the_clamp_edge_gives_the_chains_finite_gradient(sign):
    """A water whose H-O-H cosine rounds past +1 (folded) or -1
    (straight): the kernel route's dE/dx equals the chain's, finite, with
    the angle passing no gradient through theta (only the two bonds')."""
    rng = np.random.default_rng(11)
    _, pb, x = _boxes("water-open")
    pb1 = pb.astype(torch.float32)
    for _ in range(10_000):
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        o = rng.uniform(0.2, 0.8, 3)
        mol = np.stack([o, o + rng.uniform(0.08, 0.11) * u,
                        o + sign * rng.uniform(0.08, 0.11) * u])
        xx = x.to(torch.float32).clone()
        xx[:3] = torch.as_tensor(mol, dtype=torch.float32)
        d21, d23 = xx[1:2] - xx[0:1], xx[2:3] - xx[0:1]
        cost = torch.sum(d21 * d23, dim=-1) / (
            torch.sqrt(torch.sum(d21 * d21, dim=-1))
            * torch.sqrt(torch.sum(d23 * d23, dim=-1)))
        if abs(float(cost)) > 1.0:
            e_c, g_c = _grads(lambda a: _chain_before(a, pb1), xx)
            if torch.isfinite(g_c).all():
                break
    else:
        pytest.fail("no cosine rounded past +-1")
    e_k, g_k = _grads(lambda a: pbonded.bonded_energy(a, _kernel_route(pb1)),
                      xx)
    assert torch.equal(e_k, e_c) and torch.equal(g_k, g_c)
    bonds_only = BondedParams.create(
        bond_idx=[(0, 1), (0, 2)], bond_k=pb1.bond_k[:2].double().numpy(),
        bond_r0=pb1.bond_r0[:2].double().numpy(), angle_idx=np.zeros((0, 3)),
        angle_k=[], angle_theta0=[], box=np.zeros(3), pbc=False,
        dtype=torch.float32, device="cpu")
    _, g_b = _grads(lambda a: pbonded.bonded_energy(a[:3], bonds_only), xx)
    assert torch.allclose(g_k[:3], g_b[:3], rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_a_nan_position_poisons_the_energy_and_its_molecule(route):
    """A NaN coordinate gives a NaN energy and NaN dE/dx on every atom of
    its molecule, the same entries as the chain before; the other atoms'
    gradients stay finite."""
    _, pb, x = _boxes("water")
    bonded = pb if route == "plain" else _kernel_route(pb)
    bad = x.clone()
    bad[3 * 40 + 2, 1] = float("nan")
    e, g = _grads(lambda a: pbonded.bonded_energy(a, bonded), bad)
    _, want = _grads(lambda a: _chain_before(a, pb), bad)
    assert torch.isnan(e)
    nan = torch.isnan(g)
    assert torch.equal(nan, torch.isnan(want))
    assert bool(nan[120:123].all()) and int(nan.any(dim=1).sum()) == 3


def test_the_kernel_route_refuses_parameter_and_box_cotangents():
    """The template function has no cotangent for k, r0, theta0 or the
    box: asking for one raises."""
    _, pb, x = _boxes("water")
    args = list(bonded_inputs(pb, x, drift=0.0)[0])
    for i in range(1, 6):
        a = list(args)
        a[i] = a[i].clone().requires_grad_(True)
        with torch.enable_grad():
            e = bt.template_bonded_energy(*a)
            with pytest.raises(RuntimeError, match="no cotangent"):
                torch.autograd.grad(e, a[i])


def _builders():
    """(name, build(system, bonded) -> a function of positions that
    evaluates the bonded terms once)."""
    def nb(system, bonded):
        e_fn, init_nb = integrate.make_nb_energy_fn(system, bonded=bonded)
        return lambda x: e_fn(x, init_nb(x))

    def respa(system, bonded):
        return integrate.make_respa_force_fns(system, bonded)[1]

    def rbe_fn(system, bonded):
        e_fn, init_nb = rbe.make_rbe_nb_energy_fn(system, 4, bonded=bonded)
        gen = torch.Generator().manual_seed(0)
        return lambda x: e_fn(x, init_nb(x), gen)

    def proposal(system, bonded):
        e_at = npt.proposal_energy(system, bonded)
        return lambda x: e_at(x, system.box)

    def replica(system, bonded):
        e_fn = replicas.replica_energy_fn(system, bonded)
        return lambda x: e_fn(x[None])

    return [("make_energy_fn", lambda s, b: integrate.make_energy_fn(s, b)),
            ("make_nb_energy_fn", nb), ("make_respa_force_fns", respa),
            ("rbe", rbe_fn), ("npt.proposal_energy", proposal),
            ("replica_energy_fn", replica)]


@pytest.mark.parametrize("builder", range(6), ids=[
    n for n, _ in _builders()])
def test_builders_put_the_bonded_terms_on_the_systems_route(
        monkeypatch, builder):
    """Each energy-function builder that holds a system sends the water
    template to the kernel entry over a system on the kernel route (faked
    "cuda", terms faked "cuda"), and to the plain chain over its
    ``with_kernel_route("plain")`` copy, with the same bits."""
    name, build = _builders()[builder]
    calls = []

    def spy(*args):
        calls.append(name)
        return bt.template_bonded_energy(*args)

    monkeypatch.setattr(pbonded, "template_bonded_energy", spy)
    force, pos, masses, box = water_box(n_side=5, cutoff=0.45)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", recip_method="pme",
                                 device="cpu")
    kern_sys = system._swap(kernel_route="cuda")
    bonded = _kernel_route(water_bonded_params(len(masses) // 3, box=box,
                                               dtype=torch.float64,
                                               device="cpu"))
    x = torch.as_tensor(np.asarray(pos))
    out = {}
    for route, sys_ in (("kernel", kern_sys),
                        ("plain", kern_sys.with_kernel_route("plain"))):
        calls.clear()
        res = build(sys_, bonded)(x)
        out[route] = res if isinstance(res, tuple) else (res,)
        assert len(calls) == (1 if route == "kernel" else 0), route
    for u, v in zip(out["kernel"], out["plain"]):
        if torch.is_tensor(u):
            assert torch.equal(u, v)
