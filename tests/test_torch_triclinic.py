"""PyTorch port: triclinic (reduced lower-triangular) boxes on every route,
held to the JAX package (tests/test_triclinic.py's boxes and oracle): the
lattice helpers, the fractional binning, the plain walk with lattice-row
image offsets (and the CUDA kernel's traversal, emulated), the fractional
SPME spread and the triclinic influence function, classical Ewald with the
reciprocal metric's cross terms, energy and forces in f64 and f32, and 20
NVE steps with neighbor reuse."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import cells as jcells
from chargeflux_tpu.charges import effective_charges as jax_charges
from chargeflux_tpu.models import water_box as jax_water_box
from chargeflux_tpu_torch import cells, ewald, pairs, pme
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.neighbors import build_neighbor_state
from chargeflux_tpu_torch.ops.direct_walk import direct_walk_plain
from chargeflux_tpu_torch.utils.measure import shear_box

from test_torch_direct_walk import _kernel_traversal
from test_triclinic import _oracle_triclinic, _shear
from torch_helpers import port_blocks, port_system, rel_err

# the module: the package attribute "energy" is the function, as in JAX
energy = importlib.import_module("chargeflux_tpu_torch.energy")

jenergy = importlib.import_module("chargeflux_tpu.energy")
jpairs = importlib.import_module("chargeflux_tpu.pairs")
jpme = importlib.import_module("chargeflux_tpu.pme")
jewald = importlib.import_module("chargeflux_tpu.ewald")

torch.set_num_threads(2)


def _systems(direct_method, recip_method, dtype=torch.float64, n_side=6,
             flux="water", cutoff=0.42, seed=3, shear=True):
    """(JAX system, port system, positions, masses, lattice) of
    tests/test_triclinic.py's sheared water box (6^3 waters: >= 3 cells
    per axis on the sheared widths)."""
    force, pos, masses, box = jax_water_box(n_side=n_side, flux=flux,
                                            cutoff=cutoff, seed=seed)
    lattice = _shear(box) if shear else np.asarray(box)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jsys = force.create_system(box=lattice, dtype=jdt,
                               direct_method=direct_method,
                               recip_method=recip_method)
    return jsys, port_system(jsys, dtype), pos, masses, lattice


def test_bench_shear_is_the_jax_tests_shear():
    box = np.array([6.8354] * 3)
    np.testing.assert_array_equal(shear_box(box), _shear(box))


def test_lattice_helpers_match_jax():
    """lattice_cart, wrap_offsets, frac_coords, plane_widths and the
    reciprocal metric on a sheared lattice, against the JAX package in
    f64 (the metric within 1e-12: JAX inverts B B^T, the port sums the
    closed-form inverse)."""
    rng = np.random.default_rng(4)
    lattice = _shear(np.array([2.1, 2.3, 1.9]))
    x = rng.uniform(-5.0, 7.0, (50, 3))
    n = rng.integers(-3, 4, (50, 3)).astype(np.float64)
    bt, bj = torch.as_tensor(lattice), jnp.asarray(lattice)
    np.testing.assert_allclose(
        pairs.lattice_cart(torch.as_tensor(n), bt).numpy(),
        np.asarray(jpairs.lattice_cart(jnp.asarray(n), bj)), rtol=0,
        atol=1e-14)
    np.testing.assert_allclose(
        cells.wrap_offsets(torch.as_tensor(x), bt).numpy(),
        np.asarray(jcells.wrap_offsets(jnp.asarray(x), bj)), rtol=0,
        atol=1e-13)
    np.testing.assert_allclose(
        pairs.frac_coords(torch.as_tensor(x), bt).numpy(),
        np.asarray(jpairs.frac_coords(jnp.asarray(x), bj)), rtol=1e-14)
    np.testing.assert_allclose(pairs.plane_widths(bt).numpy(),
                               np.asarray(jpairs.plane_widths(bj)),
                               rtol=1e-14)
    g_t = pairs.reciprocal_metric(bt, torch.float64).numpy()
    g_j = np.asarray(jpairs.reciprocal_metric(bj, jnp.float64))
    assert np.abs(g_t - g_j).max() <= 1e-12 * np.abs(g_j).max()
    # wrapped positions lie in the primary cell
    f = pairs.frac_coords(torch.as_tensor(x) - cells.wrap_offsets(
        torch.as_tensor(x), bt), bt)
    assert float(f.min()) >= -1e-12 and float(f.max()) < 1.0 + 1e-12
    # an orthorhombic [3] box keeps its diagonal metric
    ortho = torch.tensor([2.1, 2.3, 1.9], dtype=torch.float64)
    g_o = pairs.reciprocal_metric(ortho, torch.float64)
    assert torch.equal(g_o, torch.diag(torch.diagonal(g_o)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_binning_slots_equal_jax_on_a_sheared_box(dtype):
    """Fractional binning: slots and inverse slots bit-equal to the JAX
    package's on the sheared lattice, with no overflow."""
    jsys, sys_t, pos, _, _ = _systems("cell", "pme", dtype)
    spec = jsys.spec
    npdt = np.float64 if dtype == torch.float64 else np.float32
    x = np.asarray(pos, npdt)
    sj, ij, oj = jcells.build_cell_list_full(
        jnp.asarray(x), jsys.box, spec.cell_grid, spec.cell_capacity)
    st, it, ot = cells.build_cell_list_full(
        torch.as_tensor(x), sys_t.box, spec.cell_grid, spec.cell_capacity)
    assert int(oj) == int(ot) == 0
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(it.numpy(), np.asarray(ij))


@pytest.fixture(scope="module")
def tri_blocks():
    """The JAX package's cell blocks of the sheared box (f64) and the
    port's copies."""
    jsys, sys_t, pos, _, _ = _systems("cell", "pme")
    spec = jsys.spec
    x = jnp.asarray(pos)
    slots, inv, _ = jcells.build_cell_list_full(x, jsys.box, spec.cell_grid,
                                                spec.cell_capacity)
    jb = jcells.blockify(x, jax_charges(x, jsys), jsys, slots, inv)
    ids = slots.reshape(jb.x.shape)
    return dict(jsys=jsys, sys_t=sys_t, jb=jb, ids=ids,
                tb=port_blocks(jb, torch.float64),
                ids_t=torch.as_tensor(np.array(ids)))


def test_plain_walk_matches_jax_on_a_sheared_box(tri_blocks):
    """The plain walk's energy, dE/dx and dE/dq on the same blocks against
    the JAX package's direct_energy_on_blocks and its gradients, f64
    within 1e-10 (lattice-row image offsets on both sides)."""
    s = tri_blocks
    jsys = s["jsys"]
    e_j, g_j = jax.value_and_grad(
        lambda b: jcells.direct_energy_on_blocks(b, s["ids"], jsys))(s["jb"])
    e_t, g_t, dq_t = direct_walk_plain(*s["tb"], s["ids_t"], s["sys_t"].box,
                                       jsys.n_atoms, jsys.spec.alpha,
                                       jsys.spec.cutoff)
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    for k, f in enumerate(("x", "y", "z")):
        assert rel_err(g_t[k], getattr(g_j, f)) <= 1e-10, f
    assert rel_err(dq_t, g_j.q) <= 1e-10


def test_kernel_traversal_matches_plain_walk_on_a_sheared_box():
    """The CUDA kernel's traversal (emulated in f64: the 27 tiles with the
    lattice rows of their image offsets added, culled against the i atoms'
    bounding box in Cartesian space, small lists that overflow) against
    the plain walk within 1e-12, on the sheared box's blocks after every
    atom moved up to 0.03 nm per axis past its frozen binning."""
    force, pos, _, box = water_box(n_side=6, flux="water", cutoff=0.42,
                                   seed=3)
    system = force.create_system(box=_shear(box), dtype=torch.float64,
                                 direct_method="cell", recip_method="pme",
                                 device="cpu")
    x = torch.as_tensor(pos)
    nb = build_neighbor_state(x, system)
    x = x + torch.as_tensor(np.random.default_rng(6).uniform(
        -0.03, 0.03, pos.shape))
    b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                       nb.inv_slot, wrap=nb.wrap)
    args = (*b, nb.slots.reshape(b.x.shape), system.box, system.n_atoms,
            system.spec.alpha, system.spec.cutoff)
    e_f, g_f, dq_f, flushes = _kernel_traversal(*args)
    e_p, g_p, dq_p = direct_walk_plain(*args)
    assert flushes > 0
    assert abs(float(e_f - e_p)) <= 1e-12 * abs(float(e_p))
    assert rel_err(g_f, g_p) <= 1e-12 and rel_err(dq_f, dq_p) <= 1e-12


def _jax_column_inputs(jb, ids, jsys):
    """The JAX package's Pallas-route spread inputs (qwlxt, wlyt, wzt,
    zorg, offsets, pad_xy), as ``pme_cell_pallas_reciprocal_energy`` forms
    them before it calls the kernel."""
    spec = jsys.spec
    order, dtype = spec.pme_order, jb.x.dtype
    ngx, ngy, ngz = spec.cell_grid
    gx, gy, gz = spec.pme_grid
    qv = jnp.where(ids < jsys.n_atoms, jb.q, 0.0)

    def weights(coord, n_cells, grid_n, length, axis):
        wl, org, w = jpme._cell_patch_weights(
            coord, n_cells, grid_n, length, spec.pme_slack[axis], axis,
            order, dtype, transposed=True)
        return wl, org + order + spec.pme_slack[axis], w

    (cx, lx), (cy, ly), (cz, lz) = jpme._block_spread_coords(jb, jsys.box)
    wlxt, opx, wx = weights(cx, ngx, gx, lx, 0)
    wlyt5, opy, wy = weights(cy, ngy, gy, ly, 1)
    uz = cz * (gz / lz)
    org_f = jnp.floor(uz) - (order - 1)
    tzk = (uz - org_f)[:, :, None, :, :] - jnp.arange(
        order, dtype=dtype).reshape(1, 1, order, 1, 1)
    n_col, rows = ngx * ngy, ngz * jb.x.shape[-1]
    wyp = -(-wy // 8) * 8
    offsets = (tuple(int(opx[c // ngy]) for c in range(n_col)),
               tuple(int(opy[c % ngy]) for c in range(n_col)))
    return ((qv[:, :, None] * wlxt).reshape(n_col, wx, rows),
            jnp.pad(wlyt5.reshape(n_col, wy, rows),
                    ((0, 0), (0, wyp - wy), (0, 0))),
            jpme.bspline(tzk, order).reshape(n_col, order, rows),
            jnp.mod(org_f, gz).astype(jnp.int32).reshape(n_col, 1, rows),
            offsets, (int(opx.max()) + wx, int(opy.max()) + wyp, gz))


def test_spread_inputs_and_influence_match_jax_on_a_sheared_box(tri_blocks):
    """The fractional spread coordinates: the port's column spread inputs
    against the JAX package's Pallas-route layout, the weights within
    1e-12 of their max, the z origins, patch offsets and padded mesh
    equal; the triclinic influence function within 1e-12; the cell-route
    reciprocal energy within 1e-10 and its gradients within 1e-8 of
    their max (the JAX cell-blocked spread)."""
    s = tri_blocks
    jsys, sys_t = s["jsys"], s["sys_t"]
    spec = jsys.spec
    ins_t = pme.column_spread_inputs(s["tb"], s["ids_t"], sys_t)
    ins_j = _jax_column_inputs(s["jb"], s["ids"], jsys)
    for k in range(3):                       # qwlxt, wlyt, wzt
        assert rel_err(ins_t[k], ins_j[k]) <= 1e-12, k
    assert np.array_equal(ins_t[3].numpy(), np.asarray(ins_j[3]))
    assert ins_t[4:] == ins_j[4:]
    d_t = pme.influence_function(spec.pme_grid, sys_t.box, spec.alpha,
                                 spec.pme_order)
    d_j = jpme.influence_function(spec.pme_grid, jsys.box, spec.alpha,
                                  spec.pme_order)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-12,
                               atol=0)
    e_j, g_j = jax.value_and_grad(
        lambda b: jpme.pme_cell_reciprocal_energy(b, s["ids"], jsys))(
            s["jb"])
    leaves = [getattr(s["tb"], f).clone().requires_grad_(True)
              for f in ("x", "y", "z", "q")]
    e_t = pme.pme_cell_column_reciprocal_energy(
        cells.CellBlocks(*leaves, s["tb"].hs, s["tb"].se), s["ids_t"], sys_t)
    grads = torch.autograd.grad(e_t, leaves)
    assert abs(float(e_t.detach()) - float(e_j)) <= 1e-10 * abs(float(e_j))
    for f, g in zip(("x", "y", "z", "q"), grads):
        assert rel_err(g, getattr(g_j, f)) <= 1e-8, f


def test_slack_covers_fractional_drift():
    """The planner's PME slack, set from the Cartesian skin over the mesh
    spacing across each lattice plane, covers the drift in fractional
    mesh units: an atom moved by up to half the skin moves at most
    ``pme_slack`` mesh points along every axis."""
    force, pos, _, box = water_box(n_side=6, flux="water", cutoff=0.42,
                                   seed=3)
    system = force.create_system(box=_shear(box), dtype=torch.float64,
                                 direct_method="cell", recip_method="pme",
                                 device="cpu")
    spec = system.spec
    widths = pairs.plane_widths(system.box)
    skin = float(torch.min(widths / torch.tensor(spec.cell_grid)
                           - spec.cutoff))
    rng = np.random.default_rng(2)
    d = rng.standard_normal((2000, 3))
    d *= 0.5 * skin / np.linalg.norm(d, axis=1, keepdims=True)
    du = pairs.frac_coords(torch.as_tensor(d), system.box) * torch.tensor(
        spec.pme_grid, dtype=torch.float64)
    assert bool((du.abs().max(dim=0).values
                 <= torch.tensor(spec.pme_slack, dtype=torch.float64)).all())


ROUTES = [("cell", "pme"), ("cell", "xla"), ("dense", "xla")]


@pytest.mark.parametrize("route", ROUTES, ids=["-".join(r) for r in ROUTES])
def test_energy_and_forces_match_jax_f64_on_a_sheared_box(route):
    """Each component and the total energy within 1e-10 relative of the
    JAX package in f64, forces within 1e-10 of their max: the cell + SPME
    route, the cell + classical route and the dense + classical route on
    the sheared box (flux="bond_angle", so q(x) enters)."""
    jsys, sys_t, pos, _, _ = _systems(*route, flux="bond_angle")
    x_j, x_t = jnp.asarray(pos), torch.as_tensor(pos)
    comps_j = jenergy._energy_components(x_j, jsys)
    comps_t = energy.energy_components(x_t, sys_t)
    assert list(comps_t) == list(comps_j)
    for k, v in comps_t.items():
        assert abs(float(v) - float(comps_j[k])) <= 1e-10 * abs(
            float(comps_j[k])), k
    e_j, f_j = jenergy.energy_and_forces(x_j, jsys)
    e_t, f_t = energy.energy_and_forces(x_t, sys_t)
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert rel_err(f_t, f_j) <= 1e-10


def test_sheared_box_matches_bruteforce_oracle():
    """The dense + classical route on tests/test_triclinic.py's 3^3 box
    against its independent NumPy oracle (27-image minimum search, full
    k-space loop), fixed charges, within 1e-10."""
    force, pos, _, box = jax_water_box(n_side=3, flux="none", cutoff=0.42,
                                       seed=21)
    lattice = _shear(box)
    jsys = force.create_system(box=lattice, dtype=jnp.float64,
                               recip_method="xla")
    sys_t = port_system(jsys)
    spec = sys_t.spec
    e_oracle = _oracle_triclinic(
        pos, np.asarray(jsys.q0), np.asarray(jsys.sigma),
        np.asarray(jsys.epsilon), np.asarray(jsys.exclusions).tolist(),
        lattice, spec.cutoff, spec.alpha, spec.kmax)
    e = float(energy.energy_and_forces(torch.as_tensor(pos), sys_t)[0])
    assert abs(e - e_oracle) <= 1e-10 * abs(e_oracle)


def test_reciprocal_energy_from_sf_takes_the_cross_terms():
    """Classical Ewald on a sheared lattice: the port's structure factors
    and reciprocal energy against the JAX package's in f64 within 1e-12."""
    rng = np.random.default_rng(8)
    lattice = _shear(np.array([2.0, 2.2, 1.8]))
    x = rng.uniform(0.0, 2.0, (60, 3))
    q = rng.uniform(-1.0, 1.0, 60)
    kmax, alpha = (5, 6, 4), 3.1
    e_t = ewald.reciprocal_energy(torch.as_tensor(x), torch.as_tensor(q),
                                  torch.as_tensor(lattice), alpha, kmax)
    e_j = jewald.reciprocal_energy(jnp.asarray(x), jnp.asarray(q),
                                   jnp.asarray(lattice), alpha, kmax)
    assert abs(float(e_t) - float(e_j)) <= 1e-12 * abs(float(e_j))


def test_diagonal_matrix_box_equals_the_edge_box():
    """A diagonal [3, 3] box collapses to the [3] box when built (same
    spec, same energy bits), as in the JAX package."""
    force, pos, _, box = water_box(n_side=3, flux="water", cutoff=0.42)
    s_vec = force.create_system(box=box, dtype=torch.float64, device="cpu")
    s_mat = force.create_system(box=np.diag(box), dtype=torch.float64,
                                device="cpu")
    assert s_mat.box.ndim == 1 and s_mat.spec == s_vec.spec
    x = torch.as_tensor(pos)
    assert float(energy.energy_and_forces(x, s_vec)[0]) == \
        float(energy.energy_and_forces(x, s_mat)[0])


@pytest.mark.parametrize("recip", ["pme", "xla"])
def test_f32_force_rms_within_budget_on_a_sheared_box(recip):
    """The port's f32 cell route on tests/test_triclinic.py's 7^3 sheared
    box: force RMS within 1e-4 of the JAX package's f64 forces."""
    force, pos, _, box = jax_water_box(n_side=7, flux="bond_angle",
                                       cutoff=0.65, seed=13)
    lattice = _shear(box)
    jsys64 = force.create_system(box=lattice, dtype=jnp.float64,
                                 direct_method="cell")
    _, f64 = jenergy.energy_and_forces(jnp.asarray(pos), jsys64)
    jsys32 = force.create_system(box=lattice, dtype=jnp.float32,
                                 direct_method="cell", recip_method=recip)
    sys32 = port_system(jsys32, torch.float32)
    _, f32 = energy.energy_and_forces(torch.as_tensor(pos).float(), sys32)
    f64 = np.asarray(f64)
    err = np.sqrt(np.mean((f32.double().numpy() - f64) ** 2)
                  / np.mean(f64 ** 2))
    assert err < 1e-4, err


def test_nve_neighbor_reuse_matches_jax_on_a_sheared_box():
    """20 NVE steps of the cell + SPME route with the neighbor state rebuilt
    every 5 (frozen lattice wrap offsets between rebuilds) and the water
    bonds and angles: per-step energies within 1e-10 relative and
    positions within 1e-9 nm of the JAX trajectory, f64."""
    from chargeflux_tpu.integrate import (init_state_nb as jinit_state,
                                          make_nb_energy_fn as jmake,
                                          nve_trajectory_nb as jnve)
    from chargeflux_tpu.models import water_bonded_params as jbonded
    from chargeflux_tpu_torch import integrate
    from chargeflux_tpu_torch.models import water_bonded_params

    jsys, sys_t, pos, masses, lattice = _systems("cell", "pme")
    n_w = pos.shape[0] // 3
    je_fn, jinit = jmake(jsys, bonded=jbonded(n_w, box=lattice,
                                              dtype=jnp.float64))
    js = jinit_state(jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos)),
                     je_fn, jinit)
    jfin, jes = jnve(js, je_fn, jinit, jnp.asarray(masses), 5e-4, 20,
                     rebuild_every=5)
    e_fn, init_nb = integrate.make_nb_energy_fn(
        sys_t, bonded=water_bonded_params(n_w, box=lattice,
                                          dtype=torch.float64, device="cpu"))
    s = integrate.init_state_nb(torch.as_tensor(pos),
                                torch.zeros((pos.shape[0], 3),
                                            dtype=torch.float64),
                                e_fn, init_nb)
    fin, es = integrate.nve_trajectory_nb(s, e_fn, init_nb,
                                          torch.as_tensor(masses), 5e-4, 20,
                                          rebuild_every=5)
    assert torch.isfinite(es).all()
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-10)
    assert np.abs(fin.positions.numpy()
                  - np.asarray(jfin.positions)).max() <= 1e-9
