"""PyTorch port: the halo route's slab walk (``cells.slab_shell_tables``,
``ops.direct_walk.direct_walk_slab_plain``, ``parallel.halo``).

The slab tables are held to the periodic walk's full-shell tables of the
global grid, mapped through each rank's extended slab; the plain slab
walks of all ranks, cut from one set of periodic blocks, to the periodic
plain walk; and the halo route on gloo groups of 2 and 4 ranks (which on
the CPU runs the plain slab walk) to the JAX package's halo route on as
many CPU devices, computed in this process (the ranks import no JAX), in
f64 and f32, on x slabs and x-by-y bricks, orthorhombic and triclinic,
classical Ewald and the halo PME mesh; then the overflow and moved-box
poisons on every rank."""

import dataclasses

import numpy as np
import pytest
import torch

from chargeflux_tpu_torch import cells
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.energy import energy_components
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.neighbors import build_neighbor_state
from chargeflux_tpu_torch.ops.direct_walk import (direct_walk_plain,
                                                  direct_walk_slab_plain)
from chargeflux_tpu_torch.utils.measure import (shear_box, slab_cells,
                                                slab_walk_args)

from torch_helpers import dist_worker, port_system, run_ranks

torch.set_num_threads(2)

DECOMPS = [(1, 1), (2, 1), (4, 1), (2, 2), (1, 4)]
GRID = (8, 8, 8)


def _water(tri: bool):
    """water_box(n_side=8, cutoff=0.29) on the forced 8^3 grid (1, 2, 4, 8
    divide it), its box sheared into bench.py's tri30k lattice with
    ``tri``: (force, positions, box) in NumPy."""
    force, pos, _, box = water_box(n_side=8, flux="bond_angle", cutoff=0.29,
                                   seed=44)
    return force, pos, (shear_box(box) if tri else box)


@pytest.mark.parametrize("tri", [False, True], ids=["ortho", "tri"])
@pytest.mark.parametrize("decomp", DECOMPS, ids=str)
def test_slab_tables_map_onto_the_global_full_shell(decomp, tri):
    """Every entry of a rank's slab tables names the extended-slab cell
    that holds the global full-shell neighbor, and its image offset plus
    the lattice shift the exchange gave that copy is the global image
    offset: in lattice units, and in Cartesian offsets on the box."""
    nbr, img = cells.slab_shell_tables(GRID, decomp)
    g_nbr, g_img = cells.full_shell_tables(GRID)
    n_own = nbr.shape[0]
    n_ext = n_own + cells.slab_halo_cells(GRID, decomp)
    assert n_own == 512 // (decomp[0] * decomp[1])
    assert nbr.min() >= 0 and nbr.max() < n_ext
    assert not img[..., 0].any()
    rows = _water(tri)[2]
    rows = np.diag(rows) if rows.ndim == 1 else rows
    for rank in range(decomp[0] * decomp[1]):
        cell, shift = slab_cells(GRID, decomp, rank)
        assert len(cell) == n_ext and not shift[:n_own].any()
        own = cell[:n_own]
        assert np.array_equal(cell[nbr], g_nbr[own])
        total = img + shift[nbr]
        assert np.array_equal(total, g_img[own])
        np.testing.assert_allclose(total @ rows, g_img[own] @ rows,
                                   rtol=0, atol=1e-12)
        assert (nbr[:, 13] == np.arange(n_own)).all()


def _walk_args(tri, dtype):
    force, pos, box = _water(tri)
    system = force.create_system(box=box, dtype=dtype, direct_method="cell",
                                 cell_grid=GRID, device="cpu")
    x = torch.tensor(pos, dtype=dtype)
    nb = build_neighbor_state(x, system)
    b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                       nb.inv_slot, wrap=nb.wrap)
    ids = nb.slots.reshape(b.x.shape).to(torch.int32)
    return (*b, ids, system.box, system.n_atoms, system.spec.alpha,
            system.spec.cutoff)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("tri", [False, True], ids=["ortho", "tri"])
@pytest.mark.parametrize("decomp", [(1, 1), (4, 1), (2, 2)], ids=str)
def test_plain_slab_walks_sum_to_the_periodic_walk(decomp, tri, dtype):
    """The ranks' plain slab walks on slabs cut from one set of periodic
    blocks: their energies sum to the periodic plain walk's, and each
    rank's dE/dx and dE/dq are the periodic walk's on its owned cells
    (f64 1e-12 relative, f32 1e-5)."""
    args = _walk_args(tri, dtype)
    e_ref, g_ref, dq_ref = direct_walk_plain(*args)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    cap = args[0].shape[-1]
    e_sum = 0.0
    for rank in range(decomp[0] * decomp[1]):
        e, g, dq = direct_walk_slab_plain(*slab_walk_args(args, decomp,
                                                          rank))
        e_sum += float(e)
        own = torch.as_tensor(slab_cells(GRID, decomp, rank)[0])
        own = own[:g.shape[1]]
        g_own = g_ref.reshape(3, -1, cap)[:, own]
        scale = float(g_ref.abs().max())
        assert float((g - g_own).abs().max()) <= tol * scale
        assert float((dq - dq_ref.reshape(-1, cap)[own]).abs().max()) <= (
            tol * float(dq_ref.abs().max()))
    assert abs(e_sum - float(e_ref)) <= tol * abs(float(e_ref))


def _jax_system(tri, dtype, recip):
    import jax.numpy as jnp

    from chargeflux_tpu.models import water_box as jax_water_box
    from chargeflux_tpu.pme import pme_halo_mesh

    force, pos, _, box = jax_water_box(n_side=8, flux="bond_angle",
                                       cutoff=0.29, seed=44)
    if tri:
        box = shear_box(box)
    jsys = force.create_system(box=box, dtype=dtype, direct_method="cell",
                               cell_grid=GRID)
    spec = jsys.spec
    if recip == "pme":
        spec = dataclasses.replace(spec, recip_method="pme",
                                   pme_grid=pme_halo_mesh(spec))
    else:
        spec = dataclasses.replace(spec, recip_method="xla")
    return dataclasses.replace(jsys, spec=spec), jnp.asarray(pos, dtype)


def _jax_halo(jsys, x, decomp):
    import jax
    from jax.sharding import Mesh

    from chargeflux_tpu.parallel.halo import make_halo_energy_fn

    world = decomp[0] * decomp[1]
    mesh = Mesh(np.array(jax.devices()[:world]), ("space",))
    e, g = jax.value_and_grad(make_halo_energy_fn(jsys, mesh,
                                                  decomp=decomp))(x)
    return float(e), -np.asarray(g, np.float64)


# (decomp, dtype, triclinic, reciprocal route)
HALO_CASES = [
    ((2, 1), "f64", False, "xla"),
    ((4, 1), "f64", False, "pme"),
    ((2, 2), "f64", False, "pme"),
    ((2, 2), "f64", True, "xla"),
    ((4, 1), "f32", False, "xla"),
    ((2, 2), "f32", True, "xla"),
]


@pytest.mark.parametrize("case", HALO_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"{'tri' if c[2] else 'ortho'}-{c[3]}")
def test_plain_slab_walk_matches_the_jax_halo_route(case, tmp_path):
    """The halo route's energy and forces on every rank against the JAX
    package's halo route on the same decomposition: f64 within 1e-10
    relative in the energy and the force RMS; f32 within 1e-5, the energy
    relative to the sum of its components' magnitudes (chip_smoke's
    scale for f32 energies)."""
    import jax.numpy as jnp

    decomp, dname, tri, recip = case
    jdtype = jnp.float64 if dname == "f64" else jnp.float32
    dtype = torch.float64 if dname == "f64" else torch.float32
    jsys, x = _jax_system(tri, jdtype, recip)
    e_ref, f_ref = _jax_halo(jsys, x, decomp)
    psys = port_system(jsys, dtype)
    xt = torch.tensor(np.asarray(x))
    res = run_ranks(decomp[0] * decomp[1], dist_worker,
                    ("halo", psys, xt, {"decomp": decomp}), tmp_path)
    if dname == "f64":
        tol, scale = 1e-10, abs(e_ref)
    else:
        tol = 1e-5
        sys64 = port_system(jsys, torch.float64)
        with torch.no_grad():
            scale = sum(float(v.abs()) for v in energy_components(
                xt.double(), sys64).values())
    rms = float(np.sqrt(np.mean(f_ref ** 2)))
    for out in res:
        assert abs(float(out["e"]) - e_ref) <= tol * scale
        d = np.sqrt(np.mean((out["f"].astype(np.float64) - f_ref) ** 2))
        assert d <= tol * rms


@pytest.mark.parametrize("decomp", [(4, 1), (2, 2)], ids=str)
def test_slab_walk_poisons_every_rank(decomp, tmp_path):
    """A binning overflow on the slabs (capacity 2) and a box shrunk below
    the cutoff poison the energy and every force to NaN on every rank;
    the same positions at the creation box give finite values."""
    force, pos, box = _water(False)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", cell_grid=GRID,
                                 device="cpu")
    tiny = system._swap(spec=dataclasses.replace(system.spec,
                                                 cell_capacity=2))
    res = run_ranks(decomp[0] * decomp[1], dist_worker,
                    ("poisons", system, torch.tensor(pos),
                     {"decomp": decomp, "tiny": tiny}), tmp_path)
    for out in res:
        e, f = out["ok"]
        assert np.isfinite(e) and np.isfinite(f).all()
        for key in ("overflow", "shrunk"):
            e, f = out[key]
            assert np.isnan(e) and np.isnan(f).all()


def test_halo_spread_work_runs_on_the_blocks_of_a_world_of_one():
    """``utils.measure.halo_spread_work`` (chip_smoke 10c times it): the
    halo mesh's spread forward and backward on the blocks of a world of
    one gives a finite gradient for every block column, zero on the
    sentinel slots' positions."""
    from chargeflux_tpu_torch.pme import pme_halo_mesh
    from chargeflux_tpu_torch.utils.measure import halo_spread_work

    force, pos, box = _water(False)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="cell", recip_method="pme",
                                 cell_grid=GRID, device="cpu")
    system = system._swap(spec=dataclasses.replace(
        system.spec, pme_grid=pme_halo_mesh(system.spec)))
    x = torch.tensor(pos, dtype=torch.float32)
    (g,) = halo_spread_work(system, x)()
    cap = system.spec.cell_capacity
    assert g.shape == GRID + (cap, 8) and bool(torch.isfinite(g).all())
    nb = build_neighbor_state(x, system)
    empty = nb.slots.reshape(GRID + (cap,)) >= system.n_atoms
    assert float(g[..., 3][~empty].abs().max()) > 0.0
    assert not g[..., :4][empty].any()
