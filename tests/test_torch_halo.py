"""PyTorch port: the halo decomposition (``parallel.halo``) and the halo
PME mesh (``pme.pme_halo_mesh`` / ``pme_halo_local_mesh``) on gloo groups
of 2 and 4 ranks on the CPU in f64, against the JAX package's
single-device energy and forces computed in this process (the ranks import
no JAX): x-slabs and x-by-y bricks, classical Ewald and the distributed
SPME, the overflow poison, moved boxes and the creation-time refusal, and
NVE and NPT over the halo energy."""

import dataclasses

import numpy as np
import pytest
import torch

from chargeflux_tpu_torch.parallel.halo import halo_compatible, halo_decomp
from chargeflux_tpu_torch.pme import pme_halo_mesh

from torch_helpers import dist_worker, port_system, run_ranks

torch.set_num_threads(1)


def _small(seed=44, **kw):
    import jax.numpy as jnp

    from chargeflux_tpu.models import water_box

    # box 2.4856 nm, cutoff 0.29: an 8^3 cell grid (1, 2, 4, 8 divide it)
    force, pos, _, box = water_box(n_side=8, flux="bond_angle", cutoff=0.29,
                                   seed=seed)
    jsys = force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell", **kw)
    assert jsys.spec.cell_grid == (8, 8, 8)
    return jsys, pos


def _jax_ef(jsys, pos):
    import jax.numpy as jnp

    from chargeflux_tpu.energy import _energy_and_forces

    e, f = _energy_and_forces(jnp.asarray(pos), jsys)
    return float(e), np.asarray(f)


def _pme(jsys, pad_y):
    from chargeflux_tpu.pme import pme_halo_mesh as j_mesh

    grid = j_mesh(jsys.spec, pad_y=pad_y)
    return dataclasses.replace(jsys, spec=dataclasses.replace(
        jsys.spec, recip_method="pme", pme_grid=grid))


def _check(results, e_ref, f_ref, rtol_e=1e-12):
    for out in results:
        np.testing.assert_allclose(out["e"], e_ref, rtol=rtol_e)
        np.testing.assert_allclose(out["f"], f_ref, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("decomp", [(2, 1), (4, 1), (2, 2), (1, 4)])
def test_halo_classical_matches_jax_single_device(decomp, tmp_path):
    jsys, pos = _small()
    e_ref, f_ref = _jax_ef(jsys, pos)
    world = decomp[0] * decomp[1]
    res = run_ranks(world, dist_worker, ("halo", port_system(jsys),
                                         torch.tensor(pos),
                                         {"decomp": decomp}), tmp_path)
    _check(res, e_ref, f_ref)
    # two x-plane exchanges a slab evaluation, two y rows and two x planes
    # for a brick, none in the backward (the halo is exchanged detached);
    # energy, overflow and S(k) all-reduces plus the forces' (a ring of
    # one, Dx = 1, copies locally)
    n_ex = 2 if decomp[1] == 1 else 4
    c = res[0]["collectives"]
    assert c["ppermute"] + c["ppermute_local"] == n_ex
    assert c["ppermute_local"] == (2 if decomp[0] == 1 else 0)
    assert res[0]["collectives"]["all_reduce"] == 5


@pytest.mark.parametrize("decomp", [(2, 1), (2, 2)])
def test_halo_pme_matches_jax_cell_pme_on_the_same_mesh(decomp, tmp_path):
    """The distributed spread (one all-reduce of the charge mesh) against
    the JAX package's single-device cell PME on the halo mesh."""
    jsys, pos = _small()
    jpme = _pme(jsys, pad_y=decomp[1] > 1)
    assert jpme.spec.pme_grid == pme_halo_mesh(port_system(jsys).spec,
                                               pad_y=decomp[1] > 1)
    e_ref, f_ref = _jax_ef(jpme, pos)
    res = run_ranks(decomp[0] * decomp[1], dist_worker,
                    ("halo", port_system(jpme), torch.tensor(pos),
                     {"decomp": decomp}), tmp_path)
    _check(res, e_ref, f_ref, rtol_e=1e-11)


def test_halo_overflow_poisons(tmp_path):
    jsys, pos = _small()
    tiny = dataclasses.replace(jsys, spec=dataclasses.replace(
        jsys.spec, cell_capacity=2))
    res = run_ranks(2, dist_worker, ("overflow", port_system(tiny),
                                     torch.tensor(pos), {}), tmp_path)
    assert all(np.isnan(r["e"]) for r in res)


def test_halo_moved_box_and_guards(tmp_path):
    """A moved box (with the coordinates scaled) matches the JAX package's
    ``with_box`` energy and forces; a shrink below the cutoff poisons; an
    invalid creation-time box raises ``ValueError``."""
    import jax.numpy as jnp

    from chargeflux_tpu.energy import _energy_and_forces
    from chargeflux_tpu.models import water_box

    force, pos, _, box = water_box(n_side=10, flux="bond_angle", cutoff=0.6,
                                   seed=2)
    jsys = force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell", halo_devices=2)
    scales = (1.02, 0.985)
    res = run_ranks(2, dist_worker, ("box", port_system(jsys),
                                     torch.tensor(pos), {"scales": scales}),
                    tmp_path)
    for s in scales:
        e_ref, f_ref = _energy_and_forces(s * jnp.asarray(pos),
                                          jsys.with_box(s * jnp.asarray(box)))
        for out in res:
            e, f = out[s]
            np.testing.assert_allclose(e, float(e_ref), rtol=1e-11)
            np.testing.assert_allclose(f, np.asarray(f_ref), rtol=1e-8,
                                       atol=1e-10)
    for out in res:
        assert np.isnan(out["shrunk"])
        assert "creation-time" in out["refused"]


def test_halo_nve_matches_jax_single_device(tmp_path):
    """Five NVE steps driven by the halo energy reproduce the JAX
    package's single-device trajectory (1e-10)."""
    import jax.numpy as jnp

    from chargeflux_tpu.energy import _energy
    from chargeflux_tpu.integrate import init_state, nve_trajectory

    jsys, pos = _small()
    x = jnp.asarray(pos)
    fn = lambda xx: _energy(xx, jsys)  # noqa: E731
    masses = jnp.ones(x.shape[0], jnp.float64) * 10.0
    fin, es = nve_trajectory(init_state(x, jnp.zeros_like(x), fn), fn,
                             masses, 2e-5, 5)
    res = run_ranks(2, dist_worker, ("nve", port_system(jsys),
                                     torch.tensor(pos),
                                     {"dt": 2e-5, "steps": 5}), tmp_path)
    for out in res:
        np.testing.assert_allclose(out["es"], np.asarray(es), rtol=1e-10)
        np.testing.assert_allclose(out["x"], np.asarray(fin.positions),
                                   rtol=1e-10, atol=1e-12)


def test_npt_over_halo_matches_the_single_device_driver(tmp_path):
    """``npt_langevin_trajectory(energy_fn=halo)`` on 2 ranks reproduces
    the port's single-device NPT run from the same generator seed: the
    barostat's boxes ride the halo energy's ``box`` argument."""
    import jax.numpy as jnp

    from chargeflux_tpu.models import water_box
    from chargeflux_tpu_torch.npt import npt_langevin_trajectory

    force, pos, masses, box = water_box(n_side=6, flux="bond_angle",
                                        cutoff=0.42, seed=7)
    jsys = force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell", halo_devices=2)
    psys = port_system(jsys)
    x = torch.tensor(pos)
    m = torch.tensor(np.asarray(masses))
    kw = dict(dt=5e-4, temperature=250.0, friction=2.0, pressure_bar=1.0,
              n_steps=4, barostat_interval=2)
    xs, _vs, box_s, diag_s = npt_langevin_trajectory(
        x, torch.zeros_like(x), psys, m,
        generator=torch.Generator().manual_seed(11), **kw)
    res = run_ranks(2, dist_worker, ("npt", psys, x,
                                     {"masses": m, "seed": 11, "kw": kw}),
                    tmp_path)
    for out in res:
        assert np.all(np.isfinite(out["energies"]))
        np.testing.assert_allclose(out["box"], box_s.numpy(), rtol=1e-9)
        np.testing.assert_allclose(out["x"], xs.numpy(), rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(out["energies"],
                                   diag_s["energies"].numpy(), rtol=1e-8)


def test_halo_decomp_and_mesh_match_jax():
    """``halo_decomp``, ``halo_compatible`` and ``pme_halo_mesh`` choose
    what the JAX package's do (no ranks needed)."""
    from chargeflux_tpu.parallel.halo import halo_decomp as j_decomp
    from chargeflux_tpu.pme import pme_halo_mesh as j_mesh

    jsys, _ = _small()
    psys = port_system(jsys)
    for ndev in (1, 2, 3, 4, 7, 8, 16, 64):
        assert halo_decomp(psys, ndev) == j_decomp(jsys, ndev)
        assert halo_compatible(psys, ndev) == (j_decomp(jsys, ndev)
                                               is not None)
    g5 = psys._swap(spec=dataclasses.replace(psys.spec, cell_grid=(5, 8, 8)))
    assert halo_decomp(g5, 4) == (1, 4)
    for grid, pme in (((8, 8, 8), (30, 30, 30)), ((11, 11, 11),
                                                  (80, 80, 80)),
                      ((7, 6, 5), (50, 48, 45))):
        spec = dataclasses.replace(jsys.spec, cell_grid=grid, pme_grid=pme)
        for pad_y in (False, True):
            assert pme_halo_mesh(spec, pad_y) == j_mesh(spec, pad_y)
