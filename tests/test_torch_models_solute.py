"""PyTorch port: the solvated-chain and salt-water models
(``models.solvated_chain_box``, ``models.salt_water_box``), held to the JAX
package's builders (tests/test_heterogeneous.py and test_salt_model.py's
boxes): the builders' arrays, the chain's remainder rows, energy and
forces in f64 on the cell and dense routes, neutrality, the NumPy oracle,
and a short NVE run through the heterogeneous bonded terms."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
import oracle
from chargeflux_tpu import energy_and_forces as jax_energy_and_forces
from chargeflux_tpu.models import salt_water_box as jax_salt
from chargeflux_tpu.models import solvated_chain_box as jax_chain
from chargeflux_tpu_torch import integrate
from chargeflux_tpu_torch.bonded import BondedParams
from chargeflux_tpu_torch.models import salt_water_box, solvated_chain_box

from torch_helpers import port_system, rel_err

# the module: the package attribute "energy" is the function, as in JAX
energy = importlib.import_module("chargeflux_tpu_torch.energy")

torch.set_num_threads(2)

#: (builder kwargs) of tests/test_heterogeneous.py's chain box and
#: tests/test_salt_model.py's salt box
CHAIN = dict(n_side=6, n_solute_sites=5, cutoff=0.58, seed=7)
SALT = dict(n_side=6, n_ion_pairs=3, cutoff=0.55)


def _spec_fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


@pytest.mark.parametrize("model", ["chain", "salt"])
def test_builders_match_jax(model):
    """Equal arguments give the same force (particles, exclusions, flux
    terms, cutoff), positions, masses, box and, for the chain, bonded
    rows; both packages plan the same spec on the cell route."""
    if model == "chain":
        out_t, out_j = solvated_chain_box(**CHAIN), jax_chain(**CHAIN)
    else:
        out_t, out_j = salt_water_box(**SALT), jax_salt(**SALT)
    assert out_t[0].to_dict() == out_j[0].to_dict()
    for a, b in zip(out_t[1:4], out_j[1:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if model == "chain":
        kw_t, kw_j = out_t[4], out_j[4]
        assert set(kw_t) == set(kw_j)
        for k in kw_t:
            np.testing.assert_array_equal(np.asarray(kw_t[k]),
                                          np.asarray(kw_j[k]))
    s_t = out_t[0].create_system(box=out_t[3], dtype=torch.float64,
                                 direct_method="cell", device="cpu")
    s_j = out_j[0].create_system(box=out_j[3], dtype=jnp.float64,
                                 direct_method="cell")
    f_t, f_j = _spec_fields(s_t.spec), _spec_fields(s_j.spec)
    for k in ("flux_template", "excl_template"):
        assert (f_t.pop(k) is None) == (f_j.pop(k) is None)
    assert f_t == {k: (tuple(v) if isinstance(v, list) else v)
                   for k, v in f_j.items()}


def test_chain_takes_the_remainder_rows():
    """The 15-bead chain (one component wider than the template stride
    limit) lands on the remainder rows of the flux terms, the exclusions
    and the bonded terms; the waters template at an offset; the fixed-
    order plans cover exactly the remainder rows."""
    force, pos, masses, box, bonded_kw = solvated_chain_box(**CHAIN)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", device="cpu")
    n_chain = 15
    fts = system.spec.flux_template
    assert len(fts.templates) == 1
    tpl = fts.templates[0]
    assert tpl.offset == n_chain and tpl.stride == 3
    assert tpl.count == 6 ** 3 - 5
    assert dict(fts.remainder) == {"bonds": n_chain - 1, "angles": 0,
                                   "waters": 0}
    assert dict(system.spec.excl_template.remainder)["exclusions"] == \
        2 * n_chain - 3
    assert system.flux_plan.idx.numel() == 2 * (n_chain - 1)
    assert system.excl_plan.idx.numel() == 2 * (2 * n_chain - 3)
    bonded = BondedParams.create(box=box, pbc=True, dtype=torch.float64,
                                 device="cpu", **bonded_kw)
    assert dict(bonded.template.remainder) == {"bonds": n_chain - 1,
                                               "angles": n_chain - 2}
    assert bonded.plan.idx.numel() == 2 * (n_chain - 1) + 3 * (n_chain - 2)


def test_bench_hetero_box_has_299_remainder_bonds():
    """bench.py's hetero30k box: its 300-bead chain's 299 flux bonds take
    the remainder rows (bench.py asserts the same)."""
    force, _, _, box, _ = solvated_chain_box(n_side=22, n_solute_sites=100,
                                             cutoff=0.72)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="cell", cell_grid=(8, 8, 8),
                                 device="cpu")
    assert dict(system.spec.flux_template.remainder)["bonds"] == 299


CASES = [("chain", "cell"), ("chain", "dense"), ("salt", "cell"),
         ("salt", "dense")]


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_energy_and_forces_match_jax_f64(case):
    """Energy within 1e-10 relative and forces within 1e-10 of their max
    of the JAX package in f64, on the same system (the JAX builder's,
    converted), SPME on the cell route and classical Ewald on the dense
    one."""
    model, direct = case
    force, pos, _, box = (jax_chain(**CHAIN) if model == "chain"
                          else jax_salt(**SALT))[:4]
    jsys = force.create_system(
        box=box, dtype=jnp.float64, direct_method=direct,
        recip_method="pme" if direct == "cell" else "xla")
    sys_t = port_system(jsys)
    e_j, f_j = jax_energy_and_forces(jnp.asarray(pos), jsys)
    e_t, f_t = energy.energy_and_forces(torch.as_tensor(pos), sys_t)
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert rel_err(f_t, f_j) <= 1e-10


def test_salt_box_is_neutral_and_matches_the_oracle():
    """The port's salt box: neutral, waters a contiguous template prefix,
    and its energy and forces (classical Ewald, cell route) against the
    NumPy f64 oracle within 1e-10 relative and 1e-9 absolute."""
    force, pos, _, box = salt_water_box(**SALT)
    params = helpers.force_to_params(force)
    assert abs(float(np.sum(params["q0"]))) < 1e-12
    assert len(pos) == 3 * (6 ** 3 - 6) + 6
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", recip_method="xla",
                                 device="cpu")
    assert system.spec.excl_template.templates[0].offset == 0
    e, f = energy.energy_and_forces(torch.as_tensor(pos), system)
    eo, fo, _ = oracle.energy_forces_pbc(pos, params, box, 0.55, 1e-4)
    assert abs(float(e) - eo) / abs(eo) < 1e-10
    assert np.max(np.abs(f.numpy() - fo)) < 1e-9


@pytest.mark.parametrize("model", ["chain", "salt"])
def test_dense_matches_cell(model):
    """The port's dense and cell routes agree in f64 (classical Ewald on
    both): energy within 1e-10 relative, forces within 1e-9."""
    force, pos, _, box = (solvated_chain_box(**CHAIN) if model == "chain"
                          else salt_water_box(**SALT))[:4]
    x = torch.as_tensor(pos)
    out = [energy.energy_and_forces(x, force.create_system(
        box=box, dtype=torch.float64, direct_method=d, recip_method="xla",
        device="cpu")) for d in ("cell", "dense")]
    (e_c, f_c), (e_d, f_d) = out
    assert abs(float(e_c) - float(e_d)) <= 1e-10 * abs(float(e_d))
    assert float((f_c - f_d).abs().max()) < 1e-9


def test_chain_nve_matches_jax_f64():
    """10 NVE steps of the chain box (flux charges, exclusions and bonded
    terms each split template + remainder) with the neighbor state rebuilt
    every 5: per-step energies within 1e-10 relative of the JAX
    trajectory, positions within 1e-9 nm."""
    from chargeflux_tpu.bonded import BondedParams as JBondedParams
    from chargeflux_tpu.integrate import (init_state_nb as jinit_state,
                                          make_nb_energy_fn as jmake,
                                          nve_trajectory_nb as jnve)

    force, pos, masses, box, bonded_kw = jax_chain(**CHAIN)
    jsys = force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell", recip_method="pme")
    jb = JBondedParams.create(box=box, pbc=True, dtype=jnp.float64,
                              **bonded_kw)
    je_fn, jinit = jmake(jsys, bonded=jb)
    x = jnp.asarray(pos)
    js = jinit_state(x, jnp.zeros_like(x), je_fn, jinit)
    jfin, jes = jnve(js, je_fn, jinit, jnp.asarray(masses), 2e-5, 10,
                     rebuild_every=5)

    sys_t = port_system(jsys)
    tb = BondedParams.create(box=box, pbc=True, dtype=torch.float64,
                             device="cpu", **bonded_kw)
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    xt = torch.as_tensor(pos)
    s = integrate.init_state_nb(xt, torch.zeros_like(xt), e_fn, init_nb)
    fin, es = integrate.nve_trajectory_nb(s, e_fn, init_nb,
                                          torch.as_tensor(masses), 2e-5, 10,
                                          rebuild_every=5)
    assert torch.isfinite(es).all()
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-10)
    assert np.abs(fin.positions.numpy()
                  - np.asarray(jfin.positions)).max() <= 1e-9
