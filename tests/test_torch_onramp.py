"""The port's on-ramps (``models.system_from_pdb``,
``models.water_system_from_pdb``) and ``models.water_cluster`` held
against the JAX package's: the same PDB file gives the same particle,
exception and flux rows, masses, box and bonded rows (with a chain break
too), the same errors, and on the on-ramp system with backbone torsions
the same f64 energy and forces; a water box past resseq 9999 gives the
same permutation."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import models as jmodels
from chargeflux_tpu.bonded import BondedParams as JBondedParams
from chargeflux_tpu.integrate import make_energy_fn as j_make_energy_fn
from chargeflux_tpu_torch import models as pmodels
from chargeflux_tpu_torch.bonded import BondedParams, bonded_energy
from chargeflux_tpu_torch.energy import energy_and_forces
from chargeflux_tpu_torch.utils.measure import (backbone_torsions,
                                                peptide_tables,
                                                write_peptide_pdb)
from chargeflux_tpu_torch.utils.trajectory import write_pdb

import jax


def _rows(force):
    """Every builder row of a CoulForce, by its getters."""
    get = [("Particle", force.getNumParticles), ("Exception",
           force.getNumExceptions), ("FluxBond", force.getNumFluxBonds),
           ("FluxAngle", force.getNumFluxAngles),
           ("FluxWater", force.getNumFluxWaters)]
    return {kind: [tuple(getattr(force, f"get{kind}Parameters")(i))
                   for i in range(count())] for kind, count in get}


def _both(path, cutoff=0.45):
    from chargeflux_tpu.models import ResidueParams as JResidueParams

    j = jmodels.system_from_pdb(path, peptide_tables(JResidueParams),
                                cutoff=cutoff)
    p = pmodels.system_from_pdb(path, peptide_tables(), cutoff=cutoff)
    return j, p


@pytest.mark.parametrize("gap", [None, 1])
def test_system_from_pdb_rows_equal_jax(tmp_path, gap):
    path = str(tmp_path / "pep.pdb")
    write_peptide_pdb(path, n_res=4, n_side=4, resseq_gap_after=gap)
    (jf, jpos, jm, jbox, jkw), (pf, ppos, pm, pbox, pkw) = _both(path)
    assert _rows(jf) == _rows(pf)
    assert (jf.usesPeriodicBoundaryConditions()
            == pf.usesPeriodicBoundaryConditions())
    assert jf.getCutoffDistance() == pf.getCutoffDistance()
    np.testing.assert_array_equal(jpos, ppos)
    np.testing.assert_array_equal(jm, pm)
    np.testing.assert_array_equal(jbox, pbox)
    assert sorted(jkw) == sorted(pkw)
    for key in jkw:
        np.testing.assert_array_equal(jkw[key], pkw[key])
    # a break (resseq gap) drops the links across it: one link bond fewer
    n_link = 3 - (gap is not None)
    assert len(pkw["bond_idx"]) == 2 * 4 + n_link + 2 * (len(pm) - 12) // 3


def _edit_pdb(path, out, fn):
    lines = open(path).read().splitlines(keepends=True)
    with open(out, "w") as fh:
        fh.writelines(fn(lines))
    return out


def _atoms(lines):
    return [i for i, ln in enumerate(lines) if ln.startswith("ATOM")]


ERRORS = {
    "missing residue": lambda ls: [ln.replace(" GLY ", " ALA ") for ln in ls],
    "extra atom": lambda ls: [
        ln[:12] + " CB " + ln[16:] if i == _atoms(ls)[1] else ln
        for i, ln in enumerate(ls)],
    "duplicate atom": lambda ls: [
        ln[:12] + " N  " + ln[16:] if i == _atoms(ls)[2] else ln
        for i, ln in enumerate(ls)],
    "missing atom": lambda ls: [ln for i, ln in enumerate(ls)
                                if i != _atoms(ls)[2]],
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_system_from_pdb_errors_equal_jax(tmp_path, case):
    path = str(tmp_path / "pep.pdb")
    write_peptide_pdb(path, n_res=2, n_side=3)
    bad = _edit_pdb(path, str(tmp_path / "bad.pdb"), ERRORS[case])
    from chargeflux_tpu.models import ResidueParams as JResidueParams

    with pytest.raises(Exception) as je:
        jmodels.system_from_pdb(bad, peptide_tables(JResidueParams))
    with pytest.raises(Exception) as pe:
        pmodels.system_from_pdb(bad, peptide_tables())
    assert type(je.value) is type(pe.value)
    assert str(je.value) == str(pe.value)


def test_onramp_energy_with_torsions_equals_jax_f64(tmp_path):
    path = str(tmp_path / "pep.pdb")
    n_res = 4
    write_peptide_pdb(path, n_res=n_res, n_side=5)
    (jf, jpos, _, jbox, jkw), (pf, ppos, _, pbox, pkw) = _both(path)
    tor = backbone_torsions(n_res)
    kw = dict(direct_method="cell", recip_method="pme")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys = jf.create_system(box=jbox, dtype=jnp.float64, **kw)
    psys = pf.create_system(box=pbox, dtype=torch.float64, device="cpu",
                            **kw)
    assert psys.spec.flux_template is not None       # the waters
    jb = JBondedParams.create(box=jbox, pbc=True, dtype=jnp.float64, **jkw,
                              **tor)
    pb = BondedParams.create(box=pbox, pbc=True, dtype=torch.float64,
                             device="cpu", **pkw, **tor)
    e_j, g_j = jax.value_and_grad(j_make_energy_fn(jsys, bonded=jb))(
        jnp.asarray(jpos))
    x = torch.tensor(ppos)
    e_p, f_p = energy_and_forces(x, psys)
    xb = x.clone().requires_grad_(True)
    e_b = bonded_energy(xb, pb)
    (g_b,) = torch.autograd.grad(e_b, xb)
    e = float(e_p + e_b.detach())
    assert abs(e - float(e_j)) <= 1e-10 * abs(float(e_j))
    f = -f_p + g_b
    np.testing.assert_allclose(f.numpy(), np.asarray(g_j),
                               atol=1e-10 * float(np.abs(g_j).max()))


def test_water_system_from_pdb_perm_equals_jax_past_resseq_9999(tmp_path):
    """10,010 waters, resseq wrapped at 9999 by write_pdb, each residue's
    atoms written H1, O, H2 (so the builder must reorder them)."""
    n_w = 10010
    rng = np.random.default_rng(4)
    pos = rng.uniform(0.0, 6.0, (3 * n_w, 3))
    names = ["H1", "O", "H2"] * n_w
    path = str(tmp_path / "w.pdb")
    write_pdb(path, pos, box=np.full(3, 6.0), names=names,
              resnames=["HOH"] * (3 * n_w),
              resseq=np.repeat(np.arange(1, n_w + 1), 3).tolist(),
              symbols=[n[0] for n in names])
    j = jmodels.water_system_from_pdb(path, cutoff=0.9)
    p = pmodels.water_system_from_pdb(path, cutoff=0.9)
    np.testing.assert_array_equal(j[4], p[4])
    np.testing.assert_array_equal(j[1], p[1])
    np.testing.assert_array_equal(j[2], p[2])
    np.testing.assert_array_equal(j[3], p[3])
    assert _rows(j[0])["FluxBond"][:6] == _rows(p[0])["FluxBond"][:6]
    assert p[0].getNumParticles() == 3 * n_w
    np.testing.assert_array_equal(p[4][:3], [1, 0, 2])


def test_water_system_from_pdb_rejects_what_jax_rejects(tmp_path):
    path = str(tmp_path / "w.pdb")
    write_pdb(path, np.zeros((3, 3)), names=["O", "O", "H1"],
              resnames=["HOH"] * 3, resseq=[1, 1, 1], symbols=["O", "O", "H"])
    with pytest.raises(ValueError) as je:
        jmodels.water_system_from_pdb(path)
    with pytest.raises(ValueError) as pe:
        pmodels.water_system_from_pdb(path)
    assert str(je.value) == str(pe.value)


@pytest.mark.parametrize("flux", ["bond_angle", "water"])
def test_water_cluster_equals_jax_f64(flux):
    jf, jpos, jm = jmodels.water_cluster(n_side=3, flux=flux, seed=2)
    pf, ppos, pm = pmodels.water_cluster(n_side=3, flux=flux, seed=2)
    np.testing.assert_array_equal(jpos, ppos)
    np.testing.assert_array_equal(jm, pm)
    assert _rows(jf) == _rows(pf)
    jsys = jf.create_system(dtype=jnp.float64)
    psys = pf.create_system(dtype=torch.float64, device="cpu")
    e_j, g_j = jax.value_and_grad(j_make_energy_fn(jsys))(jnp.asarray(jpos))
    e_p, f_p = energy_and_forces(torch.tensor(ppos), psys)
    assert abs(float(e_p) - float(e_j)) <= 1e-10 * abs(float(e_j))
    np.testing.assert_allclose(-f_p.numpy(), np.asarray(g_j),
                               atol=1e-10 * float(np.abs(g_j).max()))
    assert pmodels.WATER_MASSES == jmodels.WATER_MASSES
