"""The port's public surface: ``__all__`` of the package, ``models``,
``utils``, ``parallel`` and ``runtime`` equal the JAX package's, each name
resolves, no
module of the port imports jax or the JAX package, and the profiling
helpers: the energy's named phases in a ``torch.profiler`` table, the
trace file and the step timer on the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import chargeflux_tpu
import chargeflux_tpu.models
import chargeflux_tpu.parallel
import chargeflux_tpu.runtime
import chargeflux_tpu.utils
import chargeflux_tpu_torch
import chargeflux_tpu_torch.models
import chargeflux_tpu_torch.parallel
import chargeflux_tpu_torch.runtime
import chargeflux_tpu_torch.utils

from torch_helpers import jax_water

PORT = pathlib.Path(chargeflux_tpu_torch.__file__).parent
PAIRS = {"package": (chargeflux_tpu, chargeflux_tpu_torch),
         "models": (chargeflux_tpu.models, chargeflux_tpu_torch.models),
         "utils": (chargeflux_tpu.utils, chargeflux_tpu_torch.utils),
         "parallel": (chargeflux_tpu.parallel, chargeflux_tpu_torch.parallel),
         "runtime": (chargeflux_tpu.runtime, chargeflux_tpu_torch.runtime)}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_all_lists_equal_jax_and_resolve(name):
    jmod, pmod = PAIRS[name]
    assert list(pmod.__all__) == list(jmod.__all__)
    for n in pmod.__all__:
        assert getattr(pmod, n) is not None


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PORT.parent)) for p in PORT.rglob("*.py")) +
    ["chip_smoke.py"])
def test_no_module_imports_jax_or_the_jax_package(path):
    names = list(_imports(PORT.parent / path))
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                   "chargeflux_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_energy_phases_show_in_a_profiler_table(tmp_path):
    from chargeflux_tpu_torch.energy import energy_and_forces
    from chargeflux_tpu_torch.integrate import make_nb_energy_fn
    from chargeflux_tpu_torch.models import water_bonded_params
    from chargeflux_tpu_torch.utils import profiling

    _, psys, pos, _ = jax_water(5, 0.45, direct_method="cell",
                                recip_method="pme")
    x = torch.tensor(pos)
    bonded = water_bonded_params(len(pos) // 3, box=psys.box.numpy(),
                                 device="cpu")
    e_fn, init_nb = make_nb_energy_fn(psys, bonded=bonded)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.phase_scope("outer"):
            energy_and_forces(x, psys)
            e_fn(x, init_nb(x))
    names = {e.key for e in prof.key_averages()}
    for phase in ("outer", "cf_charges", "cf_binning", "cf_direct",
                  "cf_exclusion", "cf_reciprocal", "cf_bonded",
                  "cf_rebuild"):
        assert phase in names
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_step_timer_on_the_cpu():
    from chargeflux_tpu_torch.utils import step_timer

    with step_timer() as t:
        out = t.sync(torch.ones(3).sum())
    assert float(out) == 3.0 and t.elapsed >= 0.0
    with step_timer(device="cpu") as t2:
        pass
    assert t2.elapsed >= 0.0 and not t2.cuda


@pytest.mark.parametrize("n_res,n_side", [(2, 3), (16, 22)])
def test_peptide_pdb_sizes(tmp_path, n_res, n_side):
    """The on-ramp input of ``utils.measure``: 3 atoms a residue and one
    water per lattice site off the chain's row (31,926 atoms at the chip's
    size), and 3 (n_res - 1) backbone torsions."""
    from chargeflux_tpu_torch.utils.measure import (backbone_torsions,
                                                    write_peptide_pdb)
    from chargeflux_tpu_torch.utils.trajectory import read_pdb

    path = str(tmp_path / "p.pdb")
    pos, box = write_peptide_pdb(path, n_res=n_res, n_side=n_side)
    n = 3 * n_res + 3 * (n_side ** 3 - n_side)
    assert pos.shape == (n, 3)
    assert read_pdb(path).positions.shape == (n, 3)
    np.testing.assert_allclose(box, 0.31 * n_side)
    tor = backbone_torsions(n_res)
    assert tor["torsion_idx"].shape == (3 * n_res - 3, 4)
    assert np.all(np.diff(tor["torsion_idx"], axis=1) == 1)
