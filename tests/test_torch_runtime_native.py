"""PyTorch port: ``runtime.native``, the C++ host runtime built into the
port's ``_build/``, against ``tests/oracle.py``, the JAX package's runtime
and the port's own engine, at tests/test_runtime_native.py's sizes; its
functions take the port's tensors.  The native tests skip where there is
no g++, as the JAX package's do."""

import numpy as np
import pytest
import torch

from chargeflux_tpu_torch.runtime import (
    cell_histogram,
    native_available,
    native_direct_energy,
    native_flux_charges,
    native_full_energy_forces,
)

from helpers import force_to_params
from oracle import compute_charges
from torch_helpers import jax_water

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="no native toolchain")


def _params(p):
    bonds = (np.array([b[:2] for b in p["bonds"]], np.int32).reshape(-1, 2),
             np.array([b[2:] for b in p["bonds"]], np.float64).reshape(-1, 2))
    angles = (np.array([a[:3] for a in p["angles"]], np.int32).reshape(-1, 3),
              np.array([a[3:] for a in p["angles"]], np.float64).reshape(-1, 2))
    waters = (np.array([w[:3] for w in p["waters"]], np.int32).reshape(-1, 3),
              np.array([w[3:] for w in p["waters"]], np.float64).reshape(-1, 5))
    return bonds, angles, waters


def test_cell_histogram_counts_every_atom():
    from chargeflux_tpu.models import water_box

    _force, pos, _, box = water_box(n_side=3, seed=61)
    counts, mx = cell_histogram(torch.tensor(pos), torch.tensor(box),
                                (3, 3, 3))
    assert counts.sum() == len(pos) and mx == counts.max()
    from chargeflux_tpu.runtime import cell_histogram as j_hist
    np.testing.assert_array_equal(counts, j_hist(pos, box, (3, 3, 3))[0])


@needs_native
def test_native_charges_match_oracle():
    from chargeflux_tpu.models import water_box

    force, pos, _, box = water_box(n_side=3, flux="bond_angle", seed=62)
    p = force_to_params(force)
    q_ref, _ = compute_charges(pos, p, box=np.asarray(box))
    bonds, angles, _w = _params(p)
    q_nat = native_flux_charges(torch.tensor(pos), torch.tensor(box), True,
                                torch.tensor(p["q0"]), bonds, angles,
                                (np.zeros((0, 3)), np.zeros((0, 5))))
    np.testing.assert_allclose(q_nat, q_ref, rtol=1e-14, atol=1e-15)


@needs_native
def test_native_direct_matches_the_port_engine():
    """Direct + exclusion energy from the port system's own tensors equals
    the port's f64 engine's terms (1e-10)."""
    from chargeflux_tpu_torch.energy import energy_components

    from chargeflux_tpu_torch.charges import effective_charges

    _jsys, psys, pos, _m = jax_water(3, 0.9)
    x = torch.tensor(pos)
    comps = energy_components(x, psys)
    q = effective_charges(x, psys)
    e_nat, f_nat, dedq = native_direct_energy(
        x, psys.box, q, psys.sigma, psys.epsilon, psys.exclusions,
        psys.spec.cutoff, psys.spec.alpha)
    assert e_nat == pytest.approx(float(comps["direct"]
                                        + comps["exclusion"]), rel=1e-10)
    assert f_nat.shape == pos.shape and dedq.shape == (len(pos),)


@needs_native
@pytest.mark.parametrize("flux", ["bond_angle", "water"])
def test_native_full_ewald_matches_oracle_and_jax_runtime(flux):
    """The complete native ground truth against the Python oracle (energy
    1e-12, forces 1e-9) and, bit for bit, against the JAX package's
    runtime (the same source)."""
    from chargeflux_tpu.models import water_box
    from chargeflux_tpu.runtime import native_full_energy_forces as j_full
    from oracle import energy_forces_pbc, ewald_alpha_kmax

    force, pos, _, box = water_box(n_side=3, flux=flux, seed=64)
    p = force_to_params(force)
    cutoff, tol = 0.55, 1e-4
    box = np.asarray(box)
    alpha, kmax = ewald_alpha_kmax(cutoff, tol, box)
    e_ref, f_ref, _ = energy_forces_pbc(pos, p, box, cutoff, tol)
    args = (p["q0"], p["sigma"], p["epsilon"],
            np.array(p["exclusions"]).reshape(-1, 2), *_params(p), cutoff,
            alpha, kmax)
    e_nat, f_nat = native_full_energy_forces(torch.tensor(pos),
                                             torch.tensor(box), *args)
    assert e_nat == pytest.approx(e_ref, rel=1e-12)
    np.testing.assert_allclose(f_nat, f_ref, rtol=1e-9, atol=1e-10)
    e_j, f_j = j_full(pos, box, *args)
    assert e_nat == e_j
    np.testing.assert_array_equal(f_nat, f_j)
