"""The port's analysis utilities (``utils.analysis``) held against the JAX
package's in f64 within 1e-12: the time-correlation functions, the IR
line shape, the total dipole with flux charges, and the radial
distribution (positions off the bin edges, so the two binnings see the
same bins; a distance exactly at r_max counts in the last bin, as
``jnp.histogram`` counts it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.utils import analysis as janalysis
from chargeflux_tpu_torch.utils import analysis as panalysis

from torch_helpers import jax_water

RNG = np.random.default_rng(77)


@pytest.mark.parametrize("max_lag", [None, 5])
def test_time_correlations_equal_jax(max_lag):
    frames = np.cumsum(RNG.standard_normal((12, 9, 3)), axis=0)
    vels = RNG.standard_normal((12, 9, 3))
    dips = RNG.standard_normal((12, 3)) + [1.0, -2.0, 0.5]
    for name, data in (("mean_squared_displacement", frames),
                       ("velocity_autocorrelation", vels),
                       ("dipole_autocorrelation", dips)):
        a = getattr(janalysis, name)(data, max_lag)
        b = getattr(panalysis, name)(torch.tensor(data), max_lag)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)


def test_constant_dipole_acf_and_ir_spectrum_equal_jax():
    const = np.tile([0.3, 0.1, -0.2], (8, 1))
    np.testing.assert_array_equal(panalysis.dipole_autocorrelation(const),
                                  janalysis.dipole_autocorrelation(const))
    dips = np.cumsum(RNG.standard_normal((40, 3)), axis=0)
    fa, ia = janalysis.infrared_spectrum(dips, 0.002)
    fb, ib = panalysis.infrared_spectrum(torch.tensor(dips), 0.002)
    np.testing.assert_allclose(fb, fa, rtol=1e-12)
    np.testing.assert_allclose(ib, ia, rtol=1e-12, atol=1e-12 * ia.max())


def test_total_dipole_equals_jax():
    jsys, psys, pos, _ = jax_water(3, 0.42, direct_method="dense")
    m_j = np.asarray(janalysis.total_dipole(jnp.asarray(pos), jsys))
    m_p = panalysis.total_dipole(torch.tensor(pos), psys).numpy()
    np.testing.assert_allclose(m_p, m_j, rtol=1e-12, atol=1e-14)


def _off_edges(pos, box, r_max, n_bins, margin=1e-9):
    """True when no min-image distance of two atoms lies within ``margin`` of a
    bin edge (so the two packages' edge arrays, equal to round-off, bin
    every pair alike)."""
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.floor(d / box + 0.5)
    r = np.sqrt((d * d).sum(-1))[~np.eye(len(pos), dtype=bool)]
    edges = np.linspace(0.0, r_max, n_bins + 1)
    return np.min(np.abs(r[..., None] - edges)) > margin


@pytest.mark.parametrize("chunk", [7, 512])
@pytest.mark.parametrize("selection", ["same", "overlap", "disjoint"])
def test_radial_distribution_equals_jax(selection, chunk):
    box = np.array([2.0, 2.2, 2.4])
    pos = RNG.uniform(0.0, 1.0, (60, 3)) * box
    assert _off_edges(pos, box, 0.95, 40)
    idx_a = np.arange(0, 60, 2)
    idx_b = {"same": idx_a, "overlap": np.arange(0, 40),
             "disjoint": np.arange(1, 60, 2)}[selection]
    r_j, g_j = janalysis.radial_distribution(
        jnp.asarray(pos), jnp.asarray(box), idx_a, idx_b, 0.95, 40, chunk)
    r_p, g_p = panalysis.radial_distribution(
        torch.tensor(pos), torch.tensor(box), idx_a, idx_b, 0.95, 40, chunk)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=1e-12)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-12)
    assert float(g_p.sum()) > 0


def test_radial_distribution_last_edge_is_inclusive_as_jax():
    box = np.array([2.0, 2.0, 2.0])
    pos = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.25, 0.0],
                    [1.0, 1.0, 1.0]])
    r_j, g_j = janalysis.radial_distribution(
        jnp.asarray(pos), jnp.asarray(box), [0, 1, 2, 3], [0, 1, 2, 3],
        0.5, 4)
    r_p, g_p = panalysis.radial_distribution(
        torch.tensor(pos), torch.tensor(box), [0, 1, 2, 3], [0, 1, 2, 3],
        0.5, 4)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-12)
    assert float(g_p[-1]) > 0                  # the r = 0.5 pair, counted
