"""Random batch Ewald of the port (``chargeflux_tpu_torch.rbe``) held
against the JAX package's: the sampling tables (``nvals`` exactly,
``logp`` and ``z_const`` within 1e-14), the estimator and the stochastic
energy function within 1e-10 in f64 on the same integer k-vectors
(injected on both sides), the inverse-CDF sampler's frequencies against
the table's probabilities, the estimator's mean against the classical
reciprocal energy, and the Langevin driver: two eager runs from one
generator state bit-equal, a further run drawing anew."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import rbe as jrbe
from chargeflux_tpu_torch import rbe as prbe
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.ewald import reciprocal_energy
from chargeflux_tpu_torch.integrate import init_state_nb, maxwell_velocities
from chargeflux_tpu_torch.models import water_bonded_params

from torch_helpers import jax_water


@pytest.mark.parametrize("box,alpha", [((1.9, 2.1, 2.3), 3.1),
                                       ((6.82, 6.82, 6.82), 4.0),
                                       ((0.9, 0.9, 0.9), 5.2)])
def test_rbe_tables_equal_jax(box, alpha):
    a = jrbe.rbe_tables(np.asarray(box), alpha)
    b = prbe.rbe_tables(torch.tensor(box, dtype=torch.float64), alpha)
    for ax in range(3):
        np.testing.assert_array_equal(a.nvals[ax], b.nvals[ax])
        np.testing.assert_allclose(b.logp[ax], a.logp[ax], rtol=1e-14,
                                   atol=1e-14)
    assert abs(b.z_const - a.z_const) <= 1e-14 * a.z_const
    assert (b.box, b.alpha) == (a.box, a.alpha)
    with pytest.raises(ValueError, match="orthorhombic"):
        prbe.rbe_tables(np.eye(3), alpha)


def _setup(**kw):
    jsys, psys, pos, masses = jax_water(3, 0.42, **kw)
    x = torch.tensor(pos)
    q = effective_charges(x, psys)
    return jsys, psys, pos, masses, x, q


def _draw(tables, p, seed):
    rng = np.random.default_rng(seed)
    n = np.stack([rng.choice(tables.nvals[a], p) for a in range(3)], axis=1)
    n[0] = 0                                  # the masked zero triple
    return n


def _inject_jax(monkeypatch, n):
    def fake(tables, n_samples, key, dtype):
        nn = jnp.asarray(n)
        scale = jnp.asarray([2.0 * np.pi / b for b in tables.box], dtype)
        k = nn.astype(dtype) * scale[None, :]
        return k, jnp.sum(k * k, axis=1), jnp.any(nn != 0, axis=1)
    monkeypatch.setattr(jrbe, "sample_kvecs", fake)


def test_estimator_equals_jax_on_the_same_kvectors(monkeypatch):
    jsys, psys, pos, _, x, q = _setup(direct_method="dense")
    tables = prbe.rbe_tables(psys.box, psys.spec.alpha)
    n = _draw(tables, 48, 3)
    _inject_jax(monkeypatch, n)
    (e_j, (gx_j, gq_j)) = jax.value_and_grad(
        lambda xx, qq: jrbe.rbe_reciprocal_energy(
            xx, qq, jrbe.rbe_tables(np.asarray(jsys.box), jsys.spec.alpha),
            48, jax.random.PRNGKey(0)), argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(q.numpy()))
    xg = x.clone().requires_grad_(True)
    qg = q.detach().clone().requires_grad_(True)
    e_p = prbe._from_kvecs(xg, qg, tables, torch.tensor(n))
    gx_p, gq_p = torch.autograd.grad(e_p, (xg, qg))
    assert abs(float(e_p.detach()) - float(e_j)) <= 1e-10 * abs(float(e_j))
    np.testing.assert_allclose(gx_p.numpy(), np.asarray(gx_j),
                               atol=1e-10 * float(np.abs(gx_j).max()))
    np.testing.assert_allclose(gq_p.numpy(), np.asarray(gq_j),
                               atol=1e-10 * float(np.abs(gq_j).max()))


@pytest.mark.parametrize("direct", ["dense", "cell"])
def test_energy_function_equals_jax_on_the_same_kvectors(monkeypatch,
                                                         direct):
    kw = dict(direct_method=direct, recip_method="pme")
    if direct == "cell":
        jsys, psys, pos, masses = jax_water(5, 0.45, **kw)
    else:
        jsys, psys, pos, masses = jax_water(3, 0.42, **kw)
    bonded_p = water_bonded_params(len(masses) // 3, box=np.asarray(
        jsys.box), dtype=torch.float64, device="cpu")
    from chargeflux_tpu.models import water_bonded_params as jwbp

    bonded_j = jwbp(len(masses) // 3, box=np.asarray(jsys.box),
                    dtype=jnp.float64)
    tables = prbe.rbe_tables(psys.box, psys.spec.alpha)
    n = _draw(tables, 32, 8)
    _inject_jax(monkeypatch, n)
    monkeypatch.setattr(prbe, "sample_integers",
                        lambda *a: torch.tensor(n))
    j_fn, j_init = jrbe.make_rbe_nb_energy_fn(jsys, 32, bonded=bonded_j)
    p_fn, p_init = prbe.make_rbe_nb_energy_fn(psys, 32, bonded=bonded_p)
    xj = jnp.asarray(pos)
    e_j, f_j, _ = j_fn(xj, j_init(xj), jax.random.PRNGKey(1))
    x = torch.tensor(pos)
    e_p, f_p, nb = p_fn(x, p_init(x), torch.Generator().manual_seed(0))
    assert (nb is None) == (direct == "dense")
    assert abs(float(e_p) - float(e_j)) <= 1e-10 * abs(float(e_j))
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j),
                               atol=1e-10 * float(np.abs(f_j).max()))


def test_sampler_frequencies_follow_the_tables():
    tables = prbe.rbe_tables((1.2, 1.5, 2.0), 3.0)
    gen = torch.Generator().manual_seed(5)
    m = 40000
    n = prbe.sample_integers(tables, m, gen, "cpu").numpy()
    assert n.shape == (m, 3)
    for ax in range(3):
        p = np.exp(tables.logp[ax])
        p /= p.sum()
        counts = np.array([(n[:, ax] == v).sum() for v in tables.nvals[ax]])
        sigma = np.sqrt(m * p * (1 - p))
        assert np.all(np.abs(counts - m * p) <= 5 * sigma + 1)
    k, k2, nonzero = prbe.sample_kvecs(tables, 16, gen, torch.float64, "cpu")
    assert k.shape == (16, 3) and k2.shape == (16,)
    assert nonzero.dtype == torch.bool


def test_estimator_mean_matches_the_classical_reciprocal():
    _, psys, _, _, x, q = _setup(direct_method="dense")
    spec = psys.spec
    e_ref = float(reciprocal_energy(x, q, psys.box, spec.alpha,
                                    tuple(k + 6 for k in spec.kmax),
                                    method="xla"))
    tables = prbe.rbe_tables(psys.box, spec.alpha)
    gen = torch.Generator().manual_seed(11)
    draws = np.array([float(prbe.rbe_reciprocal_energy(x, q, tables, 64,
                                                       gen))
                      for _ in range(300)])
    se = draws.std(ddof=1) / np.sqrt(len(draws))
    assert abs(draws.mean() - e_ref) <= 5 * se


def test_estimator_moments_mean_is_the_classical_sum_over_the_tables():
    """The estimator's exact expectation (S(k) enumerated over the tables'
    grid) is the classical reciprocal energy on that grid, and the draws'
    mean lies within 5 of its exact standard errors."""
    _, psys, _, _, x, q = _setup(direct_method="dense")
    tables = prbe.rbe_tables(psys.box, psys.spec.alpha)
    mean, var = prbe.estimator_moments(x, q, tables)
    kmax = tuple((len(n) + 1) // 2 for n in tables.nvals)
    e_ref = float(reciprocal_energy(x, q, psys.box, psys.spec.alpha, kmax,
                                    method="xla"))
    assert abs(float(mean) - e_ref) <= 1e-12 * abs(e_ref)
    assert float(var) > 0
    gen = torch.Generator().manual_seed(4)
    draws = torch.stack([prbe.rbe_reciprocal_energy(x, q, tables, 32, gen)
                         for _ in range(100)])
    se = (float(var) / (32 * 100)) ** 0.5
    assert abs(float(draws.mean()) - e_ref) <= 5 * se


def test_langevin_driver_eager_runs_repeat_bit_for_bit():
    _, psys, pos, masses = jax_water(5, 0.45, direct_method="cell",
                                     recip_method="pme")
    bonded = water_bonded_params(len(masses) // 3, box=psys.box.numpy(),
                                 dtype=torch.float64, device="cpu")
    e_fn, init_nb = prbe.make_rbe_nb_energy_fn(psys, 16, bonded=bonded)
    m = torch.tensor(masses)
    gen = torch.Generator().manual_seed(3)
    x = torch.tensor(pos)
    v = maxwell_velocities(m, 300.0, gen, dtype=torch.float64)
    state = init_state_nb(x, v, lambda xx, nb: e_fn(xx, nb, gen), init_nb)

    def run(seed):
        if seed is not None:
            gen.manual_seed(seed)
        return prbe.rbe_langevin_trajectory_nb(
            state, e_fn, init_nb, m, 5e-4, 300.0, 20.0, gen, 12,
            rebuild_every=5, graph=False)

    a, b, c = run(29), run(29), run(None)
    assert torch.isfinite(a[1]).all() and a[1].shape == (12,)
    for u, w in ((a[1], b[1]), (a[0].positions, b[0].positions),
                 (a[0].velocities, b[0].velocities),
                 (a[0].potential, b[0].potential)):
        assert torch.equal(u, w)
    assert not torch.equal(a[1], c[1])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="positive"):
            prbe.rbe_langevin_trajectory_nb(state, e_fn, init_nb, m, 5e-4,
                                            300.0, 20.0, gen, 0)
