"""The port's public bonded helpers ``harmonic_bond_energy`` and
``harmonic_angle_energy`` held against the JAX package's in f64: energy
and gradient on water-like bonds and angles, in a periodic box (bonds
across its boundary) and without one, and empty index lists."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import bonded as jbonded
from chargeflux_tpu_torch import bonded as pbonded

CASES = [(kind, pbc, n) for kind in ("bond", "angle") for pbc in (False, True)
         for n in (0, 12)]


@pytest.mark.parametrize("kind,pbc,n", CASES,
                         ids=[f"{k}-{'pbc' if p else 'open'}-{n}"
                              for k, p, n in CASES])
def test_harmonic_helpers_equal_jax(kind, pbc, n):
    rng = np.random.default_rng(3)
    box = np.array([1.2, 1.3, 1.1])
    # n waters around random centres, some straddling the box's faces
    centre = rng.uniform(0.0, 1.0, (n, 1, 3)) * box
    geom = np.array([[0.0, 0.0, 0.0], [0.0957, 0.0, 0.0],
                     [-0.024, 0.0927, 0.0]])
    pos = (centre + geom + 0.005 * rng.standard_normal((n, 3, 3)))
    pos = pos.reshape(-1, 3)
    if pbc:
        pos = pos - box * np.floor(pos / box)
    base = 3 * np.arange(n)[:, None]
    if kind == "bond":
        idx = np.concatenate([base + [0, 1], base + [0, 2]]).reshape(-1, 2)
        k = rng.uniform(4e5, 5e5, len(idx))
        ref = np.full(len(idx), 0.0957)
        jfn, pfn = jbonded.harmonic_bond_energy, pbonded.harmonic_bond_energy
    else:
        idx = (base + [1, 0, 2]).reshape(-1, 3)
        k = rng.uniform(300.0, 400.0, len(idx))
        ref = np.full(len(idx), 1.8242)
        jfn, pfn = jbonded.harmonic_angle_energy, pbonded.harmonic_angle_energy
    idx = idx.astype(np.int64)
    e_j, g_j = jax.value_and_grad(
        lambda x: jfn(x, jnp.asarray(idx), jnp.asarray(k), jnp.asarray(ref),
                      jnp.asarray(box), pbc))(jnp.asarray(pos))
    x = torch.tensor(pos, requires_grad=True)
    e_p = pfn(x, torch.tensor(idx), torch.tensor(k), torch.tensor(ref),
              torch.tensor(box), pbc)
    assert e_p.dtype == torch.float64 and e_p.shape == ()
    if n == 0:
        assert float(e_p) == 0.0 == float(e_j)
        return
    (g_p,) = torch.autograd.grad(e_p, x)
    np.testing.assert_allclose(float(e_p.detach()), float(e_j), rtol=1e-12)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-9)
