"""Periodic torsions and position restraints of the port
(``chargeflux_tpu_torch.bonded``) held against the JAX package's in f64:
energies and gradients within 1e-12 at phi near 0, near pi and in
between, for n = 1..4; ``BondedParams`` carrying its torsion rows through
``create``, ``with_box`` and ``astype``; the restraints' energies and
gradients, finite at |d| = 0; and NPT's molecules joined by a torsion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import bonded as jbonded
from chargeflux_tpu.npt import molecule_index as j_molecule_index
from chargeflux_tpu_torch import bonded as pbonded
from chargeflux_tpu_torch.npt import bonded_rows, molecule_index
from chargeflux_tpu_torch.system import CoulForce


def _chain(phi, rng):
    """4 atoms with dihedral phi about the 1-2 bond, jittered by 1e-9."""
    pos = np.array([[1.0, 0.0, -0.3], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                    [np.cos(phi), np.sin(phi), 1.3]])
    return pos + 1e-9 * rng.standard_normal(pos.shape)


def _torsion_pair(pos, idx, k, n, phi0, box=None):
    pbc = box is not None
    boxj = jnp.asarray(box if pbc else np.zeros(3))
    e_j, g_j = jax.value_and_grad(
        lambda x: jbonded.periodic_torsion_energy(
            x, jnp.asarray(idx), jnp.asarray(k), jnp.asarray(n),
            jnp.asarray(phi0), boxj, pbc))(jnp.asarray(pos))
    x = torch.tensor(pos, requires_grad=True)
    e_p = pbonded.periodic_torsion_energy(
        x, torch.tensor(idx), torch.tensor(k), torch.tensor(n),
        torch.tensor(phi0), torch.tensor(np.asarray(boxj)), pbc)
    (g_p,) = torch.autograd.grad(e_p, x)
    return float(e_j), np.asarray(g_j), float(e_p.detach()), g_p.numpy()


@pytest.mark.parametrize("phi", [0.0, 1e-7, -1e-7, np.pi - 1e-7,
                                 -np.pi + 1e-7, np.pi, 1.1, -2.3])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_torsion_energy_and_forces_equal_jax(phi, n):
    rng = np.random.default_rng(n)
    pos = _chain(phi, rng)
    idx = np.array([[0, 1, 2, 3]])
    e_j, g_j, e_p, g_p = _torsion_pair(pos, idx, np.array([7.3]),
                                       np.array([float(n)]),
                                       np.array([0.4 * n]))
    assert abs(e_p - e_j) <= 1e-12 * max(1.0, abs(e_j))
    np.testing.assert_allclose(g_p, g_j, atol=1e-12 * max(
        1.0, float(np.abs(g_j).max())))


def test_torsions_across_the_periodic_boundary_equal_jax():
    rng = np.random.default_rng(5)
    box = np.array([2.0, 2.1, 2.2])
    pos = np.concatenate([_chain(0.8, rng) * 0.3, _chain(-2.0, rng) * 0.3])
    pos[4:] += [1.85, 0.1, 2.05]          # the second chain straddles
    pos = pos % box
    idx = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [7, 6, 5, 4]])
    e_j, g_j, e_p, g_p = _torsion_pair(pos, idx, np.array([2.0, 3.0, 1.5]),
                                       np.array([3.0, 1.0, 2.0]),
                                       np.array([0.0, 0.3, -1.0]), box)
    assert abs(e_p - e_j) <= 1e-12 * max(1.0, abs(e_j))
    np.testing.assert_allclose(g_p, g_j, atol=1e-12 * float(
        np.abs(g_j).max()))


def _bonded_kw(rng, n_mol=5):
    """Water-like molecules (templated bonds and angles) plus torsions
    over two remainder atoms chains."""
    base = 3 * np.arange(n_mol)[:, None]
    n = 3 * n_mol + 6
    return dict(
        bond_idx=np.concatenate([base + [0, 1], base + [0, 2],
                                 [[n - 6, n - 5], [n - 5, n - 4]]]),
        bond_k=rng.uniform(1e3, 2e3, 2 * n_mol + 2),
        bond_r0=rng.uniform(0.09, 0.11, 2 * n_mol + 2),
        angle_idx=np.concatenate([base + [1, 0, 2], [[n - 6, n - 5, n - 4]]]),
        angle_k=rng.uniform(100, 200, n_mol + 1),
        angle_theta0=rng.uniform(1.7, 2.0, n_mol + 1),
        torsion_idx=np.array([[n - 6, n - 5, n - 4, n - 3],
                              [n - 5, n - 4, n - 3, n - 2],
                              [n - 4, n - 3, n - 2, n - 1]]),
        torsion_k=np.array([2.0, 1.0, 0.5]),
        torsion_n=np.array([3.0, 2.0, 1.0]),
        torsion_phi0=np.array([0.0, 0.5, np.pi]),
        n_atoms=n), n


@pytest.mark.parametrize("pbc", [False, True])
def test_bonded_energy_with_torsions_equals_jax(pbc):
    rng = np.random.default_rng(13)
    kw, n = _bonded_kw(rng)
    box = np.array([1.5, 1.6, 1.7])
    pos = rng.uniform(0.0, 1.5, (n, 3))
    jb = jbonded.BondedParams.create(box=box, pbc=pbc, dtype=jnp.float64,
                                     **kw)
    pb = pbonded.BondedParams.create(box=box, pbc=pbc, dtype=torch.float64,
                                     device="cpu", **kw)
    assert pb.template is not None and pb.torsion_idx.shape == (3, 4)
    e_j, g_j = jax.value_and_grad(lambda x: jbonded.bonded_energy(x, jb))(
        jnp.asarray(pos))
    x = torch.tensor(pos, requires_grad=True)
    e_p = pbonded.bonded_energy(x, pb)
    (g_p,) = torch.autograd.grad(e_p, x)
    assert abs(float(e_p.detach()) - float(e_j)) <= 1e-12 * abs(float(e_j))
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j),
                               atol=1e-12 * float(np.abs(g_j).max()))
    # with_box and astype keep the torsion rows (the NPT views use them)
    moved = pb.with_box(torch.tensor(box * 1.01))
    f32 = pb.astype(torch.float32)
    for b in (moved, f32):
        assert torch.equal(b.torsion_idx, pb.torsion_idx)
        assert b.torsion_k is not None and b.torsion_phi0 is not None
    assert f32.torsion_k.dtype == torch.float32


def _restraint_case(rng, zero_first):
    x = rng.uniform(0.0, 2.0, (9, 3))
    idx = np.array([1, 4, 7, 8])
    x0 = x[idx] + rng.normal(0.0, 0.2, (4, 3))
    if zero_first:
        x0[0] = x[idx[0]]                  # |d| = 0 on the first row
    return x, idx, rng.uniform(50.0, 150.0, 4), x0


@pytest.mark.parametrize("zero_first", [False, True])
@pytest.mark.parametrize("kind", ["position", "flat_bottom"])
def test_restraints_equal_jax(kind, zero_first):
    rng = np.random.default_rng(21)
    x, idx, k, x0 = _restraint_case(rng, zero_first)
    radius = np.array([0.05, 0.1, 0.2, 0.15])
    extra = (radius,) if kind == "flat_bottom" else ()
    jfn = getattr(jbonded, f"{kind}_restraint_energy")
    pfn = getattr(pbonded, f"{kind}_restraint_energy")
    e_j, g_j = jax.value_and_grad(lambda xx: jfn(
        xx, jnp.asarray(idx), jnp.asarray(k), jnp.asarray(x0),
        *map(jnp.asarray, extra)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    e_p = pfn(xt, torch.tensor(idx), torch.tensor(k), torch.tensor(x0),
              *map(torch.tensor, extra))
    (g_p,) = torch.autograd.grad(e_p, xt)
    assert torch.isfinite(g_p).all()
    assert abs(float(e_p.detach()) - float(e_j)) <= 1e-12 * max(
        1.0, abs(float(e_j)))
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), atol=1e-12)


def test_scalar_restraint_constants_equal_jax():
    rng = np.random.default_rng(8)
    x, idx, _, x0 = _restraint_case(rng, True)
    e_j = float(jbonded.flat_bottom_restraint_energy(
        jnp.asarray(x), jnp.asarray(idx), 100.0, jnp.asarray(x0), 0.1))
    e_p = float(pbonded.flat_bottom_restraint_energy(
        torch.tensor(x), torch.tensor(idx), 100.0, torch.tensor(x0), 0.1))
    assert abs(e_p - e_j) <= 1e-12 * abs(e_j)


def test_a_torsion_alone_joins_two_fragments_for_npt():
    """Two 2-atom fragments joined only by a torsion row 0-1-2-3: NPT must
    count one molecule, as the JAX package does (its driver adds the
    torsion rows to the molecule connectivity)."""
    force = CoulForce()
    for q in (0.2, -0.2, 0.3, -0.3, 0.1, -0.1):
        force.addParticle(q, 0.3, 0.5)
    force.addException(0, 1)
    force.addException(2, 3)
    force.addException(4, 5)
    force.setUsesPeriodicBoundaryConditions(True)
    force.setCutoffDistance(0.5)
    box = np.full(3, 2.0)
    psys = force.create_system(box=box, dtype=torch.float64, device="cpu",
                               direct_method="dense")
    kw = dict(bond_idx=np.zeros((0, 2), int), bond_k=[], bond_r0=[],
              angle_idx=np.zeros((0, 3), int), angle_k=[], angle_theta0=[],
              torsion_idx=[[0, 1, 2, 3]], torsion_k=[1.0], torsion_n=[3.0],
              torsion_phi0=[0.0], n_atoms=6)
    pb = pbonded.BondedParams.create(box=box, pbc=True, dtype=torch.float64,
                                     device="cpu", **kw)
    jb = jbonded.BondedParams.create(box=box, pbc=True, dtype=jnp.float64,
                                     **kw)
    from chargeflux_tpu.system import CoulForce as JCoulForce

    jforce = JCoulForce.from_dict(force.to_dict())
    jsys = jforce.create_system(box=box, dtype=jnp.float64,
                                direct_method="dense")
    j_extra = tuple(np.asarray(a) for a in (jb.bond_idx, jb.angle_idx,
                                            jb.torsion_idx))
    mol_j = j_molecule_index(jsys, j_extra)
    mol_p = molecule_index(psys, bonded_rows(pb))
    for a, b in zip(mol_j, mol_p):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert mol_p[1].shape[0] == 2             # {0, 1, 2, 3} and {4, 5}
    assert len(bonded_rows(pb)) == 3
