"""Flexible 3-site water boxes with charge flux, the rigid box, the
non-periodic cluster and the water-box PDB on-ramp (torch counterpart of
``chargeflux_tpu.models.water``).

:func:`water_box`, :func:`rigid_water_box` and :func:`water_cluster` draw
from the same NumPy generator in the same order as the JAX package, so for
equal arguments the positions are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bonded import BondedParams
from ..constraints import RigidWaterParams
from ..system import CoulForce

# TIP3P-flavored parameters (charges e, lengths nm, energies kJ/mol).
Q_O, Q_H = -0.834, 0.417
SIG_O, EPS_O = 0.31507, 0.6364
SIG_H, EPS_H = 0.1, 0.0
R_OH = 0.09572
ANGLE_HOH = 1.82421813  # 104.52 degrees in radians
R_HH = 2 * R_OH * np.sin(ANGLE_HOH / 2)

# Charge-flux couplings (e/nm and e/rad).
K_BOND = 1.2
K_ANGLE = 0.12
K1_WATER, K2_WATER, KUB_WATER = 1.0, 0.4, -0.3

WATER_MASSES = (15.999, 1.008, 1.008)

# SPC/Fw-like flexible-water bonded constants (kJ/mol/nm^2, kJ/mol/rad^2).
KB_OH = 443153.0
KA_HOH = 317.6


def _one_water(center, rng, perturb: float = 0.02):
    """O/H1/H2 positions for one water with a random orientation and a
    small geometry perturbation."""
    m = rng.standard_normal((3, 3))
    qmat, r = np.linalg.qr(m)
    qmat *= np.sign(np.diag(r))
    d1 = R_OH * (1.0 + perturb * rng.standard_normal())
    d2 = R_OH * (1.0 + perturb * rng.standard_normal())
    ang = ANGLE_HOH * (1.0 + perturb * rng.standard_normal())
    h1 = np.array([d1, 0.0, 0.0])
    h2 = np.array([d2 * np.cos(ang), d2 * np.sin(ang), 0.0])
    o = np.zeros(3)
    pts = np.stack([o, h1, h2]) @ qmat.T
    return pts + center


def _build(force: CoulForce, n_waters: int, flux: str):
    for _ in range(n_waters):
        o = force.addParticle(Q_O, SIG_O, EPS_O)
        h1 = force.addParticle(Q_H, SIG_H, EPS_H)
        h2 = force.addParticle(Q_H, SIG_H, EPS_H)
        force.addException(o, h1)
        force.addException(o, h2)
        force.addException(h1, h2)
        if flux == "bond_angle":
            force.addFluxBond(o, h1, K_BOND, R_OH)
            force.addFluxBond(o, h2, K_BOND, R_OH)
            force.addFluxAngle(h1, o, h2, K_ANGLE, ANGLE_HOH)
        elif flux == "water":
            force.addFluxWater(o, h1, h2, K1_WATER, K2_WATER, KUB_WATER,
                               R_OH, R_HH)
        elif flux != "none":
            raise ValueError(f"unknown flux mode {flux!r}")


def water_bonded_params(n_waters: int, box=None, dtype=torch.float32,
                        device=None) -> BondedParams:
    """SPC/Fw-style harmonic bonds/angles holding each water together."""
    base = 3 * np.arange(n_waters)[:, None]
    bond_idx = np.concatenate([base + [0, 1], base + [0, 2]], axis=0)
    angle_idx = base + [1, 0, 2]
    n_b, n_a = 2 * n_waters, n_waters
    pbc = box is not None
    box_arr = np.asarray(box, dtype=np.float64) if pbc else np.zeros(3)
    return BondedParams.create(
        bond_idx=bond_idx, bond_k=np.full(n_b, KB_OH),
        bond_r0=np.full(n_b, R_OH), angle_idx=angle_idx,
        angle_k=np.full(n_a, KA_HOH), angle_theta0=np.full(n_a, ANGLE_HOH),
        box=box_arr, pbc=pbc, n_atoms=3 * n_waters, dtype=dtype,
        device=device)


def _lattice(n_side, density_spacing, rng, perturb):
    """One water per lattice site, centers jittered by 0.01 nm."""
    pos = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                center = density_spacing * (np.array([ix, iy, iz]) + 0.5)
                center += 0.01 * rng.standard_normal(3)
                pos.append(_one_water(center, rng, perturb=perturb))
    return np.concatenate(pos, axis=0)


def _periodic_force(cutoff, ewald_tol):
    force = CoulForce()
    force.setUsesPeriodicBoundaryConditions(True)
    force.setCutoffDistance(cutoff)
    force.setEwaldErrorTolerance(ewald_tol)
    return force


def rigid_water_box(n_side: int = 6, cutoff: float = 0.9,
                    ewald_tol: float = 1e-4, density_spacing: float = 0.3107,
                    seed: int = 0, dtype=torch.float64, device=None):
    """Periodic rigid-TIP3P box: exact R_OH / HOH geometry (on the
    constraint manifold), fixed charges (rigid geometry makes the
    intramolecular flux constant, so no flux terms), the same LJ and
    exclusions as the flexible boxes.

    Returns (force, positions [N, 3] float64 NumPy, masses [N], box [3],
    params), where ``params`` (``constraints.RigidWaterParams``, in
    ``dtype``, on the card unless ``device`` says otherwise) feeds the
    RATTLE drivers of :mod:`chargeflux_tpu_torch.constraints`."""
    rng = np.random.default_rng(seed)
    force = _periodic_force(cutoff, ewald_tol)
    n_w = n_side ** 3
    _build(force, n_w, flux="none")
    box = np.full(3, n_side * density_spacing)
    positions = _lattice(n_side, density_spacing, rng, perturb=0.0)
    masses = np.tile(np.array(WATER_MASSES), n_w)
    params = RigidWaterParams.create(
        n_w, d_oh=R_OH, d_hh=float(R_HH), m_o=WATER_MASSES[0],
        m_h=WATER_MASSES[1], dtype=dtype, device=device)
    return force, positions, masses, box, params


def water_box(n_side: int = 6, flux: str = "bond_angle", cutoff: float = 0.9,
              ewald_tol: float = 1e-4, density_spacing: float = 0.3107,
              seed: int = 0):
    """Periodic n_side^3-water box at roughly liquid density.

    Returns (force, positions [N, 3] float64 NumPy, masses [N], box [3]).
    """
    rng = np.random.default_rng(seed)
    force = _periodic_force(cutoff, ewald_tol)
    n_w = n_side ** 3
    _build(force, n_w, flux)
    box = np.full(3, n_side * density_spacing)
    positions = _lattice(n_side, density_spacing, rng, perturb=0.02)
    masses = np.tile(np.array(WATER_MASSES), n_w)
    return force, positions, masses, box


def water_cluster(n_side: int = 5, spacing: float = 0.31,
                  flux: str = "bond_angle", seed: int = 0, **system_kwargs):
    """Non-periodic n_side^3-water cluster on a jittered lattice.

    Returns (force, positions [3*n^3, 3], masses [3*n^3]).  n_side=5 gives
    the 125-water cluster of BASELINE.md.  ``system_kwargs`` is accepted
    for the JAX package's signature and unused."""
    rng = np.random.default_rng(seed)
    force = CoulForce()
    n_w = n_side ** 3
    _build(force, n_w, flux)
    pos = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                center = spacing * np.array([ix, iy, iz], dtype=np.float64)
                center += 0.02 * rng.standard_normal(3)
                pos.append(_one_water(center, rng))
    positions = np.concatenate(pos, axis=0)
    masses = np.tile(np.array(WATER_MASSES), n_w)
    return force, positions, masses


WATER_RESIDUES = frozenset({"HOH", "WAT", "SOL", "TIP3", "TIP", "H2O"})


def water_system_from_pdb(path: str, flux: str = "bond_angle",
                          cutoff: float = 0.9, ewald_tol: float = 1e-4):
    """Build a flux-water system from a water-box PDB file.

    Waters are recognized by residue (HOH/WAT/SOL/TIP3/TIP/H2O), each
    needing one O and two H in a contiguous (resname, resseq) run, so
    boxes past the resseq-9999 wrap parse correctly; atoms are reordered
    to the (O, H1, H2) molecule template.  Returns (force, positions,
    masses, box, perm) with ``positions == pdb positions[perm]``; ``box``
    is the CRYST1 cell ([3] nm or triclinic [3, 3]; None for a vacuum
    cluster)."""
    from ..utils.trajectory import read_pdb

    pdb = read_pdb(path)
    groups = []
    prev = None
    for i, (rn, rs) in enumerate(zip(pdb.resnames, pdb.resseq)):
        if rn.upper() not in WATER_RESIDUES:
            raise ValueError(
                f"atom {i}: residue {rn!r} is not a recognized water "
                f"residue ({sorted(WATER_RESIDUES)}); this builder handles "
                f"pure water boxes")
        if (rn, rs) != prev:
            groups.append(((rn, rs), []))
            prev = (rn, rs)
        groups[-1][1].append(i)
    perm = []
    for key, idx in groups:
        sym = [pdb.symbols[i].upper() for i in idx]
        o_idx = [i for i, s in zip(idx, sym) if s.startswith("O")]
        h_idx = [i for i, s in zip(idx, sym) if s.startswith("H")]
        if len(o_idx) != 1 or len(h_idx) != 2:
            raise ValueError(
                f"residue {key}: expected 1 O + 2 H in a contiguous "
                f"run, got {sym} (water atoms must be adjacent in the "
                f"file; interleaved-residue PDBs are not supported)")
        perm.extend([o_idx[0], h_idx[0], h_idx[1]])
    perm = np.asarray(perm)
    n_w = len(perm) // 3
    force = (_periodic_force(cutoff, ewald_tol) if pdb.box is not None
             else CoulForce())
    _build(force, n_w, flux)
    positions = pdb.positions[perm]
    masses = np.tile(np.array(WATER_MASSES), n_w)
    return force, positions, masses, pdb.box, perm
