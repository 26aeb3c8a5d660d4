"""Ionic-solution model family: Na+/Cl- in flexible charge-flux water
(torch counterpart of ``chargeflux_tpu.models.salt``, a NumPy copy of its
builder: for equal arguments both packages build the same force,
positions and masses).

Monovalent ions (Joung-Cheatham-flavored LJ) dissolved in the flexible
3-site water of :mod:`.water`: mixed molecule sizes (3-atom waters and
1-atom ions), flux terms on a subset of the atoms only.

Atom layout: all waters first (contiguous 3-atom molecules, one
template), then the ions, alternating Na+ / Cl- so any prefix of pairs is
neutral.
"""

from __future__ import annotations

import numpy as np

from ..system import CoulForce
from .water import WATER_MASSES, _build, _one_water

# Joung-Cheatham-flavored monovalent ion parameters (nm, kJ/mol, e).
SIG_NA, EPS_NA, Q_NA = 0.2439, 0.3658, +1.0
SIG_CL, EPS_CL, Q_CL = 0.4478, 0.1489, -1.0
MASS_NA, MASS_CL = 22.990, 35.453


def salt_water_box(n_side: int = 6, n_ion_pairs: int = 4,
                   flux: str = "bond_angle", cutoff: float = 0.9,
                   ewald_tol: float = 1e-4, density_spacing: float = 0.3107,
                   seed: int = 0):
    """Periodic box of (n_side^3 - 2*n_ion_pairs) flexible waters plus
    n_ion_pairs Na+/Cl- pairs on the same jittered lattice (each ion
    replaces one water site, keeping roughly liquid density).

    Returns (force, positions [N, 3], masses [N], box [3]).
    """
    n_sites = n_side ** 3
    n_ions = 2 * n_ion_pairs
    if n_ions > n_sites:
        raise ValueError(
            f"{n_ion_pairs} ion pairs need {n_ions} lattice sites but the "
            f"box has only {n_sites}")
    n_w = n_sites - n_ions

    rng = np.random.default_rng(seed)
    force = CoulForce()
    force.setUsesPeriodicBoundaryConditions(True)
    force.setCutoffDistance(cutoff)
    force.setEwaldErrorTolerance(ewald_tol)
    _build(force, n_w, flux)
    for k in range(n_ions):
        if k % 2 == 0:
            force.addParticle(Q_NA, SIG_NA, EPS_NA)
        else:
            force.addParticle(Q_CL, SIG_CL, EPS_CL)

    box = np.full(3, n_side * density_spacing)
    centers = [density_spacing * (np.array([ix, iy, iz]) + 0.5)
               + 0.01 * rng.standard_normal(3)
               for ix in range(n_side)
               for iy in range(n_side)
               for iz in range(n_side)]
    # spread the ion sites through the lattice deterministically
    ion_sites = set(np.linspace(0, n_sites - 1, n_ions).astype(int).tolist())
    pos_w, pos_i = [], []
    for s, center in enumerate(centers):
        if s in ion_sites:
            pos_i.append(center[None, :])
        else:
            pos_w.append(_one_water(center, rng))
    positions = np.concatenate(pos_w + pos_i, axis=0)
    masses = np.concatenate([
        np.tile(np.array(WATER_MASSES), n_w),
        np.array([MASS_NA if k % 2 == 0 else MASS_CL
                  for k in range(n_ions)]),
    ])
    return force, positions, masses, box
