"""General heterogeneous on-ramp: a mixed-topology PDB plus a residue
parameter table -> a ready CoulForce + bonded terms (torch counterpart of
``chargeflux_tpu.models.onramp``; host-side NumPy, as there).

Each residue is described ONCE (charges, LJ, masses, intra-residue flux
terms and exclusions, optional links to the previous residue for polymer
backbones) and :func:`system_from_pdb` instantiates the builder calls for
every residue instance in the file.  The result flows through the
molecule-template detection of ``create_system``: the repeated residues
(waters) take the template path, the rest (a chain) the remainder rows.

Atom names follow the PDB columns; a leading ``-`` in a link term
(e.g. ``("-C", "N", k, r0)``) refers to the PREVIOUS residue in the file
when its resseq immediately precedes this one — the linear-polymer
backbone convention.  Atoms keep file order (no permutation).  As in the
JAX package, ``read_pdb`` ignores chain IDs and TER records, so two chains
whose resseq continue one another get linked (ROADMAP C.3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from ..system import CoulForce


@dataclasses.dataclass(frozen=True)
class ResidueParams:
    """Per-residue parametrization for :func:`system_from_pdb`.

    ``atoms`` maps each PDB atom name to ``(charge, sigma, epsilon,
    mass)``.  The term lists hold atom NAMES (resolved per residue
    instance); ``link_*`` entries may prefix a name with ``-`` to
    reference the previous residue (applied only between runs with
    consecutive resseq — chain breaks get no link).
    """

    atoms: Dict[str, Tuple[float, float, float, float]]
    # charge-flux terms (the reference's addFluxBond/Angle/Water rows)
    flux_bonds: Sequence[Tuple] = ()     # (a1, a2, k, b0)
    flux_angles: Sequence[Tuple] = ()    # (a1, a2, a3, k, theta0)
    flux_waters: Sequence[Tuple] = ()    # (O, H1, H2, k1, k2, kub, b0, ub0)
    exclusions: Sequence[Tuple] = ()     # (a1, a2)
    # harmonic bonded terms (the host-framework side: bonded.py)
    bonds: Sequence[Tuple] = ()          # (a1, a2, k, r0)
    angles: Sequence[Tuple] = ()         # (a1, a2, a3, k, theta0)
    # backbone links to the previous residue ("-" name prefix)
    link_exclusions: Sequence[Tuple] = ()
    link_bonds: Sequence[Tuple] = ()
    link_flux_bonds: Sequence[Tuple] = ()
    link_angles: Sequence[Tuple] = ()


def _runs(resnames, resseq):
    """Contiguous (resname, resseq) runs in file order (resseq wraps at
    9999, so runs — not dict keys — define residue instances)."""
    runs, prev = [], None
    for i, key in enumerate(zip(resnames, resseq)):
        if key != prev:
            runs.append((key, []))
            prev = key
        runs[-1][1].append(i)
    return runs


def system_from_pdb(path: str, params: Mapping[str, "ResidueParams"],
                    cutoff: float = 0.9, ewald_tol: float = 1e-4):
    """Build a system for an arbitrary mixed-topology PDB.

    Args:
      path: PDB file (ATOM/HETATM + optional CRYST1).
      params: residue name -> :class:`ResidueParams`.  Every residue in
        the file must have an entry; every atom in a residue instance
        must appear in its entry's ``atoms`` (and vice versa) — missing
        or extra atoms fail loudly with the residue identified.
      cutoff, ewald_tol: electrostatics knobs (PBC iff the file has a
        CRYST1 cell, matching the reference's PBC flag semantics).

    Returns ``(force, positions [N, 3] nm, masses [N], box, bonded_kw)``
    with atoms in FILE ORDER (no reordering — names key the parameter
    lookup) and ``bonded_kw`` ready for ``BondedParams.create``.
    """
    from ..utils.trajectory import read_pdb

    pdb = read_pdb(path)
    runs = _runs(pdb.resnames, pdb.resseq)

    force = CoulForce()
    if pdb.box is not None:
        force.setUsesPeriodicBoundaryConditions(True)
        force.setCutoffDistance(cutoff)
        force.setEwaldErrorTolerance(ewald_tol)

    n = len(pdb.resnames)
    masses = np.zeros(n)
    b_idx, b_k, b_r0 = [], [], []
    a_idx, a_k, a_t0 = [], [], []

    prev_map, prev_seq = None, None
    for (rn, rs), idx in runs:
        rp = params.get(rn)
        if rp is None:
            raise KeyError(
                f"residue {rn!r} (resseq {rs}) has no entry in the "
                f"parameter table; known residues: {sorted(params)}")
        names = [pdb.names[i] for i in idx]
        amap = {}
        for i, nm in zip(idx, names):
            if nm not in rp.atoms:
                raise ValueError(
                    f"residue {rn} {rs}: atom {nm!r} not in its "
                    f"parameter entry (has {sorted(rp.atoms)})")
            if nm in amap:
                raise ValueError(f"residue {rn} {rs}: duplicate atom "
                                 f"name {nm!r}")
            amap[nm] = i
        missing = set(rp.atoms) - set(amap)
        if missing:
            raise ValueError(f"residue {rn} {rs}: file is missing "
                             f"atoms {sorted(missing)}")

        # particles in file order so positions need no permutation
        for i in idx:
            q, sig, eps, m = rp.atoms[pdb.names[i]]
            at = force.addParticle(q, sig, eps)
            assert at == i
            masses[i] = m

        def res(nm, _amap=amap, _prev=prev_map, _linked=(
                prev_seq is not None and rs == prev_seq + 1)):
            if nm.startswith("-"):
                if not _linked or _prev is None or nm[1:] not in _prev:
                    return None
                return _prev[nm[1:]]
            return _amap[nm]

        for a1, a2 in rp.exclusions:
            force.addException(res(a1), res(a2))
        for a1, a2, k, b0 in rp.flux_bonds:
            force.addFluxBond(res(a1), res(a2), k, b0)
        for a1, a2, a3, k, t0 in rp.flux_angles:
            force.addFluxAngle(res(a1), res(a2), res(a3), k, t0)
        for row in rp.flux_waters:
            o, h1, h2 = (res(x) for x in row[:3])
            force.addFluxWater(o, h1, h2, *row[3:])
        for a1, a2, k, r0 in rp.bonds:
            b_idx.append((res(a1), res(a2)))
            b_k.append(k)
            b_r0.append(r0)
        for a1, a2, a3, k, t0 in rp.angles:
            a_idx.append((res(a1), res(a2), res(a3)))
            a_k.append(k)
            a_t0.append(t0)

        # backbone links: only between consecutive-resseq runs; a link
        # whose "-" atom cannot resolve (chain start / break) is skipped
        for pair in rp.link_exclusions:
            ii = [res(x) for x in pair]
            if None not in ii:
                force.addException(*ii)
        for a1, a2, k, b0 in rp.link_flux_bonds:
            ii = [res(a1), res(a2)]
            if None not in ii:
                force.addFluxBond(ii[0], ii[1], k, b0)
        for a1, a2, k, r0 in rp.link_bonds:
            ii = [res(a1), res(a2)]
            if None not in ii:
                b_idx.append(tuple(ii))
                b_k.append(k)
                b_r0.append(r0)
        for a1, a2, a3, k, t0 in rp.link_angles:
            ii = [res(a1), res(a2), res(a3)]
            if None not in ii:
                a_idx.append(tuple(ii))
                a_k.append(k)
                a_t0.append(t0)

        prev_map, prev_seq = amap, rs

    bonded_kw = dict(
        bond_idx=np.asarray(b_idx, np.int32).reshape(-1, 2),
        bond_k=np.asarray(b_k, np.float64),
        bond_r0=np.asarray(b_r0, np.float64),
        angle_idx=np.asarray(a_idx, np.int32).reshape(-1, 3),
        angle_k=np.asarray(a_k, np.float64),
        angle_theta0=np.asarray(a_t0, np.float64),
        n_atoms=n,
    )
    return force, pdb.positions.copy(), masses, pdb.box, bonded_kw
