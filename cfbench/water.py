"""The inputs of a water configuration: positions from the seed, masses,
and the program's system built from the configuration's frozen
parameters through its public builder (``CoulForce``, ``create_system``,
``BondedParams``).  The reference (``cfbench.reference``) gets the same
parameters and positions and derives the rest itself.
"""

from __future__ import annotations

import numpy as np
import torch


def lattice_waters(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    """Positions [3 n^3, 3] (f64, nm) of one n^3 lattice of waters, (O, H1,
    H2) per molecule: the O on the site jittered by ``center_jitter_nm``
    normals, the molecule turned by a uniform random rotation, the O-H
    lengths and the angle scaled by 1 + ``geometry_perturbation`` normals."""
    sysc, w, lat = cfg["system"], cfg["water"], cfg["lattice"]
    n = int(sysc["lattice_side"])
    m = n ** 3
    site = np.indices((n, n, n)).reshape(3, -1).T.astype(np.float64)
    centers = sysc["spacing_nm"] * (site + 0.5)
    centers += lat["center_jitter_nm"] * rng.standard_normal((m, 3))
    qmat, r = np.linalg.qr(rng.standard_normal((m, 3, 3)))
    qmat *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    p = lat["geometry_perturbation"]
    d1 = w["r_OH"] * (1.0 + p * rng.standard_normal(m))
    d2 = w["r_OH"] * (1.0 + p * rng.standard_normal(m))
    ang = w["angle_HOH"] * (1.0 + p * rng.standard_normal(m))
    local = np.zeros((m, 3, 3))
    local[:, 1, 0] = d1
    local[:, 2, 0] = d2 * np.cos(ang)
    local[:, 2, 1] = d2 * np.sin(ang)
    pts = np.einsum("mij,mkj->mik", local, qmat) + centers[:, None, :]
    return pts.reshape(-1, 3)


def box_of(cfg: dict) -> np.ndarray:
    s = cfg["system"]
    return np.full(3, s["lattice_side"] * s["spacing_nm"])


def masses_of(cfg: dict) -> np.ndarray:
    w = cfg["water"]
    return np.tile([w["mass_O"], w["mass_H"], w["mass_H"]],
                   int(cfg["system"]["n_waters"]))


def port_force(cfg: dict):
    """The program's ``CoulForce`` of the configuration: per water the
    three particles, the three intramolecular exceptions, two flux bonds
    and one flux angle, in that order; periodic, with its cutoff and
    Ewald tolerance."""
    from chargeflux_tpu_torch import CoulForce

    s, w = cfg["system"], cfg["water"]
    force = CoulForce()
    force.setUsesPeriodicBoundaryConditions(True)
    force.setCutoffDistance(s["cutoff_nm"])
    force.setEwaldErrorTolerance(s["ewald_tol"])
    for _ in range(int(s["n_waters"])):
        o = force.addParticle(w["charge_O"], w["sigma_O"], w["epsilon_O"])
        h1 = force.addParticle(w["charge_H"], w["sigma_H"], w["epsilon_H"])
        h2 = force.addParticle(w["charge_H"], w["sigma_H"], w["epsilon_H"])
        force.addException(o, h1)
        force.addException(o, h2)
        force.addException(h1, h2)
        force.addFluxBond(o, h1, w["flux_bond_k"], w["flux_bond_b0"])
        force.addFluxBond(o, h2, w["flux_bond_k"], w["flux_bond_b0"])
        force.addFluxAngle(h1, o, h2, w["flux_angle_k"],
                           w["flux_angle_theta0"])
    return force


def port_system(cfg: dict, device, dtype=torch.float32):
    """The program's system: the cell route with SPME on the configured
    grid, capacity and mesh, or the dense route with classical Ewald."""
    s = cfg["system"]
    force = port_force(cfg)
    box = box_of(cfg)
    if s["direct"] == "cell":
        return force.create_system(
            box=box, dtype=dtype, direct_method="cell", recip_method="pme",
            cell_grid=tuple(s["cell_grid"]),
            cell_capacity=int(s["cell_capacity"]),
            pme_grid=tuple(s["pme_grid"]), device=device)
    return force.create_system(box=box, dtype=dtype, direct_method="dense",
                               device=device)


def port_bonded(cfg: dict, device, dtype=torch.float32):
    """The water bonds and angles as the program's ``BondedParams``."""
    from chargeflux_tpu_torch import BondedParams

    w = cfg["water"]
    n_w = int(cfg["system"]["n_waters"])
    base = 3 * np.arange(n_w)[:, None]
    return BondedParams.create(
        bond_idx=np.concatenate([base + [0, 1], base + [0, 2]], axis=0),
        bond_k=np.full(2 * n_w, w["bond_k"]),
        bond_r0=np.full(2 * n_w, w["bond_r0"]),
        angle_idx=base + [1, 0, 2], angle_k=np.full(n_w, w["angle_k"]),
        angle_theta0=np.full(n_w, w["angle_theta0"]), box=box_of(cfg),
        pbc=True, n_atoms=3 * n_w, dtype=dtype, device=device)
