"""Step measurements of the port's MD paths on one CUDA card.

    python3 -m chargeflux_tpu_torch.utils.measure profile [--path PATH]
    python3 -m chargeflux_tpu_torch.utils.measure f64 [--path PATH]
    python3 -m chargeflux_tpu_torch.utils.measure thermo
    python3 -m chargeflux_tpu_torch.utils.measure stamps [--path PATH]
    python3 -m chargeflux_tpu_torch.utils.measure multigpu [--device cpu]

PATH is 30k (the default), 216, rigid, respa, npt, or one of the other
NVE configs of the JAX package's bench.py: 4k, 100k, tri30k, hetero30k
(:func:`bench_path`, burned in as the 30k path); or csvr / nhc, the CSVR
and Nose-Hoover chain NVT drivers on the burned-in 30k box; onramp30k,
Langevin NVT on the peptide-in-water PDB read through the on-ramp
(:func:`onramp_path`, 31,926 atoms); rbe / rbe100k, random batch Ewald NVT
(p = 128, friction 20/ps) on the burned-in 30k / 100k box, with the SPME
Langevin step at the same settings timed in the same process.

``--path 30k`` (the default) starts from the cell + SPME main path's system
(``water_box(n_side=22, flux="bond_angle", cutoff=0.72)``, 31,944 atoms,
forced 8^3 cell grid, 64^3 PME mesh at order 8) and the burn-in that
``chip_smoke.py`` runs (:func:`burn_in`).  ``--path 216`` starts from the
dense + classical-Ewald system of :func:`dense_path` at the lattice, at
rest, as the JAX package's ``bench.py 216`` does; it has no neighbor state,
and its "rebuild chunks" are 10 steps.  ``--path rigid`` is the JAX
package's ``bench.py rigid`` at the main-path box (:func:`rigid_path`:
rigid water, fixed charges, RATTLE-BAOAB at 2 fs, 300 K, friction 5/ps
after a 20/ps burn-in); ``--path respa`` its ``bench.py respa``
(:func:`respa_path`: flexible water, BAOAB r-RESPA with 4 bonded substeps
per 2 fs outer step, 300 K, friction 5/ps after 0.2 ps of 0.5 fs
Langevin); ``--path npt`` its ``bench.py npt`` (:func:`npt_path`: BAOAB
Langevin at 300 K and friction 5/ps with an isotropic MC barostat at 1 bar,
one volume attempt per rebuild chunk, after 0.2 ps at friction 20/ps).
Run from the root of a checkout; each prints the card's name and power
limit first.

``profile``: ms/step from CUDA events of the kernel path replayed as CUDA
graphs (each rebuild chunk one replay), of the same run eagerly
(``graph=False``) and of the plain path's replays (the plain route,
``with_kernel_route("plain")``, binning included),
samples in the order graph, eager, plain, plain, eager, graph, each ten
rebuild chunks from the same start state (the graphs are captured before
the first sample), then the captured chunk alone, ten replays back to
back; on the 30k path the ms of one eager neighbor rebuild (the
plain-torch binning).  Then ``torch.profiler`` windows of two chunks over
the kernel path: the device-busy time (union of the device events'
intervals), the window's wall time on the host clock, and the idle share
``1 - busy / wall`` of that window, over two replays with CUDA activity
only and with CPU and CUDA activity, and over an eager trajectory (with
its eager final evaluation).  On the rigid path also the device time of
one step's five constraint projections (two of the positions, three of
the velocities) and on the RESPA path that of one outer step's bonded
substeps, on the NPT path that of one barostat proposal (centroids,
scaled positions, the forward energy with its binning; once per chunk),
and on the nhc path that of one step's two chain updates, each a CUDA
graph timed alone, and their share of the step's device busy time.  The
NPT and thermostat paths have no plain-path variant.

``stamps``: the stage stamps of ``utils.profiling`` on an NVE path's
captured chunk (:func:`stamp_costs`): the replay's bits with the stamps
against without, the device time of ten back-to-back replays of the
chunk's own graph (stamps out), of its graph with the stamps, and of the
same chunk captured without stamps (CUDA events, rounds in turns),
the record's replay time against CUDA events around the same replays, the
launch counters against the kernels a profiler saw, and one trajectory
call of 25 chunks under the profiler: its per-step time by stage, its host
spans and where the card sat idle (``profiling.idle_by_span``).

``f64``: 200 NVE steps of the f32 kernel path beside 200 of the plain f64
path from one start state: ms/step, net drift, max and RMS of ``E - E0``.

``thermo``: on the burned-in 30k box (phase 5's state in chip_smoke),
BAOAB Langevin, CSVR and the Nose-Hoover chain at 300 K, 4000 replayed f32
steps each on the kernel route, and BAOAB and CSVR for 1000 steps in f64
on the plain route, from one generator seed: the mean kinetic temperature
over each window of 200 steps (:func:`thermo_windows`).

``multigpu``: the multi-device routes on one process per visible card
(an NCCL group), each against the single-card route; ``--device cpu``
rehearses them on gloo ranks at small sizes (``utils/multigpu.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import math
import re
import statistics
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

DT_PS = 5e-4              # 0.5 fs, as the JAX package's bench.py
DT_RIGID = 2e-3           # bench.py rigid's 2 fs step
N_INNER = 4               # bench.py respa's substeps: 2 fs outer steps
TEMP = 300.0              # the thermostats' target, K
FRICTION = 5.0            # production friction, 1/ps (burn-ins: 20)
PRESSURE_BAR = 1.0        # bench.py npt's barostat target
TAU_CSVR = 0.1            # CSVR coupling time, ps
TAU_NHC = 0.02            # Nose-Hoover chain period, ps (40 steps)
KB = 0.00831446261815324  # kJ/mol/K

# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): f32 on the
# CUDA cores (no tensor cores), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4  # bytes of a float32 or an int32
# flops of one excluded pair in csrc/exclusion_pairs.cu (an FMA counts 2;
# rsqrt, exp, sqrt and a division 1): the forward's energy, and what the
# backward adds for the derivatives and the two ends' gradients
EXCL_FWD_FLOPS = 67
EXCL_BWD_EXTRA_FLOPS = 62
# flops of one bond and one angle row in csrc/bonded_terms.cu, counted the
# same way (a periodic minimum image is 6 a component; acos 1): the
# forward's energy, and what the backward adds for the derivatives and
# the row's atoms' gradients; and per atom of the backward, the cotangent
BOND_FWD_FLOPS = 29
ANGLE_FWD_FLOPS = 63
BOND_BWD_EXTRA_FLOPS = 11
ANGLE_BWD_EXTRA_FLOPS = 45
# the port's hand-written kernels, as a profiler trace names them
PORT_KERNELS = re.compile(r"\(anonymous namespace\)::"
                          r"(spread_|direct_walk|sf_|cell_bin_)")
ROUNDS = 7        # timing rounds of interleaved_ms, the functions in turns
GRAPH_REPS = 20   # calls per timed CUDA graph


def kernel_bound(name: str, **dims) -> dict:
    """The least time the card could take for one call of kernel ``name``
    at the shapes ``dims``: its flops (an FMA counts 2, rsqrt 1), the bytes
    it must move (each input read once, each output written once), and
    ``bound_ms``, the larger of flops / PEAK_F32_FLOPS and bytes /
    PEAK_BYTES_PER_S, with ``bound_by`` naming the larger.

    spread_fwd / spread_bwd (n_col, wx, wy, wyp, rows, order, px, py, gz,
      n_real): only the n_real rows that carry an atom make work (the
      sentinel slots have q = 0: they add nothing to the mesh, and their
      cotangents are multiplied by q = 0 on the way to the positions), and
      of such a row only ``order`` x weights of wx and ``order`` y weights
      of wy are nonzero (a B-spline's support; the zero pad rows up to
      wyp never are).  Forward: per nonzero (x, y) pair of a row, q w_x w_y
      (1) and its order taps (2 order).  Backward: the mesh dot product of
      the order taps (2 order) for every pair with a nonzero x or y
      weight, the x cotangent (2) per pair with a nonzero y weight, the y
      cotangent (2) per pair with a nonzero x weight, and the term and its
      tap cotangents (1 + 2 order) per pair with both.  With every weight
      nonzero (wx = wy = order, n_real = n_col rows) these are the dense
      (2 order + 1) and (4 order + 5) per (column, x, y, row) term.
    sf_fwd / sf_bwd_tables / sf_bwd_zq (kx, ky, kz2, n[, reps]): two
      [Kx Ky, N] by [N, 2Kz] products (4 Kx Ky N 2Kz); forming cxy, sxy
      costs 6 per (kx, ky, n), the tables' epilogue 16; a batched launch
      over ``reps`` replicas does ``reps`` times the work.
    direct_walk (n_pairs, n_slots, n_cells, ncoef[, box_floats]): each of
      the n_pairs in-cutoff pairs once, 51 + 4 (ncoef - 1) flops (the
      Horner pair of P and dP is 4 per coefficient; the j-side updates are
      counted, the distance tests of pairs beyond the cutoff are not);
      bytes: six float and one id column per slot in, dE/dx and dE/dq per
      slot out, the 27-cell neighbor and image tables, one energy per cell
      and the box (3 floats, 9 for a triclinic lattice).
    direct_walk_halo (n_pairs, n_own_slots, n_ext_slots, n_own, ncoef[,
      box_floats]): the walk's flops for the n_pairs in-cutoff pairs of
      the owned cells; bytes: seven columns per slot of the extended slab
      in, dE/dx and dE/dq per owned slot out, the tables and one energy
      per owned cell, the box and the coefficients.
    binning (n_atoms, n_slots): the cell binning of a neighbor rebuild
      (``cells.build_cell_list_full``), no flops counted: the positions in
      (3 floats per atom), the slots (one int per slot), the inverse slots
      (one per atom) and the overflow count out.
    cell_bin (n_atoms, n_slots): the binning kernel alone
      (``ops.cell_bin``), from the cell ids: one int per atom in, the
      slots, inverse slots and overflow count out.
    patch_weights_fwd / patch_weights_bwd (n_slots, wx, wyp, order): the
      B-spline patch weights (``ops.pme_weights``), one slot of the blocks
      each.  Forward: de Boor's recursion to the order on the support
      points of three axes (5 flops a point of each level n, n points at
      level n from 3) and the charge on each x tap; bytes: x, y, z, q and
      the id in, the wx + wyp + order weights and the z origin out.
      Backward: the recursion to order - 1 on three axes, per in-support
      tap the slope and its product (3), on x also the charge (1) and the
      value with its product (7); bytes: x, y, z, q and the id, the
      3 order in-support cotangents in, dE/dx, dE/dy, dE/dz and dE/dq out
      (the origin tables and the lengths, a few words, aside).
    exclusion_fwd / exclusion_bwd (n_atoms, n_pairs): one template's
      excluded pairs (``ops.exclusion``), n_atoms its atoms.  Forward:
      EXCL_FWD_FLOPS a pair (the minimum image, rsqrt, the erfc polynomial
      and exp, the Coulomb terms, LJ and the sum); bytes: positions, q,
      sigma and epsilon in (6 words an atom).  Backward: the forward's
      flops and EXCL_BWD_EXTRA_FLOPS a pair for its derivatives and the
      two ends' gradients; bytes: the same in, dE/dx and dE/dq out (4 words
      an atom); the box, the rows and the partial sums, a few words, aside.
    bonded_fwd / bonded_bwd (n_molecules, stride, n_bonds, n_angles): one
      template's bonds and angles (``ops.bonded_terms``), n_bonds and
      n_angles rows a molecule.  Forward: BOND_FWD_FLOPS a bond and
      ANGLE_FWD_FLOPS an angle (minimum images, lengths, the cosine, acos,
      the harmonic terms and the sum); bytes: the molecule's positions and
      two parameters a row in.  Backward: the forward's flops, the
      *_BWD_EXTRA_FLOPS a row and 3 an atom (the cotangent); bytes: the
      same in, dE/dx out (3 words an atom).  Each row counts once (the
      kernel recomputes a row for each of its atoms); the box, the rows'
      table and the partial sums, a few words, aside.
    """
    d = dims
    if name in ("spread_fwd", "spread_bwd"):
        o, wx, wy = d["order"], d["wx"], d["wy"]
        weights = d["n_col"] * d["rows"] * (wx + d["wyp"] + o)
        rest = d["n_col"] * d["rows"] + d["px"] * d["py"] * d["gz"]
        if name == "spread_fwd":
            flops = d["n_real"] * o * o * (2 * o + 1)
            nbytes = F32 * (weights + rest)
        else:                           # reads and writes the weights
            either = wx * o + o * wy - o * o
            flops = d["n_real"] * (2 * o * either + 2 * wx * o + 2 * o * wy
                                   + o * o * (2 * o + 1))
            nbytes = F32 * (2 * weights + rest)
    elif name in ("sf_fwd", "sf_bwd_tables", "sf_bwd_zq"):
        k, n = d["kx"] * d["ky"], d["n"]
        tables = 2 * (d["kx"] + d["ky"]) * n     # cx, sx, cy, sy
        bwd_tables = name == "sf_bwd_tables"      # reads and writes them
        reps = d.get("reps", 1)
        flops = reps * k * n * (4 * d["kz2"] + (16 if bwd_tables else 6))
        nbytes = reps * F32 * ((2 if bwd_tables else 1) * tables
                               + n * d["kz2"] + 2 * k * d["kz2"])
    elif name == "direct_walk":
        flops = d["n_pairs"] * (51 + 4 * (d["ncoef"] - 1))
        nbytes = (F32 * (11 * d["n_slots"] + d["n_cells"] * (1 + 27 + 81)
                         + d.get("box_floats", 3) + d["ncoef"]))
    elif name == "direct_walk_halo":
        flops = d["n_pairs"] * (51 + 4 * (d["ncoef"] - 1))
        nbytes = F32 * (7 * d["n_ext_slots"] + 4 * d["n_own_slots"]
                        + d["n_own"] * (1 + 27 + 81)
                        + d.get("box_floats", 3) + d["ncoef"])
    elif name == "binning":
        flops = 0
        nbytes = F32 * (3 * d["n_atoms"] + d["n_slots"] + d["n_atoms"] + 1)
    elif name == "cell_bin":
        flops = 0
        nbytes = F32 * (2 * d["n_atoms"] + d["n_slots"] + 1)
    elif name in ("patch_weights_fwd", "patch_weights_bwd"):
        o, n = d["order"], d["n_slots"]

        def recursion(top):
            return 5 * (top * (top + 1) // 2 - 3)
        if name == "patch_weights_fwd":
            flops = n * (3 * recursion(o) + d["wx"])
            nbytes = F32 * n * (5 + d["wx"] + d["wyp"] + o + 1)
        else:
            flops = n * (3 * recursion(o - 1) + 9 * o + 8 * o)
            nbytes = F32 * n * (5 + 3 * o + 4)
    elif name in ("exclusion_fwd", "exclusion_bwd"):
        flops = d["n_pairs"] * EXCL_FWD_FLOPS
        nbytes = F32 * 6 * d["n_atoms"]
        if name == "exclusion_bwd":
            flops += d["n_pairs"] * EXCL_BWD_EXTRA_FLOPS
            nbytes += F32 * 4 * d["n_atoms"]
    elif name in ("bonded_fwd", "bonded_bwd"):
        n_m, nb, na, s = (d["n_molecules"], d["n_bonds"], d["n_angles"],
                          d["stride"])
        flops = n_m * (nb * BOND_FWD_FLOPS + na * ANGLE_FWD_FLOPS)
        nbytes = F32 * n_m * (3 * s + 2 * nb + 2 * na)
        if name == "bonded_bwd":
            flops += n_m * (nb * BOND_BWD_EXTRA_FLOPS
                            + na * ANGLE_BWD_EXTRA_FLOPS + 3 * s)
            nbytes += F32 * n_m * 3 * s
    else:
        raise ValueError(f"no bound for kernel {name!r}")
    t_ops, t_mem = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"flops": int(flops), "bytes": int(nbytes),
            "bound_ms": 1e3 * max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def pairs_within_cutoff(x, box, cutoff: float, chunk: int = 1024) -> int:
    """Unordered atom pairs closer than ``cutoff`` under the minimum image
    of ``box``, [3] or a reduced [3, 3] lattice (the pairs the direct walk
    must evaluate)."""
    from ..pairs import delta_periodic

    box = box.to(x.dtype)
    n, count = x.shape[0], 0
    for i0 in range(0, n, chunk):
        d = delta_periodic(x[None, :, :], x[i0:i0 + chunk, None, :], box)
        close = (d * d).sum(-1) < cutoff * cutoff
        rows = torch.arange(i0, min(i0 + chunk, n), device=x.device)
        close &= rows[:, None] < torch.arange(n, device=x.device)[None, :]
        count += int(close.sum())
    return count


def build_system(force, box, cap, device, dtype=torch.float32,
                 grid=(8, 8, 8)):
    """The cell + SPME system (recip_method pinned to "pme", so the f64
    control stays on SPME too); ``grid=None`` takes the planner's cell
    grid."""
    return force.create_system(box=box, dtype=dtype, direct_method="cell",
                               recip_method="pme", cell_grid=grid,
                               cell_capacity=cap, device=device)


#: n_side of the water boxes of the JAX package's bench.py configs.
BENCH_SIDES = {"216": 6, "4k": 11, "30k": 22, "100k": 32}


def shear_box(box):
    """bench.py's tri30k lattice: the orthorhombic ``box`` sheared into the
    reduced lower-triangular [[L, 0, 0], [0.15 L, L, 0], [0.10 L,
    -0.12 L, L]] (NumPy f64)."""
    import numpy as np

    L = np.asarray(box, np.float64)
    return np.array([[L[0], 0.0, 0.0],
                     [0.15 * L[0], L[1], 0.0],
                     [0.10 * L[0], -0.12 * L[1], L[2]]])


def bench_path(config: str, device, cutoff=None):
    """(force, x, masses, box, bonded, system) of one of the JAX package's
    bench.py configs, built as ``build_full`` and ``bench_hetero`` build
    them, f32: "30k" and "tri30k" (the 30k box sheared by
    :func:`shear_box`) at cutoff 0.72 on the forced 8^3 cell grid, "4k"
    and "100k" at cutoff 0.8 on the planner's grid, "hetero30k"
    (``solvated_chain_box(n_side=22, n_solute_sites=100, cutoff=0.72)``,
    forced 8^3, its bonded rows), each with the capacity from
    ``suggest_capacity(margin=1.05)`` and SPME; "216" dense with
    ``recip_method="auto"``.  ``cutoff`` replaces the 30k box's (bench.py's
    rc 0.9 and rc 1.0 legs, on the planner's grid)."""
    from ..bonded import BondedParams
    from ..cells import suggest_capacity
    from ..models import solvated_chain_box, water_bonded_params, water_box

    if config == "216":
        return dense_path(device)
    grid = (8, 8, 8)
    if config == "hetero30k":
        force, pos, masses, box, bonded_kw = solvated_chain_box(
            n_side=22, n_solute_sites=100, cutoff=0.72)
        bonded = BondedParams.create(box=box, pbc=True, device=device,
                                     **bonded_kw)
    else:
        base = config[3:] if config.startswith("tri") else config
        if base not in BENCH_SIDES or base == "216":
            raise ValueError(f"unknown bench config {config!r}")
        if base != "30k" or cutoff is not None:
            grid = None
        if cutoff is None:
            cutoff = 0.72 if base == "30k" else 0.8
        force, pos, masses, box = water_box(n_side=BENCH_SIDES[base],
                                            flux="bond_angle", cutoff=cutoff)
        if config.startswith("tri"):
            box = shear_box(box)
        bonded = water_bonded_params(len(masses) // 3, box=box,
                                     device=device)
    if grid is None:
        grid = force.create_system(box=box, direct_method="cell",
                                   device="cpu").spec.cell_grid
    cap = suggest_capacity(pos, box, grid, margin=1.05)
    system = build_system(force, box, cap, device, grid=grid)
    x = torch.tensor(pos, dtype=torch.float32, device=device)
    m = torch.tensor(masses, dtype=torch.float32, device=device)
    return force, x, m, box, bonded, system


def dense_path(device):
    """(force, x, masses, box, bonded, system) of the JAX package's
    ``bench.py 216`` program at full width, nothing cut: water_box(n_side=6,
    flux="bond_angle", cutoff=0.9), 648 atoms in a 1.8642 nm box, f32,
    dense direct space, classical Ewald with ``recip_method="auto"`` (alpha
    3.2427, kmax (7, 7, 7): 1183 half-space k-vectors, so the
    structure-factor kernel route on a CUDA card)."""
    from ..models import water_bonded_params, water_box

    force, pos, masses, box = water_box(n_side=6, flux="bond_angle",
                                        cutoff=0.9)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="dense", device=device)
    x = torch.tensor(pos, dtype=torch.float32, device=device)
    m = torch.tensor(masses, dtype=torch.float32, device=device)
    bonded = water_bonded_params(len(masses) // 3, box=box, device=device)
    return force, x, m, box, bonded, system


#: Replicas of bench.py's ``replicas`` config.
REPLICAS = 64
#: bench.py replicas' step: x <- x - DESCENT * grad E for every replica.
DESCENT = 1e-9


def replicas_path(device, n_replicas: int = REPLICAS, recip=None) -> dict:
    """bench.py's ``replicas`` config at full width, nothing cut:
    ``water_box(n_side=6, flux="bond_angle")`` (648 atoms, cutoff 0.9,
    dense direct space, classical Ewald), f32, through
    ``parallel.replicas.vmap_friendly_system``; ``n_replicas`` copies each
    moved by 0.01 nm normals from ``np.random.default_rng(0)``.
    ``recip`` pins the reciprocal route ("xla": the plain batched product;
    "pallas": the batched structure-factor kernels).  Returns {force,
    system, x [R, N, 3], masses [N], box}."""
    import dataclasses

    from ..models import water_box
    from ..parallel.replicas import vmap_friendly_system

    force, pos, masses, box = water_box(n_side=6, flux="bond_angle")
    system = vmap_friendly_system(force.create_system(
        box=box, dtype=torch.float32, device=device))
    if recip is not None:
        system = system._swap(spec=dataclasses.replace(system.spec,
                                                       recip_method=recip))
    rng = np.random.default_rng(0)
    batch = np.stack([pos + 0.01 * rng.standard_normal(pos.shape)
                      for _ in range(n_replicas)])
    return {"force": force, "system": system, "box": box,
            "x": torch.tensor(batch, dtype=torch.float32, device=device),
            "masses": torch.tensor(masses, dtype=torch.float32,
                                   device=device)}


def replica_drive(path: dict):
    """(drive, owner) of bench.py's replicas step: ``drive(n_steps,
    graph=True)`` runs x <- x - DESCENT grad E for every replica of the
    path's batch, ``n_steps`` times, in chunks of
    ``parallel.replicas.STEPS_PER_CHUNK`` steps, each a CUDA graph replay
    on the card (``graph=False``: the same chunks eagerly); returns (final
    x, [n_steps] energies summed over the replicas).  ``owner`` keeps the
    chunks."""
    from ..integrate import Chunk, _chunk_getter, _run_chunks
    from ..parallel.replicas import (STEPS_PER_CHUNK, _forces,
                                     replica_energy_fn)

    e_fn = replica_energy_fn(path["system"])
    x0 = path["x"]
    ones = torch.ones(x0.shape[1], dtype=x0.dtype, device=x0.device)

    def make_step(_m, _g):
        def step(carry, _nb):
            e, f = _forces(e_fn, carry[0])
            return (carry[0] + DESCENT * f,), e, torch.sum(e)
        return step

    def drive(n_steps, graph=True):
        def make(k):
            return Chunk(make_step, None, k, (x0,), graph, ones,
                         potential_shape=(x0.shape[0],))

        get = _chunk_getter(e_fn, graph, x0, ones, ("descent", DESCENT),
                            make)
        last, es = _run_chunks(get, (x0,), n_steps, STEPS_PER_CHUNK, ones)
        return last.x.clone(), es
    return drive, e_fn


#: (n_side, cutoff) of the water boxes the structure-factor kernels are
#: timed at: the 216 path's (Kx 7, Ky 13, 2Kz 26, N 648) and a 4k box's
#: (kmax 13^3: Kx 13, Ky 25, 2Kz 50, N 3993).
SF_SHAPES = {"216": (6, 0.9), "4k": (11, 0.8)}


def sf_tables(label: str, device):
    """(tables, system): the structure-factor kernels' inputs (cxT, sxT,
    cyT, syT, zq) of the ``SF_SHAPES[label]`` water box, from its lattice
    positions and flux charges, f32 on ``device``, and its dense system."""
    from .. import ewald
    from ..charges import effective_charges
    from ..models import water_box

    n_side, cutoff = SF_SHAPES[label]
    force, pos, _, box = water_box(n_side=n_side, cutoff=cutoff)
    system = force.create_system(box=box, dtype=torch.float32,
                                 direct_method="dense", device=device)
    x = torch.tensor(pos, dtype=torch.float32, device=device)
    with torch.no_grad():
        tabs = ewald.kernel_inputs(x, effective_charges(x, system),
                                   system.box, system.spec.kmax)
    return tabs, system


def sf_dims(tabs) -> dict:
    """(kx, ky, kz2, n) of structure-factor tables, by name."""
    return dict(kx=tabs[0].shape[0], ky=tabs[2].shape[0],
                kz2=tabs[4].shape[1], n=tabs[0].shape[1])


def burn_in(force, system0, x, masses, box, bonded, n_steps: int = 240):
    """The JAX package's bench.py burn-in: NVE from rest on a capacity-1.35
    twin in rebuild chunks, velocities rescaled to 300 K at each chunk
    boundary; the capacity is re-provisioned from the relaxed occupancy.
    Returns (system, state, rebuild_every, info) with ``state`` evaluated
    on ``system``."""
    from ..cells import suggest_capacity
    from ..integrate import init_state_nb, make_nb_energy_fn, nve_trajectory_nb
    from ..neighbors import suggest_rebuild_interval
    from .diagnose import max_cell_occupancy

    dev = x.device
    n = x.shape[0]
    grid = system0.spec.cell_grid
    cap_burn = suggest_capacity(x.cpu().numpy(), box, grid, margin=1.35)
    burn_sys = build_system(force, box, max(cap_burn,
                                            system0.spec.cell_capacity), dev,
                            grid=grid)
    e_fn, init_nb = make_nb_energy_fn(burn_sys, bonded=bonded)
    state = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    re_burn = suggest_rebuild_interval(burn_sys, DT_PS, max_speed=24.0, cap=40)
    occ = []
    t0 = time.perf_counter()
    for _ in range(max(1, math.ceil(n_steps / re_burn))):
        state, es = nve_trajectory_nb(state, e_fn, init_nb, masses, DT_PS,
                                      re_burn, re_burn)
        if not torch.isfinite(es).all():
            raise RuntimeError("burn-in chunk NaN-poisoned")
        v = state.velocities.double()
        t_cur = float(torch.sum(masses.double()[:, None] * v * v)) / (3 * n * KB)
        state = type(state)(state.positions, (v * math.sqrt(
            300.0 / max(t_cur, 1.0))).float(), state.forces, state.potential,
            state.nb)
        occ.append(max_cell_occupancy(state.positions, burn_sys))
    burn_s = time.perf_counter() - t0
    occ_eq = max(occ[len(occ) // 2:])
    cap_eq = -(-int(math.ceil(occ_eq * 1.05)) // 8) * 8
    system = system0
    if cap_eq > system0.spec.cell_capacity:
        system = build_system(force, box, cap_eq, dev, grid=grid)
    vmax = float(state.velocities.norm(dim=-1).max())
    rebuild_every = suggest_rebuild_interval(
        system, DT_PS, max_speed=max(8.0, 1.2 * vmax), cap=40)
    e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)
    state = init_state_nb(state.positions, state.velocities, e_fn, init_nb)
    info = dict(chunk=re_burn, chunks=len(occ), seconds=burn_s,
                occupancy=occ_eq, vmax=vmax)
    return system, state, rebuild_every, info


def _reprovision(force, system, positions, margin: float = 1.10):
    """bench.py's capacity re-provisioning from one relaxed occupancy
    sample: ``system``, or one with the occupancy times ``margin`` rounded
    up to 8 slots if that is more."""
    from .diagnose import max_cell_occupancy

    occ = max_cell_occupancy(positions, system)
    cap = -(-int(math.ceil(occ * margin)) // 8) * 8
    if cap <= system.spec.cell_capacity:
        return system, occ
    return build_system(force, system.box.cpu().numpy(), cap,
                        system.box.device, grid=system.spec.cell_grid), occ


def rigid_path(device, n_side: int = 22, cutoff: float = 0.72,
               grid=(8, 8, 8), burn_chunks: int = 200, seed: int = 0):
    """The JAX package's ``bench.py rigid`` set-up at the main-path box:
    ``rigid_water_box(n_side=22, cutoff=0.72)`` (31,944 atoms, fixed
    charges, no bonded terms), f32, forced 8^3 cell grid, SPME.  Maxwell
    velocities at 300 K, then ``burn_chunks`` rebuild chunks of
    RATTLE-BAOAB at 2 fs and friction 20/ps on a capacity-1.35 twin with
    ``rebuild_every`` for 12 nm/ps; the capacity re-provisioned from the
    relaxed occupancy (margin 1.10) and ``rebuild_every`` taken from the
    relaxed max speed.  Returns a dict: system, state (evaluated on the
    system), rebuild_every, masses, params, generator (the one the
    burn-in drew from, to draw on), e_fns (``make_nb_energy_fn``), info."""
    from ..cells import suggest_capacity
    from ..constraints import rattle_langevin_trajectory_nb
    from ..integrate import init_state_nb, make_nb_energy_fn, maxwell_velocities
    from ..models import rigid_water_box
    from ..neighbors import suggest_rebuild_interval

    force, pos, masses, box, params = rigid_water_box(
        n_side=n_side, cutoff=cutoff, dtype=torch.float32, device=device)
    cap = suggest_capacity(pos, box, grid, margin=1.1)
    system = build_system(force, box, cap, device, grid=grid)
    burn_sys = build_system(force, box, max(cap, suggest_capacity(
        pos, box, grid, margin=1.35)), device, grid=grid)
    x = torch.tensor(pos, dtype=torch.float32, device=device)
    m = torch.tensor(masses, dtype=torch.float32, device=device)
    e_fn, init_nb = make_nb_energy_fn(burn_sys)
    hot = suggest_rebuild_interval(burn_sys, DT_RIGID, max_speed=12.0, cap=10)
    gen = torch.Generator(device).manual_seed(seed)
    s0 = init_state_nb(x, maxwell_velocities(m, TEMP, gen,
                                             dtype=torch.float32),
                       e_fn, init_nb)
    t0 = time.perf_counter()
    s_eq, kes = rattle_langevin_trajectory_nb(
        s0, e_fn, init_nb, m, DT_RIGID, TEMP, 20.0, gen, burn_chunks * hot,
        params, rebuild_every=hot)
    if not torch.isfinite(kes).all():
        raise RuntimeError("rigid burn-in NaN-poisoned")
    burn_s = time.perf_counter() - t0
    system, occ = _reprovision(force, system, s_eq.positions)
    vmax = float(s_eq.velocities.norm(dim=-1).max())
    rebuild_every = suggest_rebuild_interval(
        system, DT_RIGID, max_speed=max(4.0, 1.2 * vmax), cap=40)
    e_fns = make_nb_energy_fn(system)
    state = init_state_nb(s_eq.positions, s_eq.velocities, *e_fns)
    return dict(system=system, state=state, rebuild_every=rebuild_every,
                masses=m, params=params, generator=gen, e_fns=e_fns,
                info=dict(chunk=hot, steps=burn_chunks * hot,
                          seconds=burn_s, occupancy=occ, vmax=vmax))


def respa_path(device, n_side: int = 22, cutoff: float = 0.72,
               grid=(8, 8, 8), burn_steps: int = 400, seed: int = 0):
    """The JAX package's ``bench.py respa`` set-up at the main-path box:
    flexible ``water_box(n_side=22, flux="bond_angle", cutoff=0.72)`` with
    ``water_bonded_params``, f32, forced 8^3 cell grid, SPME.  Maxwell
    velocities at 300 K, then ``burn_steps`` (rounded up to whole chunks)
    of 0.5 fs BAOAB at friction 20/ps on a capacity-1.35 twin; the
    capacity re-provisioned from the relaxed occupancy (margin 1.10) and
    ``rebuild_every`` (outer steps of 2 fs) from the relaxed max speed
    (times 1.2, at least 8 nm/ps), as for the rigid path: bench.py's flat
    8 nm/ps bound (every 4 outer steps at 30k) let atoms outrun skin/2,
    and the freshness guard NaN-poisoned a replayed run on the card.
    Returns a dict: system, state, bonded,
    rebuild_every, masses, generator, fns (``make_respa_force_fns``),
    info."""
    from ..cells import suggest_capacity
    from ..integrate import (init_state_nb, langevin_trajectory_nb,
                             make_nb_energy_fn, make_respa_force_fns,
                             maxwell_velocities)
    from ..models import water_bonded_params, water_box
    from ..neighbors import suggest_rebuild_interval

    force, pos, masses, box = water_box(n_side=n_side, flux="bond_angle",
                                        cutoff=cutoff)
    cap = suggest_capacity(pos, box, grid, margin=1.05)
    system = build_system(force, box, cap, device, grid=grid)
    burn_sys = build_system(force, box, max(cap, suggest_capacity(
        pos, box, grid, margin=1.35)), device, grid=grid)
    x = torch.tensor(pos, dtype=torch.float32, device=device)
    m = torch.tensor(masses, dtype=torch.float32, device=device)
    bonded = water_bonded_params(len(masses) // 3, box=box, device=device)
    e_fn, init_nb = make_nb_energy_fn(burn_sys, bonded=bonded)
    every_b = suggest_rebuild_interval(burn_sys, DT_PS, max_speed=24.0,
                                       cap=10)
    n_burn = -(-burn_steps // every_b) * every_b
    gen = torch.Generator(device).manual_seed(seed)
    s0 = init_state_nb(x, maxwell_velocities(m, TEMP, gen,
                                             dtype=torch.float32),
                       e_fn, init_nb)
    t0 = time.perf_counter()
    s_eq, kes = langevin_trajectory_nb(s0, e_fn, init_nb, m, DT_PS, TEMP,
                                       20.0, gen, n_burn, every_b)
    if not torch.isfinite(kes).all():
        raise RuntimeError("RESPA burn-in NaN-poisoned")
    burn_s = time.perf_counter() - t0
    system, occ = _reprovision(force, system, s_eq.positions)
    fns = make_respa_force_fns(system, bonded)
    vmax = float(s_eq.velocities.norm(dim=-1).max())
    rebuild_every = suggest_rebuild_interval(
        system, DT_PS * N_INNER, max_speed=max(8.0, 1.2 * vmax), cap=40)
    state = init_state_nb(s_eq.positions, s_eq.velocities, fns[0], fns[2])
    return dict(system=system, state=state, bonded=bonded,
                rebuild_every=rebuild_every, masses=m, generator=gen,
                fns=fns, info=dict(chunk=every_b, steps=n_burn,
                                   seconds=burn_s, occupancy=occ, vmax=vmax))


# The on-ramp's residue tables (the JAX package's examples/run_peptide_pdb.py):
# a 3-atom peptide-like backbone (N, CA, C) with intra flux bonds,
# exclusions, harmonic geometry and "-" links to the previous residue, and
# flexible flux water; as ResidueParams keyword arguments, filled in from
# the water model's constants by :func:`peptide_tables`.
GLY_TABLE = dict(
    atoms={"N": (0.25, 0.21, 0.2, 14.007),
           "CA": (-0.1, 0.23, 0.15, 12.011),
           "C": (-0.15, 0.22, 0.12, 12.011)},
    flux_bonds=[("N", "CA", 0.35, 0.146), ("CA", "C", 0.3, 0.152)],
    exclusions=[("N", "CA"), ("CA", "C"), ("N", "C")],
    bonds=[("N", "CA", 60000.0, 0.14), ("CA", "C", 60000.0, 0.14)],
    angles=[("N", "CA", "C", 300.0, 3.0)],
    link_exclusions=[("-C", "N"), ("-CA", "N")],
    link_flux_bonds=[("-C", "N", 0.4, 0.133)],
    link_bonds=[("-C", "N", 70000.0, 0.135)],
    link_angles=[("-CA", "-C", "N", 280.0, 3.0)],
)
TORSION_K, TORSION_N, TORSION_PHI0 = 2.0, 3.0, 0.0   # backbone, kJ/mol


def peptide_tables(residue_params=None) -> dict:
    """{"GLY": ..., "HOH": ...} as ``residue_params(**kwargs)`` (the
    port's ``models.ResidueParams`` by default; the tests pass the JAX
    package's to build the same system there)."""
    from ..models import water as w

    if residue_params is None:
        from ..models import ResidueParams as residue_params
    hoh = dict(
        atoms={"O": (w.Q_O, w.SIG_O, w.EPS_O, 15.999),
               "H1": (w.Q_H, w.SIG_H, w.EPS_H, 1.008),
               "H2": (w.Q_H, w.SIG_H, w.EPS_H, 1.008)},
        flux_bonds=[("O", "H1", w.K_BOND, w.R_OH),
                    ("O", "H2", w.K_BOND, w.R_OH)],
        flux_angles=[("H1", "O", "H2", w.K_ANGLE, w.ANGLE_HOH)],
        exclusions=[("O", "H1"), ("O", "H2"), ("H1", "H2")],
        bonds=[("O", "H1", w.KB_OH, w.R_OH), ("O", "H2", w.KB_OH, w.R_OH)],
        angles=[("H1", "O", "H2", w.KA_HOH, w.ANGLE_HOH)],
    )
    return {"GLY": residue_params(**GLY_TABLE),
            "HOH": residue_params(**hoh)}


def write_peptide_pdb(path, n_res: int = 16, n_side: int = 22,
                      seed: int = 11, resseq_gap_after=None):
    """The JAX package's examples/run_peptide_pdb.py input at any size: an
    ``n_res``-residue GLY backbone row (N, CA, C, 0.135 nm apart) along x
    through the box centre of an ``n_side``^3 water lattice (0.31 nm
    apart), the row's lattice sites left out, written by
    ``utils.trajectory.write_pdb`` with a CRYST1 box.  At n_side 22 and 16
    residues: 10,626 waters and 48 backbone atoms, 31,926 atoms in a
    6.82 nm box.  ``resseq_gap_after`` numbers the residues after that one
    two higher (a chain break).  Returns (positions, box)."""
    from ..models.water import _one_water
    from .trajectory import write_pdb

    rng = np.random.default_rng(seed)
    spacing = 0.31
    box = np.full(3, n_side * spacing)
    pos, names, resnames, resseq = [], [], [], []
    for r in range(n_res):
        num = r + 1 + (2 if resseq_gap_after is not None
                       and r >= resseq_gap_after else 0)
        for j, nm in enumerate(("N", "CA", "C")):
            pos.append([0.12 + 0.135 * (3 * r + j), box[1] / 2, box[2] / 2]
                       + 0.01 * rng.standard_normal(3))
            names.append(nm)
            resnames.append("GLY")
            resseq.append(num)
    k = 0
    mid = n_side // 2
    first = max(resseq) + 1
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                if iy == mid and iz == mid:
                    continue                        # the chain's row
                c = spacing * (np.array([ix, iy, iz]) + 0.5)
                pos.extend(_one_water(c + 0.01 * rng.standard_normal(3),
                                      rng))
                names.extend(["O", "H1", "H2"])
                resnames.extend(["HOH"] * 3)
                resseq.extend([first + k] * 3)
                k += 1
    pos = np.asarray(pos)
    write_pdb(path, pos, box=box, names=names, resnames=resnames,
              resseq=resseq, symbols=[nm[0] for nm in names])
    return pos, box


def backbone_torsions(n_res: int, first: int = 0):
    """The backbone's torsion rows (N-CA-C-N, CA-C-N-CA, C-N-CA-C at each
    residue junction: every 4 consecutive backbone atoms) with
    k = 2 kJ/mol, n = 3, phi0 = 0, as ``BondedParams.create`` keywords."""
    idx = first + np.arange(3 * n_res - 3)[:, None] + np.arange(4)[None, :]
    t = idx.shape[0]
    return dict(torsion_idx=idx, torsion_k=np.full(t, TORSION_K),
                torsion_n=np.full(t, TORSION_N),
                torsion_phi0=np.full(t, TORSION_PHI0))


def onramp_system(path, device, cutoff: float = 0.72, grid=(8, 8, 8),
                  n_res: int = 16):
    """The on-ramp's f32 system from the PDB at ``path``:
    ``system_from_pdb`` with :func:`peptide_tables`, ``create_system`` on
    the cell + SPME route (``grid`` forced, or the planner's for None;
    capacity ``suggest_capacity(margin=1.05)``), and the bonded terms with
    the backbone torsions.  Returns (force, x, masses, box, bonded,
    system)."""
    from ..bonded import BondedParams
    from ..cells import suggest_capacity
    from ..models import system_from_pdb

    force, pos, masses, box, bonded_kw = system_from_pdb(
        path, peptide_tables(), cutoff=cutoff)
    if grid is None:
        grid = force.create_system(box=box, direct_method="cell",
                                   device="cpu").spec.cell_grid
    cap = suggest_capacity(pos, box, grid, margin=1.05)
    system = build_system(force, box, cap, device, grid=grid)
    bonded = BondedParams.create(box=box, pbc=True, device=device,
                                 **bonded_kw, **backbone_torsions(n_res))
    x = torch.tensor(pos, dtype=torch.float32, device=device)
    m = torch.tensor(masses, dtype=torch.float32, device=device)
    return force, x, m, box, bonded, system


def langevin_path(force, system, x, masses, box, bonded, device,
                  burn_steps: int = 400, seed: int = 0):
    """A flexible system's NVT set-up, as :func:`respa_path` burns in:
    Maxwell velocities at 300 K, ``burn_steps`` (rounded up to whole
    chunks) of 0.5 fs BAOAB at friction 20/ps on a capacity-1.35 twin, the
    capacity re-provisioned from the relaxed occupancy (margin 1.10) and
    ``rebuild_every`` from the relaxed max speed (times 1.2, at least
    8 nm/ps).  Returns a dict: system, state, bonded, rebuild_every,
    masses, generator, e_fns (``make_nb_energy_fn``), info."""
    from ..cells import suggest_capacity
    from ..integrate import (init_state_nb, langevin_trajectory_nb,
                             make_nb_energy_fn, maxwell_velocities)
    from ..neighbors import suggest_rebuild_interval

    grid = system.spec.cell_grid
    pos = x.detach().cpu().double().numpy()
    burn_sys = build_system(force, box, max(
        system.spec.cell_capacity,
        suggest_capacity(pos, box, grid, margin=1.35)), device,
        dtype=x.dtype, grid=grid)
    e_fn, init_nb = make_nb_energy_fn(burn_sys, bonded=bonded)
    every_b = suggest_rebuild_interval(burn_sys, DT_PS, max_speed=24.0,
                                       cap=10)
    n_burn = -(-burn_steps // every_b) * every_b
    gen = torch.Generator(device).manual_seed(seed)
    s0 = init_state_nb(x, maxwell_velocities(masses, TEMP, gen,
                                             dtype=x.dtype),
                       e_fn, init_nb)
    t0 = time.perf_counter()
    s_eq, kes = langevin_trajectory_nb(s0, e_fn, init_nb, masses, DT_PS,
                                       TEMP, 20.0, gen, n_burn, every_b)
    if not torch.isfinite(kes).all():
        raise RuntimeError("Langevin burn-in NaN-poisoned")
    burn_s = time.perf_counter() - t0
    system, occ = _reprovision(force, system, s_eq.positions)
    vmax = float(s_eq.velocities.norm(dim=-1).max())
    rebuild_every = suggest_rebuild_interval(
        system, DT_PS, max_speed=max(8.0, 1.2 * vmax), cap=40)
    e_fns = make_nb_energy_fn(system, bonded=bonded)
    state = init_state_nb(s_eq.positions, s_eq.velocities, *e_fns)
    return dict(system=system, state=state, bonded=bonded,
                rebuild_every=rebuild_every, masses=masses, generator=gen,
                e_fns=e_fns, info=dict(chunk=every_b, steps=n_burn,
                                       seconds=burn_s, occupancy=occ,
                                       vmax=vmax))


def onramp_path(device, n_side: int = 22, n_res: int = 16,
                cutoff: float = 0.72, grid=(8, 8, 8), burn_steps: int = 400,
                directory=None):
    """onramp30k: the JAX package's "PDB + parameter table -> Context"
    workflow at the main-path size.  :func:`write_peptide_pdb` writes the
    peptide-in-water PDB (31,926 atoms at the defaults) into ``directory``
    (a temporary one by default), :func:`onramp_system` reads it back
    through ``system_from_pdb`` into an f32 cell + SPME system on the
    forced 8^3 grid with the backbone torsions, and
    :func:`langevin_path` burns it in.  Returns that dict plus pdb (the
    file's path), force, box and pdb_positions (the positions written)."""
    import os
    import tempfile

    if directory is None:
        directory = tempfile.mkdtemp(prefix="onramp")
    pdb = os.path.join(directory, "peptide_water.pdb")
    written, _ = write_peptide_pdb(pdb, n_res=n_res, n_side=n_side)
    force, x, m, box, bonded, system = onramp_system(
        pdb, device, cutoff=cutoff, grid=grid, n_res=n_res)
    path = langevin_path(force, system, x, m, box, bonded, device,
                         burn_steps=burn_steps)
    path.update(pdb=pdb, force=force, box=box, pdb_positions=written)
    return path


def langevin_drive(path: dict):
    """:func:`nve_drive` of a Langevin NVT path (:func:`langevin_path`):
    ``langevin_trajectory_nb`` at 0.5 fs, 300 K, friction 5/ps, drawing
    from the path's generator; records: the kinetic energies."""
    from ..integrate import langevin_trajectory_nb, make_nb_energy_fn

    fns = {False: path["e_fns"], True: make_nb_energy_fn(
        path["system"].with_kernel_route("plain"), bonded=path["bonded"])}

    def drive(n_steps, graph=True, plain=False):
        return langevin_trajectory_nb(
            path["state"], *fns[plain], path["masses"], DT_PS, TEMP,
            FRICTION, path["generator"], n_steps, path["rebuild_every"],
            graph=graph)
    return drive, fns[False][0], fns[False][1]


RBE_SAMPLES = 128         # p, the JAX package's choice at 0.5 fs, 20/ps
RBE_FRICTION = 20.0       # 1/ps


def rbe_drive(system, state, rebuild_every, masses, bonded, generator,
              n_samples: int = RBE_SAMPLES):
    """:func:`nve_drive` of random batch Ewald NVT on a burned-in state:
    ``rbe_langevin_trajectory_nb`` at 0.5 fs, 300 K, friction 20/ps, p =
    ``n_samples`` k-vectors a step, drawing from ``generator``; records:
    the kinetic energies; ``plain``: over the plain route."""
    from ..rbe import make_rbe_nb_energy_fn, rbe_langevin_trajectory_nb

    fns = {p: make_rbe_nb_energy_fn(s, n_samples, bonded=bonded) for p, s
           in ((False, system), (True, system.with_kernel_route("plain")))}

    def drive(n_steps, graph=True, plain=False):
        return rbe_langevin_trajectory_nb(
            state, *fns[plain], masses, DT_PS, TEMP, RBE_FRICTION,
            generator, n_steps, rebuild_every, graph=graph)
    return drive, fns[False][0], fns[False][1]


def spme_langevin_drive(system, state, rebuild_every, masses, bonded,
                        generator):
    """The SPME counterpart of :func:`rbe_drive` (``langevin_trajectory_nb``
    at the same dt, temperature and friction): the step RBE replaces."""
    from ..integrate import langevin_trajectory_nb, make_nb_energy_fn

    fns = {p: make_nb_energy_fn(s, bonded=bonded) for p, s in
           ((False, system), (True, system.with_kernel_route("plain")))}

    def drive(n_steps, graph=True, plain=False):
        return langevin_trajectory_nb(
            state, *fns[plain], masses, DT_PS, TEMP, RBE_FRICTION,
            generator, n_steps, rebuild_every, graph=graph)
    return drive, fns[False][0], fns[False][1]


def npt_path(device, n_side: int = 22, cutoff: float = 0.72,
             grid=(8, 8, 8), burn_steps: int = 400, seed: int = 0):
    """The JAX package's ``bench.py npt`` set-up (``bench_npt``): flexible
    ``water_box(n_side=22, flux="bond_angle", cutoff=0.72)`` with
    ``water_bonded_params``, f32, forced 8^3 cell grid, SPME, the capacity
    from ``suggest_capacity(margin=1.05)``.  From rest, ``burn_steps``
    (rounded up to whole chunks) of 0.5 fs BAOAB at 300 K and friction
    20/ps on a capacity-1.35 twin, rebuilt for 24 nm/ps; the capacity
    re-provisioned to 1.10 x the relaxed peak occupancy, and the barostat
    interval (the rebuild interval) ``suggest_rebuild_interval(max_speed=
    max(8, 1.2 vmax), cap=40)``.  Returns a dict: system, state (evaluated
    on the system), bonded, rebuild_every (the barostat interval), masses,
    generator (the one the burn-in drew from), e_fns
    (``make_nb_energy_fn``), info."""
    from ..cells import suggest_capacity
    from ..integrate import (init_state_nb, langevin_trajectory_nb,
                             make_nb_energy_fn)
    from ..models import water_bonded_params, water_box
    from ..neighbors import suggest_rebuild_interval

    force, pos, masses, box = water_box(n_side=n_side, flux="bond_angle",
                                        cutoff=cutoff)
    cap = suggest_capacity(pos, box, grid, margin=1.05)
    system = build_system(force, box, cap, device, grid=grid)
    burn_sys = build_system(force, box, max(cap, suggest_capacity(
        pos, box, grid, margin=1.35)), device, grid=grid)
    x = torch.tensor(pos, dtype=torch.float32, device=device)
    m = torch.tensor(masses, dtype=torch.float32, device=device)
    bonded = water_bonded_params(len(masses) // 3, box=box, device=device)
    e_fn, init_nb = make_nb_energy_fn(burn_sys, bonded=bonded)
    every_b = suggest_rebuild_interval(burn_sys, DT_PS, max_speed=24.0,
                                       cap=10)
    n_burn = -(-burn_steps // every_b) * every_b
    gen = torch.Generator(device).manual_seed(seed)
    s0 = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    t0 = time.perf_counter()
    s_eq, kes = langevin_trajectory_nb(s0, e_fn, init_nb, m, DT_PS, TEMP,
                                       20.0, gen, n_burn, every_b)
    if not torch.isfinite(kes).all():
        raise RuntimeError("NPT burn-in NaN-poisoned")
    burn_s = time.perf_counter() - t0
    system, occ = _reprovision(force, system, s_eq.positions)
    vmax = float(s_eq.velocities.norm(dim=-1).max())
    interval = suggest_rebuild_interval(
        system, DT_PS, max_speed=max(8.0, 1.2 * vmax), cap=40)
    e_fns = make_nb_energy_fn(system, bonded=bonded)
    state = init_state_nb(s_eq.positions, s_eq.velocities, *e_fns)
    return dict(system=system, state=state, bonded=bonded,
                rebuild_every=interval, masses=m, generator=gen, e_fns=e_fns,
                info=dict(chunk=every_b, steps=n_burn, seconds=burn_s,
                          occupancy=occ, vmax=vmax))


class NPTRun(NamedTuple):
    """What one NPT drive returns beside its energies: the final
    positions, velocities and box, and the driver's ``diag``."""

    positions: torch.Tensor
    velocities: torch.Tensor
    box: torch.Tensor
    diag: dict


def npt_drive(path: dict):
    """:func:`nve_drive` of the NPT path (:func:`npt_path`):
    ``npt_langevin_trajectory`` from the path's state at 300 K, friction
    5/ps, 1 bar, one attempt per ``rebuild_every`` steps, drawing from the
    path's generator; ``drive(n_steps, graph, plain)`` returns
    (:class:`NPTRun`, per-step total energies) and takes no plain path.
    The chunks are kept on the system."""
    from ..npt import npt_langevin_trajectory

    s = path["state"]

    def drive(n_steps, graph=True, plain=False):
        if plain:
            raise ValueError("the NPT drive has no plain path")
        x, v, box, diag = npt_langevin_trajectory(
            s.positions, s.velocities, path["system"], path["masses"],
            DT_PS, TEMP, FRICTION, PRESSURE_BAR, path["generator"], n_steps,
            bonded=path["bonded"], barostat_interval=path["rebuild_every"],
            graph=graph)
        return NPTRun(x, v, box, diag), diag["energies"]
    return drive, path["system"], path["e_fns"][1]


def proposal_work(path: dict):
    """One barostat attempt at the NPT path's state, as the driver runs it
    (``npt.isotropic_attempt``: its draws, the centroids, positions and
    box scaled, the forward energy with its own binning and the bonded
    terms, the acceptance), at the driver's starting width, drawing from
    the default generator (which a graph capture registers); returns the
    potential after the attempt."""
    from ..npt import (BAR_TO_KJ_MOL_NM3, bonded_rows, isotropic_attempt,
                       molecules, proposal_energy)
    from ..pairs import box_volume

    system, bonded, x = path["system"], path["bonded"], path["state"].positions
    mols = molecules(system, bonded_rows(bonded))
    e_at = proposal_energy(system, bonded)
    box = system.box
    dv = 0.01 * box_volume(box)       # npt_langevin_trajectory's dv_frac
    with torch.no_grad():
        e_old = e_at(x, box)

    def run():
        with torch.no_grad():
            return isotropic_attempt(x, box, dv, e_old, mols, e_at, None,
                                     KB * TEMP,
                                     PRESSURE_BAR * BAR_TO_KJ_MOL_NM3)[3]
    return run


def thermostat_drive(kind: str, system, state, rebuild_every, masses,
                     bonded, generator=None):
    """:func:`nve_drive` of a thermostatted NVT path on a burned-in state:
    ``csvr_trajectory_nb`` (tau :data:`TAU_CSVR`, drawing from
    ``generator``; records: the kinetic energies) or
    ``nose_hoover_trajectory_nb`` (tau :data:`TAU_NHC`, a chain of 3
    from rest; records: the kinetic energies), at 300 K; no plain path."""
    from ..csvr import csvr_trajectory_nb
    from ..integrate import make_nb_energy_fn
    from ..nosehoover import nose_hoover_trajectory_nb

    e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)

    def drive(n_steps, graph=True, plain=False):
        if plain:
            raise ValueError(f"the {kind} drive has no plain path")
        if kind == "csvr":
            fin, diag = csvr_trajectory_nb(state, e_fn, init_nb, masses,
                                           DT_PS, TEMP, TAU_CSVR, generator,
                                           n_steps, rebuild_every,
                                           graph=graph)
            return fin, diag["kinetic"]
        fin, _chain, kes = nose_hoover_trajectory_nb(
            state, e_fn, init_nb, masses, DT_PS, TEMP, TAU_NHC, n_steps,
            rebuild_every, graph=graph)
        return fin, kes
    return drive, e_fn, init_nb


def chain_work(state, masses):
    """One NHC step's two chain half updates (chain of 3, 3N - 3 degrees
    of freedom) at a state's velocities: the scalar chain the profile's
    Nose-Hoover path adds to a step."""
    from ..integrate import kinetic_energy
    from ..nosehoover import _nhc_half, nhc_init

    v = state.velocities
    n_dof = 3 * v.shape[0] - 3
    chain = nhc_init(n_dof, TEMP, TAU_NHC, 3, v.dtype, v.device)
    kt = KB * TEMP

    def run():
        ke2 = 2.0 * kinetic_energy(v, masses)
        s1, ch = _nhc_half(chain, ke2, n_dof, kt, 0.5 * DT_PS)
        s2, ch = _nhc_half(ch, ke2 * s1 * s1, n_dof, kt, 0.5 * DT_PS)
        return s2, ch
    return run


def ns_per_day(dt_ps: float, ms_per_step: float) -> float:
    """Simulated ns per day at ``ms_per_step`` for a step of ``dt_ps``."""
    return dt_ps * 86400.0 / ms_per_step


def call_graph(fn):
    """A CUDA graph of GRAPH_REPS back-to-back calls of ``fn``, warmed up
    first on the capture's side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(GRAPH_REPS):
            fn()
    return graph


def interleaved_ms(fns, before=None) -> list:
    """Median CUDA-event ms per call of each function over ROUNDS rounds:
    in each, the graph of every function is replayed once, in turns (the
    order reversed every other round).  Device time, no host enqueue."""
    return replayed_ms([call_graph(fn) for fn in fns], before)


def replayed_ms(graphs, before=None) -> list:
    """:func:`interleaved_ms` of graphs already captured by
    :func:`call_graph`; ``before()`` (a barrier of a process group, so
    that every rank replays in step) runs before each replay."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = [[] for _ in graphs]
    order = list(range(len(graphs)))
    for r in range(ROUNDS):
        for k in order if r % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            if before is not None:
                before()
            a.record()
            graphs[k].replay()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b) / GRAPH_REPS)
    return [statistics.median(t) for t in times]


def eager_ms(fn, reps: int = 3, before=None, cuda: bool = True) -> float:
    """ms per call of ``fn`` over ``reps`` calls after a warm one, with
    ``before()`` (a barrier, say) between them: CUDA events on the card,
    the host clock with ``cuda=False``."""
    fn()
    if cuda:
        torch.cuda.synchronize()
    if before is not None:
        before()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


HALO_TOL_F32 = 1e-5   # the halo route against the single-card route, f32


def energy_forces(e_fn, x, *args):
    """(energy, forces) of ``e_fn(x, *args)``: the energy detached and
    -dE/dx of its sum, taken at a fresh leaf copy of ``x``."""
    xg = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        e = e_fn(xg, *args)
        (g,) = torch.autograd.grad(e.sum(), xg)
    return e.detach(), -g


def energy_scale(x, system) -> float:
    """sum over the energy components of |E_c| at ``x``: the scale of an
    f32 energy comparison (the total cancels far below its terms)."""
    from ..energy import energy_components

    with torch.no_grad():
        return sum(float(v.abs()) for v in
                   energy_components(x, system).values())


def rel_errors(e, f, e_ref, f_ref, scale: float) -> tuple:
    """(|e - e_ref| / scale, RMS(f - f_ref) / RMS(f_ref)), in f64."""
    d_e = abs(float(e) - float(e_ref)) / scale
    d_f = float(torch.sqrt(torch.mean((f.double() - f_ref.double()) ** 2))
                / torch.sqrt(torch.mean(f_ref.double() ** 2)))
    return d_e, d_f


def spread_inputs(x, system):
    """The spread's arguments at positions ``x`` (``spread_columns``'s
    (qwlxt, wlyt, wzt, zorg, offsets, pad_xy)) and the cell blocks."""
    from .. import cells, pme
    from ..charges import effective_charges
    from ..neighbors import build_neighbor_state

    with torch.no_grad():
        nb = build_neighbor_state(x, system)
        if int(nb.overflow) != 0:
            raise RuntimeError("binning overflow at these positions")
        b = cells.blockify(x, effective_charges(x, system), system,
                           nb.slots, nb.inv_slot, wrap=nb.wrap)
        ids = nb.slots.reshape(b.x.shape)
        return pme.column_spread_inputs(b, ids, system), b, ids


def patch_weight_inputs(b, ids, system):
    """The arguments of ``ops.pme_weights.patch_weights_fwd`` for the cell
    blocks ``b`` (x, y, z, q, ids, lengths, n_atoms, geometry) and the
    reciprocal energy's cotangents of its three weight outputs (through
    the plain spread and the mesh energy)."""
    from .. import pme
    from ..ops import pme_spread as ps
    from ..ops import pme_weights as pw

    geom, offsets, pad_xy = pme.column_patch_geometry(system.spec)
    with torch.no_grad():
        coords, lengths = pme._block_spread_coords(b, system.box)
        args = (*coords, b.q, ids, lengths, system.n_atoms, geom)
        w = pw.patch_weights_fwd_plain(*args)
    with torch.enable_grad():
        qpad = ps.spread_fwd_plain(*w, offsets, pad_xy).requires_grad_(True)
        (ct,) = torch.autograd.grad(pme.mesh_energy(qpad, system), qpad)
    with torch.no_grad():
        return args, ps.spread_bwd_plain(*w, offsets, ct.contiguous())


def exclusion_inputs(system, x, seed: int = 0, drift: float = 0.01):
    """The exclusion kernels' tensor arguments (positions, q, sigma,
    epsilon, box) of ``system`` at ``x``: the whole box shifted by a random
    fraction of its edges and each atom moved by up to ``drift`` nm per
    coordinate (a generator seeded with ``seed``; the default keeps bond
    lengths within some 20 % of the lattice's), then wrapped atom by atom
    into the box, so that molecules straddle its faces; with the effective
    charges there."""
    from ..charges import effective_charges

    box = system.box
    x = wrapped_positions(x, box, seed, drift)
    with torch.no_grad():
        q = effective_charges(x, system).contiguous()
    return (x, q, system.sigma.to(x.dtype), system.epsilon.to(x.dtype),
            box)


def wrapped_positions(x, box, seed: int = 0, drift: float = 0.01):
    """``x`` shifted by a random fraction of the box [3]'s edges, each atom
    moved by up to ``drift`` nm per coordinate (a generator seeded with
    ``seed``), then wrapped atom by atom into the box (contiguous); with
    ``box`` None (no periodicity), only moved."""
    g = torch.Generator(x.device).manual_seed(seed)

    def uniform(shape):
        return torch.rand(shape, device=x.device, generator=g, dtype=x.dtype)

    with torch.no_grad():
        if box is None:
            return (x + drift * (2.0 * uniform(x.shape) - 1.0)).contiguous()
        x = x + box * uniform((3,)) + drift * (2.0 * uniform(x.shape) - 1.0)
        return (x - box * torch.floor(x / box)).contiguous()


def bonded_inputs(bonded, x, seed: int = 0, drift: float = 0.01):
    """Per template of ``bonded``, the bonded kernels' arguments at ``x``
    (:func:`wrapped_positions` in its box, so that molecules straddle the
    box's faces): (positions, bond_k, bond_r0, angle_k, angle_theta0, box,
    template, b0, a0, pbc), b0 and a0 the template's first parameter
    rows.  Without periodicity the atoms are only moved."""
    x = wrapped_positions(x, bonded.box if bonded.pbc else None, seed, drift)
    out, b0, a0 = [], 0, 0
    for tpl in bonded.template.templates:
        out.append((x, bonded.bond_k, bonded.bond_r0, bonded.angle_k,
                    bonded.angle_theta0, bonded.box, tpl, b0, a0,
                    bonded.pbc))
        b0 += tpl.count * len(tpl.local_rows("bonds"))
        a0 += tpl.count * len(tpl.local_rows("angles"))
    return out


def bonded_scale(args) -> float:
    """The sum over a template's rows of each row's |energy| (the bonded
    kernels' arguments ``args``, :func:`bonded_inputs`): the scale of its
    energy's round-off."""
    from ..ops.bonded_terms import _angle_e, _bond_e

    x, bk, br0, ak, at0, box, tpl, b0, a0, pbc = args
    c, s = tpl.count, tpl.stride
    p = x[tpl.offset:tpl.offset + c * s].reshape(c, s, 3)
    total = 0.0
    with torch.no_grad():
        for rows, k, v, start, fn in (
                (tpl.local_rows("bonds"), bk, br0, b0, _bond_e),
                (tpl.local_rows("angles"), ak, at0, a0, _angle_e)):
            m = len(rows)
            k = k[start:start + c * m].reshape(c, m, 1)
            v = v[start:start + c * m].reshape(c, m, 1)
            for t, row in enumerate(rows):
                e = fn(*(p[:, i, None] for i in row), k[:, t], v[:, t], box,
                       pbc)
                total += float(e.double().abs().sum())
    return total


def exclusion_scale(args, tpl, spec, subtract_direct: bool) -> float:
    """The sum over template ``tpl``'s pairs of each pair's |correction|
    (``ops.exclusion.pair_terms`` on one pair at a time): the scale of its
    energy's round-off."""
    from ..ops.exclusion import pair_terms

    x, q, sig, eps, box = args
    sl = slice(tpl.offset, tpl.offset + tpl.count * tpl.stride)
    shape = (tpl.count, tpl.stride)
    pos, q, sig, eps = (x[sl].reshape(shape + (3,)), q[sl].reshape(shape),
                        sig[sl].reshape(shape), eps[sl].reshape(shape))
    total = 0.0
    with torch.no_grad():
        for l1, l2 in tpl.local_rows("exclusions"):
            e = pair_terms(pos[:, l1, None], pos[:, l2, None],
                           *(t[:, i, None] for t in (q, sig, eps)
                             for i in (l1, l2)), box, spec,
                           subtract_direct, template=True)
            total += float(e.double().abs().sum())
    return total


def drifted_blocks(system, state, e_fn, masses, n_steps: int):
    """The walk's arguments after ``n_steps`` NVE steps from ``state`` on
    its neighbor state, with no rebuild: the blocks are gathered with the
    slots and the wrap frozen at the last rebuild, so atoms have left their
    cells' nominal bounds, as on every step between two rebuilds.  Returns
    (walk_args, info): the arguments of ``ops.direct_walk.direct_walk`` and
    the count of real atoms outside their cell's nominal bounds, the
    largest displacement since the rebuild and the drifted positions."""
    from .. import cells
    from ..charges import effective_charges
    from ..integrate import nve_step_nb
    from ..pairs import frac_coords

    nb = state.nb
    for _ in range(n_steps):
        state = nve_step_nb(state, e_fn, masses, DT_PS)
    if not torch.isfinite(state.potential):
        raise RuntimeError("drifted_blocks: the neighbor state went stale")
    x = state.positions
    spec = system.spec
    with torch.no_grad():
        b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                           nb.inv_slot, wrap=nb.wrap)
        ids = nb.slots.reshape(b.x.shape).to(torch.int32).contiguous()
        outside = torch.zeros_like(ids, dtype=torch.bool)
        # a cell's nominal bounds in fractional coordinates (the binning's)
        frac = frac_coords(torch.stack([b.x, b.y, b.z], dim=-1), system.box)
        for k in range(3):
            n = spec.cell_grid[k]
            shape = [1, 1, 1, 1]
            shape[k] = n
            lo = torch.arange(n, device=x.device).view(shape)
            u = frac[..., k] * n
            outside |= (u < lo) | (u >= lo + 1)
        info = dict(outside=int((outside & (ids < system.n_atoms)).sum()),
                    moved=float((x - nb.x_ref).norm(dim=-1).max()),
                    positions=x.detach())
    return (*b, ids, system.box, system.n_atoms, spec.alpha,
            spec.cutoff), info


def binning_cells(system, x, decomp=(1, 1), rank: int = 0):
    """(cell ids [N] int32, n_cells) that ``system``'s binning ranks at
    positions ``x`` on rank ``rank``'s slab of the halo route's ``decomp``
    (``parallel.halo.slab_cell_ids``: an atom owned elsewhere takes the id
    n_cells, binned nowhere).  The slab of (1, 1) is the whole grid: its
    ids are the periodic route's (``cells.build_cell_list_full``)."""
    from ..parallel.halo import slab_cell_ids

    grid = system.spec.cell_grid
    cell, n_cells = slab_cell_ids(x, system, rank // decomp[1],
                                  rank % decomp[1], grid[0] // decomp[0],
                                  grid[1] // decomp[1])
    return cell.to(torch.int32), n_cells


def binning_cases(system, x, label: str):
    """The binning kernel's cases at positions ``x`` on ``system``:
    {name: (cell ids, n_cells, capacity)}: the system's grid and capacity
    (also the halo slab of (1, 1)), the same at capacity 8 (cells
    overflow), and every rank's slab of the halo route's (4, 1) slabs and
    (2, 2) bricks."""
    cap = system.spec.cell_capacity
    out = {label: (*binning_cells(system, x), cap),
           f"{label} capacity 8": (*binning_cells(system, x), 8)}
    for decomp in ((4, 1), (2, 2)):
        for rank in range(4):
            out[f"{label} halo {decomp} rank {rank}"] = (
                *binning_cells(system, x, decomp, rank), cap)
    return out


def halo_spread_work(system, x):
    """The halo route's plain patch spread (``pme.pme_halo_local_mesh``)
    forward and backward alone, on the blocks of a world of one at
    positions ``x`` (``system`` on its halo PME mesh), against a fixed
    random mesh cotangent: a function to time beside the evaluation."""
    from ..pme import pme_halo_local_mesh

    _spread_in, b, ids = spread_inputs(x, system)
    valid = (ids < system.n_atoms).to(x.dtype)
    g8 = torch.stack([b.x, b.y, b.z, b.q, b.hs, b.se, valid,
                      torch.zeros_like(valid)], dim=-1).requires_grad_(True)
    mesh = system.spec.pme_grid
    ct = torch.randn(mesh, dtype=x.dtype, device=x.device,
                     generator=torch.Generator(x.device).manual_seed(0))

    def run():
        with torch.enable_grad():
            q_mesh = pme_halo_local_mesh(g8, ids, system, 0, mesh)
            return torch.autograd.grad(q_mesh, g8, ct)
    return run


def slab_cells(grid, decomp, rank: int):
    """What the halo route's exchange puts in each cell of rank ``rank``'s
    extended slab (the layout of ``cells.slab_shell_tables``): (global
    cell id [n_ext], lattice shift [n_ext, 3] of the copy, in lattice
    units), NumPy."""
    import numpy as np

    gx, gy, gz = grid
    ddx, ddy = decomp
    gxl, gyl = gx // ddx, gy // ddy
    rx, ry = rank // ddy, rank % ddy
    out = []

    def add(cx, cy):
        for cz in range(gz):
            out.append((((cx % gx) * gy + cy % gy) * gz + cz,
                        cx // gx, cy // gy))

    for lx in range(gxl):
        for ly in range(gyl):
            add(rx * gxl + lx, ry * gyl + ly)
    if ddy == 1:
        for cx in (rx * gxl - 1, rx * gxl + gxl):
            for cy in range(gy):
                add(cx, cy)
    else:
        for cy in (ry * gyl - 1, ry * gyl + gyl):
            for lx in range(gxl):
                add(rx * gxl + lx, cy)
        for cx in (rx * gxl - 1, rx * gxl + gxl):
            for ly in range(-1, gyl + 1):
                add(cx, ry * gyl + ly)
    a = np.asarray(out)
    return a[:, 0], np.stack([a[:, 1], a[:, 2], 0 * a[:, 2]], axis=-1)


def slab_walk_args(walk_args, decomp, rank: int):
    """The slab walk's arguments (``ops.direct_walk.direct_walk_slab``) for
    rank ``rank`` of ``decomp``, cut from the periodic walk's
    ``walk_args`` (blocks [gx, gy, gz, cap], ids, box, n_atoms, alpha,
    cutoff, as :func:`drifted_blocks` returns them): the extended slab's
    cells gathered from the global blocks, the exchange's lattice shift
    added to the valid slots of each copy.  For a world of one, decomp
    (1, 1), the slab is the whole grid and its two x planes."""
    x, y, z, q, hs, se, ids, box, n_atoms, alpha, cutoff = walk_args
    grid, cap = tuple(x.shape[:3]), x.shape[3]
    cell, shift = slab_cells(grid, decomp, rank)
    idx = torch.as_tensor(cell, device=x.device)
    sh = torch.as_tensor(shift, dtype=x.dtype, device=x.device)
    rows = box if box.ndim == 2 else torch.diag(box)
    off = sh[:, 0:1] * rows[0] + sh[:, 1:2] * rows[1]      # [n_ext, 3]
    ids_ext = ids.reshape(-1, cap)[idx].contiguous()
    valid = (ids_ext < n_atoms).to(x.dtype)
    pos = [(a.reshape(-1, cap)[idx] + off[:, k:k + 1] * valid).contiguous()
           for k, a in enumerate((x, y, z))]
    rest = [a.reshape(-1, cap)[idx].contiguous() for a in (q, hs, se)]
    return (*pos, *rest, ids_ext, box, n_atoms, alpha, cutoff, grid,
            tuple(decomp))


def device_events(events) -> list:
    """The device-side events of a ``torch.profiler`` trace."""
    return [e for e in events
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def traced_launches(events) -> dict:
    """Per launch counter, the device events of its wrapper's kernel
    (``ops.KERNEL_SYMBOLS``) in a profiler trace."""
    from .. import ops

    pats = {k: re.compile(rf"\b{sym}\b")
            for k, sym in ops.KERNEL_SYMBOLS.items()}
    counts = dict.fromkeys(pats, 0)
    for e in device_events(events):
        for k, pat in pats.items():
            counts[k] += bool(pat.search(e.name))
    return counts


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def nve_drive(system, state, rebuild_every, masses, bonded):
    """(drive, owner, init_nb) of an NVE path: ``drive(n_steps, graph,
    plain)`` runs ``nve_trajectory_nb`` from ``state`` on the kernel path
    or (``plain``) over the system's copy on the plain route; ``owner``
    keeps the kernel path's chunks."""
    from ..integrate import make_nb_energy_fn, nve_trajectory_nb

    fns = {p: make_nb_energy_fn(s, bonded=bonded) for p, s in
           ((False, system), (True, system.with_kernel_route("plain")))}

    def drive(n_steps, graph=True, plain=False):
        return nve_trajectory_nb(state, *fns[plain], masses, DT_PS, n_steps,
                                 rebuild_every, graph=graph)
    return drive, fns[False][0], fns[False][1]


def rigid_drive(path: dict):
    """:func:`nve_drive` of the rigid path (:func:`rigid_path`):
    ``rattle_langevin_trajectory_nb`` at 2 fs, 300 K, friction 5/ps,
    drawing from the path's generator."""
    from ..constraints import rattle_langevin_trajectory_nb
    from ..integrate import make_nb_energy_fn

    fns = {False: path["e_fns"], True: make_nb_energy_fn(
        path["system"].with_kernel_route("plain"))}

    def drive(n_steps, graph=True, plain=False):
        return rattle_langevin_trajectory_nb(
            path["state"], *fns[plain], path["masses"], DT_RIGID, TEMP,
            FRICTION, path["generator"], n_steps, path["params"],
            path["rebuild_every"], graph=graph)
    return drive, fns[False][0], fns[False][1]


def respa_drive(path: dict):
    """:func:`nve_drive` of the RESPA path (:func:`respa_path`):
    ``respa_langevin_trajectory_nb``, 4 substeps of 0.5 fs per outer step,
    300 K, friction 5/ps, drawing from the path's generator; steps count
    outer steps."""
    from ..integrate import make_respa_force_fns, respa_langevin_trajectory_nb

    fns = {False: path["fns"], True: make_respa_force_fns(
        path["system"].with_kernel_route("plain"), path["bonded"])}

    def drive(n_steps, graph=True, plain=False):
        slow_fn, fast_fn, init_nb = fns[plain]
        return respa_langevin_trajectory_nb(
            path["state"], slow_fn, fast_fn, init_nb, path["masses"],
            DT_PS * N_INNER, N_INNER, TEMP, FRICTION, path["generator"],
            n_steps, path["rebuild_every"], graph=graph)
    return drive, fns[False][0], fns[False][2]


def projection_work(path: dict):
    """One rigid step's constraint projections, as the step runs them
    (velocities, positions, velocities, positions, velocities), at the
    path's state: the work whose device time :func:`profile` sets beside
    the step's."""
    from ..constraints import project_positions, project_velocities

    x, v, params = (path["state"].positions, path["state"].velocities,
                    path["params"])
    half = 0.5 * DT_RIGID

    def run():
        v1 = project_velocities(x, v, params)
        x1 = project_positions(x, x + half * v1, params)
        v2 = project_velocities(x1, v1, params)
        x2 = project_positions(x1, x1 + half * v2, params)
        return project_velocities(x2, v2, params)
    return run


def substep_work(path: dict):
    """One RESPA outer step's bonded substeps (BAOAB, the fast force, the
    fast kick), at the path's state, drawing from the card's default
    generator."""
    from ..integrate import baoab_coeffs, baoab_pre_force

    _, fast_fn, _ = path["fns"]
    x, v = path["state"].positions, path["state"].velocities
    inv_m = (1.0 / path["masses"])[:, None]
    f = fast_fn(x)[1]
    c1, c2 = baoab_coeffs(DT_PS, FRICTION, TEMP)

    def run():
        xx, vv, ff = x, v, f
        for _ in range(N_INNER):
            xx, vv = baoab_pre_force(xx, vv, ff, inv_m, DT_PS, c1, c2, None)
            ff = fast_fn(xx)[1]
            vv = vv + 0.5 * DT_PS * ff * inv_m
        return vv
    return run


def timed(drive, n_steps, graph: bool = True, plain: bool = False):
    """(ms/step from CUDA events around one ``drive`` call, its per-step
    records)."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    _, es = drive(n_steps, graph, plain)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n_steps, es


def window(run, n_steps: int, activities) -> dict:
    """One ``torch.profiler`` window over ``run()``: per step, the host
    wall time, the device busy time (union of the device events'
    intervals), the device events, and the idle share ``1 - busy / wall``;
    and the program's record of the window (``utils.profiling.totals``:
    the stage stamps and host spans), where the window traced the CPU."""
    from .profiling import totals

    from torch.profiler import profile as torch_profile

    with torch_profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof.events())
    if not events:
        return {"events": []}
    busy = union_length([(e.time_range.start, e.time_range.end)
                         for e in events]) / 1e3
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    return {"events": events, "wall": wall / n_steps, "busy": busy / n_steps,
            "per_step": len(events) / n_steps, "span": span / n_steps,
            "idle": 1 - busy / wall, "idle_span": 1 - busy / span,
            "record": totals()}


def profile(drive, owner, init_nb, state, rebuild_every, dt_ps,
            parts=None, plain=True):
    """ms/step of the kernel path replayed as CUDA graphs, the same run
    eagerly (``graph=False``) and, with ``plain``, the plain path's
    replays (``drive`` of :func:`nve_drive` and its kind), with ns/day for
    a step of ``dt_ps``; then profiler windows over the replays and over
    the eager run.  ``parts`` maps a label to a function, or to (function,
    steps it serves), whose device time, a CUDA graph timed alone, is set
    per step beside the step's device busy time."""
    from torch.profiler import ProfilerActivity

    from .profiling import stage_ms

    n_steps = 10 * rebuild_every
    variants = {"graph": (False, True), "eager": (False, False)}
    if plain:
        variants["plain graph"] = (True, True)
    for plain, graph in variants.values():
        if graph:                       # capture, outside the timed runs
            timed(drive, rebuild_every, graph, plain)
    times = {v: [] for v in variants}
    order = list(variants)
    for name in order + order[::-1]:
        plain, graph = variants[name]
        ms, es = timed(drive, n_steps, graph, plain)
        if not torch.isfinite(es).all():
            raise RuntimeError(f"timed run ({name}) NaN-poisoned")
        times[name].append(ms)
    print(f"ms/step over {n_steps} steps (CUDA events around the trajectory "
          f"call, rebuild_every {rebuild_every}, incl. the eager final "
          f"consistent-state evaluation): "
          + "; ".join(f"{k} {['%.3f' % t for t in v]}"
                      for k, v in times.items())
          + f"; ns/day of the replays "
          f"{['%.2f' % ns_per_day(dt_ps, t) for t in times['graph']]}",
          flush=True)

    # the captured chunk alone, replayed back to back on the state its
    # last run left (no copy-in, no final evaluation)
    chunk = next(c for c in owner.nve_chunks.values()
                 if c.k == rebuild_every and c.graph is not None)

    def replays(count):
        for _ in range(count):
            chunk()

    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    replays(10)
    b.record()
    torch.cuda.synchronize()
    print(f"replays alone: {a.elapsed_time(b) / n_steps:.3f} ms/step (CUDA "
          f"events around 10 back-to-back replays of the {rebuild_every}-step "
          f"chunk)", flush=True)
    if state.nb is not None:
        init_nb(state.positions)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for _ in range(5):
            init_nb(state.positions)
        b.record()
        torch.cuda.synchronize()
        bound = kernel_bound("binning", n_atoms=state.positions.shape[0],
                             n_slots=state.nb.slots.numel())
        print(f"neighbor rebuild: {a.elapsed_time(b) / 5:.3f} ms (CUDA "
              f"events, mean of 5, eager); the binning's bound "
              f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: "
              f"{bound['bytes']} bytes)", flush=True)

    n_win = 2 * rebuild_every
    cuda = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    runs = {"two replays": lambda: replays(2),
            "eager trajectory": lambda: drive(n_win, False, False)}
    busy = None
    for label, run, acts in (("two replays, CUDA only", "two replays", cuda),
                             ("two replays, CPU+CUDA", "two replays", both),
                             ("eager trajectory incl. its final evaluation, "
                              "CPU+CUDA", "eager trajectory", both)):
        w = window(runs[run], n_win, acts)
        if not w["events"]:
            print(f"profiler window ({label}): no device events recorded",
                  flush=True)
            continue
        busy = w["busy"] if busy is None else busy
        print(f"profiler window ({label}), kernel path, {n_win} steps: "
              f"wall {w['wall']:.3f} ms/step "
              f"(host clock); device busy {w['busy']:.3f} ms/step (union of "
              f"{w['per_step']:.0f} device events per step); idle share "
              f"{w['idle']:.3f} of the wall, {w['idle_span']:.3f} of the "
              f"device span {w['span']:.3f} ms/step", flush=True)
        by_stage = stage_ms(w["record"], n_win)
        if by_stage is not None:
            print("  device time by stage in the replays (stage stamps, "
                  "forward and backward): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in by_stage.items())
                  + " ms/step", flush=True)
        per_kernel = {}
        for e in w["events"]:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + (e.time_range.end - e.time_range.start))
        ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
        # the twelve largest, then the port's own kernels below them
        own = [kv for kv in ranked[12:] if PORT_KERNELS.search(kv[0])]
        for name, us in ranked[:12] + own:
            print(f"  {us / 1e3 / n_win:8.4f} ms/step  {name[:100]}",
                  flush=True)
    for label, fn in (parts or {}).items():
        fn, steps = fn if isinstance(fn, tuple) else (fn, 1)
        ms = interleaved_ms([fn])[0]
        share = ("not measured" if busy is None
                 else f"{ms / steps / busy:.3f}")
        print(f"{label}: {ms:.4f} ms per call, one call per {steps} "
              f"step(s), {ms / steps:.4f} ms per step (a CUDA graph of "
              f"{GRAPH_REPS} calls, median of {ROUNDS}); share of the "
              f"step's device busy time {share}", flush=True)


def _replays_ms(replay, count: int) -> float:
    """Device ms of ``count`` back-to-back calls of ``replay`` (a graph's
    launch; CUDA events around them)."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(count):
        replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def _bare_copy(chunk):
    """A copy of ``chunk`` on its static buffers, captured anew without
    stage stamps (the device's stamp record hidden during the capture)."""
    from unittest import mock

    from . import profiling

    bare = copy.copy(chunk)
    bare.graph = None
    key = profiling._key(chunk.x.device)
    buf = profiling._REC.buffers.pop(key)
    try:
        with mock.patch.object(profiling, "_buffer",
                               lambda device, create=True: None):
            bare._capture()
    finally:
        profiling._REC.buffers[key] = buf
    assert not bare.stamps.nodes
    return bare


def stamp_costs(drive, owner, state, rebuild_every):
    """``measure stamps`` (the module's docstring) on the chunk of
    ``rebuild_every`` steps that ``drive`` (:func:`nve_drive`) replays."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from .. import ops
    from . import profiling

    dev = state.positions.device
    timed(drive, rebuild_every)                       # captures the chunk
    chunk = next(c for c in owner.nve_chunks.values()
                 if c.k == rebuild_every and c.graph is not None)
    start = tuple(t.clone() for t in chunk.carry)
    per_step = len(profiling.ENERGY_STAGES) * 4 + 4 / rebuild_every
    print(f"stamps: {len(chunk.stamps.nodes)} stamp nodes in the "
          f"{rebuild_every}-step chunk graph ({per_step:.1f} a step); "
          f"edges made to keep the work's order without them: "
          f"{chunk.stamps.bridged}",
          flush=True)

    launch = {"none": None, "out": chunk.graph.replay,
              "in": chunk.stamps.launch}

    def run(how: str):
        """One replay from ``start``, with the stamps (``in``) or
        without; its outputs."""
        chunk._copy_in(start)
        launch[how]()
        torch.cuda.synchronize()
        return [t.clone() for t in (*chunk.carry, chunk.potential,
                                    chunk.es)]

    same = all(torch.equal(a, b) for a, b in zip(run("out"), run("in")))
    print(f"stamps: a replay with the stamps gives the bits of one "
          f"without: {same}", flush=True)

    launch["none"] = _bare_copy(chunk).graph.replay
    chunk._copy_in(start)
    ms = {k: [] for k in launch}
    for r in range(ROUNDS):
        for k in (list(launch) if r % 2 == 0 else list(launch)[::-1]):
            ms[k].append(_replays_ms(launch[k], 10) / (10 * rebuild_every))
    med = {k: statistics.median(v) for k, v in ms.items()}
    pct = {k: 100 * (med[k] - med["none"]) / med["none"] for k in med}
    print(f"stamps: ten back-to-back replays of the {rebuild_every}-step "
          f"chunk (CUDA events, median of {ROUNDS} rounds in turns): "
          f"captured without stamps {med['none']:.4f} ms/step "
          f"{['%.4f' % t for t in ms['none']]}, the graph's own (stamps "
          f"out) {med['out']:.4f} ms/step {['%.4f' % t for t in ms['out']]} "
          f"({pct['out']:+.3f} %), with the stamps {med['in']:.4f} ms/step "
          f"{['%.4f' % t for t in ms['in']]} ({pct['in']:+.3f} %, "
          f"{1e3 * (med['in'] - med['none']) / per_step:.3f} us a stamp)",
          flush=True)
    del launch["none"]

    # the host's time inside replay() against the replay's device time,
    # without a profiler and with one (CPU and CUDA activity)
    for label, acts in (("no profiler", None),
                        ("a CPU+CUDA profiler", [ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])):
        with (torch_profile(activities=acts) if acts
              else contextlib.nullcontext()):
            host = []
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            a.record()
            for _ in range(10):
                t0 = time.perf_counter()
                chunk.graph.replay()
                host.append(1e3 * (time.perf_counter() - t0))
            b.record()
            torch.cuda.synchronize()
        print(f"stamps: host ms inside replay(), ten back-to-back replays "
              f"with {label}: {['%.3f' % h for h in host]}; device "
              f"{a.elapsed_time(b) / 10:.3f} ms per replay (CUDA events)",
              flush=True)

    # the record's replay time against CUDA events around the same replays;
    # the launch counters against the kernels the profiler saw
    n_rep = 10
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ops.reset_launch_counts()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        a.record()
        for _ in range(n_rep):
            chunk()
        b.record()
        torch.cuda.synchronize()
    rec = profiling.totals()
    stamped = rec["stages"]["replay"]["replay"]["fwd"]
    events_ms = a.elapsed_time(b)
    print(f"stamps: {n_rep} replays under the profiler: the record's replay "
          f"time {stamped['seconds'] * 1e3:.3f} ms over {stamped['count']} "
          f"replays, CUDA events {events_ms:.3f} ms (ratio "
          f"{stamped['seconds'] * 1e3 / events_ms:.5f})", flush=True)
    by_stage = profiling.stage_ms(rec, n_rep * rebuild_every)
    print(f"stamps: device ms per replayed step by stage: {by_stage}",
          flush=True)
    counted = ops.launch_counts()
    traced = traced_launches(prof.events())
    print(f"stamps: launch counters after {n_rep} replays {counted}; "
          f"kernels traced {traced}; equal: {counted == traced}", flush=True)

    # one trajectory call of 25 chunks, as a report interval runs them
    n_call = 25 * rebuild_every
    drive(n_call)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        drive(n_call)
        torch.cuda.synchronize()
    rec = profiling.totals()
    print(f"stamps: one call of {n_call} steps under the profiler: device "
          f"ms per replayed step by stage "
          f"{profiling.stage_ms(rec, n_call)}", flush=True)
    for name, r in rec["host"].items():
        if name.startswith("cf.md."):
            print(f"  host span {name}: {r['count']} x, total "
                  f"{r['total_s'] * 1e3:.3f} ms, self "
                  f"{r['self_s'] * 1e3:.3f} ms, in {r['parents']}",
                  flush=True)
    eager = {s: {p: round(v["seconds"] * 1e3, 4) for p, v in d.items()}
             for s, d in rec["stages"]["eager"].items()}
    print(f"  eager stages (ms, the final evaluation and rebuild): {eager}",
          flush=True)
    for name, r in list(profiling.idle_by_span(prof).items())[:12]:
        print(f"  idle in {name}: {r['seconds'] * 1e3:.3f} ms over "
              f"{r['gaps']} gaps, longest {r['longest_s'] * 1e3:.3f} ms",
              flush=True)


def rbe_profile(system, state, rebuild_every, masses, bonded, device):
    """``profile`` of random batch Ewald NVT (:func:`rbe_drive`, p = 128,
    20/ps) on a burned-in state, then, in the same process, RBE at p = 512
    and the SPME Langevin step at the same settings
    (:func:`spme_langevin_drive`): ms/step and mean temperature of each
    replayed, in turns (p 128, p 512, SPME, SPME, p 512, p 128), ten
    rebuild chunks each."""
    from ..units import BOLTZ

    gen = torch.Generator(device).manual_seed(0)
    drive, owner, init_nb = rbe_drive(system, state, rebuild_every, masses,
                                      bonded, gen)
    profile(drive, owner, init_nb, state, rebuild_every, DT_PS)
    drives = {
        f"rbe p {RBE_SAMPLES}": drive,
        "rbe p 512": rbe_drive(system, state, rebuild_every, masses, bonded,
                               torch.Generator(device).manual_seed(2),
                               n_samples=512)[0],
        "spme": spme_langevin_drive(system, state, rebuild_every, masses,
                                    bonded, torch.Generator(
                                        device).manual_seed(1))[0]}
    for d in drives.values():
        timed(d, rebuild_every)                    # capture
    n_steps = 10 * rebuild_every
    times = {name: [] for name in drives}
    temps = {name: [] for name in drives}
    order = list(drives)
    for name in order + order[::-1]:
        ms, kes = timed(drives[name], n_steps)
        if not torch.isfinite(kes).all():
            raise RuntimeError(f"timed run ({name}) NaN-poisoned")
        times[name].append(ms)
        temps[name].append(float((2.0 * kes.double() / (
            3 * state.positions.shape[0] * BOLTZ)).mean()))
    print(f"RBE vs SPME Langevin, friction {RBE_FRICTION}/ps, {n_steps} "
          f"replayed steps each from the same state (CUDA events around "
          f"the call): " + "; ".join(
              f"{k} {['%.3f' % t for t in v]} ms/step, mean T "
              f"{['%.1f' % t for t in temps[k]]} K"
              for k, v in times.items()), flush=True)


def f64_control(system, state, rebuild_every, masses, bonded):
    from ..integrate import (init_state_nb, kinetic_energy, make_nb_energy_fn,
                             nve_trajectory_nb)

    for label, dtype in (("f32 kernel path", torch.float32),
                         ("f64 plain path", torch.float64)):
        sys_ = system.astype(dtype)
        e_fn, init_nb = make_nb_energy_fn(sys_, bonded=bonded.astype(dtype))
        m = masses.to(dtype)
        s0 = init_state_nb(state.positions.to(dtype),
                           state.velocities.to(dtype), e_fn, init_nb)
        e0 = float(s0.potential) + float(kinetic_energy(s0.velocities, m))
        ms, es = timed(lambda n, graph, _plain: nve_trajectory_nb(
            s0, e_fn, init_nb, m, DT_PS, n, rebuild_every, graph=graph), 200)
        d = es.double().cpu() - e0
        print(f"{label}: 200 steps, {ms:.3f} ms/step (CUDA events); E0 "
              f"{e0:.3f} kJ/mol; drift {float(d[-1]):.4f}; max |E - E0| "
              f"{float(d.abs().max()):.4f}; rms(E - E0) "
              f"{float(d.pow(2).mean().sqrt()):.4f}; finite "
              f"{bool(torch.isfinite(d).all())}", flush=True)
        if not torch.isfinite(d).all():
            raise RuntimeError(f"{label}: non-finite energies")


THERMO_STEPS = 4000       # thermo: f32 steps of each driver (2 ps)
THERMO_F64_STEPS = 1000   # thermo: f64 plain steps of BAOAB and CSVR
THERMO_WINDOW = 200       # chip_smoke 7b's averaging window, steps


def thermo_windows(system, state, rebuild_every, masses, bonded, device):
    """``thermo``: the mean kinetic temperature of BAOAB Langevin (5/ps),
    CSVR (tau :data:`TAU_CSVR`) and the Nose-Hoover chain (tau
    :data:`TAU_NHC`) at 300 K from one burned-in state, over consecutive
    windows of :data:`THERMO_WINDOW` steps: :data:`THERMO_STEPS` replayed
    steps in f32 on the kernel route, then BAOAB and CSVR for
    :data:`THERMO_F64_STEPS` steps in f64 on the plain route, each from
    the generator seed 0 (3N degrees of freedom; the chain 3N - 3).
    Prints one line per run and returns {run: window means in K}."""
    from ..csvr import csvr_trajectory_nb
    from ..integrate import (init_state_nb, langevin_trajectory_nb,
                             make_nb_energy_fn)
    from ..nosehoover import nose_hoover_trajectory_nb

    n = state.positions.shape[0]
    out = {}
    runs = [(k, torch.float32, THERMO_STEPS) for k in ("baoab", "csvr",
                                                       "nhc")]
    runs += [(k, torch.float64, THERMO_F64_STEPS) for k in ("baoab", "csvr")]
    for kind, dtype, steps in runs:
        sys_ = system.astype(dtype)
        e_fn, init_nb = make_nb_energy_fn(sys_, bonded=bonded.astype(dtype))
        m = masses.to(dtype)
        s0 = init_state_nb(state.positions.to(dtype),
                           state.velocities.to(dtype), e_fn, init_nb)
        gen = torch.Generator(device).manual_seed(0)
        args = (s0, e_fn, init_nb, m, DT_PS, TEMP)
        n_dof = 3 * n - (3 if kind == "nhc" else 0)
        if kind == "baoab":
            kes = langevin_trajectory_nb(*args, FRICTION, gen, steps,
                                         rebuild_every)[1]
        elif kind == "csvr":
            kes = csvr_trajectory_nb(*args, TAU_CSVR, gen, steps,
                                     rebuild_every)[1]["kinetic"]
        else:
            kes = nose_hoover_trajectory_nb(*args, TAU_NHC, steps,
                                            rebuild_every)[2]
        temps = 2.0 * kes.double().cpu() / (n_dof * KB)
        if not torch.isfinite(temps).all():
            raise RuntimeError(f"thermo {kind}: non-finite temperatures")
        means = [float(w.mean()) for w in temps.split(THERMO_WINDOW)]
        half = float(temps[steps // 2:].mean())
        plain = dtype == torch.float64
        label = f"{kind} {'f64 plain' if plain else 'f32 kernels'}"
        out[label] = means
        print(f"thermo {label}: {steps} steps; mean T per "
              f"{THERMO_WINDOW}-step window (K): "
              f"{[round(t, 2) for t in means]}; second half {half:.2f} K",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("profile", "f64", "thermo",
                                     "multigpu", "stamps"))
    ap.add_argument("--path", choices=("30k", "216", "rigid", "respa", "npt",
                                       "csvr", "nhc", "4k", "100k", "tri30k",
                                       "hetero30k", "onramp30k", "rbe",
                                       "rbe100k"),
                    default="30k")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="multigpu: 'cpu' rehearses the routes on gloo "
                    "ranks at small sizes")
    args = ap.parse_args(argv)
    if args.what == "multigpu" and args.device == "cpu":
        from .multigpu import run

        run(small=True)
        return
    if not torch.cuda.is_available():
        raise SystemExit("measure: needs a CUDA device")
    if args.what == "f64" and args.path in ("rigid", "respa", "npt", "csvr",
                                            "nhc", "onramp30k", "rbe",
                                            "rbe100k"):
        raise SystemExit("measure f64: NVE paths only")
    if args.what == "thermo" and args.path != "30k":
        raise SystemExit("measure thermo: the 30k path only")
    if args.what == "stamps" and args.path not in BENCH_SIDES:
        raise SystemExit(f"measure stamps: the NVE paths "
                         f"{sorted(BENCH_SIDES)} only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if args.what == "multigpu":
        from .multigpu import run

        run()
        return
    dev = torch.device("cuda", 0)
    dt_ps, parts, plain = DT_PS, None, True
    if args.path == "npt":
        path = npt_path(dev)
        state, rebuild_every = path["state"], path["rebuild_every"]
        system = path["system"]
        print(f"npt path: {system.n_atoms} atoms, burned in "
              f"({path['info']}); capacity {system.spec.cell_capacity}, "
              f"barostat_interval {rebuild_every}", flush=True)
        drive, owner, init_nb = npt_drive(path)
        parts = {"barostat attempt (npt.isotropic_attempt: draws, "
                 "centroids, scaled positions, forward energy with its "
                 "binning, acceptance)": (proposal_work(path),
                                          rebuild_every)}
        profile(drive, owner, init_nb, state, rebuild_every, dt_ps, parts,
                plain=False)
        return
    if args.path == "216":
        from ..integrate import init_state_nb, make_nb_energy_fn

        _, x, m, box, bonded, system = dense_path(dev)
        state = init_state_nb(x, torch.zeros_like(x),
                              *make_nb_energy_fn(system, bonded=bonded))
        rebuild_every = 10
        print(f"216 path: {system.n_atoms} atoms, dense, kmax "
              f"{system.spec.kmax}, from the lattice at rest", flush=True)
    elif args.path == "onramp30k":
        path = onramp_path(dev)
        state, rebuild_every = path["state"], path["rebuild_every"]
        system = path["system"]
        print(f"onramp30k path: {system.n_atoms} atoms from the peptide "
              f"PDB, burned in ({path['info']}); capacity "
              f"{system.spec.cell_capacity}, rebuild_every {rebuild_every}",
              flush=True)
        drive, owner, init_nb = langevin_drive(path)
        profile(drive, owner, init_nb, state, rebuild_every, dt_ps)
        return
    elif args.path in ("rigid", "respa"):
        path = (rigid_path if args.path == "rigid" else respa_path)(dev)
        state, rebuild_every = path["state"], path["rebuild_every"]
        system = path["system"]
        print(f"{args.path} path: {system.n_atoms} atoms, burned in "
              f"({path['info']}); capacity {system.spec.cell_capacity}, "
              f"rebuild_every {rebuild_every}", flush=True)
        if args.path == "rigid":
            drive, owner, init_nb = rigid_drive(path)
            dt_ps = DT_RIGID
            parts = {"constraint projections (2 positions, 3 velocities)":
                     projection_work(path)}
        else:
            drive, owner, init_nb = respa_drive(path)
            dt_ps = DT_PS * N_INNER
            parts = {f"bonded substeps ({N_INNER} BAOAB substeps)":
                     substep_work(path)}
    else:
        base = {"csvr": "30k", "nhc": "30k", "rbe": "30k",
                "rbe100k": "100k"}.get(args.path, args.path)
        force, x, m, box, bonded, system0 = bench_path(base, dev)
        system, state, rebuild_every, info = burn_in(force, system0, x, m,
                                                     box, bonded)
        print(f"{args.path} path: {system.n_atoms} atoms, cells "
              f"{system.spec.cell_grid}, PME {system.spec.pme_grid}; burned "
              f"in: capacity {system.spec.cell_capacity}, rebuild_every "
              f"{rebuild_every}, vmax {info['vmax']:.2f} nm/ps", flush=True)
    if args.what == "f64":
        f64_control(system, state, rebuild_every, m, bonded)
        return
    if args.what == "thermo":
        thermo_windows(system, state, rebuild_every, m, bonded, dev)
        return
    if args.what == "stamps":
        drive, owner, _ = nve_drive(system, state, rebuild_every, m, bonded)
        stamp_costs(drive, owner, state, rebuild_every)
        return
    if args.path in ("rbe", "rbe100k"):
        rbe_profile(system, state, rebuild_every, m, bonded, dev)
        return
    if args.path in ("csvr", "nhc"):
        drive, owner, init_nb = thermostat_drive(
            args.path, system, state, rebuild_every, m, bonded,
            torch.Generator(dev).manual_seed(0))
        plain = False
        if args.path == "nhc":
            parts = {"NHC chain updates (two halves)": chain_work(state, m)}
    elif args.path not in ("rigid", "respa"):
        drive, owner, init_nb = nve_drive(system, state, rebuild_every, m,
                                          bonded)
    profile(drive, owner, init_nb, state, rebuild_every, dt_ps, parts, plain)


if __name__ == "__main__":
    main()
