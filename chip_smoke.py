#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (chargeflux_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and a CUDA build of PyTorch.  It drives sixteen paths of the port: the
30k cell + SPME path (the JAX package's ``bench.py 30k``), the 216-water
dense + classical-Ewald path (``bench.py 216``), rigid and RESPA NVT at
the 30k box (``bench.py rigid``, ``respa``), the 30k box on a sheared
triclinic lattice (``bench.py tri30k``), the solvated chain
(``bench.py hetero30k``), NPT at the 30k box (``bench.py npt``), the
CSVR and Nose-Hoover chain thermostats on it, the PDB on-ramp at the 30k
size (onramp30k), random batch Ewald NVT at the 30k box (rbe30k), the
216-water box on the dense-mesh SPME (dense216), the 125-water cluster
(cluster), the 64 x 216 replica ensemble (``bench.py replicas``), its
temperature REMD and the halo route in a world of one (halo1).  Phases,
in order:

1. CUDA present (else exit non-zero), the card's name and power limit;
2. build the CUDA kernels from ``chargeflux_tpu_torch/csrc``;
3. at the 30k shapes (water_box(n_side=22), 8^3 cells, capacity 88, 64^3
   PME mesh, order 8) the B-spline patch weights' kernels (the backward on
   the reciprocal energy's real weight cotangents), the spread and walk
   kernels against their plain-PyTorch versions on the card: max |diff| /
   max |plain|, bitwise equality of two launches, and the time per call of
   each: a CUDA graph of 20 back-to-back calls (no host enqueue in the
   timed span) replayed between CUDA events, kernel, plain version and
   library yardstick in turns over 7 rounds, median.  The yardstick is one
   PyTorch call for the kernel's core product (``library_ms``; the port
   never calls it; none for the weights and the walk, which no single call
   computes).  Beside each time, the kernel's bound at these inputs
   (``utils.measure.kernel_bound``: the larger of flops over the H100's
   f32 peak and bytes over its memory rate) and ``bound_share`` = bound /
   ms;
3b. the same for the three structure-factor kernels, at the 216 path's
   shapes and at a 4k box's (n_side 11, kmax 13^3), on the real tables
   and the real cotangents dE_rec/dA, dE_rec/dB; the forward once more at
   the kernels' Ky / 2Kz limits (agreement and bitwise repeat only);
3c. the cell binning kernel (``cell_bin``) against its plain version,
   bit for bit (slots, inverse slots, overflow count): at the 30k start
   (timed as in phase 3 beside its bound; no library call computes the
   slots), at capacity 8 (cells overflow, and the kernel route's energy
   and forces are NaN), on every rank's slab of the halo route's (4, 1)
   slabs and (2, 2) bricks, on the positions halved (most cells empty), on
   the first 2049 atoms (N not a multiple of the kernel's chunk) and on
   bench.py's 100k box (11^3 cells);
3d. the exclusion kernels (``exclusion_fwd`` / ``exclusion_bwd``) against
   their plain chain at the 30k start and at the benchmark's 98k box
   (each shifted, drifted by up to 0.01 nm and wrapped atom by atom, so
   molecules straddle the box's faces; E within 1e-6 of the sum of the
   pair terms' magnitudes, the gradients within 1e-5 of their max), timed
   as in phase 3 beside their bound (no library call computes them);
3e. the bonded kernels (``bonded_fwd`` / ``bonded_bwd``) against their
   plain chain at the 30k start and at the benchmark's 98k box (each
   shifted, drifted by up to 0.01 nm and wrapped atom by atom; E within
   1e-6 of the sum of the rows' |energy|, the gradient within 1e-5 of its
   max), timed as in phase 3 beside their bound (no library call computes
   them); one bonded evaluation with its gradient at the 30k start
   launches each once, its plain copy neither;
4. / 4b. energy_and_forces at the start positions of each path: kernel
   path against the plain path (the system's copy on the plain route) in
   f32 and in f64 on the card, and the f64 system on its own route (it
   records the plain versions when it is built) against plain f64 within
   1e-12; the plain copy's neighbor rebuild and one evaluation with it
   launch no kernel;
5. the 30k path: 240 burn-in steps on a capacity-1.35 twin (velocities
   rescaled to 300 K per rebuild chunk), capacity re-provisioned from the
   measured occupancy; the walk kernel once more against its plain
   version (phase 3's tolerances, bitwise repeat) on the blocks of the
   burned-in state after all but one step of a rebuild interval on one
   neighbor state, where atoms have left their cells' nominal bounds, and
   the binning kernel on those drifted positions (the cases of 3c at the
   30k box), and the patch weights' kernels on those blocks; then 200 NVE
   steps with neighbor reuse;
5b. the 216 path: 200 NVE steps from the lattice at rest;
   in 5 and 5b a trajectory runs each rebuild chunk as one CUDA graph
   replay, as a user's does.  Before the 200 steps, the same start state
   runs two chunks and a remainder chunk eagerly (``graph=False``, under
   ``set_sync_debug_mode("error")`` once warm) and as replays: per-step
   energies, final positions and velocities must be bit-equal, and both
   ms/step are printed.  The launch counts are reset just before the 200
   steps (whose graphs that check captured) and each kernel of that path
   must have launched (on every path with bonded terms, the bonded
   kernels too): a replay counts the launches its capture counted;
5c. rigid NVT at the 30k box (the JAX package's ``bench.py rigid``,
   ``utils.measure.rigid_path``): rigid water, fixed charges,
   RATTLE-BAOAB at 2 fs after its 20/ps burn-in, then 200 steps at
   300 K and 5/ps;
5d. r-RESPA NVT at the 30k box (``bench.py respa``,
   ``utils.measure.respa_path``): flexible water after 0.2 ps of 0.5 fs
   Langevin, then 200 outer steps of 2 fs, 4 bonded BAOAB substeps each
   (the rebuild interval from the relaxed max speed, as for rigid);
   in 5c and 5d (and 7b, 9) each driver first runs SETTLE_PS = 1 ps from
   its burn-in state (the burn-ins leave the box relaxing: the first
   0.1 ps after phase 5's read 312-314 K), and the chunk check and the
   window start from there; the chunk check runs as in 5 from one
   generator state
   (re-seeded before each run: the replays must draw the eager run's
   normals), and a further call with the generator carried on must draw
   new ones; over the 200 timed steps (ms/step and ns/day printed, the
   counts reset before them) the energies must be finite, the spread and
   walk kernels must have launched, the mean kinetic temperature must be
   within 10 % of 300 K (rigid: 3N - n_constraints degrees of freedom) and,
   for rigid water, the largest |constraint residual| at the end at most
   1e-4 nm^2;
6. tri30k (``utils.measure.bench_path("tri30k")``: the 30k box sheared into
   [[L, 0, 0], [0.15 L, L, 0], [0.10 L, -0.12 L, L]], forced 8^3 cells):
   burn-in as in 5; the triclinic walk kernel (``direct_walk_tri``)
   against its plain version on the drifted blocks, timed as in phase 3
   beside its bound; energy_and_forces against the plain f32 and f64
   route as in 4; the chunk check as in 5; then 200 replayed NVE steps
   (ms/step printed), in which the triclinic walk and the spread kernels
   must have launched;
6b. hetero30k (``bench_path("hetero30k")``: a 300-bead chain in 10,548
   flexible waters, forced 8^3 cells): the remainder row counts (the
   chain's 299 flux bonds), burn-in, the chunk check, 200 replayed NVE
   steps with finite energies (ms/step printed);
7. NPT at the 30k box (``utils.measure.npt_path``: bench.py npt's 400
   steps of 20/ps Langevin from rest, capacity re-provisioned, the
   barostat interval from the relaxed max speed; then BAOAB at 300 K,
   5/ps, an isotropic MC barostat at 1 bar, one attempt per interval):
   two intervals from one generator state eagerly (warm, under
   ``set_sync_debug_mode("error")``) and as replays, bit-equal (energies,
   positions, velocities, boxes, accepts), a further call drawing new
   noise, one graph for the interval; then 200 steps rounded up to whole
   intervals, replayed (counts reset before): finite energies, at least
   one accepted move, the box moved, the same single graph replayed, the
   poisoned count printed, the spread and walk kernels launched
   (``launches_npt``); the three kernels against their plain versions at
   the final box (phase 3's tolerances); ms/step and ns/day; the virial
   pressure once at the final state (finite; its seconds and peak
   memory);
7b. CSVR and Nose-Hoover chain NVT on phase 5's burned-in 30k state: 1 ps
   of each, then the chunk check of 5c for each (CSVR from one generator
   state), 200 replayed steps each; CSVR's mean temperature within 10 % of 300 K,
   the chain's conserved-quantity drift printed;
9. onramp30k (``utils.measure.onramp_path``): a peptide-in-water PDB
   written by the port's ``write_pdb`` (a 16-residue GLY backbone row
   through the 22^3 water lattice, 10,626 waters + 48 backbone atoms =
   31,926 atoms, the JAX package's examples/run_peptide_pdb.py layout),
   read back through ``system_from_pdb`` with that example's residue
   tables at cutoff 0.72, f32 cell + SPME on the forced 8^3 grid, the
   backbone torsions (k 2 kJ/mol, n 3, phi0 0) through
   ``BondedParams.create``; 400 steps of 20/ps Langevin on a
   capacity-1.35 twin, capacity re-provisioned, ``rebuild_every`` from
   the relaxed max speed; the chunk check of 5c from one generator state;
   200 replayed BAOAB steps at 300 K, 5/ps, 0.5 fs (mean temperature
   within 10 %, the walk and both spreads launched, ms/step and ns/day);
   then on the final state a PDB frame and a 10-frame DCD written and
   read back (to the formats' precision), a checkpoint saved and loaded
   bit-equal, ``diagnose_nan`` reporting no cause, and the O-O
   ``radial_distribution`` first peak within 0.25-0.32 nm;
9b. rbe30k: random batch Ewald NVT (p = 128, 20/ps, 0.5 fs, 300 K) on
   phase 5's burned-in 30k state: the chunk check (the k-vector draws
   included), 200 replayed steps (finite, the walk launched and no
   spread; the mean temperature printed: the estimator's noise heats the
   box by ~1/p), 200 more at p = 512 (mean temperature within 10 %),
   beside the SPME Langevin step at the same settings in this call; the
   estimator's exact expectation (``rbe.estimator_moments``: S(k)
   enumerated over its tables) against the SPME reciprocal energy
   (<= 1e-4 of sum|E_c|), and its mean over 64 draws at p = 128 within 5
   standard errors of SPME, the error from the exact variance (the
   terms' heavy tail makes the draws' own spread understate it); 2^20
   k-vectors drawn on the card against the tables' per-axis
   probabilities (every bin within 5 standard deviations);
9c. dense216: water_box(n_side=6, cutoff=0.9) on direct_method="dense",
   recip_method="pme": f32 against f64 on the card (force RMS relative
   <= 1e-4), f64 dense SPME against f64 classical Ewald at the system's
   kmax (|dE| <= 1e-4 of the components' summed magnitudes, phase 4's
   scale), ``forces_manual`` against the autograd
   forces in f64 (<= 1e-10 relative);
9d. cluster: the non-periodic 125-water ``water_cluster(n_side=5)`` with
   its bonded terms, 1,600 replayed Langevin steps (0.5 fs, 300 K,
   2/ps), ``total_dipole`` every 4 steps, a finite
   ``infrared_spectrum`` of the 400 samples and its peak in the
   60-130 THz stretch band;
10. replicas: the JAX package's ``bench.py replicas`` at full width (64
   replicas of the 216-water box, f32, ``utils.measure.replicas_path``):
   the three structure-factor kernels batched over the replicas (one
   launch each) against their batched plain versions (phase 3b's
   tolerances), timed beside their bound and one batched matmul, and
   each replica's slice bit-equal to the single-system launch on it;
   ``replica_energy_and_forces`` on "xla" and on "pallas" against a loop
   of single-system ``energy_and_forces`` (|dE| <= 1e-5 of sum|E_c|,
   force RMS <= 1e-5 relative); the bench step (x <- x - 1e-9 grad E) as
   graph replays on both routes (ms/step), the batched kernels launched
   once a step on the "pallas" run (counts reset before it); one
   ``replica_nve_trajectory`` chunk graph bit-equal to graph=False;
10b. REMD of that ensemble on a geometric 300-450 K ladder (5/ps, 0.5 fs,
   a sweep every 10 steps) after 800 steps at 20/ps: replays bit-equal to
   graph=False from one generator state, new noise on a further call,
   the configurations kept as a multiset at dt = 0, every slot's mean
   temperature within 10 % of its target, and the ladder's mean relative
   deviation with its standard error over the slots (a bias common to
   them); acceptance per parity, ms/step;
10c. halo1: ``parallel.halo`` in a world of one (an NCCL group of one
   rank, decomposition (1, 1)).  The walk kernel's slab form
   (``direct_walk_halo``) against its plain slab walk (phase 3's
   tolerances, bitwise repeat) on phase 5's drifted blocks cut into the
   extended slab of a world of one, timed as in phase 3 beside its bound,
   and into the slabs of ranks of (4, 1) and (2, 2), and its triclinic
   form on phase 6's drifted tri30k blocks cut the same three ways; at
   phase 5's burned-in 30k state in f32 against the single-system kernel
   route (|dE| <= 1e-5 of sum|E_c|, force RMS <= 1e-5; one slab kernel
   and one binning kernel launch and no periodic walk an evaluation; in
   f64 neither kernel) and at a 4k box in f64 against
   the plain route (1e-10), each on the halo PME mesh and on classical
   Ewald, with both routes' ms per evaluation (device time as graphs in
   turns, and eager) and the collectives issued; the halo PME mesh's
   plain patch spread alone and its share of the 30k evaluation; NVE
   over the 4k f64 halo energy ('xla', the plain slab walk) and over the
   30k halo energy and the water bonds, each with the NCCL all-reduces
   inside the chunk graphs and bit-equal to graph=False, then 100 replayed
   steps (ms/step; counts reset before them) in which the slab and the
   binning kernels must have launched and the periodic walk not;
11. a JSON line with each kernel's numbers, then the last line
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero before the last
line.  TF32 is off for matmuls and convolutions (f32 references stay full
f32).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SF_SRC = "chargeflux_tpu_torch/csrc/structure_factor.cu"
EXCL_SRC = "chargeflux_tpu_torch/csrc/exclusion_pairs.cu"
EXCL_REPL = "chargeflux_tpu/energy.py:115 (XLA fusion, not Pallas)"
BONDED_SRC = "chargeflux_tpu_torch/csrc/bonded_terms.cu"
BONDED_REPL = "chargeflux_tpu/bonded.py:73 (XLA fusion, not Pallas)"
# wrapper: (source, the TPU kernel it replaces, the path that runs it)
KERNELS = {
    "spread_fwd": ("chargeflux_tpu_torch/csrc/pme_spread.cu",
                   "chargeflux_tpu/ops/pallas_pme.py:162", "30k"),
    "spread_bwd": ("chargeflux_tpu_torch/csrc/pme_spread.cu",
                   "chargeflux_tpu/ops/pallas_pme.py:183", "30k"),
    "direct_walk": ("chargeflux_tpu_torch/csrc/direct_walk.cu",
                    "chargeflux_tpu/cells.py:862", "30k"),
    "direct_walk_tri": ("chargeflux_tpu_torch/csrc/direct_walk.cu",
                        "chargeflux_tpu/cells.py:862", "tri30k"),
    # the walk's slab form on the halo route (the JAX package's tile_energy
    # under jax.checkpoint, the concat walk on one rank's slab)
    "direct_walk_halo": ("chargeflux_tpu_torch/csrc/direct_walk.cu",
                         "chargeflux_tpu/parallel/halo.py:307", "halo1"),
    # the binning of every cell path (the JAX package's XLA ranking; also
    # its halo route's ownership-masked copy)
    "cell_bin": ("chargeflux_tpu_torch/csrc/cell_bin.cu",
                 "chargeflux_tpu/cells.py:151", "30k"),
    # the cell route's B-spline patch weights (no Pallas kernel: the JAX
    # package's jnp chain, which XLA fuses)
    "patch_weights_fwd": ("chargeflux_tpu_torch/csrc/bspline_patch.cu",
                          "chargeflux_tpu/pme.py:445 (XLA fusion, not "
                          "Pallas)", "30k"),
    "patch_weights_bwd": ("chargeflux_tpu_torch/csrc/bspline_patch.cu",
                          "chargeflux_tpu/pme.py:445 (XLA fusion, not "
                          "Pallas)", "30k"),
    # the templated exclusion rows (no Pallas kernel: the JAX package's jnp
    # slices, which XLA fuses); the _98k rows are phase 3d's at the
    # benchmark box's shapes
    "exclusion_fwd": (EXCL_SRC, EXCL_REPL, "30k"),
    "exclusion_bwd": (EXCL_SRC, EXCL_REPL, "30k"),
    "exclusion_fwd_98k": (EXCL_SRC, EXCL_REPL, "98k"),
    "exclusion_bwd_98k": (EXCL_SRC, EXCL_REPL, "98k"),
    # the templated bonds and angles (no Pallas kernel: the JAX package's
    # jnp slices, which XLA fuses), on every path with bonded terms; the
    # _98k rows are phase 3e's at the benchmark box's shapes
    "bonded_fwd": (BONDED_SRC, BONDED_REPL, "bonded"),
    "bonded_bwd": (BONDED_SRC, BONDED_REPL, "bonded"),
    "bonded_fwd_98k": (BONDED_SRC, BONDED_REPL, "98k"),
    "bonded_bwd_98k": (BONDED_SRC, BONDED_REPL, "98k"),
    "sf_fwd": (SF_SRC, "chargeflux_tpu/ops/pallas_recip.py:145", "216"),
    "sf_bwd_tables": (SF_SRC, "chargeflux_tpu/ops/pallas_recip.py:157",
                      "216"),
    "sf_bwd_zq": (SF_SRC, "chargeflux_tpu/ops/pallas_recip.py:172", "216"),
    # the structure-factor kernels batched over the replicas of phase 10
    # (one launch for all 64; the JAX package's vmap of the same calls)
    "sf_fwd_x64": (SF_SRC, "chargeflux_tpu/ops/pallas_recip.py:145",
                   "replicas"),
    "sf_bwd_tables_x64": (SF_SRC, "chargeflux_tpu/ops/pallas_recip.py:157",
                          "replicas"),
    "sf_bwd_zq_x64": (SF_SRC, "chargeflux_tpu/ops/pallas_recip.py:172",
                      "replicas"),
}
N_STEPS = 200
# the cell route's SPME kernels (the dense, RBE and halo paths run none)
WEIGHT_AND_SPREAD = ("patch_weights_fwd", "patch_weights_bwd", "spread_fwd",
                     "spread_bwd")
T_TOL = 0.10          # the NVT phases' mean temperature, relative to 300 K
# ps each NVT driver runs from its burn-in state before its chunk check and
# timed window: the burn-ins leave the box relaxing, and the first 0.1 ps
# read 312-316 K where the same drivers read 300 K after 1 ps
# (``utils.measure thermo``)
SETTLE_PS = 1.0
RESIDUAL_TOL = 1e-4   # nm^2, the JAX package's f32 constraint tolerance
WALK_TOLS = (1e-5, 1e-4, 1e-4)  # the walk's energy, dE/dx and dE/dq
# the patch weights' qwlxt, wlyt, wzt and zorg (the same floors, so equal),
# and dE/dx, dE/dy, dE/dz, dE/dq (sums of 8 f32 terms in other orders)
WEIGHT_TOLS = (1e-6, 1e-6, 1e-6, 0.0)
WEIGHT_BWD_TOLS = 2e-5
# the exclusion kernels: E within 1e-6 of the sum of the pair terms'
# magnitudes (the limit of max |diff| / |E| is scaled from it), ct dE/dx and
# ct dE/dq within 1e-5 of their max
EXCL_E_TOL = 1e-6
EXCL_GRAD_TOL = 1e-5
# the bonded kernels: E within 1e-6 of the sum of the rows' |energy|, ct
# dE/dx within 1e-5 of its max
BONDED_E_TOL = 1e-6
BONDED_GRAD_TOL = 1e-5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_rel(a, b) -> float:
    """max |a - b| / max |b| over matching tensors."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def agree(name, kern, plain, tols, where):
    """One kernel against its plain version on the same inputs: max |diff| /
    max |plain| of each output within its tolerance (one for all outputs,
    or a tuple) and two launches bitwise equal, or the script fails;
    returns (the relative errors, the largest absolute one)."""
    import torch

    out_k, out_k2, out_p = kern(), kern(), plain()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(u, v) for u, v in zip(out_k, out_k2))
    errs = [max_rel(u, v) for u, v in zip(out_k, out_p)]
    abs_err = max(float((u.double() - v.double()).abs().max())
                  for u, v in zip(out_k, out_p))
    if not isinstance(tols, tuple):
        tols = (tols,) * len(errs)
    print(f"{where} kernel {name}: rel_err={['%.3e' % e for e in errs]} "
          f"(limits {list(tols)}) max_abs_err={abs_err:.4e} "
          f"bitwise_repeat={bitwise}", flush=True)
    if any(not e <= t for e, t in zip(errs, tols)):
        fail(f"{name} disagrees with its plain version ({where}): {errs}")
    if not bitwise:
        fail(f"{name}: two launches on the same inputs differ ({where})")
    return errs, abs_err


def compare(name, kern, plain, tols, where, bound, library=None):
    """:func:`agree`, then the median ms per call of the kernel, the plain
    version and the ``library`` yardstick (if any) in turns
    (:func:`interleaved_ms`), beside the kernel's ``bound``
    (``utils.measure.kernel_bound``); returns the kernel's JSON fields."""
    import torch

    from chargeflux_tpu_torch.utils.measure import interleaved_ms

    with torch.no_grad():
        errs, abs_err = agree(name, kern, plain, tols, where)
        times = interleaved_ms((kern, plain) + ((library,) if library else ()))
    ms, plain_ms = times[:2]
    library_ms = times[2] if library else None
    lib = "none" if library_ms is None else f"{library_ms:.4f}"
    print(f"{where} kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib} bound_ms={bound['bound_ms']:.6f} "
          f"({bound['bound_by']}: {bound['flops']} flops, {bound['bytes']} "
          f"bytes) bound_share={bound['bound_ms'] / ms:.4f}", flush=True)
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound,
            "bound_share": bound["bound_ms"] / ms}


def kernel_entry(name, fields):
    src, repl, _ = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": repl,
            **fields}


def check_kernels(system, x, results):
    """Phase 3: each kernel against its plain version at the real shapes."""
    for name, (kern, plain, tols, bound, library) in kernel_cases(
            system, x, "phase 3").items():
        results[name] = kernel_entry(
            name, compare(name, kern, plain, tols, "phase 3", bound, library))
    results["direct_walk"]["library_note"] = (
        "no single call: no PyTorch call computes the cell walk's energy, "
        "dE/dx and dE/dq")
    for name in ("patch_weights_fwd", "patch_weights_bwd"):
        results[name]["library_note"] = (
            "no single call: no PyTorch call computes B-spline weights")


def kernel_cases(system, x, where):
    """The patch weights', spread and walk kernels' calls at positions
    ``x`` on ``system`` (its box): per kernel (kernel call, plain call,
    tolerances, bound, library yardstick or None), with the real mesh
    cotangent for the spread's backward and the real weight cotangents
    for the weights' backward."""
    import torch

    from chargeflux_tpu_torch import pme
    from chargeflux_tpu_torch.ops import direct_walk as dw
    from chargeflux_tpu_torch.ops import pme_spread as ps
    from chargeflux_tpu_torch.ops import pme_weights as pw
    from chargeflux_tpu_torch.ops.erfc import erf_over_r_coeffs
    from chargeflux_tpu_torch.utils.measure import (kernel_bound,
                                                    pairs_within_cutoff,
                                                    patch_weight_inputs,
                                                    spread_inputs)

    spread_in, b, ids = spread_inputs(x, system)
    w_args, w_cts = patch_weight_inputs(b, ids, system)
    geom = w_args[-1]
    weight_dims = dict(n_slots=b.x.numel(), wx=geom.wx, wyp=geom.wyp,
                       order=geom.order)
    spec = system.spec
    walk_args = (b.x, b.y, b.z, b.q, b.hs, b.se, ids, system.box,
                 system.n_atoms, spec.alpha, spec.cutoff)
    qw, wy, wz, zo, offsets, pad_xy = spread_in
    with torch.no_grad():
        # the yardsticks' operands, formed outside the timed calls: the
        # plain version's dense patch product and its backward's two
        n_col, wx, rows = qw.shape
        px, py, gz = pad_xy
        a2 = ps._a2(qw, wy)                          # [n_col, Wx*Wyp, rows]
        wz_dense = ps._expand_z(wz, zo, gz)          # [n_col, rows, Gz]
        # wy: the y rows of the patch, not the zero rows padding it to Wyp;
        # n_real: the rows that hold an atom (the rest are sentinel slots)
        spread_dims = dict(
            n_col=n_col, wx=wx, wyp=wy.shape[1], rows=rows,
            order=wz.shape[1], px=px, py=py, gz=gz,
            wy=pme._patch_width(spec.cell_grid[1], spec.pme_grid[1],
                                spec.pme_order, spec.pme_slack[1]),
            n_real=int((ids < system.n_atoms).sum()))
        n_pairs = pairs_within_cutoff(x, system.box, spec.cutoff)
    # the real mesh cotangent dE_rec/dQpad
    qpad_ref = ps.spread_fwd_plain(*spread_in).requires_grad_(True)
    (ct,) = torch.autograd.grad(pme.mesh_energy(qpad_ref, system), qpad_ref)
    ct = ct.contiguous()
    dp = torch.stack([ct[ox:ox + wx, oy:oy + wy.shape[1]]
                      for ox, oy in zip(*offsets)]).reshape(n_col, -1, gz)
    print(f"{where} shapes: spread {spread_dims}; walk {n_pairs} pairs "
          f"within the cutoff over {b.x.numel()} slots", flush=True)

    cases = {
        "patch_weights_fwd": (lambda: pw.patch_weights_fwd(*w_args),
                              lambda: pw.patch_weights_fwd_plain(*w_args),
                              WEIGHT_TOLS,
                              kernel_bound("patch_weights_fwd",
                                           **weight_dims), None),
        "patch_weights_bwd": (lambda: pw.patch_weights_bwd(*w_args, *w_cts),
                              lambda: pw.patch_weights_bwd_plain(*w_args,
                                                                 *w_cts),
                              WEIGHT_BWD_TOLS,
                              kernel_bound("patch_weights_bwd",
                                           **weight_dims), None),
        "spread_fwd": (lambda: (ps.spread_fwd(*spread_in),),
                       lambda: (ps.spread_fwd_plain(*spread_in),), 1e-6,
                       kernel_bound("spread_fwd", **spread_dims),
                       lambda: (torch.bmm(a2, wz_dense),)),
        "spread_bwd": (lambda: ps.spread_bwd(qw, wy, wz, zo, offsets, ct),
                       lambda: ps.spread_bwd_plain(qw, wy, wz, zo, offsets,
                                                   ct), 2e-5,
                       kernel_bound("spread_bwd", **spread_dims),
                       lambda: (torch.bmm(a2.transpose(1, 2), dp),
                                torch.bmm(dp, wz_dense.transpose(1, 2)))),
        "direct_walk": (lambda: dw.direct_walk(*walk_args),
                        lambda: dw.direct_walk_plain(*walk_args), WALK_TOLS,
                        kernel_bound("direct_walk", n_pairs=n_pairs,
                                     n_slots=b.x.numel(),
                                     n_cells=math.prod(spec.cell_grid),
                                     ncoef=len(erf_over_r_coeffs(
                                         spec.alpha, spec.cutoff))),
                        None),
    }
    return cases


def check_exclusions(system, x, results):
    """Phase 3d: the exclusion kernels against their plain chain (subtract
    direct, the cell route's) at the 30k start and at the benchmark's 98k
    box, each shifted, drifted by up to 0.01 nm and wrapped atom by atom
    (``utils.measure.exclusion_inputs``), timed as in phase 3 beside their
    bound; the plain chain's backward row times its forward and backward
    through autograd."""
    import torch

    from chargeflux_tpu_torch.models import water_box
    from chargeflux_tpu_torch.ops import exclusion as ex
    from chargeflux_tpu_torch.utils.measure import (exclusion_inputs,
                                                    exclusion_scale,
                                                    kernel_bound)

    dev = x.device
    force, pos, _, box = water_box(n_side=32, cutoff=1.0)
    s98 = force.create_system(box=box, dtype=torch.float32,
                              direct_method="cell", recip_method="pme",
                              cell_grid=(8, 8, 8), cell_capacity=256,
                              pme_grid=(64, 64, 64), device=dev)
    x98 = torch.tensor(pos, dtype=torch.float32, device=dev)
    ct = torch.ones((), device=dev)
    for label, sys_, xx, suffix in (("30k", system, x, ""),
                                    ("98k", s98, x98, "_98k")):
        spec = sys_.spec
        (tpl,) = spec.excl_template.templates
        args = exclusion_inputs(sys_, xx, seed=22)
        n_pairs = tpl.count * len(tpl.local_rows("exclusions"))
        dims = dict(n_atoms=tpl.count * tpl.stride, n_pairs=n_pairs)
        with torch.no_grad():
            e_plain = float(ex.exclusion_fwd_plain(*args, tpl, spec, True))
        scale = exclusion_scale(args, tpl, spec, True)
        where = (f"phase 3d at the {label} shapes ({dims['n_atoms']} atoms, "
                 f"{n_pairs} pairs; sum of |pair terms| {scale:.6e})")
        cases = {
            "exclusion_fwd": (
                lambda: (ex.exclusion_fwd(*args, tpl, spec, True),),
                lambda: (ex.exclusion_fwd_plain(*args, tpl, spec, True),),
                EXCL_E_TOL * scale / abs(e_plain)),
            "exclusion_bwd": (
                lambda: ex.exclusion_bwd(*args, tpl, spec, True, ct),
                lambda: ex.exclusion_bwd_plain(*args, tpl, spec, True, ct),
                EXCL_GRAD_TOL)}
        for name, (kern, plain, tol) in cases.items():
            results[name + suffix] = kernel_entry(name + suffix, compare(
                name, kern, plain, tol, where, kernel_bound(name, **dims)))
            results[name + suffix]["library_note"] = (
                "no single call: no PyTorch call computes the excluded "
                "pairs' correction")


def check_bonded(bonded, x, results):
    """Phase 3e: the bonded kernels against their plain chain at the 30k
    start and at the benchmark's 98k box, each shifted, drifted by up to
    0.01 nm and wrapped atom by atom (``utils.measure.bonded_inputs``),
    timed as in phase 3 beside their bound (the plain chain's backward row
    times its forward and backward through autograd); then one bonded
    evaluation and its gradient at the 30k start on the kernel route and
    on the plain copy, counting launches."""
    import torch

    from chargeflux_tpu_torch import ops
    from chargeflux_tpu_torch.bonded import bonded_energy
    from chargeflux_tpu_torch.models import water_bonded_params, water_box
    from chargeflux_tpu_torch.ops import bonded_terms as bt
    from chargeflux_tpu_torch.utils.measure import (bonded_inputs,
                                                    bonded_scale,
                                                    kernel_bound)

    dev = x.device
    _f, pos, masses, box = water_box(n_side=32, cutoff=1.0)
    b98 = water_bonded_params(len(masses) // 3, box=box, device=dev)
    x98 = torch.tensor(pos, dtype=torch.float32, device=dev)
    ct = torch.ones((), device=dev)
    for label, bd, xx, suffix in (("30k", bonded, x, ""),
                                  ("98k", b98, x98, "_98k")):
        (args,) = bonded_inputs(bd, xx, seed=22)
        tpl = args[6]
        dims = dict(n_molecules=tpl.count, stride=tpl.stride,
                    n_bonds=len(tpl.local_rows("bonds")),
                    n_angles=len(tpl.local_rows("angles")))
        with torch.no_grad():
            e_plain = float(bt.bonded_fwd_plain(*args))
        scale = bonded_scale(args)
        where = (f"phase 3e at the {label} shapes ({dims['n_molecules']} "
                 f"molecules of {dims['stride']} atoms, {dims['n_bonds']} "
                 f"bonds and {dims['n_angles']} angles each; sum of |row "
                 f"energies| {scale:.6e})")
        cases = {
            "bonded_fwd": (lambda: (bt.bonded_fwd(*args),),
                           lambda: (bt.bonded_fwd_plain(*args),),
                           BONDED_E_TOL * scale / abs(e_plain)),
            "bonded_bwd": (lambda: (bt.bonded_bwd(*args, ct),),
                           lambda: (bt.bonded_bwd_plain(*args, ct),),
                           BONDED_GRAD_TOL)}
        for name, (kern, plain, tol) in cases.items():
            results[name + suffix] = kernel_entry(name + suffix, compare(
                name, kern, plain, tol, where, kernel_bound(name, **dims)))
            results[name + suffix]["library_note"] = (
                "no single call: no PyTorch call computes the bonds' and "
                "angles' energy")
    seen = {}
    for route in ("cuda", "plain"):
        xg = x.clone().requires_grad_(True)
        ops.reset_launch_counts()
        e = bonded_energy(xg, bonded.with_kernel_route(route))
        torch.autograd.grad(e, xg)
        torch.cuda.synchronize()
        seen[route] = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"phase 3e one bonded evaluation and its gradient at the 30k "
          f"start: kernel route launched {seen['cuda']}, the plain copy "
          f"{seen['plain'] or 'no kernel'}", flush=True)
    if seen["cuda"] != {"bonded_fwd": 1, "bonded_bwd": 1} or seen["plain"]:
        fail("phase 3e: a bonded evaluation must launch each bonded kernel "
             "once on the kernel route and none on the plain copy")


def weights_agree(walk_args, system, where):
    """The patch weights' kernels against their plain versions on the
    blocks of the walk's arguments ``walk_args`` (phase 3's tolerances,
    bitwise repeat; the backward on the real weight cotangents)."""
    import torch

    from chargeflux_tpu_torch.cells import CellBlocks
    from chargeflux_tpu_torch.ops import pme_weights as pw
    from chargeflux_tpu_torch.utils.measure import patch_weight_inputs

    args, cts = patch_weight_inputs(CellBlocks(*walk_args[:6]),
                                    walk_args[6], system)
    with torch.no_grad():
        agree("patch_weights_fwd", lambda: pw.patch_weights_fwd(*args),
              lambda: pw.patch_weights_fwd_plain(*args), WEIGHT_TOLS, where)
        agree("patch_weights_bwd",
              lambda: pw.patch_weights_bwd(*args, *cts),
              lambda: pw.patch_weights_bwd_plain(*args, *cts),
              WEIGHT_BWD_TOLS, where)


def binning_agree(cases, where):
    """The binning kernel bit-equal to its plain version (slots, inverse
    slots, overflow; tolerance 0) in each of ``cases`` {name: (cell ids,
    n_cells, capacity)}, two launches repeating bit for bit."""
    from chargeflux_tpu_torch.ops import cell_bin as cb

    for name, (cell, n_cells, cap) in cases.items():
        agree("cell_bin", lambda: cb.cell_bin(cell, n_cells, cap),
              lambda: cb.cell_bin_plain(cell, n_cells, cap), 0.0,
              f"{where}, {name} ({cell.shape[0]} atoms, {n_cells} cells of "
              f"{cap})")


def check_binning(system, x, results):
    """Phase 3c: the binning kernel against its plain version, bit for bit,
    at the 30k start (timed beside its bound), at capacity 8 (cells
    overflow; the energy on the kernel route is NaN), on every rank's slab
    of the halo route's (4, 1) and (2, 2), the positions halved (most
    cells empty), the first 2049 atoms (N not a multiple of the kernel's
    chunk) and bench.py's 100k box on its 11^3 grid."""
    import dataclasses

    import torch

    from chargeflux_tpu_torch.energy import energy_and_forces
    from chargeflux_tpu_torch.ops import cell_bin as cb
    from chargeflux_tpu_torch.utils.measure import (bench_path,
                                                    binning_cases,
                                                    binning_cells,
                                                    kernel_bound)

    cases = binning_cases(system, x, "30k start")
    cell, n_cells, cap = cases.pop("30k start")
    results["cell_bin"] = kernel_entry("cell_bin", compare(
        "cell_bin", lambda: cb.cell_bin(cell, n_cells, cap),
        lambda: cb.cell_bin_plain(cell, n_cells, cap), 0.0,
        f"phase 3c at the 30k start ({cell.shape[0]} atoms, {n_cells} "
        f"cells of {cap})",
        kernel_bound("cell_bin", n_atoms=cell.shape[0],
                     n_slots=n_cells * cap)))
    results["cell_bin"]["library_note"] = (
        "no single call: no PyTorch call computes the slots")
    half, n_half = binning_cells(system, 0.5 * x)
    cases["30k halved"] = (half, n_half, int(torch.bincount(
        half.long(), minlength=n_half).max()))
    cases["2049 atoms"] = (*binning_cells(system, x[:2049]), cap)
    _f, x100, _m, _b, _bd, s100 = bench_path("100k", x.device)
    cases["100k"] = (*binning_cells(s100, x100), s100.spec.cell_capacity)
    binning_agree(cases, "phase 3c")
    over = int(cb.cell_bin(*cases["30k start capacity 8"])[2])
    empty = int((cb.cell_bin(*cases["30k halved"])[0][:, 0]
                 == x.shape[0]).sum())
    tiny = system._swap(spec=dataclasses.replace(system.spec,
                                                 cell_capacity=8))
    e, f = energy_and_forces(x, tiny)
    print(f"phase 3c binning: capacity 8 drops {over} atoms and the kernel "
          f"route's energy and forces are NaN: "
          f"{bool(torch.isnan(e) and torch.isnan(f).all())}; the halved "
          f"positions leave {empty} of {n_half} cells empty", flush=True)
    if not (over > 0 and empty > 0):
        fail("phase 3c: the binning cases do not overflow or leave no cell "
             "empty")
    if not (torch.isnan(e) and torch.isnan(f).all()):
        fail("phase 3c: a binning overflow did not poison the energy")


def check_energy(system, x, phase):
    """Phase 4 / 4b: kernel path vs plain path (f32) and plain f64."""
    import torch

    from chargeflux_tpu_torch import ops
    from chargeflux_tpu_torch.energy import energy_and_forces, energy_components
    from chargeflux_tpu_torch.integrate import make_nb_energy_fn

    e_k, f_k = energy_and_forces(x, system)
    # the plain copy's rebuild and one evaluation: no kernel launched
    e_fn, init_nb = make_nb_energy_fn(system.with_kernel_route("plain"))
    ops.reset_launch_counts()
    e_p, f_p, _ = e_fn(x, init_nb(x))
    torch.cuda.synchronize()
    plain_launches = {k: v for k, v in ops.launch_counts().items() if v}
    sys_64 = system.astype(torch.float64)
    e_64, f_64 = energy_and_forces(x.double(),
                                   sys_64.with_kernel_route("plain"))
    # the f64 system on its own route: built in f64, it records the plain
    # versions (the kernels are f32 only)
    e_64g, f_64g = energy_and_forces(x.double(), sys_64)
    d_gate = max(abs(float(e_64g - e_64)) / abs(float(e_64)),
                 float((f_64g - f_64).abs().max() / f_64.abs().max()))
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in
                    energy_components(x.double(), sys_64).values())

    def rms_rel(f, ref):
        return float(torch.sqrt(torch.mean((f.double() - ref.double()) ** 2))
                     / torch.sqrt(torch.mean(ref.double() ** 2)))

    d_p = abs(float(e_k) - float(e_p)) / scale
    d_64 = abs(float(e_k) - float(e_64)) / scale
    fr_p, fr_64 = rms_rel(f_k, f_p), rms_rel(f_k, f_64)
    print(f"phase {phase} energy_and_forces: E_kernel={float(e_k):.6f} "
          f"E_plain={float(e_p):.6f} E_plain_f64={float(e_64):.6f} "
          f"|dE|/sum|E_c|: vs plain {d_p:.3e} vs f64 {d_64:.3e}; "
          f"force rms rel: vs plain {fr_p:.3e} vs f64 {fr_64:.3e}; f64 "
          f"system on its route ({sys_64.kernel_route}) vs plain f64 "
          f"{d_gate:.3e}; plain copy's rebuild + evaluation launched "
          f"{plain_launches or 'no kernel'}", flush=True)
    if plain_launches:
        fail("the plain copy launched kernels")
    if not (torch.isfinite(f_k).all() and math.isfinite(float(e_k))):
        fail("non-finite energy or forces at the start positions")
    if d_p > 1e-5 or fr_p > 1e-4 or fr_64 > 1e-4 or d_64 > 1e-5:
        fail("kernel path disagrees with the plain path")
    if system.kernel_route != "cuda" or sys_64.kernel_route != "plain":
        fail("the f32 system on the card must record the kernels' route "
             "and the f64 one the plain route")
    if not d_gate <= 1e-12:
        fail("the f64 system on its route is not the plain f64 path")


def run_md(force, system0, x, masses, box):
    """Phase 5: burn-in, capacity re-provisioning, then 200 NVE steps."""
    import torch

    from chargeflux_tpu_torch.integrate import kinetic_energy
    from chargeflux_tpu_torch.models import water_bonded_params
    from chargeflux_tpu_torch.ops import direct_walk as dw
    from chargeflux_tpu_torch.utils.measure import (binning_cases, burn_in,
                                                    drifted_blocks,
                                                    nve_drive)

    bonded = water_bonded_params(x.shape[0] // 3, box=box, device=x.device)
    system, s1, rebuild_every, info = burn_in(force, system0, x, masses, box,
                                              bonded)
    drive, e_fn, _ = nve_drive(system, s1, rebuild_every, masses, bonded)
    print(f"phase 5 burn-in: {info['chunk']}-step chunks, {info['chunks']} "
          f"chunks in {info['seconds']:.1f} s; relaxed peak occupancy "
          f"{info['occupancy']} -> capacity {system.spec.cell_capacity}; "
          f"vmax {info['vmax']:.2f} nm/ps -> rebuild_every {rebuild_every}",
          flush=True)

    walk_args, info = drifted_blocks(system, s1, e_fn, masses,
                                     rebuild_every - 1)
    where = (f"phase 5 blocks after {rebuild_every - 1} steps on one "
             f"neighbor state ({info['outside']} atoms outside their cells' "
             f"nominal bounds, moved up to {info['moved']:.4f} nm)")
    if info["outside"] == 0:
        fail("no atom left its cell's nominal bounds: nothing drifted")
    with torch.no_grad():
        agree("direct_walk", lambda: dw.direct_walk(*walk_args),
              lambda: dw.direct_walk_plain(*walk_args), WALK_TOLS, where)
    weights_agree(walk_args, system, where)
    binning_agree(binning_cases(system, info["positions"], "drifted"),
                  "phase 5")

    ms_eager, _ = check_chunks("5", drive, rebuild_every)
    chunk = next(c for c in e_fn.nve_chunks.values() if c.k == rebuild_every)
    capture = {"capture_mib": chunk.capture_bytes / 2 ** 20,
               "capture_s": chunk.capture_seconds}
    print(f"phase 5 chunk graph of {rebuild_every} steps: capture took "
          f"{capture['capture_s']:.3f} s (host clock, incl. its eager warm-up "
          f"step); its memory pool reserved {capture['capture_mib']:.2f} "
          f"MiB (torch.cuda.memory_reserved around the capture)", flush=True)
    launches, ms, final, es = timed_run(drive)
    e0 = float(s1.potential) + float(kinetic_energy(s1.velocities, masses))
    drift = float(es[-1]) - e0
    print(f"phase 5 NVE: {N_STEPS} steps as CUDA graph replays, {ms:.3f} "
          f"ms/step (CUDA events, includes the eager final consistent-state "
          f"evaluation); total energy "
          f"{e0:.3f} -> {float(es[-1]):.3f} kJ/mol, drift {drift:.4f} "
          f"kJ/mol ({drift / x.shape[0]:.3e} per atom), max |E - E0| "
          f"{float((es - e0).abs().max()):.4f}; launches {launches}",
          flush=True)
    if int(final.nb.overflow) != 0:
        fail("binning overflow in the NVE run")
    return (check_30k_launches(launches), ms, ms_eager,
            capture, (system, s1, rebuild_every, bonded, masses))


def run_tri(dev, results):
    """Phase 6: tri30k, the 30k box on the sheared lattice."""
    import torch

    from chargeflux_tpu_torch.ops import direct_walk as dw
    from chargeflux_tpu_torch.ops.erfc import erf_over_r_coeffs
    from chargeflux_tpu_torch.utils.measure import (bench_path, burn_in,
                                                    drifted_blocks,
                                                    kernel_bound, nve_drive,
                                                    pairs_within_cutoff)

    force, x, m, box, bonded, system0 = bench_path("tri30k", dev)
    system, s1, every, info = burn_in(force, system0, x, m, box, bonded)
    spec = system.spec
    print(f"phase 6 tri30k: {system.n_atoms} atoms, box rows "
          f"{[[round(float(v), 4) for v in row] for row in system.box]}, "
          f"cells {spec.cell_grid} cap {spec.cell_capacity} (burn-in peak "
          f"occupancy {info['occupancy']}), PME {spec.pme_grid} slack "
          f"{spec.pme_slack}, rebuild_every {every}", flush=True)
    drive, e_fn, _ = nve_drive(system, s1, every, m, bonded)
    walk_args, moved = drifted_blocks(system, s1, e_fn, m, every - 1)
    if moved["outside"] == 0:
        fail("phase 6: no atom left its cell's nominal bounds")
    with torch.no_grad():
        n_pairs = pairs_within_cutoff(s1.positions, system.box, spec.cutoff)
    bound = kernel_bound("direct_walk", n_pairs=n_pairs,
                         n_slots=walk_args[0].numel(),
                         n_cells=math.prod(spec.cell_grid),
                         ncoef=len(erf_over_r_coeffs(spec.alpha,
                                                     spec.cutoff)),
                         box_floats=9)
    where = (f"phase 6 tri30k blocks after {every - 1} steps on one neighbor "
             f"state ({moved['outside']} atoms outside their cells' nominal "
             f"bounds; {n_pairs} pairs within the cutoff)")
    results["direct_walk_tri"] = kernel_entry("direct_walk_tri", compare(
        "direct_walk_tri", lambda: dw.direct_walk(*walk_args),
        lambda: dw.direct_walk_plain(*walk_args), WALK_TOLS, where, bound))
    results["direct_walk_tri"]["library_note"] = (
        results["direct_walk"]["library_note"])
    weights_agree(walk_args, system, where)
    check_energy(system, s1.positions, "6")
    ms_eager, _ = check_chunks("6", drive, every)
    launches, ms, final, _ = timed_run(drive)
    print(f"phase 6 tri30k NVE: {N_STEPS} steps as CUDA graph replays, "
          f"{ms:.3f} ms/step (CUDA events, incl. the eager final "
          f"evaluation); eager {ms_eager:.3f} ms/step; launches {launches}",
          flush=True)
    if int(final.nb.overflow) != 0:
        fail("phase 6: binning overflow in the NVE run")
    counts = check_launches(launches, "tri30k", lambda c: c > 0)
    if not (all(launches[k] > 0 for k in WEIGHT_AND_SPREAD)
            and launches["direct_walk"] == 0):
        fail("phase 6: the sheared box must run the weights and spread "
             "kernels and the triclinic walk only")
    return counts, ms, ms_eager, walk_args


def run_hetero(dev):
    """Phase 6b: hetero30k, the 300-bead chain solvated in flexible
    water; returns (ms/step, eager ms/step)."""
    from chargeflux_tpu_torch.utils.measure import (bench_path, burn_in,
                                                    nve_drive)

    force, x, m, box, bonded, system0 = bench_path("hetero30k", dev)
    rem = {"flux": dict(system0.spec.flux_template.remainder),
           "exclusions": dict(system0.spec.excl_template.remainder),
           "bonded": dict(bonded.template.remainder)}
    print(f"phase 6b hetero30k: {system0.n_atoms} atoms, remainder rows "
          f"{rem}", flush=True)
    if rem["flux"].get("bonds") != 299:
        fail("phase 6b: the chain's 299 flux bonds must take the remainder "
             "rows")
    system, s1, every, info = burn_in(force, system0, x, m, box, bonded)
    print(f"phase 6b burn-in: capacity {system.spec.cell_capacity} (peak "
          f"occupancy {info['occupancy']}), rebuild_every {every}",
          flush=True)
    drive, _, _ = nve_drive(system, s1, every, m, bonded)
    ms_eager, _ = check_chunks("6b", drive, every)
    launches, ms, final, es = timed_run(drive)
    print(f"phase 6b hetero30k NVE: {N_STEPS} steps as CUDA graph replays, "
          f"{ms:.3f} ms/step; eager {ms_eager:.3f} ms/step; total energy "
          f"{float(es[0]):.3f} -> {float(es[-1]):.3f} kJ/mol; launches "
          f"{launches}", flush=True)
    if int(final.nb.overflow) != 0:
        fail("phase 6b: binning overflow in the NVE run")
    return ms, ms_eager


def check_npt_chunks(drive, every, gen, owner):
    """Phase 7's chunk check: two barostat intervals from one generator
    state (re-seeded before each run) eagerly, warm and under
    ``set_sync_debug_mode("error")``, then as replays (the first call
    captures): energies, positions, velocities, boxes, accepts and
    poisoned flags bit-equal, one graph kept for the interval, and a
    further call with the generator carried on draws new noise.  Returns
    (eager, replayed) ms/step."""
    import torch

    n = 2 * every
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def run(graph, seed=29):
        if seed is not None:
            gen.manual_seed(seed)
        a.record()
        out = drive(n, graph, False)
        b.record()
        return out

    def parts(out):
        run_, es = out
        d = run_.diag
        return (es, run_.positions, run_.velocities, run_.box, d["boxes"],
                d["accepts"], d["poisoned"])

    run(False)                                      # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = parts(run(False))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms_eager = a.elapsed_time(b) / n
    first = parts(run(True))
    replay = parts(run(True))
    torch.cuda.synchronize()
    ms_graph = a.elapsed_time(b) / n
    same = all(torch.equal(u, v) for out in (first, replay)
               for u, v in zip(eager, out))
    fresh = not torch.equal(run(True, seed=None)[1], replay[0])
    graphs = [c for c in owner.nve_chunks.values() if c.graph is not None]
    print(f"phase 7 chunks: {n} steps ({every}-step intervals) from one "
          f"generator state, eager (graph=False, under "
          f"set_sync_debug_mode('error')) {ms_eager:.3f} ms/step, replays "
          f"{ms_graph:.3f} ms/step (CUDA events); energies, positions, "
          f"velocities, boxes, accepts bit-equal: {same}; new noise on a "
          f"further call: {fresh}; graphs kept: {len(graphs)}", flush=True)
    if not torch.isfinite(eager[0]).all():
        fail("phase 7: non-finite energies in the chunk check")
    if not same:
        fail("phase 7: NPT graph replays differ from the eager chunks")
    if not fresh:
        fail("phase 7: a second call drew the same noise")
    if len(graphs) != 1:
        fail(f"phase 7: {len(graphs)} graphs for one barostat interval")
    return ms_eager, ms_graph


def run_npt(dev):
    """Phase 7: NPT at the 30k box (bench.py npt).  Returns (launches,
    ms/step, eager ms/step, the line's extra fields)."""
    import torch

    from chargeflux_tpu_torch import ops
    from chargeflux_tpu_torch.npt import instantaneous_pressure
    from chargeflux_tpu_torch.pairs import box_volume
    from chargeflux_tpu_torch.utils.measure import (DT_PS, npt_drive,
                                                    npt_path, ns_per_day)

    path = npt_path(dev)
    every, system = path["rebuild_every"], path["system"]
    info = path["info"]
    print(f"phase 7 npt burn-in: {info['steps']} steps of 20/ps Langevin in "
          f"{info['chunk']}-step chunks, {info['seconds']:.1f} s; relaxed "
          f"peak occupancy {info['occupancy']} -> capacity "
          f"{system.spec.cell_capacity}; vmax {info['vmax']:.2f} nm/ps -> "
          f"barostat_interval {every}", flush=True)
    drive, owner, _ = npt_drive(path)
    ms_eager, _ = check_npt_chunks(drive, every, path["generator"], owner)
    graph = next(c.graph for c in owner.nve_chunks.values())
    n = -(-N_STEPS // every) * every
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    run, es = drive(n, True, False)
    b.record()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    ms = a.elapsed_time(b) / n
    diag = run.diag
    vols = [float(box_volume(bx.double())) for bx in diag["boxes"]]
    v0 = float(box_volume(system.box.double()))
    n_acc = int(diag["accepts"].sum())
    n_poison = int(diag["poisoned"].sum())
    same_graph = (len(owner.nve_chunks) == 1
                  and next(iter(owner.nve_chunks.values())).graph is graph)
    print(f"phase 7 NPT: {n} steps ({n // every} attempts) as CUDA graph "
          f"replays, {ms:.3f} ms/step (CUDA events around the call, incl. "
          f"the copy-in and the start energy), "
          f"{ns_per_day(DT_PS, ms):.2f} ns/day; eager {ms_eager:.3f} "
          f"ms/step; accepted {n_acc} of {n // every}, poisoned {n_poison}; "
          f"volume {v0:.4f} -> {vols[-1]:.4f} nm^3 (min {min(vols):.4f}, "
          f"max {max(vols):.4f}); one graph replayed throughout: "
          f"{same_graph}; energy {float(es[0]):.3f} -> {float(es[-1]):.3f} "
          f"kJ/mol; launches {launches}", flush=True)
    if not (torch.isfinite(es).all() and torch.isfinite(run.positions).all()):
        fail("phase 7: non-finite energies or positions in the NPT run")
    if n_acc == 0 or not float(box_volume(run.box.double())) != v0:
        fail("phase 7: no volume move was accepted")
    if not same_graph:
        fail("phase 7: the box moved through a recapture")
    sysb = system.with_box(run.box)
    cases = kernel_cases(sysb, run.positions, "phase 7 at the final box")
    with torch.no_grad():
        for name, (kern, plain, tols, _b, _l) in cases.items():
            agree(name, kern, plain, tols, "phase 7 at the final box")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    p = float(instantaneous_pressure(run.positions, run.velocities, sysb,
                                     path["masses"],
                                     path["bonded"].with_box(run.box)))
    p_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"phase 7 instantaneous_pressure at the final state: {p:.2f} bar "
          f"(plain autodiff through the box, classical Ewald at kmax "
          f"{system.spec.kmax}) in {p_s:.2f} s (host clock, synchronised), "
          f"peak device memory {peak:.2f} GiB", flush=True)
    if not math.isfinite(p):
        fail("phase 7: the virial pressure is not finite")
    extra = {"barostat_interval": every, "attempts": n // every,
             "accepted": n_acc, "poisoned": n_poison,
             "volume_start_nm3": v0, "volume_end_nm3": vols[-1],
             "pressure_bar": p, "pressure_s": p_s,
             "pressure_peak_gib": peak,
             "ns_per_day": ns_per_day(DT_PS, ms)}
    return check_30k_launches(launches), ms, ms_eager, extra


def run_thermostats(dev, ctx):
    """Phase 7b: CSVR and Nose-Hoover chain NVT on phase 5's burned-in
    state, each after :func:`settle`.  Returns {name: (ms/step, eager
    ms/step)} and the chain's conserved-quantity drift."""
    import torch

    from chargeflux_tpu_torch.nosehoover import (nhc_conserved, nhc_init,
                                                 nose_hoover_trajectory_nb)
    from chargeflux_tpu_torch.units import BOLTZ
    from chargeflux_tpu_torch.utils.measure import (DT_PS, TAU_NHC, TEMP,
                                                    thermostat_drive)

    system, s1, every, bonded, m = ctx
    n_atoms = system.n_atoms
    gen = torch.Generator(dev).manual_seed(0)
    s_eq = settle("7b csvr", thermostat_drive("csvr", system, s1, every, m,
                                              bonded, gen)[0], DT_PS)
    drive, _, _ = thermostat_drive("csvr", system, s_eq, every, m, bonded,
                                   gen)
    ms_eager_c, _ = check_chunks("7b csvr", drive, every, gen)
    launches, ms_c, _, kes = timed_run(drive)
    t_mean = float((2.0 * kes / (3 * n_atoms * BOLTZ)).mean())
    print(f"phase 7b CSVR NVT: {N_STEPS} steps as CUDA graph replays, "
          f"{ms_c:.3f} ms/step; eager {ms_eager_c:.3f}; mean temperature "
          f"{t_mean:.2f} K (3N degrees of freedom); launches {launches}",
          flush=True)
    if not abs(t_mean / 300.0 - 1.0) <= T_TOL:
        fail(f"phase 7b: CSVR mean temperature {t_mean:.2f} K is not "
             f"within {T_TOL:.0%} of 300 K")
    check_30k_launches(launches)
    s_eq = settle("7b nhc", thermostat_drive("nhc", system, s1, every, m,
                                             bonded)[0], DT_PS)
    drive, e_fn, init_nb = thermostat_drive("nhc", system, s_eq, every, m,
                                            bonded)
    ms_eager_n, _ = check_chunks("7b nhc", drive, every)
    n_dof = 3 * n_atoms - 3
    chain0 = nhc_init(n_dof, TEMP, TAU_NHC, 3, torch.float32, dev)
    h0 = float(nhc_conserved(s_eq, chain0, m, n_dof, TEMP))
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    fin, chain, kes = nose_hoover_trajectory_nb(
        s_eq, e_fn, init_nb, m, DT_PS, TEMP, TAU_NHC, N_STEPS, every)
    b.record()
    torch.cuda.synchronize()
    ms_n = a.elapsed_time(b) / N_STEPS
    h1 = float(nhc_conserved(fin, chain, m, n_dof, TEMP))
    t_mean = float((2.0 * kes / (n_dof * BOLTZ)).mean())
    print(f"phase 7b NHC NVT (chain of 3, tau {TAU_NHC} ps): {N_STEPS} "
          f"steps as CUDA graph replays, {ms_n:.3f} ms/step; eager "
          f"{ms_eager_n:.3f}; conserved quantity {h0:.3f} -> {h1:.3f} "
          f"kJ/mol (drift {h1 - h0:.4f}, {(h1 - h0) / n_atoms:.3e} per "
          f"atom); mean temperature {t_mean:.2f} K", flush=True)
    if not (torch.isfinite(kes).all() and math.isfinite(h1)):
        fail("phase 7b: non-finite Nose-Hoover run")
    return {"csvr": (ms_c, ms_eager_c), "nhc": (ms_n, ms_eager_n)}, h1 - h0


def timed_run(drive):
    """N_STEPS replayed steps through ``drive`` with the launch counts reset
    just before: (launches, ms/step from CUDA events around the call, the
    final state, the per-step records in f64 on the host), or the script
    fails on a non-finite record, potential or position (a NaN poison or
    a blowup)."""
    import torch

    from chargeflux_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    final, es = drive(N_STEPS, True, False)
    b.record()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if not (torch.isfinite(es).all() and math.isfinite(float(final.potential))
            and torch.isfinite(final.positions).all()):
        fail("a timed run produced non-finite energies or positions")
    return launches, a.elapsed_time(b) / N_STEPS, final, es.double().cpu()


def check_chunks(phase, drive, rebuild_every, gen=None):
    """The same start state through two rebuild chunks and a remainder
    chunk (the remainder of N_STEPS, so the counted run that follows finds
    every graph it replays captured) by ``drive(n, graph, plain)`` of
    ``utils.measure``, eagerly (``graph=False``) and as CUDA graph replays:
    per-step records, final positions and velocities bit-equal.  The eager
    run, once warm, runs under ``set_sync_debug_mode("error")``: no step,
    rebuild or final evaluation reads a device value on the host.  For a
    stochastic driver (``gen``, the generator it draws from) every run
    starts from the same generator state (``gen`` re-seeded), and one more
    call with the generator carried on must draw new noise.  Returns the
    eager and the replayed ms/step (CUDA events around the trajectory call,
    which include the eager final consistent-state evaluation)."""
    import torch

    rem = N_STEPS % rebuild_every or max(1, rebuild_every // 2)
    n = 2 * rebuild_every + rem
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def run(graph, seed=29):
        if gen is not None and seed is not None:
            gen.manual_seed(seed)
        a.record()
        out = drive(n, graph, False)
        b.record()
        return out

    run(False)                                      # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = run(False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms_eager = a.elapsed_time(b) / n
    first = run(True)                               # captures, then replays
    torch.cuda.synchronize()
    ms_capture = a.elapsed_time(b) / n
    replay = run(True)
    torch.cuda.synchronize()
    ms_graph = a.elapsed_time(b) / n
    same = all(torch.equal(u, v) for out in (first, replay) for u, v in (
        (eager[1], out[1]), (eager[0].positions, out[0].positions),
        (eager[0].velocities, out[0].velocities)))
    fresh = None
    if gen is not None:
        fresh = not torch.equal(run(True, seed=None)[1], replay[1])
    print(f"phase {phase} chunks: {n} steps ({rebuild_every}-step chunks and "
          f"a {rem}-step remainder){'' if gen is None else ' from one generator state'}, "
          f"eager (graph=False, under set_sync_debug_mode('error')) "
          f"{ms_eager:.3f} ms/step, first call (capture + replays) "
          f"{ms_capture:.3f}, replays {ms_graph:.3f} ms/step (CUDA events, "
          f"incl. the eager final evaluation); records, positions and "
          f"velocities bit-equal: {same}"
          + ("" if gen is None else f"; the generator carried on draws new "
             f"noise: {fresh}"), flush=True)
    if not torch.isfinite(eager[1]).all():
        fail(f"phase {phase}: non-finite records in the chunk check")
    if not same:
        fail(f"phase {phase}: graph replays differ from the eager chunks")
    if fresh is False:
        fail(f"phase {phase}: a second call drew the same noise")
    return ms_eager, ms_graph


def settle(phase, drive, dt_ps):
    """SETTLE_PS of replayed steps through ``drive`` from its start state:
    the state the phase's chunk check and timed window start from."""
    n = round(SETTLE_PS / dt_ps)
    final, _ = drive(n, True, False)
    print(f"phase {phase}: {n} settling steps ({SETTLE_PS:g} ps) before "
          f"the window", flush=True)
    return final


def run_nvt(phase, label, path, drive, dt_ps, params=None):
    """Phases 5c / 5d / 9: :func:`settle`, the chunk check, then N_STEPS
    timed replayed steps with the launch counts reset before them; checks
    finite energies,
    the spread and walk kernels' launches, the mean kinetic temperature
    and, with ``params``, the constraint residual.  Returns (launches,
    ms/step, eager ms/step, the final state)."""
    from chargeflux_tpu_torch.constraints import constraint_residuals
    from chargeflux_tpu_torch.units import BOLTZ
    from chargeflux_tpu_torch.utils.measure import ns_per_day

    every, n_atoms = path["rebuild_every"], path["system"].n_atoms
    info = path["info"]
    print(f"phase {phase} {label} burn-in: {info['steps']} steps in "
          f"{info['chunk']}-step chunks, {info['seconds']:.1f} s; relaxed "
          f"peak occupancy {info['occupancy']} -> capacity "
          f"{path['system'].spec.cell_capacity}; rebuild_every {every}",
          flush=True)
    path["state"] = settle(phase, drive, dt_ps)
    ms_eager, _ = check_chunks(phase, drive, every, path["generator"])
    launches, ms, final, kes = timed_run(drive)
    n_c = 0 if params is None else params.n_constraints
    temps = 2.0 * kes / ((3 * n_atoms - n_c) * BOLTZ)
    t_mean = float(temps.mean())
    res = (float(constraint_residuals(final.positions, params).abs().max())
           if params is not None else None)
    print(f"phase {phase} {label}: {N_STEPS} steps as CUDA graph replays, "
          f"{ms:.3f} ms/step (CUDA events, incl. the eager final "
          f"evaluation), {ns_per_day(dt_ps, ms):.2f} ns/day at "
          f"{dt_ps * 1e3:g} fs; eager {ms_eager:.3f} ms/step; mean "
          f"temperature {t_mean:.2f} K over the window (3N - {n_c} degrees "
          f"of freedom); max |constraint residual| "
          f"{'none' if res is None else '%.3e nm^2' % res}; final potential "
          f"{float(final.potential):.3f} kJ/mol; launches {launches}",
          flush=True)
    if not abs(t_mean / 300.0 - 1.0) <= T_TOL:
        fail(f"phase {phase}: mean temperature {t_mean:.2f} K is not within "
             f"{T_TOL:.0%} of 300 K")
    if res is not None and not res <= RESIDUAL_TOL:
        fail(f"phase {phase}: constraint residual {res:.3e} nm^2 exceeds "
             f"{RESIDUAL_TOL:g}")
    return (check_30k_launches(launches, path.get("bonded") is not None), ms,
            ms_eager, final)


PDB_TOL_NM = 5e-5 + 1e-9   # PDB columns: 1e-3 Angstrom, rounded
DCD_REL_TOL = 2e-7         # DCD: f32 Angstrom, relative to max |x|


def onramp_utilities(path, final, tmp):
    """Phase 9's utilities on onramp30k's final state: a PDB frame and a
    10-frame DCD (ten further replayed rebuild chunks) read back to the
    formats' precision, a checkpoint loaded back bit-equal,
    ``diagnose_nan`` with no cause, and the O-O radial distribution's
    first peak; returns that peak (nm)."""
    import os

    import numpy as np
    import torch

    from chargeflux_tpu_torch.integrate import langevin_trajectory_nb
    from chargeflux_tpu_torch.utils import (DCDWriter, diagnose_nan,
                                            load_checkpoint, radial_distribution,
                                            read_dcd, read_pdb, save_checkpoint,
                                            write_pdb)
    from chargeflux_tpu_torch.utils.measure import DT_PS, FRICTION, TEMP

    system, masses, every = path["system"], path["masses"], path["rebuild_every"]
    e_fn, init_nb = path["e_fns"]
    x = final.positions
    pdb = os.path.join(tmp, "final.pdb")
    write_pdb(pdb, x, box=path["box"], masses=masses)
    d_pdb = float(np.abs(read_pdb(pdb).positions
                         - x.double().cpu().numpy()).max())
    frames, state = [], final
    dcd = os.path.join(tmp, "run.dcd")
    with DCDWriter(dcd, system.n_atoms, dt_ps=DT_PS, interval=every) as w:
        for _ in range(10):
            state, kes = langevin_trajectory_nb(
                state, e_fn, init_nb, masses, DT_PS, TEMP, FRICTION,
                path["generator"], every, every)
            if not torch.isfinite(kes).all():
                fail("phase 9: non-finite energies in the DCD frames")
            w.write(state.positions, box=system.box)
            frames.append(state.positions.double().cpu().numpy())
    back, cells = read_dcd(dcd)
    frames = np.stack(frames)
    d_dcd = float(np.abs(back - frames).max())
    tol_dcd = DCD_REL_TOL * float(np.abs(frames).max())
    ckpt = os.path.join(tmp, "state")
    save_checkpoint(ckpt, final, step=N_STEPS)
    loaded, step = load_checkpoint(ckpt, final)
    same = (step == N_STEPS and all(
        torch.equal(getattr(loaded, f), getattr(final, f))
        for f in ("positions", "velocities", "forces", "potential"))
        and all(torch.equal(getattr(loaded.nb, f), getattr(final.nb, f))
                for f in ("slots", "inv_slot", "wrap", "x_ref", "overflow")))
    rep = diagnose_nan(x, system, nb=final.nb, dt=DT_PS)
    names = read_pdb(path["pdb"]).names
    oxy = [i for i, nm in enumerate(names) if nm == "O"]
    with torch.no_grad():
        r, g = radial_distribution(x, system.box, oxy, oxy, r_max=0.8,
                                   n_bins=160)
    peak = float(r[int(torch.argmax(g))])
    print(f"phase 9 utilities: PDB frame max |diff| {d_pdb:.3e} nm (limit "
          f"{PDB_TOL_NM:.3e}); 10-frame DCD max |diff| {d_dcd:.3e} nm "
          f"(limit {tol_dcd:.3e}), {len(cells)} cell records; checkpoint "
          f"loaded bit-equal: {same}; diagnose_nan: {rep['cause']}; O-O "
          f"g(r) over {len(oxy)} oxygens: first peak {peak:.4f} nm, "
          f"g_max {float(g.max()):.3f}", flush=True)
    if not d_pdb <= PDB_TOL_NM:
        fail("phase 9: the PDB frame does not read back")
    if not (d_dcd <= tol_dcd and back.shape == frames.shape):
        fail("phase 9: the DCD frames do not read back")
    if not same:
        fail("phase 9: the checkpoint did not load back bit-equal")
    if rep["cause"] != "none":
        fail(f"phase 9: diagnose_nan reports {rep['cause']}")
    if not 0.25 <= peak <= 0.32:
        fail(f"phase 9: the O-O first peak {peak:.4f} nm is outside "
             f"0.25-0.32 nm")
    return peak


def run_onramp(dev):
    """Phase 9: onramp30k, the PDB on-ramp at the 30k size.  Returns
    (launches, ms/step, eager ms/step, the line's fields)."""
    import tempfile

    import numpy as np

    from chargeflux_tpu_torch.utils.measure import (DT_PS, langevin_drive,
                                                    ns_per_day, onramp_path)
    from chargeflux_tpu_torch.utils.trajectory import read_pdb

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = onramp_path(dev, directory=tmp)
        system, bonded = path["system"], path["bonded"]
        d_read = float(np.abs(read_pdb(path["pdb"]).positions
                              - path["pdb_positions"]).max())
        rem = {"flux": dict(system.spec.flux_template.remainder),
               "exclusions": dict(system.spec.excl_template.remainder),
               "bonded": dict(bonded.template.remainder)}
        print(f"phase 9 onramp30k: {system.n_atoms} atoms from the port's "
              f"PDB ({path['pdb_positions'].shape[0]} written, read back "
              f"within {d_read:.2e} nm), {path['force'].getNumFluxBonds()} "
              f"flux bonds, {bonded.torsion_idx.shape[0]} backbone "
              f"torsions; remainder rows {rem}; cells "
              f"{system.spec.cell_grid}, PME {system.spec.pme_grid}",
              flush=True)
        if system.n_atoms != 31926:
            fail(f"phase 9: {system.n_atoms} atoms, not 31,926")
        if not d_read <= PDB_TOL_NM:
            fail("phase 9: the written PDB does not read back")
        drive, _, _ = langevin_drive(path)
        launches, ms, ms_eager, final = run_nvt("9", "onramp30k NVT", path,
                                                drive, DT_PS)
        peak = onramp_utilities(path, final, tmp)
    seconds = time.perf_counter() - t0
    print(f"phase 9 took {seconds:.1f} s (host clock)", flush=True)
    return launches, ms, ms_eager, {
        "ns_per_day": ns_per_day(DT_PS, ms), "rebuild_every":
        path["rebuild_every"], "oo_peak_nm": peak,
        "remainder_flux_bonds": rem["flux"].get("bonds", 0),
        "seconds": seconds}


RBE_DRAWS = 64      # phase 9b's estimator draws
RBE_FREQ_DRAWS = 1 << 20   # k-vectors drawn for the sampler's frequencies
# p of phase 9b's temperature check: the estimator's force noise heats
# the box by ~1/p (+57 K at p = 128, 20/ps, 0.5 fs on the 30k box on an
# NVIDIA H100: PERF.md), so the 10 % check runs at four times the JAX
# package's p
RBE_CHECK_SAMPLES = 512


def run_rbe(dev, ctx):
    """Phase 9b: random batch Ewald NVT on phase 5's burned-in 30k state,
    beside the SPME Langevin step at the same settings.  Returns (launches,
    the line's fields)."""
    import numpy as np
    import torch

    from chargeflux_tpu_torch.charges import effective_charges
    from chargeflux_tpu_torch.energy import energy_components_fixed_charges
    from chargeflux_tpu_torch.rbe import (estimator_moments,
                                          rbe_reciprocal_energy,
                                          sample_integers)
    from chargeflux_tpu_torch.units import BOLTZ
    from chargeflux_tpu_torch.utils.measure import (RBE_FRICTION,
                                                    RBE_SAMPLES, rbe_drive,
                                                    spme_langevin_drive)

    t0 = time.perf_counter()
    system, s1, every, bonded, m = ctx
    gen = torch.Generator(dev).manual_seed(0)
    drive, e_fn, _ = rbe_drive(system, s1, every, m, bonded, gen)
    tables = e_fn.tables
    print(f"phase 9b rbe30k: p = {RBE_SAMPLES}, friction {RBE_FRICTION}/ps, "
          f"rebuild_every {every}; tables of {[len(n) for n in tables.nvals]} "
          f"integers per axis, Z {tables.z_const:.6f}", flush=True)
    ms_eager, _ = check_chunks("9b", drive, every, gen)
    rem = N_STEPS % every or max(1, every // 2)
    launches, ms, final, kes = timed_run(drive)
    t_mean = float((2.0 * kes / (3 * system.n_atoms * BOLTZ)).mean())
    g4 = torch.Generator(dev).manual_seed(1)
    drive4, _, _ = rbe_drive(system, s1, every, m, bonded, g4,
                             n_samples=RBE_CHECK_SAMPLES)
    drive4(2 * every + rem)                                  # capture
    launches4, ms4, _, kes4 = timed_run(drive4)
    t_mean4 = float((2.0 * kes4 / (3 * system.n_atoms * BOLTZ)).mean())
    g2 = torch.Generator(dev).manual_seed(0)
    spme, _, _ = spme_langevin_drive(system, s1, every, m, bonded, g2)
    spme(2 * every + rem)                                    # capture
    _, ms_spme, _, _ = timed_run(spme)
    print(f"phase 9b rbe30k NVT: {N_STEPS} steps as CUDA graph replays, "
          f"{ms:.3f} ms/step at p = {RBE_SAMPLES} (CUDA events, incl. the "
          f"eager final evaluation; eager {ms_eager:.3f}), {ms4:.3f} at p = "
          f"{RBE_CHECK_SAMPLES}; SPME Langevin at the same settings in this "
          f"call {ms_spme:.3f} ms/step (RBE / SPME {ms / ms_spme:.3f}, "
          f"{ms4 / ms_spme:.3f}); mean temperature {t_mean:.2f} K at p = "
          f"{RBE_SAMPLES} (the estimator's noise heats; no check), "
          f"{t_mean4:.2f} K at p = {RBE_CHECK_SAMPLES}; launches {launches}, "
          f"{launches4}", flush=True)
    if not abs(t_mean4 / 300.0 - 1.0) <= T_TOL:
        fail(f"phase 9b: mean temperature {t_mean4:.2f} K at p = "
             f"{RBE_CHECK_SAMPLES} is not within {T_TOL:.0%} of 300 K")
    for counts in (launches, launches4):
        if not (counts["direct_walk"] > 0
                and not any(counts[k] for k in WEIGHT_AND_SPREAD)):
            fail("phase 9b: RBE must run the walk kernel and no spread or "
                 "patch weights")
    x = s1.positions
    with torch.no_grad():
        q = effective_charges(x, system)
        comps = energy_components_fixed_charges(x, q, system)
        e_spme = float(comps["reciprocal"])
        scale = sum(abs(float(v)) for v in comps.values())
        draws = torch.stack([rbe_reciprocal_energy(x, q, tables, RBE_SAMPLES,
                                                   gen)
                             for _ in range(RBE_DRAWS)]).double()
        e_exact, var = estimator_moments(x.double(), q.double(), tables)
    mean, se_sample = float(draws.mean()), float(draws.std() / RBE_DRAWS ** 0.5)
    se = (float(var) / (RBE_SAMPLES * RBE_DRAWS)) ** 0.5
    z = (mean - e_spme) / se
    d_exact = abs(float(e_exact) - e_spme) / scale
    print(f"phase 9b estimator at the start state: mean of {RBE_DRAWS} "
          f"draws {mean:.3f} kJ/mol; its exact expectation (S(k) enumerated "
          f"over the tables) {float(e_exact):.3f}, SPME reciprocal "
          f"{e_spme:.3f}, |exact - SPME| / sum|E_c| {d_exact:.3e} (limit "
          f"1e-4); standard error {se:.3f} from the exact variance "
          f"(the draws' own {se_sample:.3f}: the terms are heavy-tailed); "
          f"(mean - SPME) / se = {z:.3f} (limit 5; "
          f"{(mean - e_spme) / se_sample:.3f} on the draws' own)",
          flush=True)
    if not d_exact <= 1e-4:
        fail("phase 9b: the RBE estimator's expectation is not the SPME "
             "reciprocal energy")
    with torch.no_grad():
        n = sample_integers(tables, RBE_FREQ_DRAWS, gen, dev).cpu().numpy()
    worst = 0.0
    for ax in range(3):
        prob = np.exp(tables.logp[ax] - tables.logp[ax].max())
        prob /= prob.sum()
        counts = np.bincount(n[:, ax] - tables.nvals[ax][0],
                             minlength=len(prob))
        expect = RBE_FREQ_DRAWS * prob
        worst = max(worst, float(np.max(np.abs(counts - expect) / (
            np.sqrt(expect * (1.0 - prob)) + 1.0))))
    print(f"phase 9b sampler on the card: {RBE_FREQ_DRAWS} k-vectors, "
          f"largest per-axis bin deviation from the tables' probabilities "
          f"{worst:.2f} standard deviations (limit 5)", flush=True)
    if not worst <= 5.0:
        fail("phase 9b: the card's k-vector draws do not follow the tables")
    if not abs(z) <= 5.0:
        fail("phase 9b: the RBE estimator's mean is not within 5 standard "
             "errors of the SPME reciprocal energy")
    seconds = time.perf_counter() - t0
    print(f"phase 9b took {seconds:.1f} s (host clock)", flush=True)
    if launches["cell_bin"] == 0:
        fail("phase 9b: RBE's neighbor rebuilds must run the binning kernel")
    if not (launches["bonded_fwd"] > 0 and launches["bonded_bwd"] > 0):
        fail("phase 9b: the RBE path must run the bonded kernels")
    return {k: launches[k] for k in ("direct_walk", "cell_bin", "bonded_fwd",
                                     "bonded_bwd")}, {
        "ms_per_step": ms, "ms_per_step_eager": ms_eager,
        "ms_per_step_p512": ms4, "t_mean_k": t_mean, "t_mean_k_p512": t_mean4,
        "ms_per_step_spme_same_call": ms_spme, "estimator_z": z,
        "estimator_se": se, "estimator_se_of_draws": se_sample,
        "estimator_exact_vs_spme": d_exact, "sampler_worst_sigma": worst,
        "seconds": seconds}


def run_dense_pme(dev):
    """Phase 9c: dense216 on the dense-mesh SPME.  Returns the line's
    fields."""
    import torch

    from chargeflux_tpu_torch.energy import (energy_and_forces,
                                             energy_components,
                                             forces_manual)
    from chargeflux_tpu_torch.models import water_box
    from chargeflux_tpu_torch.utils.measure import interleaved_ms

    t0 = time.perf_counter()
    force, pos, _, box = water_box(n_side=6, cutoff=0.9)

    def build(dtype, recip):
        return force.create_system(box=box, dtype=dtype,
                                   direct_method="dense", recip_method=recip,
                                   device=dev)

    s32, s64, s64e = (build(torch.float32, "pme"), build(torch.float64, "pme"),
                      build(torch.float64, "xla"))
    x64 = torch.tensor(pos, dtype=torch.float64, device=dev)
    x32 = x64.float()
    e32, f32 = energy_and_forces(x32, s32)
    e64, f64 = energy_and_forces(x64, s64)
    e_ew, _ = energy_and_forces(x64, s64e)
    f_man = forces_manual(x64, s64)
    rms = float(torch.sqrt(torch.mean((f32.double() - f64) ** 2)
                           / torch.mean(f64 ** 2)))
    # the scale of phase 4: the sum of the components' magnitudes (the
    # total cancels to a few hundred kJ/mol at the lattice start)
    with torch.no_grad():
        scale = sum(abs(float(v)) for v in
                    energy_components(x64, s64e).values())
    d_ew = abs(float(e64) - float(e_ew)) / scale
    d_man = float((f_man - f64).abs().max() / f64.abs().max())
    ms = interleaved_ms([lambda: energy_and_forces(x32, s32)])[0]
    print(f"phase 9c dense216: {s32.n_atoms} atoms, PME mesh "
          f"{s32.spec.pme_grid} order {s32.spec.pme_order}, kmax "
          f"{s32.spec.kmax}; E f32 {float(e32):.6f} f64 {float(e64):.6f} "
          f"classical Ewald f64 {float(e_ew):.6f} kJ/mol; force RMS rel f32 "
          f"vs f64 {rms:.3e} (limit 1e-4); |E_pme - E_ewald| "
          f"/ sum|E_c| {d_ew:.3e} (limit 1e-4; / |E_ewald| "
          f"{abs(float(e64) - float(e_ew)) / abs(float(e_ew)):.3e}); "
          f"forces_manual vs autograd f64 max rel "
          f"{d_man:.3e} (limit 1e-10); f32 energy_and_forces "
          f"{ms:.4f} ms per call (CUDA graph of 20 calls, median of 7)",
          flush=True)
    if not (torch.isfinite(f32).all() and rms <= 1e-4):
        fail("phase 9c: f32 dense SPME forces disagree with f64")
    if not d_ew <= 1e-4:
        fail("phase 9c: dense SPME disagrees with classical Ewald")
    if not d_man <= 1e-10:
        fail("phase 9c: forces_manual disagrees with the autograd forces")
    seconds = time.perf_counter() - t0
    print(f"phase 9c took {seconds:.1f} s (host clock)", flush=True)
    return {"force_rms_f32_f64": rms, "rel_e_vs_ewald": d_ew,
            "forces_manual_rel": d_man, "ms_energy_and_forces": ms,
            "seconds": seconds}


CLUSTER_STEPS, CLUSTER_EVERY = 1600, 4


def run_cluster(dev):
    """Phase 9d: the 125-water cluster, Langevin with the total dipole
    every 4 steps and its IR line shape.  Returns the line's fields."""
    import numpy as np
    import torch

    from chargeflux_tpu_torch.integrate import (init_state,
                                                langevin_trajectory,
                                                make_energy_fn,
                                                maxwell_velocities)
    from chargeflux_tpu_torch.models import water_bonded_params, water_cluster
    from chargeflux_tpu_torch.units import BOLTZ
    from chargeflux_tpu_torch.utils import infrared_spectrum, total_dipole
    from chargeflux_tpu_torch.utils.measure import DT_PS, TEMP

    t0 = time.perf_counter()
    force, pos, masses = water_cluster(n_side=5, seed=11)
    system = force.create_system(dtype=torch.float32, device=dev)
    bonded = water_bonded_params(len(masses) // 3, device=dev)
    e_fn = make_energy_fn(system, bonded=bonded)
    m = torch.tensor(masses, dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.tensor(pos, dtype=torch.float32, device=dev)
    state = init_state(x, maxwell_velocities(m, TEMP, gen,
                                             dtype=torch.float32), e_fn)
    dips, kes = [], []
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(CLUSTER_STEPS // CLUSTER_EVERY):
        state, ke = langevin_trajectory(state, e_fn, m, DT_PS, TEMP, 2.0, gen,
                                        CLUSTER_EVERY)
        with torch.no_grad():
            dips.append(total_dipole(state.positions, system))
        kes.append(ke)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / CLUSTER_STEPS
    kes = torch.cat(kes).double()
    dips = torch.stack(dips).double().cpu().numpy()
    freq, inten = infrared_spectrum(dips, CLUSTER_EVERY * DT_PS)
    band = (freq >= 60.0) & (freq <= 130.0)
    peak = float(freq[band][np.argmax(inten[band])])
    t_mean = float((2.0 * kes / (3 * system.n_atoms * BOLTZ)).mean())
    print(f"phase 9d cluster: {system.n_atoms} atoms, non-periodic, "
          f"{CLUSTER_STEPS} Langevin steps in calls of {CLUSTER_EVERY} "
          f"(each a CUDA graph replay, its final energy and the dipole "
          f"eager), {ms:.3f} ms/step (CUDA events); mean temperature "
          f"{t_mean:.2f} K; {len(dips)} dipole samples, IR stretch-band "
          f"peak {peak:.2f} THz (60-130 THz band, resolution "
          f"{float(freq[1]):.3f} THz)", flush=True)
    if not (np.isfinite(inten).all() and np.isfinite(dips).all()
            and torch.isfinite(kes).all()):
        fail("phase 9d: non-finite dipoles, spectrum or energies")
    seconds = time.perf_counter() - t0
    print(f"phase 9d took {seconds:.1f} s (host clock)", flush=True)
    return {"ms_per_step": ms, "ir_peak_thz": peak, "t_mean_k": t_mean,
            "seconds": seconds}


def run_rigid(dev):
    """Phase 5c: rigid NVT at the 30k box."""
    from chargeflux_tpu_torch.utils.measure import (DT_RIGID, rigid_drive,
                                                    rigid_path)

    path = rigid_path(dev)
    drive, _, _ = rigid_drive(path)
    return run_nvt("5c", "rigid NVT", path, drive, DT_RIGID,
                   path["params"])[:3]


def run_respa(dev):
    """Phase 5d: r-RESPA NVT at the 30k box (steps are outer steps)."""
    from chargeflux_tpu_torch.utils.measure import (DT_PS, N_INNER,
                                                    respa_drive, respa_path)

    path = respa_path(dev)
    drive, _, _ = respa_drive(path)
    return run_nvt("5d", "RESPA NVT", path, drive, DT_PS * N_INNER)[:3]


def check_launches(launches, path, ok):
    """Every kernel of ``path`` launched as ``ok`` wants in that path's
    run; returns that path's counts."""
    counts = {k: launches[k] for k, v in KERNELS.items() if v[2] == path}
    for name, count in counts.items():
        if not ok(count):
            fail(f"kernel {name}: {count} launches on the {path} path")
    return counts


def check_30k_launches(launches, bonded: bool = True):
    """:func:`check_launches` of the 30k path's kernels and, on a path with
    bonded terms, of the bonded kernels: each launched."""
    counts = check_launches(launches, "30k", lambda c: c > 0)
    if bonded:
        counts.update(check_launches(launches, "bonded", lambda c: c > 0))
    return counts


def check_sf_kernels(results):
    """Phase 3b: the structure-factor kernels against their plain versions
    at the 216 path's shapes and at a 4k box's, on the real tables (real
    positions and flux charges) and the real cotangents dE_rec/d(A, B)."""
    import torch

    from chargeflux_tpu_torch import ewald
    from chargeflux_tpu_torch.ops import structure_factor as sf
    from chargeflux_tpu_torch.utils.measure import (SF_SHAPES, kernel_bound,
                                                    sf_dims, sf_tables)

    dev = torch.device("cuda", 0)
    fwd_limits = sf.forward_limits()
    for label in SF_SHAPES:
        tabs, system = sf_tables(label, dev)
        spec = system.spec
        a, b = (t.requires_grad_(True) for t in sf.sf_fwd_plain(*tabs))
        e = ewald.reciprocal_energy_from_sf(
            *ewald.assemble(a, b, tabs[4].shape[1] // 2), system.box,
            spec.alpha, spec.kmax)
        abar, bbar = (t.contiguous() for t in torch.autograd.grad(e, (a, b)))
        dims = sf_dims(tabs)
        shape = "Kx {kx} Ky {ky} 2Kz {kz2} N {n}".format(**dims)
        with torch.no_grad():
            # the yardsticks' operands: [cxy; sxy] [2 Kx Ky, N] and its
            # transpose, [Abar; Bbar] [2 Kx Ky, 2Kz]
            left = torch.cat(sf.xy_tables(*tabs[:4]))
            left_t = left.T.contiguous()
            bars = torch.cat([abar, bbar])
        zq = tabs[4]
        cases = {
            "sf_fwd": (lambda: sf.sf_fwd(*tabs),
                       lambda: sf.sf_fwd_plain(*tabs), 1e-5,
                       lambda: (left @ zq,)),
            "sf_bwd_tables": (
                lambda: sf.sf_bwd_tables(*tabs, abar, bbar),
                lambda: sf.sf_bwd_tables_plain(*tabs, abar, bbar), 2e-5,
                lambda: (bars @ zq.T,)),
            "sf_bwd_zq": (
                lambda: (sf.sf_bwd_zq(*tabs[:4], abar, bbar),),
                lambda: (sf.sf_bwd_zq_plain(*tabs[:4], abar, bbar),), 2e-5,
                lambda: (left_t @ bars,)),
        }
        for name, (kern, plain, tol, library) in cases.items():
            fields = compare(name, kern, plain, tol,
                             f"phase 3b at the {label} shapes ({shape})",
                             kernel_bound(name, **dims), library)
            if name == "sf_fwd":
                plan = sf.plan_forward(*dims.values(), fwd_limits)
                print(f"phase 3b sf_fwd launch at the {label} shapes: "
                      f"{plan.blocks(dims['kx'])} blocks, {plan}", flush=True)
            if label == "216":
                results[name] = kernel_entry(name, fields)
            else:
                results[name].update(
                    {f"{k}_4k": v for k, v in fields.items()})

    # the forward at the kernels' Ky / 2Kz limits (kmax 32: the ky rows in
    # groups, the largest shared memory a block asks for), on seeded random
    # tables: agreement and bitwise repeat only
    kx, ky, kz2, n = 4, 63, 126, 1000
    g = torch.Generator(dev).manual_seed(63126)
    tabs = [torch.rand(shape, device=dev, generator=g) * 2.0 - 1.0
            for shape in ((kx, n), (kx, n), (ky, n), (ky, n), (n, kz2))]
    with torch.no_grad():
        agree("sf_fwd", lambda: sf.sf_fwd(*tabs),
              lambda: sf.sf_fwd_plain(*tabs), 1e-5,
              f"phase 3b at the limit shapes (Kx {kx} Ky {ky} 2Kz {kz2} N "
              f"{n}; {sf.plan_forward(kx, ky, kz2, n, fwd_limits)})")


def run_dense_md(x, masses, bonded, system):
    """Phase 5b: the 216 path, NVE from the lattice at rest as the JAX
    package's bench.py 216 runs it; each structure-factor kernel launches
    once per step plus the final consistent-state evaluation."""
    import torch

    from chargeflux_tpu_torch.integrate import init_state_nb, make_nb_energy_fn
    from chargeflux_tpu_torch.utils.measure import nve_drive

    s0 = init_state_nb(x, torch.zeros_like(x),
                       *make_nb_energy_fn(system, bonded=bonded))
    drive, _, _ = nve_drive(system, s0, 10, masses, bonded)
    ms_eager, _ = check_chunks("5b", drive, 10)
    launches, ms, final, es = timed_run(drive)
    e0 = float(s0.potential)
    drift = float(es[-1]) - e0
    print(f"phase 5b dense NVE: {N_STEPS} steps of {x.shape[0]} atoms as "
          f"CUDA graph replays, {ms:.3f} ms/step (CUDA events, includes the "
          f"eager final consistent-state evaluation); total energy "
          f"{e0:.3f} -> "
          f"{float(es[-1]):.3f} kJ/mol, drift {drift:.4f} kJ/mol, max "
          f"|E - E0| {float((es - e0).abs().max()):.4f}; launches "
          f"{launches}", flush=True)
    if any(launches[k] for k in WEIGHT_AND_SPREAD):
        fail("phase 5b: the dense path launched a cell-column SPME kernel")
    return (check_launches(launches, "216", lambda c: c == N_STEPS + 1), ms,
            ms_eager)


REPLICA_STEPS = 100        # phase 10's timed bench steps per route
REMD_LADDER = (300.0, 450.0)  # K, geometric over the 64 slots
REMD_FRICTION = 5.0        # 1/ps
REMD_EVERY = 10            # steps per exchange sweep
REMD_BURN_STEPS = 800      # steps of 20/ps burn-in
REMD_CALLS = 20            # production calls of REMD_CALL_STEPS each
REMD_CALL_STEPS = 20
HALO_TOL_F64 = 1e-10       # energy and force RMS relative, f64 4k box
HALO_STEPS = 100           # phase 10c's replayed halo NVE steps


def check_batched_sf(path, results):
    """Phase 10: the three structure-factor kernels batched over the 64
    replicas (one launch each) against their batched plain versions
    (phase 3b's tolerances), timed beside their bound (R x the 216 work)
    and one batched matmul of the core product; and each replica's slice
    of a batched launch against the single-system launch on that replica,
    bit for bit."""
    import torch

    from chargeflux_tpu_torch import ewald
    from chargeflux_tpu_torch.charges import effective_charges
    from chargeflux_tpu_torch.ops import structure_factor as sf
    from chargeflux_tpu_torch.utils.measure import kernel_bound

    system, x = path["system"], path["x"]
    spec = system.spec
    r = x.shape[0]
    with torch.no_grad():
        q = effective_charges(x, system)
        tabs = ewald.kernel_inputs(x, q, system.box, spec.kmax)
    a, b = (t.requires_grad_(True) for t in sf.sf_fwd_plain(*tabs))
    e = ewald.reciprocal_energy_from_sf(
        *ewald.assemble(a, b, tabs[4].shape[-1] // 2), system.box,
        spec.alpha, spec.kmax)
    abar, bbar = (t.contiguous()
                  for t in torch.autograd.grad(e.sum(), (a, b)))
    kx, n = tabs[0].shape[1:]
    dims = dict(kx=kx, ky=tabs[2].shape[1], kz2=tabs[4].shape[2], n=n,
                reps=r)
    shape = "R {reps} Kx {kx} Ky {ky} 2Kz {kz2} N {n}".format(**dims)
    with torch.no_grad():
        left = torch.cat(sf.xy_tables(*tabs[:4]), dim=1)   # [R, 2KxKy, N]
        left_t = left.transpose(1, 2).contiguous()
        bars = torch.cat([abar, bbar], dim=1)               # [R, 2KxKy, 2Kz]
        zq, zq_t = tabs[4], tabs[4].transpose(1, 2).contiguous()
    cases = {
        "sf_fwd_x64": (lambda: sf.sf_fwd(*tabs),
                       lambda: sf.sf_fwd_plain(*tabs), 1e-5,
                       lambda: (torch.matmul(left, zq),)),
        "sf_bwd_tables_x64": (
            lambda: sf.sf_bwd_tables(*tabs, abar, bbar),
            lambda: sf.sf_bwd_tables_plain(*tabs, abar, bbar), 2e-5,
            lambda: (torch.matmul(bars, zq_t),)),
        "sf_bwd_zq_x64": (
            lambda: (sf.sf_bwd_zq(*tabs[:4], abar, bbar),),
            lambda: (sf.sf_bwd_zq_plain(*tabs[:4], abar, bbar),), 2e-5,
            lambda: (torch.matmul(left_t, bars),)),
    }
    for name, (kern, plain, tol, library) in cases.items():
        fields = compare(name, kern, plain, tol,
                         f"phase 10 batched ({shape})",
                         kernel_bound(name[:-4], **dims), library)
        results[name] = kernel_entry(name, {**fields, "replicas": r})
    with torch.no_grad():
        batched = (sf.sf_fwd(*tabs), sf.sf_bwd_tables(*tabs, abar, bbar),
                   (sf.sf_bwd_zq(*tabs[:4], abar, bbar),))
        same = True
        for i in range(r):
            one = [t[i] for t in tabs]
            single = (sf.sf_fwd(*one),
                      sf.sf_bwd_tables(*one, abar[i], bbar[i]),
                      (sf.sf_bwd_zq(*one[:4], abar[i], bbar[i]),))
            same &= all(torch.equal(u[i], v) for bt, st in zip(batched, single)
                        for u, v in zip(bt, st))
        torch.cuda.synchronize()
    print(f"phase 10 batched kernels: each replica's slice equals the "
          f"single-system launch on it bit for bit ({r} replicas, 3 "
          f"kernels): {same}", flush=True)
    if not same:
        fail("phase 10: a batched launch differs from the single-system "
             "launches")


def run_replicas(dev, results):
    """Phase 10: bench.py's replicas config at full width (64 x 216, f32)
    on both reciprocal routes: the batched kernels (check_batched_sf),
    ``replica_energy_and_forces`` against a loop of single-system
    ``energy_and_forces`` on the kernel route, the bench step timed as
    graph replays, the kernels' launches on the "pallas" route's timed
    run, and one ``replica_nve_trajectory`` chunk graph against
    ``graph=False``, bit for bit."""
    import torch

    from chargeflux_tpu_torch import ops
    from chargeflux_tpu_torch.energy import (energy_and_forces,
                                             energy_components,
                                             resolve_recip_method)
    from chargeflux_tpu_torch.integrate import MDState
    from chargeflux_tpu_torch.parallel.replicas import (
        _forces, replica_energy_and_forces, replica_energy_fn,
        replica_nve_trajectory)
    from chargeflux_tpu_torch.utils.measure import (DT_PS, replica_drive,
                                                    replicas_path)

    t0 = time.perf_counter()
    auto = replicas_path(dev)
    route = auto["system"].spec.recip_method
    paths = {rt: replicas_path(dev, recip=rt) for rt in ("xla", "pallas")}
    x, m = auto["x"], auto["masses"]
    r, n = x.shape[:2]
    print(f"phase 10 replicas: {r} x {n} atoms, f32, dense, kmax "
          f"{auto['system'].spec.kmax}; recip_method 'auto' for a batch -> "
          f"{route!r}", flush=True)
    check_batched_sf(paths["pallas"], results)

    single = auto["force"].create_system(box=auto["box"], dtype=torch.float32,
                                         device=dev)
    s_route = resolve_recip_method(single.spec, torch.float32, dev)
    ref_e, ref_f, scale = [], [], []
    for i in range(r):
        e, f = energy_and_forces(x[i], single)
        ref_e.append(e)
        ref_f.append(f)
        with torch.no_grad():
            scale.append(sum(float(v.abs()) for v in
                             energy_components(x[i], single).values()))
    ref_e, ref_f = torch.stack(ref_e), torch.stack(ref_f)
    ef = {}
    for rt, path in paths.items():
        e, f = replica_energy_and_forces(x, path["system"])
        d_e = max(float((e[i] - ref_e[i]).abs()) / scale[i] for i in range(r))
        d_f = float(torch.sqrt(torch.mean((f.double() - ref_f.double()) ** 2))
                    / torch.sqrt(torch.mean(ref_f.double() ** 2)))
        ef[rt] = (d_e, d_f)
        print(f"phase 10 replica_energy_and_forces on {rt!r} against "
              f"{r} single-system energy_and_forces ({s_route!r}): max "
              f"|dE| / sum|E_c| {d_e:.3e}, force RMS relative {d_f:.3e} "
              f"(limits 1e-5)", flush=True)
        if not (d_e <= 1e-5 and d_f <= 1e-5):
            fail(f"phase 10: the {rt!r} batch disagrees with the "
                 f"single-system loop")

    ms, launches = {}, None
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for rt in ("xla", "pallas"):
        drive, _owner = replica_drive(paths[rt])
        drive(REPLICA_STEPS)                     # captures, then replays
        torch.cuda.synchronize()
        if rt == "pallas":
            ops.reset_launch_counts()
        a.record()
        _xf, es = drive(REPLICA_STEPS)
        b.record()
        torch.cuda.synchronize()
        if rt == "pallas":
            launches = ops.launch_counts()
        ms[rt] = a.elapsed_time(b) / REPLICA_STEPS
        if not torch.isfinite(es).all():
            fail(f"phase 10: non-finite energies on the {rt!r} route")
    print(f"phase 10 bench step (x <- x - 1e-9 grad E, {r} replicas): "
          f"{REPLICA_STEPS} steps as CUDA graph replays, 'xla' "
          f"{ms['xla']:.4f} ms/step, 'pallas' {ms['pallas']:.4f} ms/step "
          f"(CUDA events); launches on the 'pallas' run {launches}",
          flush=True)
    for name in ("sf_fwd", "sf_bwd_tables", "sf_bwd_zq"):
        if launches[name] != REPLICA_STEPS:
            fail(f"phase 10: {name} launched {launches[name]} times in "
                 f"{REPLICA_STEPS} batched steps")
        results[name + "_x64"]["launches"] = launches[name]
    if any(launches[k] for k in (*WEIGHT_AND_SPREAD, "direct_walk",
                                 "direct_walk_tri")):
        fail("phase 10: the dense replica path launched a cell-route kernel")

    e_fn = replica_energy_fn(paths["pallas"]["system"])
    e0, f0 = _forces(e_fn, x)
    s0 = MDState(x, torch.zeros_like(x), f0, e0)
    runs = [replica_nve_trajectory(s0, e_fn, m, DT_PS, 10, graph=g)
            for g in (False, True, True)]
    same = all(torch.equal(u, v) for out in runs[1:] for u, v in (
        (runs[0][1], out[1]), (runs[0][0].positions, out[0].positions),
        (runs[0][0].velocities, out[0].velocities)))
    print(f"phase 10 replica_nve_trajectory: one 10-step chunk graph "
          f"(capture, then a replay) against graph=False, energies, "
          f"positions and velocities bit-equal: {same}", flush=True)
    if not same:
        fail("phase 10: replica NVE replays differ from graph=False")
    seconds = time.perf_counter() - t0
    print(f"phase 10 took {seconds:.1f} s (host clock)", flush=True)
    return {"route_auto": route, "ms_per_step": ms,
            "energy_force_rel": ef, "seconds": seconds}, paths[route]


def run_remd(dev, path):
    """Phase 10b: temperature REMD of the 64 x 216 ensemble (flexible
    water: the water bonds and angles added) on a geometric 300-450 K
    ladder (5/ps, 0.5 fs, a sweep every 10 steps) after a 20/ps burn-in: replays against graph=False from one generator state, new
    noise on a further call, the multiset of configurations kept exactly
    at dt = 0, every slot's mean temperature within T_TOL of its target;
    the acceptance of each parity and ms/step."""
    import numpy as np
    import torch

    from chargeflux_tpu_torch.integrate import MDState, maxwell_velocities
    from chargeflux_tpu_torch.models import water_bonded_params
    from chargeflux_tpu_torch.parallel import remd_langevin_trajectory
    from chargeflux_tpu_torch.parallel.replicas import (_forces,
                                                        pairing_tables,
                                                        replica_energy_fn)
    from chargeflux_tpu_torch.units import BOLTZ
    from chargeflux_tpu_torch.utils.measure import DT_PS

    t0 = time.perf_counter()
    system, x, m = path["system"], path["x"], path["masses"]
    r, n = x.shape[:2]
    lo, hi = REMD_LADDER
    temps = lo * (hi / lo) ** (np.arange(r) / (r - 1))
    gen = torch.Generator(dev).manual_seed(1010)
    v0 = torch.stack([maxwell_velocities(m, float(t), gen,
                                         dtype=torch.float32)
                      for t in temps])
    # flexible water: the replicas' energy with the water bonds and angles
    e_fn = replica_energy_fn(system, bonded=water_bonded_params(
        n // 3, box=path["box"], device=dev))
    e0, f0 = _forces(e_fn, x)
    state, _, _ = remd_langevin_trajectory(
        MDState(x, v0, f0, e0), e_fn, m, DT_PS, temps, 20.0, gen,
        REMD_BURN_STEPS, REMD_EVERY)

    def run(graph, steps=2 * REMD_EVERY, seed=29, dt=DT_PS):
        if seed is not None:
            gen.manual_seed(seed)
        return remd_langevin_trajectory(state, e_fn, m, dt, temps,
                                        REMD_FRICTION, gen, steps,
                                        REMD_EVERY, graph=graph)

    eager, first, replay = run(False), run(True), run(True)
    same = all(torch.equal(u, v) for out in (first, replay) for u, v in (
        (eager[0].positions, out[0].positions),
        (eager[0].velocities, out[0].velocities), (eager[1], out[1]),
        (eager[2], out[2])))
    fresh = not torch.equal(run(True, seed=None)[0].positions,
                            replay[0].positions)
    still = run(True, steps=4 * REMD_EVERY, dt=0.0)
    kept = torch.equal(
        torch.sort(state.positions.reshape(r, -1), dim=0).values,
        torch.sort(still[0].positions.reshape(r, -1), dim=0).values)
    print(f"phase 10b REMD chunks: 2 sweeps from one generator state, "
          f"replays bit-equal to graph=False: {same}; a further call draws "
          f"new noise: {fresh}; dt = 0, 4 sweeps ({int(still[2].sum())} "
          f"swaps): configurations kept as a multiset: {kept}", flush=True)
    if not (same and fresh and kept):
        fail("phase 10b: the REMD chunk checks failed")

    gen.manual_seed(77)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_slot, acc = [], []
    torch.cuda.synchronize()
    a.record()
    for _ in range(REMD_CALLS):
        state, pots, accepts = remd_langevin_trajectory(
            state, e_fn, m, DT_PS, temps, REMD_FRICTION, gen,
            REMD_CALL_STEPS, REMD_EVERY)
        t_slot.append(torch.sum(m[:, None] * state.velocities ** 2,
                                dim=(1, 2)) / (3 * n * BOLTZ))
        acc.append(accepts)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / (REMD_CALLS * REMD_CALL_STEPS)
    t_mean = torch.stack(t_slot).double().mean(0).cpu().numpy()
    acc = torch.stack(acc).cpu().numpy()          # [calls, sweeps, pairs]
    (_l0, _h0, ok0), (_l1, _h1, ok1) = pairing_tables(r)
    acc_even = float(acc[:, 0::2][..., np.asarray(ok0)].mean())
    acc_odd = float(acc[:, 1::2][..., np.asarray(ok1)].mean())
    rel = t_mean / temps - 1.0
    dev_t = np.abs(rel)
    # the ladder's mean deviation and its standard error over the slots:
    # a bias common to the slots, apart from each slot's own noise
    bias, bias_se = float(rel.mean()), float(rel.std(ddof=1) / np.sqrt(r))
    print(f"phase 10b REMD: {REMD_CALLS} calls of {REMD_CALL_STEPS} steps "
          f"(a sweep every {REMD_EVERY}), {ms:.4f} ms/step (CUDA events, "
          f"each call's copy-in and graph replays); swap acceptance even "
          f"pairs {acc_even:.3f}, odd pairs {acc_odd:.3f}; slot mean "
          f"temperatures {t_mean[0]:.1f} K (target {temps[0]:.1f}) .. "
          f"{t_mean[-1]:.1f} K (target {temps[-1]:.1f}), largest relative "
          f"deviation {dev_t.max():.4f} (limit {T_TOL}), mean over the "
          f"ladder {bias:+.4f} +- {bias_se:.4f}", flush=True)
    if not np.isfinite(t_mean).all() or dev_t.max() > T_TOL:
        fail("phase 10b: a slot's mean temperature is off its target")
    seconds = time.perf_counter() - t0
    print(f"phase 10b took {seconds:.1f} s (host clock)", flush=True)
    return {"ms_per_step": ms, "accept_even": acc_even,
            "accept_odd": acc_odd, "t_dev_max": float(dev_t.max()),
            "t_dev_mean": bias, "t_dev_mean_se": bias_se,
            "seconds": seconds}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def halo_case(label, system, x, tol, f32):
    """One halo comparison in phase 10c: ``make_halo_energy_fn`` over the
    group of one against the single-system ``energy_and_forces`` on the
    same system, each timed in this process (energy and forces: device
    time as graphs of calls in turns, and eagerly, 3 calls after a warm
    one); an f32 system must run the slab walk kernel and not the
    periodic one.  Returns the times and the collectives of one
    evaluation."""
    import torch

    from chargeflux_tpu_torch import ops
    from chargeflux_tpu_torch.energy import energy_and_forces
    from chargeflux_tpu_torch.parallel import shard
    from chargeflux_tpu_torch.parallel.halo import make_halo_energy_fn
    from chargeflux_tpu_torch.utils.measure import (GRAPH_REPS, ROUNDS,
                                                    eager_ms, energy_forces,
                                                    energy_scale,
                                                    interleaved_ms,
                                                    rel_errors)

    e_ref, f_ref = energy_and_forces(x, system)
    e_fn = make_halo_energy_fn(system, None)

    def ef():
        return energy_forces(e_fn, x)

    def single():
        return energy_and_forces(x, system)

    shard.reset_collectives()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    e, f = ef()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    coll = dict(shard.COLLECTIVES)
    if f32:
        scale, what = energy_scale(x, system), "|dE| / sum|E_c|"
    else:
        scale, what = abs(float(e_ref)), "|dE| / |E|"
    d_e, d_f = rel_errors(e, f, e_ref, f_ref, scale)
    ms, ms_single = eager_ms(ef), eager_ms(single)
    dev_ms, dev_single = interleaved_ms((ef, single))
    walks = {k: launches[k] for k in ("direct_walk_halo", "direct_walk",
                                      "direct_walk_tri", "cell_bin")}
    print(f"phase 10c halo {label}: {what} {d_e:.3e}, force RMS relative "
          f"{d_f:.3e} (limits {tol}); energy and forces {dev_ms:.3f} ms per "
          f"evaluation on the device against {dev_single:.3f} for the "
          f"single-system route (graphs of {GRAPH_REPS} calls in turns, "
          f"median of {ROUNDS}); eager {ms:.3f} against {ms_single:.3f} "
          f"(CUDA events); walk and binning launches of one evaluation "
          f"{walks}; "
          f"collectives {coll}", flush=True)
    if not (torch.isfinite(f).all() and d_e <= tol and d_f <= tol):
        fail(f"phase 10c: the halo route disagrees ({label})")
    if walks["direct_walk"] or walks["direct_walk_tri"] or (
            walks["direct_walk_halo"] != (1 if f32 else 0)) or (
            walks["cell_bin"] != (1 if f32 else 0)):
        fail(f"phase 10c: the halo route's walk launches {walks} ({label})")
    return {"ms_per_eval": dev_ms, "ms_per_eval_single": dev_single,
            "ms_per_eval_eager": ms, "ms_per_eval_single_eager": ms_single,
            "collectives": coll}


def check_slab_kernel(ctx30k, walk_tri, results):
    """Phase 10c: the slab walk kernel against its plain version on the
    drifted blocks of phase 5's burned-in state, cut into the extended
    slab of a world of one (timed, beside its bound) and into the slabs of
    ranks of (4, 1) and (2, 2) (agreement only); then its triclinic form
    on phase 6's drifted tri30k blocks cut the same three ways (agreement
    only)."""
    import torch

    from chargeflux_tpu_torch.integrate import make_nb_energy_fn
    from chargeflux_tpu_torch.ops import direct_walk as dw
    from chargeflux_tpu_torch.ops.erfc import erf_over_r_coeffs
    from chargeflux_tpu_torch.utils.measure import (drifted_blocks,
                                                    kernel_bound,
                                                    pairs_within_cutoff,
                                                    slab_walk_args)

    system, s1, rebuild_every, bonded, masses = ctx30k
    spec = system.spec
    e_fn, _ = make_nb_energy_fn(system, bonded=bonded)
    walk_args, info = drifted_blocks(system, s1, e_fn, masses,
                                     rebuild_every - 1)
    where = (f"phase 10c slabs of the blocks after {rebuild_every - 1} steps "
             f"on one neighbor state ({info['outside']} atoms outside their "
             f"cells' nominal bounds)")
    with torch.no_grad():
        for decomp, ranks in (((4, 1), (0, 3)), ((2, 2), (0, 3))):
            for rank in ranks:
                slab = slab_walk_args(walk_args, decomp, rank)
                agree("direct_walk_halo",
                      lambda: dw.direct_walk_slab(*slab),
                      lambda: dw.direct_walk_slab_plain(*slab), WALK_TOLS,
                      f"{where}, rank {rank} of {decomp}")
        for decomp, rank in (((1, 1), 0), ((4, 1), 3), ((2, 2), 1)):
            slab = slab_walk_args(walk_tri, decomp, rank)
            agree("direct_walk_halo",
                  lambda: dw.direct_walk_slab(*slab),
                  lambda: dw.direct_walk_slab_plain(*slab), WALK_TOLS,
                  f"phase 10c slabs of phase 6's drifted tri30k blocks "
                  f"(the triclinic kernel), rank {rank} of {decomp}")
        slab = slab_walk_args(walk_args, (1, 1), 0)
        ids = walk_args[6]
        valid = ids < system.n_atoms
        xs = torch.stack([walk_args[k][valid] for k in range(3)], dim=-1)
        n_pairs = pairs_within_cutoff(xs, system.box, spec.cutoff)
    bound = kernel_bound(
        "direct_walk_halo", n_pairs=n_pairs, n_own_slots=ids.numel(),
        n_ext_slots=slab[0].numel(), n_own=math.prod(spec.cell_grid),
        ncoef=len(erf_over_r_coeffs(spec.alpha, spec.cutoff)))
    results["direct_walk_halo"] = kernel_entry("direct_walk_halo", compare(
        "direct_walk_halo", lambda: dw.direct_walk_slab(*slab),
        lambda: dw.direct_walk_slab_plain(*slab), WALK_TOLS,
        f"{where}, the slab of a world of one ({slab[0].shape[0]} cells)",
        bound))
    results["direct_walk_halo"]["library_note"] = (
        "no single call: no PyTorch call computes the slab walk's energy, "
        "dE/dx and dE/dq")


def run_halo(dev, results, ctx30k, walk_tri):
    """Phase 10c: the halo route in a world of one (an NCCL group of one
    rank, decomposition (1, 1)): the slab walk kernel against its plain
    version (:func:`check_slab_kernel`); at phase 5's burned-in 30k state
    in f32 against the single-system kernel route, and at a 4k box in f64
    against the plain route, each on classical Ewald and on the halo PME
    mesh; then NVE over the 4k f64 and the 30k f32 halo energy with their
    chunks captured as CUDA graphs against graph=False, and a replayed 30k
    run in which the slab kernel must have launched and the periodic walk
    not."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from chargeflux_tpu_torch import ops
    from chargeflux_tpu_torch.bonded import bonded_energy
    from chargeflux_tpu_torch.integrate import init_state, nve_trajectory
    from chargeflux_tpu_torch.models import water_box
    from chargeflux_tpu_torch.parallel.halo import (halo_decomp,
                                                    make_halo_energy_fn)
    from chargeflux_tpu_torch.pme import pme_halo_mesh
    from chargeflux_tpu_torch.utils.measure import (DT_PS, HALO_TOL_F32,
                                                    halo_spread_work,
                                                    interleaved_ms)

    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    out = {}
    try:
        check_slab_kernel(ctx30k, walk_tri, results)
        system, s1, _every, bonded, masses = ctx30k
        x = s1.positions
        spec = system.spec
        if halo_decomp(system, 1) != (1, 1):
            fail("phase 10c: no (1, 1) decomposition of the 30k grid")
        print(f"phase 10c: 30k cells {spec.cell_grid} capacity "
              f"{spec.cell_capacity}, PME mesh {spec.pme_grid}, halo mesh "
              f"{pme_halo_mesh(spec)}", flush=True)
        systems = {}
        for rt in ("pme", "xla"):
            systems[rt] = system._swap(spec=dataclasses.replace(
                spec, recip_method=rt, pme_grid=pme_halo_mesh(spec)))
            out[f"30k_{rt}"] = halo_case(f"30k f32 {rt!r} vs the kernel "
                                         f"route", systems[rt], x,
                                         HALO_TOL_F32, True)
        (spread_ms,) = interleaved_ms([halo_spread_work(systems["pme"], x)])
        share = spread_ms / out["30k_pme"]["ms_per_eval"]
        out["30k_pme"]["halo_spread_ms"] = spread_ms
        print(f"phase 10c halo PME mesh's plain patch spread "
              f"(pme.pme_halo_local_mesh, forward and backward, a graph "
              f"alone): {spread_ms:.3f} ms, {share:.3f} of the 30k 'pme' "
              f"evaluation's device time", flush=True)
        force, pos, _mm, box = water_box(n_side=11, flux="bond_angle",
                                         cutoff=0.8)
        x64 = torch.tensor(pos, dtype=torch.float64, device=dev)
        for rt in ("pme", "xla"):
            s64 = force.create_system(box=box, dtype=torch.float64,
                                      direct_method="cell", recip_method=rt,
                                      device=dev)
            s64 = s64._swap(spec=dataclasses.replace(
                s64.spec, pme_grid=pme_halo_mesh(s64.spec)))
            out[f"4k_{rt}"] = halo_case(
                f"4k f64 {rt!r} (cells {s64.spec.cell_grid}) vs the plain "
                f"route", s64, x64, HALO_TOL_F64, False)
        # NVE over the 4k f64 halo energy ('xla'; the plain slab walk)
        # with its NCCL all-reduces inside the chunks' CUDA graphs,
        # against graph=False
        e64 = make_halo_energy_fn(s64, None)
        m64 = torch.full((x64.shape[0],), 10.0, dtype=torch.float64,
                         device=dev)
        s0 = init_state(x64, torch.zeros_like(x64), e64)
        runs = [nve_trajectory(s0, e64, m64, 2e-5, 20, graph=g)
                for g in (False, True, True)]
        same = all(torch.equal(u, v) for r in runs[1:] for u, v in (
            (runs[0][1], r[1]), (runs[0][0].positions, r[0].positions)))
        print(f"phase 10c NVE over the halo energy (4k f64, 20 steps, "
              f"chunks with NCCL all-reduces captured in CUDA graphs): "
              f"replays bit-equal to graph=False: {same}", flush=True)
        if not same:
            fail("phase 10c: 4k f64 halo NVE replays differ from "
                 "graph=False")
        # NVE over the 30k halo energy (the slab kernel, the halo PME mesh)
        # and the water bonds: its NCCL all-reduces inside the chunks' CUDA
        # graphs, against graph=False
        halo = make_halo_energy_fn(systems["pme"], None)

        def e_fn(xx):
            return halo(xx) + bonded_energy(xx, bonded)

        s0 = init_state(x, s1.velocities, e_fn)
        runs = [nve_trajectory(s0, e_fn, masses, DT_PS, 20, graph=g)
                for g in (False, True, True)]
        same = all(torch.equal(u, v) for r in runs[1:] for u, v in (
            (runs[0][1], r[1]), (runs[0][0].positions, r[0].positions),
            (runs[0][0].velocities, r[0].velocities)))
        print(f"phase 10c NVE over the halo energy (30k f32, 20 steps, "
              f"chunks with NCCL all-reduces captured in CUDA graphs): "
              f"replays bit-equal to graph=False: {same}", flush=True)
        if not same:
            fail("phase 10c: halo NVE replays differ from graph=False")
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        a.record()
        fin, es = nve_trajectory(s0, e_fn, masses, DT_PS, HALO_STEPS)
        b.record()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        ms = a.elapsed_time(b) / HALO_STEPS
        print(f"phase 10c halo NVE: {HALO_STEPS} steps as CUDA graph "
              f"replays, {ms:.3f} ms/step (CUDA events); launches "
              f"{launches}", flush=True)
        if not (torch.isfinite(es).all()
                and torch.isfinite(fin.positions).all()):
            fail("phase 10c: non-finite halo NVE run")
        if launches["direct_walk"] or launches["direct_walk_tri"]:
            fail("phase 10c: the halo route launched the periodic walk")
        if any(launches[k] for k in WEIGHT_AND_SPREAD):
            fail("phase 10c: the halo route's plain patch spread launched "
                 "a cell-column SPME kernel")
        counts = check_launches(launches, "halo1", lambda c: c > 0)
        results["direct_walk_halo"]["launches"] = counts["direct_walk_halo"]
        if launches["cell_bin"] == 0:
            fail("phase 10c: the halo NVE run did not launch the binning "
                 "kernel")
        results["cell_bin"]["launches_halo1"] = launches["cell_bin"]
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    print(f"phase 10c took {seconds:.1f} s (host clock)", flush=True)
    return out | {"ms_per_step_nve": ms, "seconds": seconds}


def main():
    if not (ROOT / "chargeflux_tpu_torch" / "__init__.py").is_file():
        fail("run from the root of a checkout (chargeflux_tpu_torch/ missing)")
    sys.path.insert(0, str(ROOT))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from chargeflux_tpu_torch.ops import native

    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {lib.name}",
          flush=True)

    from chargeflux_tpu_torch.energy import resolve_recip_method
    from chargeflux_tpu_torch.utils.measure import bench_path, dense_path

    dev = torch.device("cuda", 0)
    force, x, m, box, bonded, system = bench_path("30k", dev)
    spec = system.spec
    print(f"phase 3 system: {system.n_atoms} atoms, cells {spec.cell_grid} "
          f"cap {spec.cell_capacity}, PME {spec.pme_grid} order "
          f"{spec.pme_order} slack {spec.pme_slack}", flush=True)
    _, x_d, m_d, _, bonded_d, sys_d = dense_path(dev)
    route = resolve_recip_method(sys_d.spec, torch.float32, dev)
    print(f"phase 3b system: {sys_d.n_atoms} atoms, dense, alpha "
          f"{sys_d.spec.alpha:.4f} kmax {sys_d.spec.kmax}, recip_method "
          f"{sys_d.spec.recip_method!r} -> {route!r}", flush=True)
    if route != "pallas":
        fail(f"the 216 path resolved to {route!r}, not the kernel route")

    results = {}
    check_kernels(system, x, results)
    check_sf_kernels(results)
    check_binning(system, x, results)
    check_exclusions(system, x, results)
    check_bonded(bonded, x, results)
    check_energy(system, x, "4")
    check_energy(sys_d, x_d, "4b")
    launches, ms_step, ms_eager, capture, ctx30k = run_md(force, system, x,
                                                          m, box)
    launches_d, ms_d, ms_eager_d = run_dense_md(x_d, m_d, bonded_d, sys_d)
    launches_r, ms_r, ms_eager_r = run_rigid(dev)
    launches_m, ms_m, ms_eager_m = run_respa(dev)
    launches_t, ms_t, ms_eager_t, walk_tri = run_tri(dev, results)
    ms_h, ms_eager_h = run_hetero(dev)
    launches_n, ms_n, ms_eager_n, npt_fields = run_npt(dev)
    thermo, nhc_drift = run_thermostats(dev, ctx30k)
    launches_o, ms_o, ms_eager_o, onramp_fields = run_onramp(dev)
    launches_b, rbe_fields = run_rbe(dev, ctx30k)
    dense_fields = run_dense_pme(dev)
    cluster_fields = run_cluster(dev)
    replicas_fields, rpath = run_replicas(dev, results)
    remd_fields = run_remd(dev, rpath)
    halo_fields = run_halo(dev, results, ctx30k, walk_tri)
    for name, count in {**launches, **launches_d, **launches_t}.items():
        results[name]["launches"] = count
    for key, counts in (("launches_rigid", launches_r),
                        ("launches_respa", launches_m),
                        ("launches_npt", launches_n),
                        ("launches_onramp30k", launches_o),
                        ("launches_rbe30k", launches_b)):
        for name, count in counts.items():
            results[name][key] = count
    from chargeflux_tpu_torch.utils.measure import ns_per_day

    print(json.dumps({"kernels": list(results.values()),
                      "ms_per_step": ms_step, "ms_per_step_216": ms_d,
                      "ms_per_step_eager": ms_eager,
                      "ms_per_step_216_eager": ms_eager_d,
                      "ms_per_step_rigid": ms_r,
                      "ms_per_step_rigid_eager": ms_eager_r,
                      "ns_per_day_rigid": ns_per_day(2e-3, ms_r),
                      "ms_per_step_respa": ms_m,
                      "ms_per_step_respa_eager": ms_eager_m,
                      "ns_per_day_respa": ns_per_day(2e-3, ms_m),
                      "ms_per_step_tri30k": ms_t,
                      "ms_per_step_tri30k_eager": ms_eager_t,
                      "ms_per_step_hetero30k": ms_h,
                      "ms_per_step_hetero30k_eager": ms_eager_h,
                      "ms_per_step_npt": ms_n,
                      "ms_per_step_npt_eager": ms_eager_n,
                      "npt": npt_fields,
                      "ms_per_step_csvr": thermo["csvr"][0],
                      "ms_per_step_csvr_eager": thermo["csvr"][1],
                      "ms_per_step_nhc": thermo["nhc"][0],
                      "ms_per_step_nhc_eager": thermo["nhc"][1],
                      "nhc_conserved_drift": nhc_drift,
                      "ms_per_step_onramp30k": ms_o,
                      "ms_per_step_onramp30k_eager": ms_eager_o,
                      "onramp30k": onramp_fields, "rbe30k": rbe_fields,
                      "dense216": dense_fields, "cluster": cluster_fields,
                      "replicas": replicas_fields, "remd": remd_fields,
                      "halo1": halo_fields,
                      "chunk_capture_30k": capture}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
