"""Constant pressure (torch counterpart of ``chargeflux_tpu.npt``): the
molecule-scaled Monte Carlo barostats, isotropic and anisotropic, with
BAOAB Langevin dynamics between attempts, and the virial pressure and
pressure tensor by differentiating the energy through the box.

A volume move scales molecule centroids (intramolecular geometry
untouched) and is accepted with the NPT weight ``W = dE + P dV - N_mol kT
ln(V'/V)``; the proposal width adapts by x1.03 on accept and /1.03 on
reject, clamped, as in the JAX package.

Each barostat interval is one ``integrate.Chunk`` (one CUDA graph replay
on the card unless ``graph=False``): the attempt, a neighbor rebuild at the
box it leaves, then ``barostat_interval`` BAOAB steps (RATTLE-projected
with ``constraints``).  The carry holds x, v, f, the box, the proposal
width and the current potential on the chunk's static buffers; the attempt
writes the box it leaves into the carry's box buffer, and every later
evaluation of the chunk reads a system made by ``with_box`` of that buffer,
so a volume move changes what the graph reads, never the graph.  The
proposal is evaluated forward only, with its own binning, on the box the
attempt computes (an intermediate of the graph, at a fixed address).

The attempt draws its uniforms (:func:`uniform_draw`) and, anisotropic,
its axis (:func:`axis_draw`) from the caller's ``torch.Generator``, the
steps their normals through ``integrate.normal_noise``; the tests hand all
three the JAX package's draws.  The chunks are kept on the system (on
``energy_fn`` where one is given), keyed by what they compute
(``integrate.chunk_key``; the molecules ride in the carry, so only their
shapes enter the key); the molecule assignment of the index arrays last
asked for and the interval check, which read the system on the host, are
kept on the system, so a warm call reads nothing back.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from . import integrate
from .bonded import bonded_energy, follow_route
from .cells import blockify, build_cell_list_full
from .charges import effective_charges
from .constraints import project_velocities
from .device import constant, ieee_matmul
from .energy import _energy, _exclusion_correction
from .ewald import reciprocal_energy, self_energy
from .neighbors import (build_neighbor_state, neighbor_state_fresh,
                        suggest_rebuild_interval)
from .ops.direct_walk import direct_walk_plain
from .pairs import box_volume, displacement, frac_coords
from .rows import RowPlan, row_plan, scatter_add_planned
from .units import BOLTZ
from .utils.profiling import phase_scope

# 1 bar in kJ/mol/nm^3: 1e5 J/m^3 x 1e-27 m^3/nm^3 x N_A.
BAR_TO_KJ_MOL_NM3 = 0.0602214076


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def molecule_index(system, extra_idx: tuple = ()):
    """Molecule assignment from the system's connectivity (NumPy, on the
    host): connected components of the exclusion pairs, the flux-term rows
    and any ``extra_idx`` [*, k] index arrays (e.g. bonded indices), by the
    JAX package's union-find.  Returns ``(mol_id [N] int32, first_idx [M]
    int32, counts [M] f64)``."""
    n = system.n_atoms
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    groups = [_host(system.exclusions).reshape(-1, 2),
              _host(system.bond_idx).reshape(-1, 2),
              _host(system.angle_idx).reshape(-1, 3),
              _host(system.water_idx).reshape(-1, 3)]
    extras = [_host(g) for g in extra_idx]
    groups += [g.reshape(-1, g.shape[-1]) for g in extras if g.size]
    for arr in groups:
        for row in arr:
            r0 = find(int(row[0]))
            for a in row[1:]:
                ra = find(int(a))
                if ra != r0:
                    parent[ra] = r0
    roots = np.fromiter((find(i) for i in range(n)), np.int64, n)
    _, mol_id, counts = np.unique(roots, return_inverse=True,
                                  return_counts=True)
    m = counts.shape[0]
    first_idx = np.full(m, n, np.int64)
    np.minimum.at(first_idx, mol_id, np.arange(n))
    return (mol_id.astype(np.int32), first_idx.astype(np.int32),
            counts.astype(np.float64))


class Molecules(NamedTuple):
    """:func:`molecule_index` on the device: atom -> molecule ids, each
    molecule's first atom, its atom count, and ``occ``, the fixed-order
    plan of the per-molecule sums (``rows.RowPlan`` of ``mol_id``)."""

    mol_id: torch.Tensor     # [N] int64
    first_idx: torch.Tensor  # [M] int64
    counts: torch.Tensor     # [M] float
    occ: torch.Tensor        # [M, largest molecule] int64

    @property
    def plan(self) -> RowPlan:
        return RowPlan(self.mol_id, self.occ)

    @property
    def n_mol(self) -> int:
        return self.first_idx.shape[0]


def bonded_rows(bonded) -> tuple:
    """The index arrays of ``bonded`` that join atoms into molecules: bonds,
    angles and, where there are any, torsions (a torsion alone may join
    two fragments)."""
    return tuple(a for a in (bonded.bond_idx, bonded.angle_idx,
                             bonded.torsion_idx) if a is not None)


def molecules(system, extra_idx: tuple = (), dtype=None) -> Molecules:
    """:func:`molecule_index` as :class:`Molecules` on the system's device
    (counts in ``dtype``, default the system's)."""
    mol_id, first_idx, counts = molecule_index(system, extra_idx)
    dev = system.q0.device
    plan = row_plan(mol_id, dev)
    return Molecules(
        plan.idx, torch.as_tensor(first_idx.astype(np.int64), device=dev),
        torch.as_tensor(counts, device=dev).to(dtype or system.q0.dtype),
        plan.occ)


def molecule_centroids(x, box, mol_id, first_idx, counts, plan=None):
    """Geometric molecule centers, minimum-imaged around each molecule's
    first atom so a molecule straddling the boundary scales as one unit.
    The per-molecule sums run in the fixed order of ``plan``
    (``rows.row_plan`` of ``mol_id``, made here if not given), so they give
    the same bits on every run."""
    dev = x.device

    def on_device(a, dtype):
        return a.to(dtype) if torch.is_tensor(a) else torch.as_tensor(
            np.asarray(a), device=dev).to(dtype)

    if plan is None:
        plan = row_plan(_host(mol_id), dev)
    mol_id, first_idx = (on_device(a, torch.int64) for a in (mol_id,
                                                             first_idx))
    counts = on_device(counts, x.dtype)
    ref = x[first_idx]                                   # [M, 3]
    d = displacement(ref[mol_id], x, box, pbc=True)      # x - ref, min image
    sums = scatter_add_planned(x.new_zeros((first_idx.shape[0], 3)), d, plan)
    return ref + sums / counts[:, None]


# ---------------------------------------------------------------------------
# Pressure by differentiating through the box
# ---------------------------------------------------------------------------


def _plain_cell_direct(xs, q, sysb):
    """The cell route's direct space by plain autodiff: binning, blocks and
    the plain half-shell walk, outside the fused walk's autograd function
    (whose backward gives no box cotangent), so the energy differentiates
    through the image offsets and the wrap."""
    spec = sysb.spec
    slots, inv_slot, _ = build_cell_list_full(
        xs.detach(), sysb.box.detach(), spec.cell_grid, spec.cell_capacity,
        plain=not sysb.uses_kernels)
    b = blockify(xs, q, sysb, slots, inv_slot)
    ids = slots.reshape(b.x.shape)
    e, _g, _dq = direct_walk_plain(b.x, b.y, b.z, b.q, b.hs, b.se, ids,
                                   sysb.box, sysb.n_atoms, spec.alpha,
                                   spec.cutoff)
    return e


def _box_grad_potential(xs, sysb, system, bonded):
    """Potential safe to differentiate through the box: on the cell route
    self + exclusion correction + the plain cell walk + the classical
    ("xla") reciprocal at the spec's kmax + the dispersion tail; otherwise
    the plain ``energy._energy``; plus the bonded terms at that box."""
    spec = system.spec
    if spec.pbc and spec.direct_method == "cell":
        q = effective_charges(xs, sysb)
        e = (self_energy(q, spec.alpha)
             + _exclusion_correction(xs, q, sysb, subtract_direct=True)
             + _plain_cell_direct(xs, q, sysb)
             + reciprocal_energy(xs, q, sysb.box, spec.alpha, spec.kmax,
                                 method="xla"))
        if spec.tail_coeff is not None:
            e = e + spec.tail_coeff / box_volume(sysb.box)
    else:
        e = _energy(xs, sysb.with_kernel_route("plain"))
    if bonded is not None:
        e = e + bonded_energy(xs, bonded.with_box(sysb.box))
    return e


def instantaneous_pressure(positions, velocities, system, masses,
                           bonded=None) -> torch.Tensor:
    """Instantaneous internal pressure in bar from the full virial,
    ``P = (2 K - dE/ds) / (3 V)``, with ``dE/ds`` the derivative of the
    uniformly scaled configuration (positions and box times ``s``) at
    ``s = 1`` (the JAX package's formulation; its accuracy note holds: the
    virial amplifies the Ewald truncation error, so build with
    ``ewald_tol <= 1e-6`` for quantitative pressures)."""
    x = positions.detach()
    s = torch.ones((), dtype=x.dtype, device=x.device, requires_grad=True)
    with torch.enable_grad():
        e = _box_grad_potential(x * s, system.with_box(system.box * s),
                                system, bonded)
        (de_ds,) = torch.autograd.grad(e, s)
    vol = box_volume(system.box)
    ke = integrate.kinetic_energy(velocities, masses)
    return (2.0 * ke - de_ds) / (3.0 * vol) / BAR_TO_KJ_MOL_NM3


def pressure_tensor(positions, velocities, system, masses,
                    bonded=None) -> torch.Tensor:
    """Instantaneous internal pressure tensor [3, 3] in bar:
    ``P_ab V = sum_i m_i v_ia v_ib - dE/d eps_ab`` for the strain
    ``F = I + tril(eps)`` of positions and lattice rows at ``eps = 0``,
    mirrored from the lower triangle; every strain product in IEEE f32 on
    the card (``device.ieee_matmul``)."""
    x = positions.detach()
    dtype, dev = x.dtype, x.device
    box0 = system.box
    b_mat = torch.diag(box0) if box0.ndim == 1 else box0
    eps = torch.zeros((3, 3), dtype=dtype, device=dev, requires_grad=True)
    with torch.enable_grad():
        f = torch.eye(3, dtype=dtype, device=dev) + torch.tril(eps)
        e = _box_grad_potential(ieee_matmul(x, f),
                                system.with_box(ieee_matmul(b_mat, f)),
                                system, bonded)
        (de,) = torch.autograd.grad(e, eps)
    v = velocities.to(dtype)
    m = masses.to(dtype)
    kin = ieee_matmul((m[:, None] * v).T.contiguous(), v)
    p_l = kin - de
    p_sym = torch.tril(p_l) + torch.tril(p_l, -1).T
    return p_sym / (box_volume(box0) * BAR_TO_KJ_MOL_NM3)


# ---------------------------------------------------------------------------
# The barostats
# ---------------------------------------------------------------------------


def uniform_draw(like: torch.Tensor, generator: torch.Generator):
    """One uniform in [0, 1) of ``like``'s type and device from
    ``generator``: each attempt draws two (the volume change, then the
    acceptance)."""
    return torch.rand((), generator=generator, dtype=like.dtype,
                      device=like.device)


def axis_draw(n: int, like: torch.Tensor, generator: torch.Generator):
    """One index uniform in [0, n) on ``like``'s device from ``generator``:
    the anisotropic attempt's axis, among the allowed ones."""
    return torch.randint(0, n, (), generator=generator, device=like.device)


def _molecules_for(system, extra, dtype) -> Molecules:
    """:func:`molecules` of ``extra``, kept on the system for the index
    arrays it was last asked for (one slot, holding those arrays so that
    their ids stay theirs), so that a warm call reads nothing back."""
    key = (tuple(id(a) for a in extra), dtype)
    slot = system.__dict__.get("npt_molecules")
    if slot is None or slot[0] != key:
        slot = (key, extra, molecules(system, extra, dtype))
        system.__dict__["npt_molecules"] = slot
    return slot[2]


def _views(system, bonded, box):
    """The system and the bonded terms at ``box`` (shallow copies), the
    bonded terms on the system's kernel route."""
    return (system.with_box(box),
            None if bonded is None else follow_route(bonded,
                                                     system).with_box(box))


def _potential(x, sb, bb, energy_fn=None, nb=None):
    """The barostat's potential: ``energy_fn(x, box)`` or the system's
    energy (with ``nb``, else its own binning), plus the bonded terms."""
    e = energy_fn(x, sb.box) if energy_fn is not None else _energy(x, sb,
                                                                   nb=nb)
    return e if bb is None else e + bonded_energy(x, bb)


def proposal_energy(system, bonded=None, energy_fn=None):
    """``e_at(x, box)``: the potential at a proposed box, with its own
    binning, as an attempt evaluates it."""
    return lambda x, box: _potential(x, *_views(system, bonded, box),
                                     energy_fn)


def _metropolis(e_new, e_old, dvol, v0, v1, p_int, kt, n_mol, generator):
    """The acceptance of a proposal: (accepted, poisoned).  A NaN weight
    (a poisoned proposal: overflow or a cell plane below the cutoff)
    compares False, and ``poisoned`` keeps it visible."""
    w = e_new - e_old + p_int * dvol - n_mol * kt * torch.log(v1 / v0)
    ok = uniform_draw(e_new, generator) < torch.exp(-w / kt)
    return ok, ~torch.isfinite(e_new)


def _adapt(ok, dv, v0):
    """The proposal width after an attempt: x1.03 on accept, /1.03 on
    reject, clamped to [1e-5, 0.1] of the volume."""
    return torch.clamp(torch.where(ok, dv * 1.03, dv / 1.03),
                       min=1e-5 * v0, max=0.1 * v0)


def isotropic_attempt(x, box, dv, e_old, mols: Molecules, e_at, generator,
                      kt: float, p_int: float):
    """One isotropic volume attempt (run it under ``torch.no_grad``): draw
    the volume change, scale the molecule centroids and the box by the
    same factor, evaluate ``e_at`` (:func:`proposal_energy`) there and
    accept by :func:`_metropolis`.  Returns ``(x, box, dv, e_cur,
    (box, accepted, poisoned))`` after the attempt."""
    v0 = box_volume(box)
    dvol = dv * (2.0 * uniform_draw(dv, generator) - 1.0)
    v1 = v0 + dvol
    s = torch.pow(v1 / v0, 1.0 / 3.0)
    c = molecule_centroids(x, box, mols.mol_id, mols.first_idx, mols.counts,
                           mols.plan)
    x1 = x + (s - 1.0) * c[mols.mol_id]
    box1 = box * s
    e_new = e_at(x1, box1)                   # fresh binning at the proposal
    ok, poisoned = _metropolis(e_new, e_old, dvol, v0, v1, p_int, kt,
                               mols.n_mol, generator)
    box_n = torch.where(ok, box1, box)
    return (torch.where(ok, x1, x), box_n, _adapt(ok, dv, v0),
            torch.where(ok, e_new, e_old), (box_n, ok, poisoned))


def anisotropic_attempt(x, box, dv, e_old, mols: Molecules, e_at, generator,
                        kt: float, p_int: float, allowed: tuple):
    """One anisotropic attempt: draw an axis among ``allowed`` and a volume
    change within that axis's width ``dv[a]``, scale lattice row ``B[a]``
    and move each centroid by ``(s - 1) f_a B[a]``; otherwise as
    :func:`isotropic_attempt`, with the attempted axis last in the
    records."""
    dtype, dev = x.dtype, x.device
    ai = axis_draw(len(allowed), x, generator)
    axis = constant(allowed, torch.int64, dev)[ai]
    onehot = (torch.arange(3, device=dev) == axis).to(dtype)
    v0 = box_volume(box)
    dva = torch.sum(dv * onehot)
    dvol = dva * (2.0 * uniform_draw(dv, generator) - 1.0)
    v1 = v0 + dvol
    s = v1 / v0                               # the one axis's scale factor
    c = molecule_centroids(x, box, mols.mol_id, mols.first_idx, mols.counts,
                           mols.plan)
    fa = torch.sum(frac_coords(c, box) * onehot, dim=-1)            # [M]
    if box.ndim == 2:
        row = torch.sum(box * onehot[:, None], dim=0)               # B[a]
        box1 = box * (1.0 + (s - 1.0) * onehot)[:, None]
    else:
        row = onehot * box
        box1 = box * (1.0 + (s - 1.0) * onehot)
    x1 = x + (s - 1.0) * fa[mols.mol_id, None] * row[None, :]
    e_new = e_at(x1, box1)
    ok, poisoned = _metropolis(e_new, e_old, dvol, v0, v1, p_int, kt,
                               mols.n_mol, generator)
    box_n = torch.where(ok, box1, box)
    dv = dv * (1.0 - onehot) + _adapt(ok, dva, v0) * onehot
    return (torch.where(ok, x1, x), box_n, dv,
            torch.where(ok, e_new, e_old), (box_n, ok, poisoned, axis))


def _npt_langevin_driver(positions, velocities, system, masses, dt: float,
                         temperature: float, friction: float, generator,
                         n_steps: int, bonded, barostat_interval: int,
                         attempt, dv0, key, extra_mol_idx,
                         constraints=None, energy_fn=None,
                         graph: bool = True):
    """The machinery both barostats share: chunks of one attempt, one
    rebuild and ``barostat_interval`` BAOAB steps (see the module
    docstring).  ``attempt(x, box, dv, e_old, mols, e_at, generator)`` is
    :func:`isotropic_attempt` or :func:`anisotropic_attempt` with its
    coefficients bound; its records (a tuple: box, accepted, poisoned[,
    axis]) are kept per attempt.  The carry holds x, v, f, the box, the
    width, the current potential and the :class:`Molecules` tensors, so
    that the chunk's key holds the molecules' shapes, not their
    identity.  The chunks are kept on ``energy_fn`` where given (as the
    other drivers keep theirs on their energy function), else on the
    system.  Returns ``(x, v, box, diag)``."""
    n_outer, rem = divmod(n_steps, barostat_interval)
    if rem or n_outer == 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "barostat_interval")
    x = positions
    dtype = x.dtype
    integrate._check_generator(generator, x.device)
    has_cells = system.spec.direct_method == "cell" and energy_fn is None
    if has_cells:
        # the neighbor state is rebuilt once per chunk, so the barostat
        # interval is the rebuild interval: warn if it outruns the skin.
        # The check reads the box on the host, so it is kept on the system.
        checked = system.__dict__.setdefault("npt_host", {})
        ikey = (float(dt), barostat_interval)
        if ikey not in checked:
            checked[ikey] = suggest_rebuild_interval(system, dt,
                                                     cap=barostat_interval)
        safe = checked[ikey]
        if safe < barostat_interval:
            warnings.warn(
                f"barostat_interval {barostat_interval} exceeds the "
                f"skin-safe rebuild interval {safe} at dt={dt}; the "
                "freshness guard will NaN-poison the trajectory if atom "
                "displacement outruns the skin — use a smaller interval",
                stacklevel=3)
    extra = tuple(extra_mol_idx)
    if bonded is not None and extra == ():
        extra = bonded_rows(bonded)
    mols = _molecules_for(system, extra, dtype)
    e_at = proposal_energy(system, bonded, energy_fn)

    def force(xx, ctx):
        nb, sb, bb = ctx
        e, f = integrate._energy_and_forces(
            lambda z: _potential(z, sb, bb, energy_fn, nb), xx)
        if has_cells:
            bad = torch.where(neighbor_state_fresh(nb, xx, sb), 1.0,
                              torch.nan).to(e.dtype)
            e, f = e * bad, f * bad
        return e, f

    def make_head(_masses, gen):
        def head(carry, rebuild):
            xx, vv, _f, box, dv, e_old, *mol_t = carry
            with torch.no_grad():
                xx, box_new, dv, e_cur, records = attempt(
                    xx, box, dv, e_old, Molecules(*mol_t), e_at, gen)
            box.copy_(box_new)            # the carry's static buffer
            sb, bb = _views(system, bonded, box)
            nb = rebuild(xx, sb) if has_cells else None
            # fresh forces at the chunk head: the box may just have moved
            _e, f0 = integrate._energy_and_forces(
                lambda z: _potential(z, sb, bb, energy_fn, nb), xx)
            return (xx, vv, f0, box, dv, e_cur, *mol_t), (nb, sb, bb), records
        return head

    def make_step(m, gen):
        if constraints is None:
            inner = integrate._baoab_step(force, m, dt, temperature,
                                          friction, gen)
        else:
            from .constraints import _rattle_baoab
            inner = _rattle_baoab(force, m, dt, temperature, friction, gen,
                                  constraints)

        def step(carry, ctx):
            (xx, vv, ff), e, kin = inner(carry[:3], ctx)
            return (xx, vv, ff, *carry[3:5], e, *carry[6:]), e, e + kin
        return step

    box0 = system.box.to(dtype)
    v0 = velocities.to(dtype)
    if constraints is not None:
        v0 = project_velocities(x, v0, constraints)
    with torch.no_grad():
        e0 = e_at(x, box0)
    carry0 = (x, v0, torch.zeros_like(x), box0, dv0, e0, *mols)

    def make(k):
        return integrate.Chunk(
            make_step, (lambda xx, sb: build_neighbor_state(xx, sb))
            if has_cells else None, k, carry0, graph, masses, generator,
            keep=(bonded, constraints), make_head=make_head)

    key = key + (float(dt), float(temperature), float(friction),
                 id(bonded), id(constraints), tuple(box0.shape),
                 tuple(tuple(t.shape) for t in mols))
    owner = system if energy_fn is None else energy_fn
    chunk = integrate._chunk_getter(owner, graph, x, masses, key,
                                    make)(barostat_interval)
    es = x.new_empty((n_steps,))
    records = None
    with phase_scope("cf.md.call"):
        chunk.load(*carry0, masses=masses, generator=generator)
        for i in range(n_outer):
            chunk()
            es[i * barostat_interval:(i + 1) * barostat_interval].copy_(
                chunk.es)
            if records is None:
                records = [r.new_empty((n_outer,) + tuple(r.shape))
                           for r in chunk.head_records]
            for buf, r in zip(records, chunk.head_records):
                buf[i].copy_(r)
    diag = {"energies": es, "boxes": records[0], "accepts": records[1],
            "poisoned": records[2], "dv": chunk.carry[4].clone()}
    if len(records) > 3:
        diag["axes"] = records[3]
    return chunk.x.clone(), chunk.v.clone(), chunk.carry[3].clone(), diag


def npt_langevin_trajectory(positions, velocities, system, masses,
                            dt: float, temperature: float, friction: float,
                            pressure_bar: float, generator: torch.Generator,
                            n_steps: int, bonded=None,
                            barostat_interval: int = 20,
                            dv_frac: float = 0.01,
                            extra_mol_idx: tuple = (),
                            constraints=None, energy_fn=None,
                            graph: bool = True):
    """NPT by BAOAB Langevin dynamics with an isotropic MC barostat attempt
    (:func:`isotropic_attempt`) every ``barostat_interval`` steps
    (``n_steps`` a multiple of it), each interval one chunk (a CUDA graph
    replay on the card unless ``graph=False``).  ``energy_fn(x, box)``
    replaces the electrostatics (evaluated afresh every step; no neighbor
    reuse).  Returns ``(x, v, box, diag)`` with ``diag = {"energies"
    [n_steps] total energy, "boxes" [n_attempts, ...], "accepts"
    [n_attempts] bool, "poisoned" [n_attempts] bool, "dv" scalar}``;
    ``poisoned`` marks proposals whose energy NaN-poisoned (overflow, or a
    cell plane below the cutoff at the proposed box)."""
    kt = BOLTZ * temperature
    p_int = pressure_bar * BAR_TO_KJ_MOL_NM3

    def attempt(*args):
        return isotropic_attempt(*args, kt, p_int)

    dv0 = dv_frac * box_volume(system.box.to(positions.dtype))
    return _npt_langevin_driver(
        positions, velocities, system, masses, dt, temperature, friction,
        generator, n_steps, bonded, barostat_interval, attempt, dv0,
        ("npt", float(pressure_bar)), extra_mol_idx, constraints, energy_fn,
        graph)


def npt_anisotropic_langevin_trajectory(
        positions, velocities, system, masses, dt: float,
        temperature: float, friction: float, pressure_bar: float,
        generator: torch.Generator, n_steps: int, bonded=None,
        barostat_interval: int = 20, dv_frac: float = 0.01,
        scale_axes=(True, True, True), extra_mol_idx: tuple = (),
        constraints=None, energy_fn=None, graph: bool = True):
    """NPT with an anisotropic MC barostat (:func:`anisotropic_attempt`):
    each attempt scales one lattice row, chosen uniformly among the
    ``scale_axes`` marked True, with a proposal width per axis
    (``scale_axes=(True, True, False)``: the semi-isotropic ensemble with
    z fixed).  Chunks, acceptance, poison visibility and ``diag`` as
    :func:`npt_langevin_trajectory`, plus ``diag["axes"]`` (the attempted
    axis per attempt); ``diag["dv"]`` is the final [3] per-axis width."""
    allowed = tuple(a for a in range(3) if scale_axes[a])
    if not allowed:
        raise ValueError("scale_axes must enable at least one axis")
    kt = BOLTZ * temperature
    p_int = pressure_bar * BAR_TO_KJ_MOL_NM3

    def attempt(*args):
        return anisotropic_attempt(*args, kt, p_int, allowed)

    dtype = positions.dtype
    dv0 = (dv_frac * box_volume(system.box.to(dtype))
           * torch.ones((3,), dtype=dtype, device=positions.device))
    return _npt_langevin_driver(
        positions, velocities, system, masses, dt, temperature, friction,
        generator, n_steps, bonded, barostat_interval, attempt, dv0,
        ("npt_aniso", float(pressure_bar), allowed), extra_mol_idx,
        constraints, energy_fn, graph)
