"""Replica ensembles (torch counterpart of
``chargeflux_tpu.parallel.replicas``): energies and forces of a batch of
independent configurations of one system, replica NVE and temperature
replica exchange (REMD).

The JAX package vmaps a single-system energy.  Here the batch is an
explicit leading replica axis: positions [R, N, 3] go through the dense
route's own functions (flux charges on the templated blocks, the [R, N, N]
pair sum, the templated exclusion and bonded terms, self energy, and the
classical-Ewald structure factors with [R, ...] phase tables: one batched
product on "xla", one batched launch of each structure-factor kernel on
"pallas"), and the forces are one ``autograd.grad`` of the sum over
replicas, which gives each replica its own forces because the replicas are
independent.  A system that route does not take in one pass (the cell
route, dense-mesh SPME, remainder rows no template covers) runs one
single-system evaluation per replica instead: the same results, the same
kernels.

The drivers take a batched ``energy_fn(x [R, N, 3]) -> [R]``
(:func:`replica_energy_fn` builds one for a system; :func:`vmap_energy_fn`
wraps a plain-torch single-system function in ``torch.func.vmap``).  Their
trajectories follow ``integrate.Chunk``: static buffers, one CUDA graph per
chunk on the card, noise from the caller's ``torch.Generator`` drawn inside
the graph, and ``graph=False`` as the control the replays equal bit for
bit.
"""

from __future__ import annotations

import dataclasses

import torch

from ..bonded import bonded_energy, follow_route
from ..energy import _energy, resolve_recip_method
from ..integrate import (MDState, Chunk, _check_generator, _chunk_getter,
                         _require_steps, _run_chunks, baoab_coeffs,
                         baoab_pre_force)
from ..units import BOLTZ
from .shard import _axis

#: Steps per chunk of :func:`replica_nve_trajectory`.
STEPS_PER_CHUNK = 10


def vmap_friendly_system(system):
    """The system with ``recip_method="auto"`` pinned for a replica batch
    on the dense periodic route, to what "auto" takes for one system on
    its device and type: "pallas" (the structure-factor kernels, batched
    over the replicas in one launch each) for f32 on the card where the
    kernels take the k grid, else "xla".  The JAX package pins "xla",
    since on its TPU a vmapped ``pallas_call`` runs the replicas one after
    another; on an NVIDIA H100 the batched kernels ran bench.py's 64 x 216
    step in 15.79 ms against 16.07 for "xla" (PERF.md).  An explicit
    method stands."""
    spec = system.spec
    if (spec.pbc and spec.direct_method == "dense"
            and spec.recip_method == "auto"):
        route = resolve_recip_method(spec, system.box.dtype,
                                     system.box.device)
        return system._swap(spec=dataclasses.replace(spec,
                                                     recip_method=route))
    return system


def batched_route(system, bonded=None) -> bool:
    """Whether ``system`` (and ``bonded``) evaluate a replica batch in one
    pass: the dense or non-periodic route with classical Ewald, every flux,
    exclusion and bonded row on a molecule template."""
    spec = system.spec
    if spec.pbc and (spec.direct_method != "dense"
                     or resolve_recip_method(spec, system.box.dtype,
                                             system.box.device) == "pme"):
        return False
    if system.flux_plan is not None or system.excl_plan is not None:
        return False
    return bonded is None or bonded.plan is None


def replica_energy_fn(system, bonded=None):
    """``energy_fn(x [R, N, 3]) -> [R]``: charge-flux electrostatics plus
    the optional bonded terms of every replica, in one pass where
    :func:`batched_route` holds, else one single-system evaluation per
    replica; the bonded terms on the system's kernel route."""
    bonded = follow_route(bonded, system)

    def single(x):
        e = _energy(x, system)
        return e if bonded is None else e + bonded_energy(x, bonded)

    if batched_route(system, bonded):
        return single

    def e_fn(x):
        return torch.stack([single(x[r]) for r in range(x.shape[0])])
    return e_fn


def vmap_energy_fn(energy_fn):
    """A plain-torch single-system ``energy_fn(x [N, 3]) -> scalar`` as the
    drivers' batched ``energy_fn(x [R, N, 3]) -> [R]`` (``torch.func.vmap``;
    the port's own energy calls kernels vmap cannot batch: use
    :func:`replica_energy_fn` for a system)."""
    return torch.func.vmap(energy_fn)


def _forces(energy_fn, x):
    """([R] energies, [R, N, 3] forces) of a batched energy function: one
    gradient of the sum over replicas."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy_fn(xg)
        (g,) = torch.autograd.grad(torch.sum(e), xg)
    return e.detach(), -g


def replica_energy_and_forces(positions_batch, system):
    """[R, N, 3] -> ([R], [R, N, 3]) batched energies and forces of
    :func:`vmap_friendly_system` (system)."""
    return _forces(replica_energy_fn(vmap_friendly_system(system)),
                   positions_batch)


def shard_replicas(positions_batch, mesh, axis_name: str = "replica"):
    """This rank's block of a [R, ...] batch whose replica axis is sharded
    over ``mesh``'s ``axis_name`` (a ``DeviceMesh`` axis, or a process
    group): rank k of D takes replicas [k R/D, (k+1) R/D).  R must divide
    by D."""
    _group, rank, size = _axis(mesh, axis_name)
    r = positions_batch.shape[0]
    if r % size:
        raise ValueError(f"{r} replicas do not divide over {size} ranks")
    return positions_batch[rank * (r // size):(rank + 1) * (r // size)]


def _kinetic(v, masses):
    """[R] kinetic energies of a batch of velocities [R, N, 3]."""
    return 0.5 * torch.sum(masses[:, None] * v * v, dim=(-2, -1))


def replica_nve_step(states: MDState, energy_fn, masses, dt: float
                     ) -> MDState:
    """One velocity-Verlet step of every replica (MDState leaves with a
    leading replica axis; ``energy_fn`` batched)."""
    inv_m = (1.0 / masses)[:, None]
    v_half = states.velocities + 0.5 * dt * states.forces * inv_m
    x = states.positions + dt * v_half
    e, f = _forces(energy_fn, x)
    return MDState(x, v_half + 0.5 * dt * f * inv_m, f, e)


def replica_nve_trajectory(states: MDState, energy_fn, masses, dt: float,
                           n_steps: int, graph: bool = True):
    """``n_steps`` of NVE for every replica; returns (final MDState batch,
    [n_steps, R] total energies).  Chunks of :data:`STEPS_PER_CHUNK` steps
    (then one of the remainder), each a CUDA graph replay on the card
    unless ``graph=False``."""
    _require_steps(n_steps)
    x = states.positions
    r = x.shape[0]

    def make_step(m, _generator):
        def step(carry, _nb):
            s = replica_nve_step(MDState(*carry, None), energy_fn, m, dt)
            return ((s.positions, s.velocities, s.forces), s.potential,
                    s.potential + _kinetic(s.velocities, m))
        return step

    def make(k):
        return Chunk(make_step, None, k, (x,) * 3, graph, masses,
                     record_shape=(r,), potential_shape=(r,))

    last, es = _run_chunks(
        _chunk_getter(energy_fn, graph, x, masses,
                      ("replica_nve", float(dt)), make),
        (x, states.velocities, states.forces), n_steps, STEPS_PER_CHUNK,
        masses)
    return MDState(last.x.clone(), last.v.clone(), last.f.clone(),
                   last.potential.clone()), es


def pairing_tables(r: int):
    """The even-odd neighbor pairings of an R-slot ladder, as the JAX
    package builds them: for parity 0 the pairs (0, 1), (2, 3), ..., for
    parity 1 (1, 2), (3, 4), ..., each padded to max(R // 2, 1) pairs with
    the self-pair (0, 0) marked invalid.  Returns ((lo, hi, valid) of
    parity 0, of parity 1) as lists."""
    n_pairs = max(r // 2, 1)

    def pairing(start):
        lo = list(range(start, r - 1, 2))
        pad = n_pairs - len(lo)
        valid = [True] * len(lo) + [False] * pad
        return lo + [0] * pad, [i + 1 for i in lo] + [0] * pad, valid

    return pairing(0), pairing(1)


def slot_coefficients(dt: float, friction: float, temperatures, like):
    """(temperatures [R], c2 [R]) as tensors of ``like``'s type and device:
    c2 = ``baoab_coeffs(dt, friction, T_r)[1]`` per slot.  They ride in the
    REMD carry, so a new ladder replays the same graph."""
    temps = [float(t) for t in temperatures]
    c2 = [baoab_coeffs(dt, friction, t)[1] for t in temps]
    return (torch.tensor(temps, dtype=like.dtype, device=like.device),
            torch.tensor(c2, dtype=like.dtype, device=like.device))


def remd_langevin_trajectory(states: MDState, energy_fn, masses, dt: float,
                             temperatures, friction: float,
                             generator: torch.Generator, n_steps: int,
                             exchange_every: int = 10, graph: bool = True):
    """Temperature replica exchange: BAOAB Langevin of every replica at its
    slot's temperature, and every ``exchange_every`` steps a Metropolis
    sweep over neighbor slots, even pairs and odd pairs in turn (the JAX
    package's scheme).  Slots keep their temperatures; configurations
    move.  A swap of slots (i, j) is accepted with min(1, exp((b_i - b_j)
    (E_i - E_j))), b = 1/kT; velocities travel with their configuration,
    rescaled by sqrt(T_dest / T_src).

    One chunk is ``exchange_every`` BAOAB steps plus one sweep: the
    acceptance by ``torch.where``, the permutation by gather, the rescale,
    all inside the chunk's graph on the card.  The noise and the uniforms
    come from ``generator``; the per-slot temperatures and O-step
    coefficients are chunk inputs, so any ladder replays one graph.
    Returns (final MDState batch, [n_sweeps, R] per-slot potentials after
    each sweep, [n_sweeps, R // 2] acceptance of each attempted pair)."""
    if n_steps <= 0 or n_steps % exchange_every:
        raise ValueError("n_steps must be a positive multiple of "
                         "exchange_every")
    x = states.positions
    _check_generator(generator, x.device)
    r = x.shape[0]
    temps, c2 = slot_coefficients(dt, friction, temperatures, x)
    if temps.shape != (r,):
        raise ValueError(f"need {r} temperatures, got {tuple(temps.shape)}")
    c1 = baoab_coeffs(dt, friction, 1.0)[0]
    tables = pairing_tables(r)
    n_pairs = len(tables[0][0])

    def make_step(m, g):
        dev = x.device
        (lo0, hi0, ok0), (lo1, hi1, ok1) = (
            [torch.tensor(t, device=dev) for t in par] for par in tables)
        slots = torch.arange(r, device=dev)

        def step(carry, _nb):
            x, v, f, pot, temps, c2, sweep = carry
            inv_m = (1.0 / m)[:, None]
            c2r = c2[:, None, None]
            for _ in range(exchange_every):
                x, v = baoab_pre_force(x, v, f, inv_m, dt, c1, c2r, g)
                pot, f = _forces(energy_fn, x)
                v = v + 0.5 * dt * f * inv_m
            even = sweep % 2 == 0
            lo = torch.where(even, lo0, lo1)
            hi = torch.where(even, hi0, hi1)
            valid = torch.where(even, ok0, ok1)
            betas = 1.0 / (BOLTZ * temps)
            delta = (betas[lo] - betas[hi]) * (pot[lo] - pot[hi])
            u = torch.rand((n_pairs,), generator=g, dtype=pot.dtype,
                           device=pot.device)
            accept = (torch.log(u) < delta) & valid
            # slot -> the slot whose configuration it receives
            perm = slots.scatter(0, lo, torch.where(accept, hi, lo))
            perm = perm.scatter(0, hi, torch.where(accept, lo, hi))
            scale = torch.sqrt(temps / temps[perm])[:, None, None]
            pot = pot[perm]
            carry = (x[perm], v[perm] * scale, f[perm], pot, temps, c2,
                     sweep + 1)
            return carry, pot, torch.cat([pot, accept.to(pot.dtype)])
        return step

    sweep0 = torch.zeros((), dtype=torch.int64, device=x.device)
    carry = (x, states.velocities, states.forces, states.potential, temps,
             c2, sweep0)

    def make(k):
        return Chunk(make_step, None, k, carry, graph, masses, generator,
                     record_shape=(r + n_pairs,), potential_shape=(r,))

    key = ("remd", float(dt), float(friction), int(exchange_every))
    last, recs = _run_chunks(
        _chunk_getter(energy_fn, graph, x, masses, key, make), carry,
        n_steps // exchange_every, 1, masses, generator)
    final = MDState(last.x.clone(), last.v.clone(), last.f.clone(),
                    last.carry[3].clone())
    return final, recs[:, :r], recs[:, r:] > 0.5
