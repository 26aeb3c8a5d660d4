"""CSVR thermostat (torch counterpart of ``chargeflux_tpu.csvr``): canonical
sampling through velocity rescaling (Bussi, Donadio & Parrinello, J. Chem.
Phys. 126, 014101 (2007)).

One global stochastic rescale of all velocities per velocity-Verlet step,
exactly canonical in the kinetic energy.  The drivers return the per-step
total energy, kinetic energy and the cumulative work ``W`` the thermostat
injected; ``etot - work`` is the Bussi conserved quantity.

The drivers run in chunks as ``integrate``'s do (``integrate.Chunk``:
static buffers, the work ``W`` in the carry beside x, v and f, one CUDA
graph replay per chunk on the card unless ``graph=False``).  Each rescale
draws one standard normal (:func:`scalar_normal`) and one chi-squared
variate of ``n_dof - 1`` degrees of freedom (:func:`chi_squared`, twice a
standard gamma variate of shape (n_dof - 1) / 2), both from the caller's
``torch.Generator``, inside the graph.  To resume, pass the same generator
on.  The tests hand both functions the JAX package's draws.
"""

from __future__ import annotations

import math

import torch

from .integrate import (MDState, STEPS_PER_CHUNK, Chunk, _check_generator,
                        _chunk_getter, _energy_and_forces, _final_nb,
                        _require_steps, _run_chunks, kinetic_energy)
from .units import BOLTZ


def scalar_normal(like: torch.Tensor, generator: torch.Generator):
    """One standard normal of ``like``'s type and device from
    ``generator``: the rescale's R1."""
    return torch.randn((), generator=generator, dtype=like.dtype,
                       device=like.device)


def chi_squared(dof: int, like: torch.Tensor, generator: torch.Generator):
    """One chi-squared variate of ``dof`` degrees of freedom, of ``like``'s
    type and device, from ``generator``: 2 Gamma(dof / 2, 1), torch's
    standard gamma sampler."""
    shape = torch.full((), 0.5 * dof, dtype=like.dtype, device=like.device)
    return 2.0 * torch._standard_gamma(shape, generator=generator)


def csvr_scale(kin, n_dof: int, dt: float, tau: float, temperature: float,
               generator: torch.Generator):
    """One CSVR rescale factor: (alpha, dK) for the kinetic energy ``kin``
    (Bussi 2007, Eq. A7), ``alpha^2 = c + (1 - c) (kT / 2K) (R1^2 + S) +
    2 R1 sqrt(c (1 - c) kT / 2K)`` with ``c = exp(-dt / tau)``, R1 a
    standard normal and S chi-squared of ``n_dof - 1``; the positive root,
    and ``kin`` guarded against 0, as in the JAX package."""
    c = math.exp(-dt / tau)
    kt_half = 0.5 * BOLTZ * temperature
    r1 = scalar_normal(kin, generator)
    s = chi_squared(n_dof - 1, kin, generator)
    ratio = kt_half / torch.clamp(kin, min=1e-12)
    alpha2 = (c + (1.0 - c) * ratio * (r1 * r1 + s)
              + 2.0 * r1 * torch.sqrt(c * (1.0 - c) * ratio))
    return torch.sqrt(alpha2), (alpha2 - 1.0) * kin


def _csvr_step(force, masses, dt, temperature, tau, n_dof, generator):
    """One velocity-Verlet step and one rescale as an ``integrate.Chunk``
    step on the carry (x, v, f, W); ``force(x, nb) -> (energy, forces)``.
    Its record is [etot, kinetic, W] after the rescale."""

    def step(carry, nb):
        x, v, f, w = carry
        half = (0.5 * dt / masses)[:, None]
        v_half = v + f * half
        x_new = x + dt * v_half
        e, f_new = force(x_new, nb)
        v_new = v_half + f_new * half
        kin = kinetic_energy(v_new, masses)
        alpha, dk = csvr_scale(kin, n_dof, dt, tau, temperature, generator)
        w = w + dk
        return ((x_new, alpha * v_new, f_new, w), e,
                torch.stack([e + kin + dk, kin + dk, w]))
    return step


def _diag(records):
    return {"etot": records[:, 0], "kinetic": records[:, 1],
            "work": records[:, 2]}


def _csvr_run(state, owner, force, rebuild, masses, dt, temperature, tau,
              generator, n_steps, k, n_constraints, graph, key):
    """The drivers' loop: chunks of ``k`` steps from (x, v, f, W = 0) kept
    on ``owner`` under ``key``; returns (the last chunk, the records)."""
    _require_steps(n_steps)
    x = state.positions
    _check_generator(generator, x.device)
    n_dof = 3 * x.shape[0] - n_constraints
    w0 = x.new_zeros(())

    def make(kk):
        return Chunk(lambda m, g: _csvr_step(force, m, dt, temperature, tau,
                                             n_dof, g), rebuild, kk,
                     (x, x, x, w0), graph, masses, generator,
                     record_shape=(3,))

    key = key + (float(dt), float(temperature), float(tau), n_dof)
    return _run_chunks(_chunk_getter(owner, graph, x, masses, key, make),
                       (x, state.velocities, state.forces, w0), n_steps, k,
                       masses, generator)


def csvr_trajectory_nb(state, e_fn, init_nb, masses, dt: float,
                       temperature: float, tau: float,
                       generator: torch.Generator, n_steps: int,
                       rebuild_every: int = 10, n_constraints: int = 0,
                       graph: bool = True):
    """``n_steps`` of velocity-Verlet plus one CSVR rescale per step, the
    neighbor state rebuilt every ``rebuild_every`` steps (a remainder runs
    as one shorter chunk, where the JAX package asks for a multiple), each
    chunk a CUDA graph replay on the card unless ``graph=False``.  Returns
    (final_state, diag) with ``diag = {"etot", "kinetic", "work"}``
    [n_steps] series; the final state keeps the carry forces and carries
    a fresh neighbor state and the potential evaluated with it."""
    chunk, rec = _csvr_run(state, e_fn, lambda xx, nb: e_fn(xx, nb)[:2],
                           init_nb, masses, dt, temperature, tau, generator,
                           n_steps, rebuild_every, n_constraints, graph,
                           ("csvr_nb", init_nb))
    return _final_nb(chunk, e_fn, init_nb), _diag(rec)


def csvr_trajectory(state: MDState, energy_fn, masses, dt: float,
                    temperature: float, tau: float,
                    generator: torch.Generator, n_steps: int,
                    n_constraints: int = 0, graph: bool = True):
    """Dense-route CSVR (no neighbor reuse) in chunks of
    ``integrate.STEPS_PER_CHUNK``; returns (final_state, diag) as
    :func:`csvr_trajectory_nb`, the final potential evaluated at the last
    positions."""
    last, rec = _csvr_run(
        state, energy_fn, lambda xx, nb: _energy_and_forces(energy_fn, xx),
        None, masses, dt, temperature, tau, generator, n_steps,
        STEPS_PER_CHUNK, n_constraints, graph, ("csvr",))
    x_fin = last.x.clone()
    with torch.no_grad():
        e_pot = energy_fn(x_fin)
    return (MDState(x_fin, last.v.clone(), last.f.clone(), e_pot),
            _diag(rec))
