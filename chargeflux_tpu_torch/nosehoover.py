"""Nose-Hoover chain (NHC) thermostat, deterministic NVT (torch counterpart
of ``chargeflux_tpu.nosehoover``).

Martyna-Tuckerman-Klein chains with a Suzuki-Yoshida-factored half step
around a velocity-Verlet core (the textbook NHC-VV splitting).  The chain's
[M] tensors ride in the chunk's carry beside x, v and f; its update is a
chain of scalar operations unrolled in Python, as the JAX package unrolls
it at trace time, so a chunk (``integrate.Chunk``: one CUDA graph replay on
the card unless ``graph=False``) captures it whole.  The thermostat draws
no noise: to resume, pass the returned chain back in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .integrate import (MDState, STEPS_PER_CHUNK, Chunk, _chunk_getter,
                        _energy_and_forces, _final_nb, _require_steps,
                        _run_chunks, kinetic_energy)
from .units import BOLTZ

# third-order Suzuki-Yoshida composition weights (w1, 1 - 2*w1, w1)
_SY1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_SY3 = (_SY1, 1.0 - 2.0 * _SY1, _SY1)


class NHChain(NamedTuple):
    xi: torch.Tensor     # [M] chain "positions" (enter only the invariant)
    v_xi: torch.Tensor   # [M] chain velocities, 1/ps
    q: torch.Tensor      # [M] chain masses, kJ/mol ps^2


def nhc_init(n_dof: int, temperature: float, tau: float,
             chain_length: int = 3, dtype=torch.float32,
             device=None) -> NHChain:
    """Chain at rest with the MTK masses Q1 = n_dof kT tau^2, Qk = kT tau^2
    (tau the coupling period, ps), on the card unless ``device`` says
    otherwise."""
    if chain_length < 2:
        raise ValueError("chain_length must be >= 2")
    dev = resolve_device(device)
    kt = BOLTZ * temperature
    q = torch.full((chain_length,), kt * tau * tau, dtype=dtype, device=dev)
    q[0] = q[0] * float(n_dof)
    z = torch.zeros((chain_length,), dtype=dtype, device=dev)
    return NHChain(z, z.clone(), q)


def _nhc_half(chain: NHChain, ke2, n_dof: int, kt: float, dt_half: float,
              n_sy: int = 3):
    """One NHC update of duration ``dt_half`` on a system whose twice
    kinetic energy is ``ke2``; returns (velocity scale factor, new chain).
    Unrolled over the Suzuki-Yoshida weights and the chain, on the chain's
    elements as scalars, in the JAX package's order of operations."""
    xi, v_xi, q = chain
    m = q.shape[0]
    qs = [q[k] for k in range(m)]
    v = [v_xi[k] for k in range(m)]
    weights = _SY3 if n_sy == 3 else (1.0,)
    scale = None

    def g(k, ke2_now):
        if k == 0:
            return (ke2_now - n_dof * kt) / qs[0]
        return (qs[k - 1] * v[k - 1] * v[k - 1] - kt) / qs[k]

    for w in weights:
        wdt = w * dt_half
        v[m - 1] = v[m - 1] + 0.25 * wdt * g(m - 1, ke2)
        for k in range(m - 2, -1, -1):
            aa = torch.exp(-0.125 * wdt * v[k + 1])
            v[k] = v[k] * aa * aa + 0.25 * wdt * g(k, ke2) * aa
        s = torch.exp(-0.5 * wdt * v[0])
        scale = s if scale is None else scale * s
        ke2 = ke2 * s * s
        xi = xi + 0.5 * wdt * torch.stack(v)
        for k in range(m - 1):
            aa = torch.exp(-0.125 * wdt * v[k + 1])
            v[k] = v[k] * aa * aa + 0.25 * wdt * g(k, ke2) * aa
        v[m - 1] = v[m - 1] + 0.25 * wdt * g(m - 1, ke2)
    return scale, NHChain(xi, torch.stack(v), q)


def nhc_conserved(state, chain: NHChain, masses, n_dof: int,
                  temperature: float):
    """The extended-system invariant H' = KE + PE + sum_k Qk v_xik^2 / 2 +
    n_dof kT xi_1 + kT sum_{k>=2} xi_k; its drift measures the integrator's
    error."""
    kt = BOLTZ * temperature
    bath = (0.5 * torch.sum(chain.q * chain.v_xi * chain.v_xi)
            + n_dof * kt * chain.xi[0] + kt * torch.sum(chain.xi[1:]))
    return kinetic_energy(state.velocities, masses) + state.potential + bath


def _nhc_vv(x, v, f, chain, force, masses, dt, kt, n_dof):
    """Half chain update, velocity-Verlet with ``force(x) -> (energy,
    forces)``, half chain update: (x, v, f, chain, energy)."""
    inv_m = (1.0 / masses)[:, None]
    s1, chain = _nhc_half(chain, 2.0 * kinetic_energy(v, masses), n_dof, kt,
                          0.5 * dt)
    v = v * s1
    v_half = v + 0.5 * dt * f * inv_m
    x = x + dt * v_half
    e, f = force(x)
    v = v_half + 0.5 * dt * f * inv_m
    s2, chain = _nhc_half(chain, 2.0 * kinetic_energy(v, masses), n_dof, kt,
                          0.5 * dt)
    return x, v * s2, f, chain, e


def nose_hoover_step(state: MDState, chain: NHChain, energy_fn, masses,
                     dt: float, temperature: float, n_dof: int):
    """One NHC-VV step: half chain update, velocity-Verlet, half chain
    update.  Returns (state, chain)."""
    x, v, f, chain, e = _nhc_vv(
        state.positions, state.velocities, state.forces, chain,
        lambda xx: _energy_and_forces(energy_fn, xx), masses, dt,
        BOLTZ * temperature, n_dof)
    return MDState(x, v, f, e), chain


def _start(state, temperature, tau, chain_length, n_dof, chain):
    if n_dof is None:
        n_dof = 3 * state.positions.shape[0] - 3
    if chain is None:
        chain = nhc_init(n_dof, temperature, tau, chain_length,
                         state.positions.dtype, state.positions.device)
    return n_dof, chain


def _nhc_run(state, owner, force, rebuild, masses, dt, temperature, n_dof,
             chain, n_steps, k, graph, key):
    """The drivers' loop: chunks of ``k`` steps on the carry (x, v, f, xi,
    v_xi, q) kept on ``owner`` under ``key``; returns (the last chunk, the
    per-step kinetic energies)."""
    _require_steps(n_steps)
    x = state.positions
    kt = BOLTZ * temperature

    def make_step(m, _generator):
        def step(carry, nb):
            xx, vv, ff, *ch = carry
            xx, vv, ff, ch, e = _nhc_vv(
                xx, vv, ff, NHChain(*ch), lambda z: force(z, nb), m, dt, kt,
                n_dof)
            return (xx, vv, ff, *ch), e, kinetic_energy(vv, m)
        return step

    def make(kk):
        return Chunk(make_step, rebuild, kk, (x, x, x) + tuple(chain), graph,
                     masses)

    key = key + (float(dt), float(temperature), n_dof,
                 tuple(chain.q.shape))
    return _run_chunks(_chunk_getter(owner, graph, x, masses, key, make),
                       (x, state.velocities, state.forces) + tuple(chain),
                       n_steps, k, masses)


def _chain_of(chunk) -> NHChain:
    return NHChain(*(t.clone() for t in chunk.carry[3:]))


def nose_hoover_trajectory_nb(state, e_fn, init_nb, masses, dt: float,
                              temperature: float, tau: float, n_steps: int,
                              rebuild_every: int = 10, chain_length: int = 3,
                              n_dof: int | None = None,
                              chain: NHChain | None = None,
                              graph: bool = True):
    """Deterministic NVT: NHC-VV with the neighbor state rebuilt every
    ``rebuild_every`` steps (a remainder runs as one shorter chunk, where
    the JAX package asks for a multiple), each chunk a CUDA graph replay on
    the card unless ``graph=False``.  ``n_dof`` defaults to 3N - 3.
    Returns (final_state, final_chain, per-step kinetic energies); the
    final state keeps the carry forces, with a fresh neighbor state and
    the potential evaluated with it.  Resume by passing the chain back."""
    n_dof, chain = _start(state, temperature, tau, chain_length, n_dof,
                          chain)
    chunk, kes = _nhc_run(state, e_fn, lambda xx, nb: e_fn(xx, nb)[:2],
                          init_nb, masses, dt, temperature, n_dof, chain,
                          n_steps, rebuild_every, graph, ("nhc_nb", init_nb))
    return _final_nb(chunk, e_fn, init_nb), _chain_of(chunk), kes


def nose_hoover_trajectory(state: MDState, energy_fn, masses, dt: float,
                           temperature: float, tau: float, n_steps: int,
                           chain_length: int = 3, n_dof: int | None = None,
                           chain: NHChain | None = None, graph: bool = True):
    """``n_steps`` of deterministic NHC NVT in chunks of
    ``integrate.STEPS_PER_CHUNK``; returns (final_state, final_chain,
    per-step kinetic energies), the final potential evaluated at the last
    positions.  ``n_dof`` defaults to 3N - 3 (the chain scales velocities
    uniformly, so zero total momentum stays zero); pass 3N if momentum is
    not zeroed.  Resume by passing the chain back."""
    n_dof, chain = _start(state, temperature, tau, chain_length, n_dof,
                          chain)
    last, kes = _nhc_run(
        state, energy_fn, lambda xx, nb: _energy_and_forces(energy_fn, xx),
        None, masses, dt, temperature, n_dof, chain, n_steps,
        STEPS_PER_CHUNK, graph, ("nhc",))
    x_fin = last.x.clone()
    with torch.no_grad():
        e_pot = energy_fn(x_fin)
    return (MDState(x_fin, last.v.clone(), last.f.clone(), e_pot),
            _chain_of(last), kes)
