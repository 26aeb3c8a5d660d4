"""Random batch Ewald (RBE): a stochastic O(N p) reciprocal space (torch
counterpart of ``chargeflux_tpu.rbe``).

After Jin, Li, Xu & Zhao (SIAM J. Sci. Comput. 43, B937 (2021)): instead
of summing every k-vector (classical Ewald) or spreading onto a mesh
(SPME), draw ``p`` k-vectors from the Ewald Gaussian
``P(k) ~ exp(-k^2 / 4 alpha^2)`` and use the importance-sampled estimator

    E_rec ~ (2 pi k_e / V) Z (1/p) sum_l 1{k_l != 0} |S(k_l)|^2 / k_l^2

with ``Z = prod_a sum_n exp(-(2 pi n / L_a)^2 / 4 alpha^2)`` the exact
partition constant (the distribution factorizes per axis for an
orthorhombic box, which this route requires).  The estimator is unbiased
in the energy, the forces and dE/dq; its O(1/p) variance is absorbed by a
thermostat, as the random force of Langevin dynamics is: use it for NVT
sampling, never for NVE or minimization.

Sampling on the card: each axis's integer n is drawn by inverse CDF, a
uniform from the caller's ``torch.Generator`` and ``torch.searchsorted``
on the axis's cumulative table, kept on the device (``device.constant``),
so a draw makes no host traffic and is captured into a trajectory chunk's
CUDA graph like the BAOAB normals.  The tables are built on the host once,
from the box when the energy function is made.

Choosing p: the JAX package records, at its 100k box on a TPU v5e, a
single-draw force noise over the total-force RMS of 1.21 / 0.84 / 0.61 /
0.44 at p = 32 / 64 / 128 / 256 (1/sqrt(p)); the operative budget is the
velocity kick 0.5 dt dF / m against the thermostat's own
~sqrt(2 friction dt) v_thermal, about 1/4, which at dt = 0.5 fs and
friction 20/ps asks p >= ~128 (p scales ~1/friction and ~dt).  Those
ratios are properties of the estimator.  The noise is not free: with no
matching friction it heats the box, by ~dt sigma_F^2 / (2 friction m kT)
relative, so by ~1/p; the 30k water box at p = 128, 20/ps, 0.5 fs ran
~57 K hot on an NVIDIA H100 (PERF.md).  The
port's step times and temperatures come from ``utils.measure profile
--path rbe`` / ``rbe100k`` and chip_smoke's phase 9b (PERF.md).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .device import constant
from .units import ONE_4PI_EPS0


class RBETables(NamedTuple):
    """Sampling tables for one (box, alpha) pair (host-side)."""

    logp: tuple          # 3 NumPy [2M_a+1] log-prob tables (unnormalized)
    nvals: tuple         # 3 NumPy [2M_a+1] integer n values
    z_const: float       # prod_a sum_n f_a(n) (includes the n=0 triple)
    box: tuple           # the box lengths the tables assume
    alpha: float


def rbe_tables(box, alpha: float, tail: float = 1e-12) -> RBETables:
    """Per-axis discrete-Gaussian tables with relative tail mass < tail:
    ``f_a(n) = exp(-(2 pi n / L_a)^2 / 4 alpha^2)``, M_a grown until the
    dropped tail is below ``tail`` relative to the axis sum."""
    if torch.is_tensor(box):
        box = box.detach().cpu().double().numpy()
    box = np.asarray(box, np.float64).reshape(-1)
    if box.size != 3:
        raise ValueError("RBE requires an orthorhombic [3] box (the "
                         "product sampling distribution factorizes "
                         "per axis)")
    logp, nvals = [], []
    z = 1.0
    for length in box:
        c = (2.0 * math.pi / float(length)) ** 2 / (4.0 * alpha * alpha)
        m = 1
        while math.exp(-c * (m + 1) ** 2) > tail:
            m += 1
        n = np.arange(-m, m + 1)
        f = np.exp(-c * n.astype(np.float64) ** 2)
        z *= float(f.sum())
        logp.append(-c * n.astype(np.float64) ** 2)
        nvals.append(n)
    return RBETables(logp=tuple(logp), nvals=tuple(nvals), z_const=z,
                     box=tuple(float(b) for b in box), alpha=float(alpha))


def _cdf(logp: np.ndarray) -> tuple:
    p = np.exp(logp - logp.max())
    return tuple(np.cumsum(p / p.sum()).tolist())


def sample_integers(tables: RBETables, n_samples: int,
                    generator: torch.Generator, device) -> torch.Tensor:
    """[p, 3] integer frequencies drawn from the factorized Ewald Gaussian
    by inverse CDF (one f64 uniform per axis and sample from
    ``generator``).  The zero triple is kept in the draw (the estimator
    masks it; keeping it preserves the distribution ``Z`` normalizes)."""
    u = torch.rand((3, n_samples), generator=generator, dtype=torch.float64,
                   device=device)
    cols = []
    for a in range(3):
        cdf = constant(_cdf(tables.logp[a]), torch.float64, device)
        nv = constant(tables.nvals[a].tolist(), torch.int64, device)
        idx = torch.searchsorted(cdf, u[a], right=True)
        cols.append(nv[torch.clamp(idx, max=nv.shape[0] - 1)])
    return torch.stack(cols, dim=1)


def sample_kvecs(tables: RBETables, n_samples: int,
                 generator: torch.Generator, dtype, device):
    """(k [p, 3] Cartesian, k2 [p], nonzero [p] bool) of
    :func:`sample_integers`'s draw."""
    return _kvecs(tables, sample_integers(tables, n_samples, generator,
                                          device), dtype)


def _kvecs(tables: RBETables, n: torch.Tensor, dtype):
    scale = constant([2.0 * math.pi / b for b in tables.box], dtype, n.device)
    k = n.to(dtype) * scale[None, :]
    return k, torch.sum(k * k, dim=1), torch.any(n != 0, dim=1)


def _from_kvecs(positions, q, tables: RBETables, n: torch.Tensor):
    """The estimator on the integer frequencies ``n`` [p, 3]:
    (2 pi k_e / V) Z (1/p) sum over nonzero rows of |S(k)|^2 / k^2, the
    phases broadcast elementwise (no f32 product)."""
    dtype = positions.dtype
    k, k2, nonzero = _kvecs(tables, n, dtype)
    phase = (positions[:, 0:1] * k[None, :, 0]
             + positions[:, 1:2] * k[None, :, 1]
             + positions[:, 2:3] * k[None, :, 2])
    s_cos = torch.sum(q[:, None] * torch.cos(phase), dim=0)
    s_sin = torch.sum(q[:, None] * torch.sin(phase), dim=0)
    k2_safe = torch.where(nonzero, k2, 1.0)
    contrib = torch.where(nonzero, (s_cos * s_cos + s_sin * s_sin) / k2_safe,
                          0.0)
    vol = tables.box[0] * tables.box[1] * tables.box[2]
    c = 2.0 * math.pi * ONE_4PI_EPS0 / vol
    return (c * tables.z_const / n.shape[0]) * torch.sum(contrib)


def rbe_reciprocal_energy(positions, q, tables: RBETables, n_samples: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Unbiased one-draw estimate of the reciprocal-space energy,
    differentiable in positions and q; the draw comes from
    ``generator``."""
    return _from_kvecs(positions, q, tables, sample_integers(
        tables, n_samples, generator, positions.device))


def estimator_moments(positions, q, tables: RBETables):
    """(mean, variance) of one sampled k-vector's term X = (2 pi k_e / V) Z
    |S(k)|^2 / k^2 (0 at k = 0) over the tables' whole distribution, by
    enumerating S(k) on their (2M+1)^3 grid (``ewald.structure_factors``,
    plain torch; memory ~ 4 N (M+1)(2M+1) values).  The mean is the
    reciprocal energy the estimator targets (the classical sum over the
    tables' k-vectors); a draw of p has variance ``variance / p``.  The
    terms are heavy-tailed (rare k-vectors near the charge structure's
    peak carry large |S|^2), so the spread of a few draws understates this
    variance."""
    from .ewald import kgrid_tensors, structure_factors

    dtype, dev = positions.dtype, positions.device
    kmax = tuple((len(n) + 1) // 2 for n in tables.nvals)
    box = torch.tensor(tables.box, dtype=dtype, device=dev)
    s_cos, s_sin = structure_factors(positions, q, box, kmax)
    grid = kgrid_tensors(kmax, dtype, dev)
    g = [(2.0 * math.pi / b) ** 2 for b in tables.box]
    sqx, sqy, sqz = grid.sq
    k2 = (g[0] * sqx[:, None, None] + g[1] * sqy[None, :, None]
          + g[2] * sqz[None, None, :]).reshape(grid.w.shape)
    k2 = torch.where(k2 > 0, k2, 1.0)
    f = torch.exp(-k2 * (0.25 / (tables.alpha * tables.alpha)))
    x = (s_cos * s_cos + s_sin * s_sin) / k2
    c = 2.0 * math.pi * ONE_4PI_EPS0 / (
        tables.box[0] * tables.box[1] * tables.box[2])
    # grid.w counts each +-k pair once (1/2 on the nx = 0 plane): a sum
    # over every k != 0 is twice the weighted half-space sum
    mean = 2.0 * c * torch.sum(grid.w * f * x)
    second = 2.0 * c * c * tables.z_const * torch.sum(grid.w * f * x * x)
    return mean, second - mean * mean


def make_rbe_nb_energy_fn(system, n_samples: int, bonded=None,
                          guard: bool = True):
    """Stochastic-reciprocal energy for NVT trajectory loops: returns
    ``(e_fn, init_nb)`` with ``e_fn(x, nb, generator) -> (energy, forces,
    nb)``, the RBE analog of ``integrate.make_nb_energy_fn``: the
    reciprocal term is the random-batch estimator drawn from
    ``generator``; self, direct, exclusion, flux charges, the poisons and
    the freshness guard are unchanged.  Requires a periodic orthorhombic
    system; its box is read on the host here, once.  The bonded terms run
    on the system's kernel route."""
    from .bonded import bonded_energy, follow_route
    from .charges import effective_charges
    from .energy import energy_components_fixed_charges
    from .integrate import _energy_and_forces
    from .neighbors import build_neighbor_state, neighbor_state_fresh
    from .utils.profiling import phase_scope

    spec = system.spec
    if not spec.pbc:
        raise ValueError("RBE is an Ewald reciprocal estimator; the "
                         "system must be periodic")
    tables = rbe_tables(system.box, spec.alpha)
    has_cells = spec.direct_method == "cell"
    bonded = follow_route(bonded, system)

    def init_nb(x):
        return build_neighbor_state(x, system) if has_cells else None

    def energy(x, nb, generator):
        with phase_scope("cf_charges", x) as st:
            q = st.output(effective_charges(*st.inputs, system))
        comps = energy_components_fixed_charges(x, q, system, nb=nb,
                                                include_recip=False)
        with phase_scope("cf_reciprocal", x, q) as st:
            e = sum(comps.values()) + st.output(rbe_reciprocal_energy(
                *st.inputs, tables, n_samples, generator))
        if bonded is not None:
            e = e + bonded_energy(x, bonded)
        return e

    def e_fn(x, nb, generator):
        e, f = _energy_and_forces(lambda xx: energy(xx, nb, generator), x)
        if not guard or nb is None:
            return e, f, nb
        bad = torch.where(neighbor_state_fresh(nb, x, system), 1.0,
                          torch.nan).to(e.dtype)
        return e * bad, f * bad, nb

    e_fn.tables = tables
    return e_fn, init_nb


def rbe_langevin_trajectory_nb(state, e_fn, init_nb, masses, dt: float,
                               temperature: float, friction: float,
                               generator: torch.Generator, n_steps: int,
                               rebuild_every: int = 10, graph: bool = True):
    """BAOAB Langevin with a fresh RBE draw every step (the thermostat
    absorbs the estimator's variance), on ``make_rbe_nb_energy_fn``'s
    ``e_fn``: the chunks of ``integrate.langevin_trajectory_nb`` (a
    neighbor rebuild, then ``rebuild_every`` steps, a remainder as one
    shorter chunk; each a CUDA graph replay on a CUDA device unless
    ``graph=False``).  Each step draws its O-step normals, then its
    k-vectors, from ``generator``; the final potential is one more draw.
    Returns (final_state, per-step kinetic energies)."""
    from .integrate import (Chunk, MDStateNB, _baoab_step, _check_generator,
                            _chunk_getter, _require_steps, _run_chunks)
    from .utils.profiling import phase_scope

    _require_steps(n_steps)
    x = state.positions
    _check_generator(generator, x.device)

    def make(k):
        return Chunk(lambda m, g: _baoab_step(
            lambda xx, nb: e_fn(xx, nb, g)[:2], m, dt, temperature,
            friction, g), init_nb, k, (x,) * 3, graph, masses, generator)

    key = ("rbe_langevin_nb", init_nb, float(dt), float(temperature),
           float(friction))
    chunk, kes = _run_chunks(_chunk_getter(e_fn, graph, x, masses, key, make),
                             (x, state.velocities, state.forces), n_steps,
                             rebuild_every, masses, generator)
    with phase_scope("cf.md.final"):
        x_fin = chunk.x.clone()
        nb = init_nb(x_fin)
        e_pot, _f, nb = e_fn(x_fin, nb, generator)
    return MDStateNB(x_fin, chunk.v.clone(), chunk.f.clone(), e_pot,
                     nb), kes
