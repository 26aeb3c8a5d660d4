"""Velocity-Verlet NVE (torch counterpart of the NVE trajectories of
``chargeflux_tpu.integrate``).

The JAX package compiles a trajectory chunk into one device program: a
neighbor rebuild, then ``lax.scan`` over the chunk's steps.  Here a chunk
is a :class:`NVEChunk`: it works on static buffers (positions, velocities,
forces, the potential, the chunk's per-step total energies and, on the
cell route, the neighbor state), and on a CUDA device it is captured once
into a CUDA graph and replayed, one ``replay()`` per chunk.  ``graph=False``
runs the same chunk code eagerly on the card (the control the replays are
held to, bit for bit); on the CPU that code always runs eagerly.  A failed
capture or replay raises.

Capture needs an evaluation that makes no host-to-device copy and reads
no device value on the host: the constants it reads are kept on the
device (``device.constant``), the binning takes its cell starts from the
sorted ids, and each chunk's first capture follows one eager warm-up step
on the capture's side stream, which fills every cache (constants, cuFFT
plans, the kernel library).  The graphs are kept on the energy function
(:func:`chunk_for`) and replayed by every later call with the same energy
function, masses tensor, dt and chunk length; each call copies the
caller's state into the static buffers first.

The kernel wrappers count their launches when they run, so at capture;
a chunk keeps the capture's counts apart (``ops.captured_launches``) and
adds them at every replay (``ops.launch_counts()`` then counts what ran on
the card).

On the cell route the neighbor state is rebuilt at the start of each
chunk, and in between the energy function's freshness guard NaN-poisons
energy and forces if an atom moved past skin/2.  The dense route has no
neighbor state (``nb`` is ``None``): its chunk is the steps alone.  The TPU
packed [N, 9] carry modes are layout workarounds and are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from . import ops
from .bonded import bonded_energy
from .device import device_key, resolve_device
from .energy import _energy
from .neighbors import NeighborState, build_neighbor_state, neighbor_state_fresh
from .units import BOLTZ


@dataclasses.dataclass(frozen=True)
class MDState:
    positions: torch.Tensor   # [N, 3] nm
    velocities: torch.Tensor  # [N, 3] nm/ps
    forces: torch.Tensor      # [N, 3] kJ/mol/nm
    potential: torch.Tensor   # scalar kJ/mol


@dataclasses.dataclass(frozen=True)
class MDStateNB:
    positions: torch.Tensor   # [N, 3] nm
    velocities: torch.Tensor  # [N, 3] nm/ps
    forces: torch.Tensor      # [N, 3] kJ/mol/nm
    potential: torch.Tensor   # scalar kJ/mol
    nb: object                # neighbors.NeighborState, None when dense


def kinetic_energy(velocities, masses) -> torch.Tensor:
    return 0.5 * torch.sum(masses[:, None] * velocities * velocities)


def temperature(velocities, masses, n_constraints: int = 0) -> torch.Tensor:
    """Instantaneous kinetic temperature in K: 2K / ((3N - n_c) kB)."""
    n_dof = 3.0 * velocities.shape[0] - n_constraints
    return 2.0 * kinetic_energy(velocities, masses) / (n_dof * BOLTZ)


def maxwell_velocities(masses, temp: float, generator: torch.Generator,
                       dtype=None, zero_momentum: bool = True) -> torch.Tensor:
    """Maxwell-Boltzmann velocities at ``temp`` K (nm/ps), with the
    center-of-mass drift removed by default and the drift-free velocities
    rescaled by sqrt(3N / (3N - 3)) to restore the expected kinetic energy,
    as in the JAX package.

    They are made on the device of ``masses`` where it is a tensor, else on
    the card (``device.resolve_device``); ``generator`` must be on that
    device, or this raises.  The noise comes from ``generator``
    (``torch.randn``), so it is not the JAX package's ``jax.random``
    stream: the two agree in distribution only."""
    dev = device_key(masses.device if torch.is_tensor(masses)
                     else resolve_device(None))
    if device_key(generator.device) != dev:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"velocities are made on {dev}: pass a generator "
                         f"of that device")
    dtype = dtype or torch.get_default_dtype()
    m = torch.as_tensor(masses, device=dev).to(dtype)
    n = m.shape[0]
    sigma = torch.sqrt(BOLTZ * temp / m)[:, None]
    v = sigma * torch.randn((n, 3), generator=generator, dtype=dtype,
                            device=dev)
    if zero_momentum and n > 1:
        v = v - torch.sum(m[:, None] * v, dim=0) / torch.sum(m)
        v = v * (3.0 * n / (3.0 * n - 3.0)) ** 0.5
    return v


def remove_com_motion(velocities, masses) -> torch.Tensor:
    """Zero the center-of-mass momentum (OpenMM CMMotionRemover analog)."""
    m = torch.as_tensor(masses, device=velocities.device).to(velocities.dtype)
    p = torch.sum(velocities * m[:, None], dim=0)
    return velocities - (p / torch.sum(m))[None, :]


def _energy_and_forces(energy_fn, x):
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy_fn(xg)
        (g,) = torch.autograd.grad(e, xg)
    return e.detach(), -g


def make_energy_fn(system, bonded=None, plain: bool = False):
    """Charge-flux electrostatics (plus the optional bonded terms) as
    ``energy_fn(positions) -> scalar``; ``plain=True`` runs the kernels'
    plain-PyTorch versions."""

    def e_fn(x):
        e = _energy(x, system, plain=plain)
        if bonded is not None:
            e = e + bonded_energy(x, bonded)
        return e

    return e_fn


def init_state(positions, velocities, energy_fn) -> MDState:
    e, f = _energy_and_forces(energy_fn, positions)
    return MDState(positions, velocities, f, e)


def nve_step(state: MDState, energy_fn, masses, dt: float) -> MDState:
    """One velocity-Verlet step.  masses [N] in amu; dt in ps."""
    inv_m = (1.0 / masses)[:, None]
    x, v, f, e = _verlet(energy_fn, inv_m, dt, state.positions,
                         state.velocities, state.forces, None)
    return MDState(x, v, f, e)


def _verlet(energy_fn, inv_m, dt, x, v, f, nb):
    """``nve_step``'s arithmetic (v += dt/2 f/m; x += dt v; f = F(x);
    v += dt/2 f/m); ``nb`` is unused."""
    v_half = v + 0.5 * dt * f * inv_m
    x_new = x + dt * v_half
    e, f_new = _energy_and_forces(energy_fn, x_new)
    return x_new, v_half + 0.5 * dt * f_new * inv_m, f_new, e


def make_nb_energy_fn(system, bonded=None, plain: bool = False):
    """Returns (e_fn, init_nb): ``e_fn(x, nb) -> (energy, forces, nb)``
    evaluates with a reused neighbor state (charge-flux electrostatics plus
    the optional bonded terms), ``init_nb(x)`` rebuilds one.  A stale state
    poisons energy and forces to NaN.  On the dense route there is nothing
    to reuse: ``init_nb`` returns ``None`` and no guard applies.
    ``plain=True`` runs the kernels' plain-PyTorch versions (the f64
    control and the kernel-vs-plain step timing of ``utils.measure`` use
    it)."""
    has_cells = system.spec.direct_method == "cell"

    def init_nb(x):
        return build_neighbor_state(x, system) if has_cells else None

    def energy(x, nb):
        e = _energy(x, system, nb=nb, plain=plain)
        if bonded is not None:
            e = e + bonded_energy(x, bonded)
        return e

    def e_fn(x, nb):
        e, f = _energy_and_forces(lambda xx: energy(xx, nb), x)
        if nb is None:
            return e, f, nb
        bad = torch.where(neighbor_state_fresh(nb, x, system), 1.0,
                          torch.nan).to(e.dtype)
        return e * bad, f * bad, nb

    return e_fn, init_nb


def init_state_nb(positions, velocities, e_fn, init_nb) -> MDStateNB:
    nb = init_nb(positions)
    e, f, nb = e_fn(positions, nb)
    return MDStateNB(positions, velocities, f, e, nb)


def nve_step_nb(state: MDStateNB, e_fn, masses, dt: float) -> MDStateNB:
    """One velocity-Verlet step with the state's neighbor state."""
    half = (0.5 * dt / masses)[:, None]
    x, v, f, e = _verlet_nb(e_fn, half, dt, state.positions,
                            state.velocities, state.forces, state.nb)
    return MDStateNB(x, v, f, e, state.nb)


def _verlet_nb(e_fn, half, dt, x, v, f, nb):
    """The JAX package's packed-chunk step (v += f * (dt/2m); x += dt v;
    f = F(x, nb); v += f * (dt/2m))."""
    v_half = v + f * half
    x_new = x + dt * v_half
    e, f_new, _ = e_fn(x_new, nb)
    return x_new, v_half + f_new * half, f_new, e


class NVEChunk:
    """One trajectory chunk on static buffers: a neighbor rebuild where
    ``rebuild`` gives one, then ``k`` velocity-Verlet steps (the JAX
    package's ``outer`` of ``make_packed_nve_chunk``).

    ``step(x, v, f, nb) -> (x, v, f, potential)`` is one step; the chunk
    writes its last positions, velocities, forces and potential and its
    per-step total energies ``es`` [k] into the buffers in place.  With
    ``graph`` (a CUDA device) the first :meth:`load` captures the chunk
    into a CUDA graph, after one eager warm-up step on the capture's side
    stream, and each call replays it."""

    def __init__(self, step, rebuild, masses, k: int, like: torch.Tensor,
                 graph: bool):
        self.step, self.rebuild, self.masses, self.k = step, rebuild, masses, k
        self.x, self.v, self.f = (torch.empty_like(like) for _ in range(3))
        self.potential = like.new_empty(())
        self.es = like.new_empty((k,))
        self.nb = None            # static NeighborState after the first rebuild
        self.want_graph = graph and like.is_cuda
        self.graph = None
        self.captured = {}        # kernel launches of one replay

    def load(self, x, v, f):
        """Copy a state into the static inputs (capturing first, if this
        chunk replays a graph that is not captured yet)."""
        if self.want_graph and self.graph is None:
            self._copy_in(x, v, f)
            self._capture()
        self._copy_in(x, v, f)

    def _copy_in(self, x, v, f):
        self.x.copy_(x)
        self.v.copy_(v)
        self.f.copy_(f)

    def __call__(self):
        """Advance the static state by one chunk."""
        if self.graph is None:
            self.run()
            return
        self.graph.replay()
        ops.add_launches(self.captured)

    def run(self, n_steps: int | None = None):
        """The chunk's work, eagerly, on the static buffers (``n_steps``
        of its ``k`` steps)."""
        x, v, f = self.x, self.v, self.f
        nb = self._rebuild(x) if self.rebuild is not None else None
        es = []
        for _ in range(self.k if n_steps is None else n_steps):
            x, v, f, e = self.step(x, v, f, nb)
            es.append(e + kinetic_energy(v, self.masses))
        self._copy_in(x, v, f)
        self.potential.copy_(e)
        self.es[:len(es)].copy_(torch.stack(es))

    def _rebuild(self, x):
        nb = self.rebuild(x)
        if nb is None:                                  # the dense route
            return None
        if self.nb is None:      # the first rebuild runs eagerly: warm-up
            self.nb = NeighborState(*(getattr(nb, f.name).clone() for f in
                                      dataclasses.fields(NeighborState)))
        else:
            for fld in dataclasses.fields(NeighborState):
                getattr(self.nb, fld.name).copy_(getattr(nb, fld.name))
        return self.nb

    def _capture(self):
        side = torch.cuda.Stream(self.x.device)
        side.wait_stream(torch.cuda.current_stream(self.x.device))
        with torch.cuda.stream(side):
            self.run(n_steps=1)            # fills every cache before capture
        torch.cuda.current_stream(self.x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with ops.captured_launches() as self.captured:
            with torch.cuda.graph(graph, stream=side):
                self.run()
        self.graph = graph


def chunk_for(energy_fn, make, key) -> NVEChunk:
    """The chunk ``make()`` builds for ``key``, kept on ``energy_fn`` (in
    its ``nve_chunks`` attribute) so that later calls replay its graph.  A
    chunk, its graph and the graph's memory pool live as long as the energy
    function; a trajectory call uses at most two (its chunk length and its
    remainder's).  The chunk holds the key's tensors,
    so their ids in ``key`` stay theirs."""
    kept = energy_fn.__dict__.setdefault("nve_chunks", {})
    if key not in kept:
        kept[key] = make()
    return kept[key]


def _run_chunks(get_chunk, x, v, f, n_steps: int, k: int):
    """``n_steps`` in chunks of ``k`` steps, then one chunk of the
    remainder (the JAX package's ``outer`` and ``outer_rem``); returns the
    last chunk run and the per-step total energies [n_steps]."""
    es = x.new_empty((n_steps,))
    n_full, rem = divmod(n_steps, k)
    done, chunk = 0, None
    for length, count in ((k, n_full), (rem, 1 if rem else 0)):
        if count == 0:
            continue
        chunk = get_chunk(length)
        chunk.load(x, v, f)
        for _ in range(count):
            chunk()
            es[done:done + length].copy_(chunk.es)
            done += length
        x, v, f = chunk.x, chunk.v, chunk.f
    return chunk, es


def nve_trajectory_nb(state: MDStateNB, e_fn, init_nb, masses, dt: float,
                      n_steps: int, rebuild_every: int = 10,
                      graph: bool = True):
    """``n_steps`` of NVE with the neighbor state rebuilt every
    ``rebuild_every`` steps (at the start of each chunk); returns
    (final_state, per-step total energies [n_steps]).  The final state
    keeps the last step's forces and carries a fresh neighbor state and
    the potential evaluated with it (an eager evaluation).  On a CUDA
    device each chunk is a CUDA graph replay unless ``graph=False``."""
    if n_steps == 0:
        return state, state.positions.new_zeros((0,))
    x = state.positions

    def get_chunk(k):
        def make():
            half = (0.5 * dt / masses)[:, None]

            def step(x, v, f, nb):
                return _verlet_nb(e_fn, half, dt, x, v, f, nb)
            return NVEChunk(step, init_nb, masses, k, x, graph)

        if not (graph and x.is_cuda):
            return make()
        key = ("nb", init_nb, id(masses), float(dt), k, tuple(x.shape),
               x.dtype, x.device)
        return chunk_for(e_fn, make, key)

    chunk, es = _run_chunks(get_chunk, x, state.velocities, state.forces,
                            n_steps, rebuild_every)
    x_fin = chunk.x.clone()
    nb = init_nb(x_fin)
    e_pot, _f, nb = e_fn(x_fin, nb)
    return MDStateNB(x_fin, chunk.v.clone(), chunk.f.clone(), e_pot, nb), es


#: Steps per chunk of :func:`nve_trajectory`, which has no rebuild interval.
STEPS_PER_CHUNK = 10


def nve_trajectory(state: MDState, energy_fn, masses, dt: float,
                   n_steps: int, graph: bool = True):
    """``n_steps`` of NVE; returns (final_state, per-step total energies).
    The final state keeps the last step's potential.  The steps run in
    chunks of :data:`STEPS_PER_CHUNK` (then one of the remainder), each a
    CUDA graph replay on a CUDA device unless ``graph=False``; on the cell
    route each step bins anew."""
    if n_steps == 0:
        return state, state.positions.new_zeros((0,))
    x = state.positions

    def get_chunk(k):
        def make():
            inv_m = (1.0 / masses)[:, None]

            def step(x, v, f, nb):
                return _verlet(energy_fn, inv_m, dt, x, v, f, nb)
            return NVEChunk(step, None, masses, k, x, graph)

        if not (graph and x.is_cuda):
            return make()
        key = ("plain", id(masses), float(dt), k, tuple(x.shape), x.dtype,
               x.device)
        return chunk_for(energy_fn, make, key)

    last, es = _run_chunks(get_chunk, x, state.velocities, state.forces,
                           n_steps, STEPS_PER_CHUNK)
    return MDState(last.x.clone(), last.v.clone(), last.f.clone(),
                   last.potential.clone()), es
