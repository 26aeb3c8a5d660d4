"""Integrators (torch counterpart of ``chargeflux_tpu.integrate``):
velocity-Verlet NVE, BAOAB Langevin NVT, impulse r-RESPA (NVE and NVT) and
FIRE minimization.

The JAX package compiles a trajectory chunk into one device program: a
neighbor rebuild, then ``lax.scan`` over the chunk's steps.  Here a chunk
is a :class:`Chunk`: it works on static buffers (the carry: positions,
velocities, forces and, for r-RESPA, the fast forces apart; the potential,
the chunk's per-step records and, on the cell route, the neighbor state),
and on a CUDA device it is captured once into a CUDA graph and replayed,
one ``replay()`` per chunk.  ``graph=False`` runs the same chunk code
eagerly on the card (the control the replays are held to, bit for bit); on
the CPU that code always runs eagerly.  A failed capture or replay raises.

Capture needs an evaluation that makes no host-to-device copy and reads
no device value on the host: the constants it reads are kept on the
device (``device.constant``), the binning takes its cell starts from the
sorted ids, and each chunk's first capture follows one eager warm-up step
on the capture's side stream, which fills every cache (constants, cuFFT
plans, the kernel library).  The graphs are kept on the energy function
(:func:`chunk_for`) under a key of what they compute (:func:`chunk_key`:
the driver and its float coefficients, the chunk length, the shapes,
types and device), and replayed by every later call with the same key;
each call copies the caller's state and masses into the chunk's own
buffers first.

Noise.  The stochastic drivers take a ``torch.Generator`` where the JAX
package takes a PRNG key, and draw every O-step's normals through
:func:`normal_noise`.  A generator continues where its last draw left it,
so the JAX package's ``advance_key`` has no counterpart: to resume, pass
the same generator on.  One call of 2n steps of
:func:`langevin_trajectory_nb` equals two calls of n steps with the
generator carried across, bit for bit (the final state keeps the carry
forces); ``constraints.rattle_langevin_trajectory_nb`` resumes to
round-off, as in the JAX package.  A chunk that replays a graph owns a
generator of its own, registered with the graph: before each replay it
takes the caller's generator state, after it gives the caller the state
it reached, so each replay draws the numbers an eager chunk draws from the
same generator state and advances the caller's generator as far.  Any
generator of the device replays the same graph.
The normals are torch's, not ``jax.random``'s: the two packages agree in
distribution, and the tests hold the drivers to the JAX package by handing
both the same normals.

The kernel wrappers count their launches when they run, so at capture;
a chunk keeps the capture's counts apart (``ops.captured_launches``) and
adds them at every replay (``ops.launch_counts()`` then counts what ran on
the card).

Tracing (``utils.profiling``).  A chunk's graph opens and closes with the
stamps of the stage ``replay``, around the energy's own stage stamps.
The capture is instantiated twice (``profiling.GraphStamps``): as the
graph's own without the stamps, which ``graph.replay()`` runs, and with
them, which a chunk call launches instead while a profiler records (and
then counts the replay, and the r-RESPA steps the capture ran).  An
r-RESPA outer step's fast tier is the stage ``respa_fast``.  The host
work of a call runs in the spans ``cf.md.call`` (the chunks),
``cf.md.load`` (the copy-in), ``cf.md.capture``, ``cf.md.replay``
(``graph.replay()``) and ``cf.md.final`` (the eager rebuild and
evaluation at the end).

On the cell route the neighbor state is rebuilt at the start of each
chunk, and in between the energy function's freshness guard NaN-poisons
energy and forces if an atom moved past skin/2.  The dense route has no
neighbor state (``nb`` is ``None``): its chunk is the steps alone.  The TPU
packed-carry modes (``x_into_energy``, ``make_packed_*_chunk``) are layout
workarounds and are not ported: their counterpart is the chunk itself.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from . import ops
from .bonded import bonded_energy, follow_route
from .device import device_key, resolve_device
from .energy import _energy
from .neighbors import NeighborState, build_neighbor_state, neighbor_state_fresh
from .units import BOLTZ
from .utils import profiling
from .utils.profiling import phase_scope


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


@dataclasses.dataclass(frozen=True)
class RespaStateNB(MDStateNB):
    """The state the r-RESPA drivers return: ``forces`` and ``potential``
    evaluated afresh at the final positions, and beside them the tier
    forces the last replayed outer step left in the chunk's carry, both at
    the same positions: ``f_slow`` (the slow tier, on the chunk's reused
    neighbor state) and ``f_fast`` (the fast tier, of the last substep).
    A RESPA driver handed such a state starts its carry from these tier
    forces and evaluates nothing first, so two calls of n outer steps
    give one call of 2n (n a multiple of ``rebuild_every``).  A state
    whose positions changed since it was returned goes in as an
    :class:`MDStateNB`, whose tiers the driver evaluates."""
    f_slow: torch.Tensor      # [N, 3] kJ/mol/nm
    f_fast: torch.Tensor      # [N, 3] kJ/mol/nm


def kinetic_energy(velocities, masses) -> torch.Tensor:
    return 0.5 * torch.sum(masses[:, None] * velocities * velocities)


def temperature(velocities, masses, n_constraints: int = 0) -> torch.Tensor:
    """Instantaneous kinetic temperature in K: 2K / ((3N - n_c) kB)."""
    n_dof = 3.0 * velocities.shape[0] - n_constraints
    return 2.0 * kinetic_energy(velocities, masses) / (n_dof * BOLTZ)


def _check_generator(generator, dev):
    if device_key(generator.device) != device_key(dev):
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"tensors are on {dev}: pass a generator of that "
                         f"device")


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
    _check_generator(generator, dev)
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


def make_energy_fn(system, bonded=None):
    """Charge-flux electrostatics (plus the optional bonded terms) as
    ``energy_fn(positions) -> scalar``, on the system's kernel route (the
    bonded terms' too: ``bonded.follow_route``)."""
    bonded = follow_route(bonded, system)

    def e_fn(x):
        e = _energy(x, system)
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


def make_nb_energy_fn(system, bonded=None):
    """Returns (e_fn, init_nb): ``e_fn(x, nb) -> (energy, forces, nb)``
    evaluates with a reused neighbor state (charge-flux electrostatics plus
    the optional bonded terms), ``init_nb(x)`` rebuilds one.  A stale state
    poisons energy and forces to NaN.  On the dense route there is nothing
    to reuse: ``init_nb`` returns ``None`` and no guard applies.  Both
    run on the system's kernel route, the binning and the bonded terms
    included."""
    has_cells = system.spec.direct_method == "cell"
    bonded = follow_route(bonded, system)

    def init_nb(x):
        return build_neighbor_state(x, system) if has_cells else None

    def energy(x, nb):
        e = _energy(x, system, nb=nb)
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


# ---------------------------------------------------------------------------
# Trajectory chunks
# ---------------------------------------------------------------------------


class Chunk:
    """One trajectory chunk on static buffers: a neighbor rebuild where
    ``rebuild`` gives one, then ``k`` steps (the JAX package's ``outer`` of
    its packed chunks).

    ``make_step(masses, generator)`` gives ``step(carry, nb) -> (carry,
    potential, record)``, one step on the carry, a tuple of tensors with
    the positions first; the chunk writes its last carry and potential and
    its per-step records ``es`` [k, *record_shape] into the buffers in
    place.  The chunk starts with its head, ``head(carry, rebuild) ->
    (carry, nb, records)``: by default the rebuild alone, recording
    nothing; ``make_head(masses, generator)``, where given, gives another
    (the barostat's attempt, npt.py).  ``rebuild(x, *args)`` rebuilds into
    the chunk's neighbor state, the steps get the ``nb`` the head returns,
    and the chunk keeps the ``records``, a tuple of tensors, in
    ``head_records``.  The step
    reads the masses and draws its noise (``generator``; None for the
    deterministic drivers) from what it is given: the caller's own on the
    CPU or with ``graph=False``.  With ``graph`` (a CUDA device) the chunk
    owns a masses buffer and a generator, and the first :meth:`load`
    captures it into a CUDA graph, after one eager warm-up step on the
    capture's side stream; each call replays it.  :meth:`load` copies the
    caller's masses in, and a replay runs from the caller's generator
    state and hands back the state it reached.  ``keep`` holds the
    objects whose ids are in the chunk's key (see :func:`chunk_key`).
    ``potential_shape`` is the shape of the step's potential: [R] for a
    replica ensemble (``parallel.replicas``)."""

    def __init__(self, make_step, rebuild, k: int, carry_like, graph: bool,
                 masses, generator=None, keep=(), make_head=None,
                 record_shape=(), potential_shape=()):
        self.rebuild, self.k = rebuild, k
        self.carry = tuple(torch.empty_like(t) for t in carry_like)
        like = self.carry[0]
        self.potential = like.new_empty(tuple(potential_shape))
        self.es = like.new_empty((k,) + tuple(record_shape))
        self.head_records = None  # static buffers after the first head
        self.nb = None            # static NeighborState after the first rebuild
        self.want_graph = graph and like.is_cuda
        if self.want_graph:
            masses = torch.empty_like(masses)
            if generator is not None:
                generator = torch.Generator(like.device)
        self.masses, self.generator = masses, generator
        self.source = None        # the caller's generator of a replay
        self.step = make_step(masses, generator)
        self.head = (self._rebuild_head if make_head is None
                     else make_head(masses, generator))
        self.keep = keep
        self.graph = None
        self.stamps = None        # the graph's stamps (profiling)
        self.rng_graph, self.rng_step = None, 0   # for a stamped replay
        self.captured = {}        # kernel launches of one replay
        self.capture_bytes = 0    # device memory the graph's pool reserved
        self.capture_seconds = 0.0  # the capture, its warm-up step included

    @property
    def x(self):
        return self.carry[0]

    @property
    def v(self):
        return self.carry[1]

    @property
    def f(self):
        return self.carry[2]

    def load(self, *carry, masses=None, generator=None):
        """Copy a state into the static inputs and, for a chunk that
        replays a graph, the caller's ``masses`` into its own and
        ``generator`` as the one its replays follow (capturing first, if
        the graph is not captured yet)."""
        with phase_scope("cf.md.load"):
            if self.want_graph:
                self.masses.copy_(masses)
                self.source = generator
                if self.graph is None:
                    self._copy_in(carry)
                    self._capture()
            self._copy_in(carry)

    def _copy_in(self, carry):
        for buf, t in zip(self.carry, carry):
            buf.copy_(t)

    def __call__(self):
        """Advance the static state by one chunk."""
        if self.graph is None:
            self.run()
            return
        stamped = self.stamps.sync()
        own, source = self.generator, self.source
        if own is not None:
            own.set_state(source.get_state())
        with phase_scope("cf.md.replay"):
            if stamped:
                self._replay_stamped()
            else:
                self.graph.replay()
        if own is not None:
            source.set_state(own.get_state())
        ops.add_launches(self.captured)
        profiling.count_replay(self.k, self.stamps.respa)

    def _replay_stamped(self):
        """The graph with its stage stamps (while a profiler records).  The
        chunk's generator is taken as ``graph.replay()`` takes it: a replay
        of ``rng_graph`` sets the captured draws' seed and offset from it,
        and it advances by what a replay of the graph draws."""
        gen = self.generator
        if gen is not None:
            offset = gen.get_offset()
            self.rng_graph.replay()
        self.stamps.launch()
        if gen is not None:
            gen.set_offset(offset + self.rng_step)

    def run(self, n_steps: int | None = None):
        """The chunk's work, eagerly, on the static buffers (``n_steps``
        of its ``k`` steps)."""
        carry, nb, records = self.head(self.carry, self._rebuild)
        if self.head_records is None:       # the first run is eager
            self.head_records = tuple(r.clone() for r in records)
        else:
            for buf, r in zip(self.head_records, records):
                buf.copy_(r)
        es = []
        for _ in range(self.k if n_steps is None else n_steps):
            carry, e, record = self.step(carry, nb)
            es.append(record)
        self._copy_in(carry)
        self.potential.copy_(e)
        self.es[:len(es)].copy_(torch.stack(es))

    def _rebuild_head(self, carry, rebuild):
        """The default head: the rebuild alone, recording nothing."""
        return (carry, rebuild(carry[0]) if self.rebuild is not None
                else None, ())

    def _rebuild(self, x, *args):
        nb = self.rebuild(x, *args)
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
        # the stamps' record is made before the capture, and the stamp
        # nodes are collected as it runs
        with (phase_scope("cf.md.capture"),
              profiling.capture_stamps(self.x.device) as stamps):
            self._capture_graph(stamps)

    def _capture_graph(self, stamps):
        # the warm-up step draws from the chunk's own generator, whose
        # state each replay sets anew
        gen = self.generator
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.x.device)
        side.wait_stream(torch.cuda.current_stream(self.x.device))
        with torch.cuda.stream(side):
            self.run(n_steps=1)            # fills every cache before capture
        torch.cuda.current_stream(self.x.device).wait_stream(side)
        # its template kept, so that the stamps can be taken out of it
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if gen is not None:
            graph.register_generator_state(gen)
        # A chunk kept on an energy function is in a reference cycle (the
        # function holds the chunk, whose step holds the function), so a
        # dropped one waits for the cyclic collector; destroying its graph
        # while this stream captures would invalidate the capture.  Collect
        # now, and hold the collector off until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        # the capture empties the allocator's cache as it starts; empty it
        # first, so that what it reserves after is the graph's pool
        torch.cuda.empty_cache()
        pool0 = torch.cuda.memory_reserved(self.x.device)
        try:
            with ops.captured_launches() as self.captured:
                with torch.cuda.graph(graph, stream=side):
                    # the graph's first and last nodes: the stage "replay"
                    with phase_scope("cf_replay", self.x):
                        self.run()
        finally:
            if collecting:
                gc.enable()
        stamps.attach(graph)      # instantiates it with and without stamps
        if gen is not None and stamps.nodes:
            self.rng_graph, self.rng_step = _rng_prologue(gen, graph, side)
        self.graph, self.stamps = graph, stamps
        # the graph's private memory pool: what the card reserved for it
        self.capture_bytes = torch.cuda.memory_reserved(self.x.device) - pool0
        self.capture_seconds = time.perf_counter() - t0


def _rng_prologue(gen, graph, stream):
    """A graph of one draw from ``gen`` (its replay first sets the RNG seed
    and offset of every graph that registered ``gen`` from ``gen``, as
    ``graph.replay()`` does: a graph that draws nothing would not), and the
    offset by which a replay of ``graph`` advances ``gen`` (from one
    replay, whose work the caller overwrites)."""
    rng = torch.cuda.CUDAGraph()
    rng.register_generator_state(gen)
    rng.scratch = torch.zeros(1, device=gen.device)
    with torch.cuda.graph(rng, stream=stream):
        rng.scratch.uniform_(generator=gen)
    offset = gen.get_offset()
    graph.replay()
    step = gen.get_offset() - offset
    gen.set_offset(offset)
    return rng, step


def chunk_for(energy_fn, make, key) -> Chunk:
    """The chunk ``make()`` builds for ``key``, kept on ``energy_fn`` (in
    its ``nve_chunks`` attribute, which holds every driver's chunks) so
    that later calls replay its graph.  A chunk, its graph and the graph's
    memory pool live as long as the energy function; a trajectory call
    uses at most two (its chunk length and its remainder's).  The chunk
    holds the objects whose ids are in ``key`` (constraint parameters, the
    fast force function), so their ids stay theirs."""
    kept = energy_fn.__dict__.setdefault("nve_chunks", {})
    if key not in kept:
        kept[key] = make()
    return kept[key]


def chunk_key(base: tuple, k: int, like, masses) -> tuple:
    """The key a chunk of ``k`` steps is kept under: ``base`` (the driver,
    its float coefficients and the ids of the functions and parameters it
    closes over), then ``k`` and the shapes, types and device of the carry
    (``like``) and the masses.  No tensor or generator identity enters it:
    fresh masses tensors and generators replay one graph."""
    return base + (k, tuple(like.shape), like.dtype, device_key(like.device),
                   tuple(masses.shape), masses.dtype)


def _chunk_getter(owner, graph: bool, like, masses, key, make):
    """``get_chunk(k)`` for :func:`_run_chunks`: ``make(k)`` eagerly on the
    CPU or with ``graph=False``, else the chunk kept on ``owner`` under
    :func:`chunk_key`."""
    def get_chunk(k):
        if not (graph and like.is_cuda):
            return make(k)
        return chunk_for(owner, lambda: make(k),
                         chunk_key(key, k, like, masses))
    return get_chunk


def _run_chunks(get_chunk, carry, n_steps: int, k: int, masses,
                generator=None):
    """``n_steps`` in chunks of ``k`` steps, then one chunk of the
    remainder (the JAX package's ``outer`` and ``outer_rem``), on
    ``masses`` and drawing from ``generator``; returns the last chunk run
    and the per-step records [n_steps, *record_shape]."""
    es = None
    n_full, rem = divmod(n_steps, k)
    done, chunk = 0, None
    with phase_scope("cf.md.call"):
        for length, count in ((k, n_full), (rem, 1 if rem else 0)):
            if count == 0:
                continue
            chunk = get_chunk(length)
            if es is None:
                es = chunk.es.new_empty((n_steps,) + chunk.es.shape[1:])
            chunk.load(*carry, masses=masses, generator=generator)
            for _ in range(count):
                chunk()
                es[done:done + length].copy_(chunk.es)
                done += length
            carry = chunk.carry
    return chunk, es


def _final_nb(chunk, e_fn, init_nb) -> MDStateNB:
    """The state a ``*_nb`` driver returns: the last carry's positions,
    velocities and forces, a fresh neighbor state and the potential
    evaluated with it (an eager evaluation)."""
    with phase_scope("cf.md.final"):
        x_fin = chunk.x.clone()
        nb = init_nb(x_fin)
        e_pot, _f, nb = e_fn(x_fin, nb)
        return MDStateNB(x_fin, chunk.v.clone(), chunk.f.clone(), e_pot, nb)


def _require_steps(n_steps: int):
    if n_steps <= 0:
        raise ValueError("n_steps must be positive")


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

    def make_step(m, _generator):
        def step(carry, nb):
            x, v, f, e = _verlet_nb(e_fn, (0.5 * dt / m)[:, None], dt,
                                    *carry, nb)
            return (x, v, f), e, e + kinetic_energy(v, m)
        return step

    def make(k):
        return Chunk(make_step, init_nb, k, (x,) * 3, graph, masses)

    get_chunk = _chunk_getter(e_fn, graph, x, masses,
                              ("nb", init_nb, float(dt)), make)
    chunk, es = _run_chunks(get_chunk, (x, state.velocities, state.forces),
                            n_steps, rebuild_every, masses)
    return _final_nb(chunk, e_fn, init_nb), es


#: Steps per chunk of the drivers that have no rebuild interval
#: (:func:`nve_trajectory`, :func:`langevin_trajectory` and the dense
#: RATTLE drivers of ``constraints``).
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

    def make_step(m, _generator):
        def step(carry, nb):
            x, v, f, e = _verlet(energy_fn, (1.0 / m)[:, None], dt, *carry,
                                 nb)
            return (x, v, f), e, e + kinetic_energy(v, m)
        return step

    def make(k):
        return Chunk(make_step, None, k, (x,) * 3, graph, masses)

    get_chunk = _chunk_getter(energy_fn, graph, x, masses,
                              ("plain", float(dt)), make)
    last, es = _run_chunks(get_chunk, (x, state.velocities, state.forces),
                           n_steps, STEPS_PER_CHUNK, masses)
    return MDState(last.x.clone(), last.v.clone(), last.f.clone(),
                   last.potential.clone()), es


# ---------------------------------------------------------------------------
# Langevin (NVT) — BAOAB splitting
# ---------------------------------------------------------------------------


def normal_noise(like: torch.Tensor, generator: torch.Generator):
    """Standard normals of ``like``'s shape, type and device from
    ``generator``: every O-step of every driver draws here."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def baoab_coeffs(dt: float, friction: float, temperature: float):
    """(c1, c2) of the O-step, v <- c1 v + c2 sqrt(1/m) noise, as Python
    floats (the JAX package computes them in the trajectory's type)."""
    c1 = math.exp(-friction * dt)
    return c1, math.sqrt((1.0 - c1 * c1) * BOLTZ * temperature)


def baoab_pre_force(x, v, f, inv_m, dt, c1, c2, generator):
    """The B-A-O-A half of one BAOAB step (Leimkuhler-Matthews); the
    caller evaluates forces at the returned x and applies the final B
    half-kick.  Shared by every Langevin driver."""
    v = v + 0.5 * dt * f * inv_m                                    # B
    x = x + 0.5 * dt * v                                            # A
    noise = normal_noise(v, generator)
    v = c1 * v + c2 * torch.sqrt(inv_m) * noise                     # O
    x = x + 0.5 * dt * v                                            # A
    return x, v


def _baoab_step(force, masses, dt, temperature, friction, generator):
    """One BAOAB step as a :class:`Chunk` step; ``force(x, nb) -> (energy,
    forces)``.  Its record is the kinetic energy."""
    c1, c2 = baoab_coeffs(dt, friction, temperature)

    def step(carry, nb):
        inv_m = (1.0 / masses)[:, None]
        x, v = baoab_pre_force(*carry, inv_m, dt, c1, c2, generator)
        e, f = force(x, nb)
        v = v + 0.5 * dt * f * inv_m                                # B
        return (x, v, f), e, kinetic_energy(v, masses)
    return step


def langevin_step(state: MDState, energy_fn, masses, dt: float,
                  temperature: float, friction: float,
                  generator: torch.Generator) -> MDState:
    """One BAOAB Langevin step (Leimkuhler-Matthews splitting).  friction
    in 1/ps, temperature in K; the O-step draws from ``generator``."""
    _check_generator(generator, state.positions.device)
    step = _baoab_step(lambda x, nb: _energy_and_forces(energy_fn, x),
                       masses, dt, temperature, friction, generator)
    (x, v, f), e, _ = step((state.positions, state.velocities,
                            state.forces), None)
    return MDState(x, v, f, e)


def langevin_trajectory(state: MDState, energy_fn, masses, dt: float,
                        temperature: float, friction: float,
                        generator: torch.Generator, n_steps: int,
                        graph: bool = True):
    """``n_steps`` of BAOAB Langevin; returns (final_state, per-step
    kinetic energies).  The final state's potential is evaluated at its
    positions.  The steps run in chunks of :data:`STEPS_PER_CHUNK` (then
    one of the remainder), each a CUDA graph replay on a CUDA device
    unless ``graph=False``."""
    _require_steps(n_steps)
    x = state.positions
    _check_generator(generator, x.device)

    def make(k):
        return Chunk(lambda m, g: _baoab_step(
            lambda xx, nb: _energy_and_forces(energy_fn, xx), m, dt,
            temperature, friction, g), None, k, (x,) * 3, graph, masses,
            generator)

    key = ("langevin", float(dt), float(temperature), float(friction))
    last, kes = _run_chunks(
        _chunk_getter(energy_fn, graph, x, masses, key, make),
        (x, state.velocities, state.forces), n_steps, STEPS_PER_CHUNK,
        masses, generator)
    with phase_scope("cf.md.final"):
        x_fin = last.x.clone()
        with torch.no_grad():
            e_pot = energy_fn(x_fin)
    return MDState(x_fin, last.v.clone(), last.f.clone(), e_pot), kes


def langevin_trajectory_nb(state: MDStateNB, e_fn, init_nb, masses,
                           dt: float, temperature: float, friction: float,
                           generator: torch.Generator, n_steps: int,
                           rebuild_every: int = 10, graph: bool = True):
    """``n_steps`` of BAOAB Langevin with the neighbor state rebuilt every
    ``rebuild_every`` steps (at the start of each chunk; a remainder runs
    as one shorter chunk, where the JAX package asks for a multiple) — the
    NVT analog of :func:`nve_trajectory_nb`.  Returns (final_state,
    per-step kinetic energies).

    Exactly resumable: a second call from the returned state with the
    same generator continues the trajectory bit for bit (the final state
    keeps the carry forces the next chunk's first B kick consumes)."""
    _require_steps(n_steps)
    x = state.positions
    _check_generator(generator, x.device)

    def make(k):
        return Chunk(lambda m, g: _baoab_step(
            lambda xx, nb: e_fn(xx, nb)[:2], m, dt, temperature, friction,
            g), init_nb, k, (x,) * 3, graph, masses, generator)

    key = ("langevin_nb", init_nb, float(dt), float(temperature),
           float(friction))
    chunk, kes = _run_chunks(_chunk_getter(e_fn, graph, x, masses, key, make),
                             (x, state.velocities, state.forces), n_steps,
                             rebuild_every, masses, generator)
    return _final_nb(chunk, e_fn, init_nb), kes


# ---------------------------------------------------------------------------
# Multi-timestep r-RESPA (impulse / Verlet-I) — bonded inner steps
# ---------------------------------------------------------------------------


def make_respa_force_fns(system, bonded):
    """Split the force field into RESPA tiers: (slow_fn, fast_fn, init_nb).

    ``slow_fn(x, nb) -> (energy, forces, nb)`` is the charge-flux nonbonded
    tier with neighbor-state reuse and the freshness guard of
    :func:`make_nb_energy_fn`, evaluated once per outer step; ``fast_fn(x)
    -> (energy, forces)`` is the harmonic bonded tier, evaluated every
    inner substep; both on the system's kernel route."""
    slow_fn, init_nb = make_nb_energy_fn(system, bonded=None)
    bonded = follow_route(bonded, system)

    def fast_fn(x):
        return _energy_and_forces(lambda xx: bonded_energy(xx, bonded), x)

    return slow_fn, fast_fn, init_nb


def _respa_start(state, slow_fn, fast_fn, init_nb):
    """The RESPA carry at ``state``: x, v, f_slow, f_fast, the tier forces
    of a :class:`RespaStateNB` as they are, else evaluated at ``state``."""
    if isinstance(state, RespaStateNB):
        return state.positions, state.velocities, state.f_slow, state.f_fast
    nb = init_nb(state.positions)
    _e, f_slow, _nb = slow_fn(state.positions, nb)
    _ef, f_fast = fast_fn(state.positions)
    return state.positions, state.velocities, f_slow, f_fast


def _respa_final(chunk, slow_fn, fast_fn, init_nb) -> RespaStateNB:
    """The final state of a RESPA driver: total forces and potential
    evaluated afresh at the last positions, with a fresh neighbor state,
    and the carry's tier forces."""
    with phase_scope("cf.md.final"):
        x = chunk.x.clone()
        nb = init_nb(x)
        e_slow, f_slow, nb = slow_fn(x, nb)
        e_fast, f_fast = fast_fn(x)
    return RespaStateNB(x, chunk.v.clone(), f_slow + f_fast,
                        e_slow + e_fast, nb, chunk.carry[2].clone(),
                        chunk.carry[3].clone())


def _respa_outer(slow_fn, inner, masses, dt, n_inner):
    """One outer RESPA step as a :class:`Chunk` step on the carry (x, v,
    f_slow, f_fast): a slow half kick, ``n_inner`` substeps
    ``inner(x, v, f_fast) -> (x, v, f_fast, e_fast)`` (the stage
    ``cf_respa_fast``), the slow force, a slow half kick.  Its record is
    (e_slow, e_fast of the last substep)."""

    def step(carry, nb):
        inv_m = (1.0 / masses)[:, None]
        x, v, f_slow, f_fast = carry
        v = v + 0.5 * dt * f_slow * inv_m                   # slow kick
        profiling.count_respa(x, n_inner)
        with phase_scope("cf_respa_fast", x):
            for _ in range(n_inner):
                x, v, f_fast, e_fast = inner(x, v, f_fast, inv_m)
        e_slow, f_slow, _nb = slow_fn(x, nb)
        v = v + 0.5 * dt * f_slow * inv_m                   # slow kick
        return (x, v, f_slow, f_fast), e_slow, e_fast
    return step


def _respa_run(state, slow_fn, fast_fn, init_nb, masses, n_steps,
               rebuild_every, graph, key, make_step, generator=None):
    """The RESPA drivers' loop: chunks of ``rebuild_every`` outer steps
    (``make_step(masses, generator)`` gives one, a :class:`Chunk` step)
    from the carry at ``state``, kept on ``slow_fn`` under ``key``;
    returns (final state, per-outer-step records)."""
    _require_steps(n_steps)
    x = state.positions

    def make(k):
        return Chunk(make_step, init_nb, k, (x,) * 4, graph, masses,
                     generator, keep=(fast_fn,))

    get_chunk = _chunk_getter(slow_fn, graph, x, masses,
                              key + (init_nb, id(fast_fn)), make)
    chunk, out = _run_chunks(get_chunk,
                             _respa_start(state, slow_fn, fast_fn, init_nb),
                             n_steps, rebuild_every, masses, generator)
    return _respa_final(chunk, slow_fn, fast_fn, init_nb), out


def respa_trajectory_nb(state: MDStateNB, slow_fn, fast_fn, init_nb, masses,
                        dt: float, n_inner: int, n_steps: int,
                        rebuild_every: int = 10, graph: bool = True):
    """Impulse r-RESPA NVE trajectory (Verlet-I; Tuckerman-Berne-Martyna):
    each outer step of ``dt`` kicks with the slow (nonbonded) force for
    half a step at each end and advances ``n_inner`` velocity-Verlet
    substeps of ``dt / n_inner`` on the fast (bonded) force in between.
    ``n_steps`` counts outer steps; the neighbor state is rebuilt every
    ``rebuild_every`` of them (a remainder runs as one shorter chunk,
    where the JAX package asks for a multiple), each chunk a CUDA graph
    replay on a CUDA device unless ``graph=False``.  Returns (final_state,
    per-outer-step total energies); the final state (:class:`RespaStateNB`)
    has its forces and potential evaluated afresh, and the last outer
    step's tier forces beside them, from which a call handed it goes on."""
    dt_in = dt / n_inner

    def make_step(m, _generator):
        def inner(x, v, f, inv_m):
            v_half = v + 0.5 * dt_in * f * inv_m
            x_new = x + dt_in * v_half
            e_fast, f_new = fast_fn(x_new)
            return x_new, v_half + 0.5 * dt_in * f_new * inv_m, f_new, e_fast

        outer = _respa_outer(slow_fn, inner, m, dt, n_inner)

        def step(carry, nb):
            carry, e_slow, e_fast = outer(carry, nb)
            return carry, e_slow, (e_slow + e_fast
                                   + kinetic_energy(carry[1], m))
        return step

    return _respa_run(state, slow_fn, fast_fn, init_nb, masses, n_steps,
                      rebuild_every, graph, ("respa", float(dt), n_inner),
                      make_step)


def respa_langevin_trajectory_nb(state: MDStateNB, slow_fn, fast_fn,
                                 init_nb, masses, dt: float, n_inner: int,
                                 temperature: float, friction: float,
                                 generator: torch.Generator, n_steps: int,
                                 rebuild_every: int = 10, graph: bool = True):
    """BAOAB Langevin with impulse slow forces — the NVT analog of
    :func:`respa_trajectory_nb`: the inner tier runs ``n_inner`` BAOAB
    substeps of ``dt / n_inner`` on the fast (bonded) force (friction and
    noise act at the inner timestep), the slow (nonbonded) force kicks at
    the outer boundaries.  With ``n_inner=1`` this is
    :func:`langevin_trajectory_nb` (kicks differ only by summation order).
    Returns (final_state, per-outer-step kinetic energies), the final state
    as :func:`respa_trajectory_nb`'s."""
    _check_generator(generator, state.positions.device)
    dt_in = dt / n_inner

    def make_step(m, g):
        c1, c2 = baoab_coeffs(dt_in, friction, temperature)

        def inner(x, v, f, inv_m):
            x, v = baoab_pre_force(x, v, f, inv_m, dt_in, c1, c2, g)
            e_fast, f_new = fast_fn(x)
            return x, v + 0.5 * dt_in * f_new * inv_m, f_new, e_fast

        outer = _respa_outer(slow_fn, inner, m, dt, n_inner)

        def step(carry, nb):
            carry, e_slow, _e_fast = outer(carry, nb)
            return carry, e_slow, kinetic_energy(carry[1], m)
        return step

    key = ("respa_langevin", float(dt), n_inner, float(temperature),
           float(friction))
    return _respa_run(state, slow_fn, fast_fn, init_nb, masses, n_steps,
                      rebuild_every, graph, key, make_step, generator)


# ---------------------------------------------------------------------------
# FIRE energy minimization
# ---------------------------------------------------------------------------


def minimize_fire(positions, energy_fn, n_steps: int = 200,
                  dt_start: float = 1e-4, dt_max: float = 1e-3,
                  alpha_start: float = 0.1):
    """FIRE (fast inertial relaxation engine) minimization; returns
    (positions, final_energy).  Eager; its step size, mixing factor and
    count of downhill steps stay on the device, so no step reads back."""
    x = positions
    v = torch.zeros_like(x)
    dt = torch.full((), dt_start, dtype=x.dtype, device=x.device)
    alpha = torch.full((), alpha_start, dtype=x.dtype, device=x.device)
    n_pos = torch.zeros((), dtype=torch.int64, device=x.device)
    for _ in range(n_steps):
        _e, f = _energy_and_forces(energy_fn, x)
        power = torch.sum(f * v)
        v_norm = torch.sqrt(torch.sum(v * v)) + 1e-30
        f_norm = torch.sqrt(torch.sum(f * f)) + 1e-30
        v_mixed = (1.0 - alpha) * v + alpha * (f / f_norm) * v_norm
        uphill = power < 0.0
        v_new = torch.where(uphill, 0.0, v_mixed)
        grow = (~uphill) & (n_pos > 5)
        n_pos = torch.where(uphill, 0, n_pos + 1)
        dt = torch.where(grow, torch.clamp(dt * 1.1, max=dt_max),
                         torch.where(uphill, dt * 0.5, dt))
        alpha = torch.where(grow, alpha * 0.99,
                            torch.where(uphill, alpha_start, alpha))
        v = v_new + dt * f
        x = x + dt * v
    with torch.no_grad():
        return x, energy_fn(x)
