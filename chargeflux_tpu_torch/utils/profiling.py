"""Tracing and timing helpers (torch counterpart of
``chargeflux_tpu.utils.profiling``).

:func:`phase_scope` names a phase of the program in a profiler trace: a
``torch.profiler.record_function`` range and, on the card, an NVTX range,
both on the host.  Given the tensors a phase reads, the scope is also one
of the program's *stages* (its name ``cf_<stage>``, :data:`TIMED`), timed
on the device as well: a stamp at each edge of the forward, and an
identity ``torch.autograd.Function`` around the stage's inputs and its
output whose backward stamps the edges of the stage's backward.  On the
card a stamp is a single-thread kernel (``csrc/stage_stamp.cu``, one per
stage, ``cf_stamp_<stage>``) that reads ``%globaltimer``; a CUDA graph
captures it like any kernel, so the stamps time the stages inside the
replays of the chunk graphs (``integrate.Chunk``), where no host code
runs.  On the CPU the same points read the host clock, with the same
bookkeeping.

The record.  Stamps do their work only while a ``torch.profiler``
records: eager code launches none otherwise, and a graph's stamps,
collected as it is captured (:func:`capture_stamps`), are in a second
executable graph of the same capture (:class:`GraphStamps`), which a
chunk call launches instead of the graph's own only while one records
(:meth:`GraphStamps.sync`); the hot path's graph holds no stamp.  Each
time a profiler starts recording (seen at the next stamp, span or chunk
call), the record starts empty.  It keeps

* per stage, pass (forward, backward) and mode (eager evaluations, graph
  replays) the summed device seconds and the count of closed spans;
* per host span (every ``phase_scope`` entered while recording, such as
  the MD driver's ``cf.md.*``) its count, total and self seconds (the
  total less the time its child spans cover) and its parents' names;
* the chunk replays, per chunk length, and the r-RESPA outer steps and
  substeps they ran.

:func:`totals` returns it, :func:`stage_ms` reads the replays' per-step
device time by stage from it, :func:`respa_ms` the r-RESPA tiers' and the
slow tier's stages' per outer step, and :func:`idle_by_span` credits the idle time of a finished
profiler's trace to the program's host spans.

:func:`trace` records a ``torch.profiler`` trace of a block into a
directory; :class:`step_timer` times a block with CUDA events on the card,
with the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
import time

import torch

from ..ops import native
from ..ops.native import INT, INT_OUT, PTR

native.declare(cf_stamp_limits=[INT_OUT] * 2,
               cf_stage_stamp=[PTR, INT, INT, PTR, PTR],
               cf_stamp_set_new=[PTR, PTR, INT, PTR, PTR],
               cf_stamp_set_launch=[PTR, PTR])
native.declare(restype=None, cf_stamp_set_free=[PTR])

#: The stages :func:`stage_ms` reads: the energy's phases, the chunk
#: head's neighbor rebuild, and ``replay``, the first and last node of each
#: chunk graph.
STAGES = ("charges", "binning", "direct", "exclusion", "reciprocal",
          "bonded", "rebuild", "replay")
#: The stages of one energy evaluation.
ENERGY_STAGES = STAGES[:6]
#: The r-RESPA slow tier's stages (the energy's but the bonded terms).
SLOW_STAGES = ENERGY_STAGES[:5]
#: Every stage the stamps time, in the slot order of ``stage_stamp.cu``:
#: :data:`STAGES`, then ``respa_fast``, an r-RESPA outer step's fast tier
#: (its substeps, their bonded evaluations inside).
TIMED = STAGES + ("respa_fast",)
PASSES = ("fwd", "bwd")
MODES = ("eager", "replay")
SLOTS = len(TIMED) * len(PASSES) * len(MODES)
_STAGE_OF = {f"cf_{s}": i for i, s in enumerate(TIMED)}
_EAGER, _REPLAY = 0, 1


def _slot(stage: int, backward: int, mode: int) -> int:
    return (stage * 2 + backward) * 2 + mode


class _Buffer:
    """One device's stamp record: ``[open times, summed ns, counts]`` of
    :data:`SLOTS` each, an int64 tensor on the card (written by the stamp
    kernels) or a list on the CPU (written here, from the host clock)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.on = False
        self.session = -1
        if self.cuda:
            built = native.limits("cf_stamp_limits")
            if built != (SLOTS, len(TIMED)):
                raise RuntimeError(f"stage_stamp.cu has {built} (slots, "
                                   f"stages); profiling expects "
                                   f"{(SLOTS, len(TIMED))}")
            self.buf = torch.zeros(3 * SLOTS, dtype=torch.int64,
                                   device=device)
        else:
            self.buf = [0] * (3 * SLOTS)

    def set(self, on: bool, session: int):
        """The record open (stamps count) or closed; opened in a new
        session, it is cleared first (the one write to the card)."""
        if on and (not self.on or self.session != session):
            if self.cuda:
                self.buf.zero_()
            else:
                self.buf[:] = [0] * (3 * SLOTS)
            self.session = session
        self.on = on

    def stamp(self, slot: int, open_: bool):
        if self.cuda:
            capturing = torch.cuda.is_current_stream_capturing()
            node = ctypes.c_void_p() if capturing else None
            native.check(native.library().cf_stage_stamp(
                self.buf.data_ptr(), slot, int(open_),
                torch.cuda.current_stream(self.device).cuda_stream,
                None if node is None else ctypes.byref(node)),
                "cf_stage_stamp")
            if node is not None and node.value:
                with _REC.lock:
                    _REC.nodes.append(node.value)
            return
        b = self.buf
        if not self.on:
            return
        now = time.perf_counter_ns()
        if open_:
            b[slot] = now
        else:
            b[SLOTS + slot] += now - b[slot]
            b[2 * SLOTS + slot] += 1

    def read(self) -> list:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            return self.buf.cpu().tolist()
        return list(self.buf)


class _Record:
    """The process's record (one, as the profiler is one per process)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.was_on = False
        self.closed = False     # read by totals() after its profiler stopped
        self.session = 0
        self.host = {}
        self.replays = {}
        self.respa = {"outer": 0, "inner": 0}
        self.buffers = {}
        self.nodes = None       # the stamp nodes of a graph being captured
        self.captured = None    # the r-RESPA steps of a graph being captured

    def stack(self) -> list:
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack


_REC = _Record()


def recording() -> bool:
    """Whether a ``torch.profiler`` records now.  The first call that sees
    one started (or sees one recording after :func:`totals` read the
    record of a stopped one) empties the record."""
    on = torch._C._autograd._profiler_enabled()
    if on and (not _REC.was_on or _REC.closed):
        with _REC.lock:
            _REC.session += 1
            _REC.host, _REC.replays = {}, {}
            _REC.respa = {"outer": 0, "inner": 0}
            _REC.closed = False
    _REC.was_on = on
    return on


def _key(device) -> tuple:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device.type, device.index


def _buffer(device, create: bool = True):
    key = _key(device)
    buf = _REC.buffers.get(key)
    if buf is None and create:
        buf = _REC.buffers[key] = _Buffer(torch.device(*key))
    return buf


class GraphStamps:
    """The stamp nodes of one CUDA graph (:func:`capture_stamps`).
    :meth:`attach` instantiates the graph as captured, stamps and all, for
    :meth:`launch`, then takes the stamps out of its kept template and
    instantiates that for ``graph.replay()``: the hot path's graph holds
    no stamp."""

    def __init__(self, device: torch.device):
        self.device = device
        self.nodes = []
        self.bridged = 0        # edges that keep the work's order without
        self.respa = {"outer": 0, "inner": 0}   # r-RESPA steps a replay runs
        self._set = None

    def attach(self, graph):
        """Instantiate ``graph``, a captured ``torch.cuda.CUDAGraph`` made
        with ``keep_graph=True``, with its stamps (for :meth:`launch`) and,
        as the graph's own, without them."""
        if self.nodes:
            lib = native.library()
            handle, bridged = ctypes.c_void_p(), ctypes.c_int()
            native.check(lib.cf_stamp_set_new(
                graph.raw_cuda_graph(),
                (ctypes.c_void_p * len(self.nodes))(*self.nodes),
                len(self.nodes), ctypes.byref(handle), ctypes.byref(bridged)),
                "cf_stamp_set_new")
            self._set, self.bridged = handle.value, bridged.value
            self._launch, self._free = (lib.cf_stamp_set_launch,
                                        lib.cf_stamp_set_free)
        graph.instantiate()

    def sync(self) -> bool:
        """Before a replay: the record open while a profiler records
        (emptied as one starts); whether the replay is to run the graph
        with its stamps (:meth:`launch`)."""
        on = recording()
        buf = _buffer(self.device, create=on)
        if buf is not None:
            buf.set(on, _REC.session)
        return on and self._set is not None

    def launch(self):
        """Launch the graph with its stamps on the current stream (as
        ``graph.replay()`` launches its own, generator states aside)."""
        native.check(self._launch(
            self._set, torch.cuda.current_stream(self.device).cuda_stream),
            "cf_stamp_set_launch")

    def __del__(self):
        if self._set is not None:
            self._free(self._set)
            self._set = None


@contextlib.contextmanager
def capture_stamps(device):
    """Around a CUDA graph's capture on ``device``: yields the
    :class:`GraphStamps` that collects the stamp nodes captured in the
    block, and the r-RESPA steps (:func:`count_respa`) the graph runs.  The
    device's record is made first, outside the capture.  A graph captured
    outside this block carries no stamps."""
    device = torch.device(*_key(device))
    _buffer(device)
    stamps = GraphStamps(device)
    with _REC.lock:
        if _REC.nodes is not None:
            raise RuntimeError("capture_stamps: another capture collects "
                               "stamp nodes")
        _REC.nodes, _REC.captured = stamps.nodes, stamps.respa
    try:
        yield stamps
    finally:
        with _REC.lock:
            _REC.nodes = _REC.captured = None


def count_replay(steps: int, respa: dict):
    """Record one replay of a chunk graph of ``steps`` steps, and the
    r-RESPA steps ``respa`` of its capture (:attr:`GraphStamps.respa`),
    while a profiler records."""
    if recording():
        with _REC.lock:
            _REC.replays[steps] = _REC.replays.get(steps, 0) + 1
            for k in _REC.respa:
                _REC.respa[k] += respa[k]


def count_respa(like: torch.Tensor, n_inner: int):
    """Count one r-RESPA outer step of ``n_inner`` substeps into the
    capture that collects stamps (:func:`count_replay` adds it at each
    replay); outside such a capture nothing is counted."""
    if like.is_cuda and torch.cuda.is_current_stream_capturing():
        with _REC.lock:
            if _REC.captured is not None:
                _REC.captured["outer"] += 1
                _REC.captured["inner"] += n_inner


class _Edge(torch.autograd.Function):
    """The identity; its backward runs ``stamp`` (where given) before
    handing the gradients on."""

    @staticmethod
    def forward(ctx, stamp, *ts):
        ctx.stamp = stamp
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.stamp is not None:
            ctx.stamp()
        return (None,) + grads


def _leaves(obj) -> list:
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    return []


def _replace(obj, new: dict):
    if torch.is_tensor(obj):
        return new.get(id(obj), obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):      # NamedTuple
        return type(obj)(*(_replace(o, new) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_replace(o, new) for o in obj)
    return obj


def _wrap(obj, stamp):
    """``obj`` (a tensor, or tuples of them) with its tensors that need a
    gradient passed through one :class:`_Edge`."""
    if not torch.is_grad_enabled():
        return obj
    ts = [t for t in _leaves(obj) if t.requires_grad]
    if not ts:
        return obj
    return _replace(obj, {id(t): w for t, w in
                          zip(ts, _Edge.apply(stamp, *ts))})


class Stage:
    """A stage's scope (``phase_scope`` given tensors): ``inputs`` are the
    tensors it was given, passed through the identity whose backward closes
    the stage's backward; :meth:`output` passes the stage's result through
    the one whose backward opens it.  Both leave the values and gradients
    as they are, and are applied whether or not a profiler records, so the
    autograd graph, and with it every sum's order, is the same either way."""

    def __init__(self, stage: int, inputs: tuple, on: bool):
        self.stage = stage
        self.buffer, self.mode = None, None
        dev = next((t.device for t in _leaves(inputs)), None)
        if dev is not None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                # stamps only in a capture that collects them
                if _REC.nodes is not None:
                    self.buffer = _buffer(dev, create=False)
                self.mode = _REPLAY
            elif on:
                self.buffer, self.mode = _buffer(dev), _EAGER
                self.buffer.set(True, _REC.session)
        if self.buffer is None:
            self.mode = None
        self.inputs = _wrap(inputs, self._stamper(1, False))

    def _stamper(self, backward: int, open_: bool):
        """The stamp of one edge as a callable that holds no tensor (the
        autograd graph keeps it until its backward has run)."""
        if self.mode is None:
            return None
        return functools.partial(self.buffer.stamp,
                                 _slot(self.stage, backward, self.mode),
                                 open_)

    def stamp(self, backward: int, open_: bool):
        if self.mode is not None:
            self._stamper(backward, open_)()

    def output(self, result):
        """``result`` (a tensor, or tuples of them), its backward stamped."""
        return _wrap(result, self._stamper(1, True))


@contextlib.contextmanager
def phase_scope(name: str, *inputs):
    """A named range around a phase of the program: a ``record_function``
    range and, when CUDA is available, an NVTX range; while a profiler
    records, a host span of the record.  With ``inputs`` (tensors, or
    tuples of them, such as ``cells.CellBlocks``) and a stage's name
    (``cf_<stage>``) it yields a :class:`Stage`, which stamps the forward's
    edges around the block and the backward's through ``inputs`` and
    ``output``; otherwise it yields None."""
    nvtx = torch.cuda.is_available()
    span, on = None, recording()
    if on:
        span = [name, time.perf_counter(), 0.0]
        _REC.stack().append(span)
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            stage = None
            if inputs and name in _STAGE_OF:
                stage = Stage(_STAGE_OF[name], inputs, on)
                stage.stamp(0, True)
            yield stage
            if stage is not None:
                stage.stamp(0, False)
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        if span is not None:
            _close_span(span)


def _close_span(span):
    stack = _REC.stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is span:
            del stack[i]
            break
    name, t0, child = span
    dt = time.perf_counter() - t0
    parent = stack[-1] if stack else None
    with _REC.lock:
        r = _REC.host.setdefault(name, {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0, "parents": set()})
        r["count"] += 1
        r["total_s"] += dt
        r["self_s"] += dt - child
        if parent is not None:
            r["parents"].add(parent[0])
    if parent is not None:
        parent[2] += dt


def totals() -> dict:
    """The record of the last (or the current) profiled window; read
    after its profiler stopped, the next profiler starts a new one:

    * ``host``: per span name, ``count``, ``total_s``, ``self_s`` and the
      sorted names of its ``parents``;
    * ``stages``: ``[mode][stage][pass]`` -> ``{"seconds", "count"}``,
      modes ``eager`` and ``replay``, passes ``fwd`` and ``bwd``, summed
      over the devices (each device's accumulators copied to the host
      once);
    * ``replays``: chunk length -> replays of it;
    * ``respa``: ``{"outer", "inner"}``, the r-RESPA outer steps and
      inner substeps the replays ran (:func:`count_respa`)."""
    with _REC.lock:
        if not torch._C._autograd._profiler_enabled():
            _REC.closed = True
        host = {k: dict(v, parents=sorted(v["parents"]))
                for k, v in _REC.host.items()}
        replays = dict(_REC.replays)
        respa = dict(_REC.respa)
        session = _REC.session
    stages = {m: {s: {p: {"seconds": 0.0, "count": 0} for p in PASSES}
                  for s in TIMED} for m in MODES}
    for buf in list(_REC.buffers.values()):
        if buf.session != session:
            continue
        vals = buf.read()
        for si, s in enumerate(TIMED):
            for bi, p in enumerate(PASSES):
                for mi, m in enumerate(MODES):
                    k = _slot(si, bi, mi)
                    cell = stages[m][s][p]
                    cell["seconds"] += vals[SLOTS + k] * 1e-9
                    cell["count"] += vals[2 * SLOTS + k]
    return {"host": host, "stages": stages, "replays": replays,
            "respa": respa}


def stage_ms(record: dict, steps: int):
    """Device milliseconds per replayed MD step of each stage of
    :data:`STAGES` but ``replay`` (forward and backward summed) in the
    chunk graphs' replays of ``record`` (:func:`totals`), and under
    ``other`` the rest of the replays' device time (the integrator, the
    autograd glue and guards).  A stage's time runs from edge to edge, the
    card's idle inside it included, so a window in which the card idles
    more inside the replays (a traced run's slow mode) reads every stage
    wider.  None where the record holds no replay, where its replays ran
    another number of steps than ``steps``, where an energy stage did not
    run exactly one forward and one backward per replayed step (one
    evaluation a step, as the NVE and Langevin chunks run), or where the
    rebuild and the graphs' bounds did not run once per replay."""
    replayed = sum(k * n for k, n in record["replays"].items())
    chunks = sum(record["replays"].values())
    rep = record["stages"]["replay"]
    if not replayed or replayed != steps:
        return None
    if any(rep[s][p]["count"] != steps for s in ENERGY_STAGES
           for p in PASSES):
        return None
    if (rep["replay"]["fwd"]["count"] != chunks
            or rep["rebuild"]["fwd"]["count"] not in (0, chunks)):
        return None
    out = {s: 1e3 * (rep[s]["fwd"]["seconds"] + rep[s]["bwd"]["seconds"])
           / steps for s in STAGES[:-1]}
    out["other"] = (1e3 * rep["replay"]["fwd"]["seconds"] / steps
                    - sum(out.values()))
    return out


def respa_ms(record: dict, outer_steps: int):
    """Device milliseconds per replayed r-RESPA outer step in the chunk
    graphs' replays of ``record`` (:func:`totals`): ``fast``, the stage
    ``respa_fast`` (the substeps: their kicks, drifts, noise and bonded
    evaluations); ``bonded``, the ``bonded`` stage inside it, forward and
    backward; each slow-tier stage (:data:`SLOW_STAGES`), forward and
    backward, and ``slow``, their sum.  A stage's time runs from edge to
    edge, as in :func:`stage_ms`.  None where the replays ran another
    number of steps than ``outer_steps`` or counted other r-RESPA steps,
    or where a replayed outer step did not run one fast tier, one forward
    and one backward of each slow-tier stage, and one bonded evaluation
    per counted substep."""
    counted = record.get("respa")
    rep = record["stages"]["replay"]
    replayed = sum(k * n for k, n in record["replays"].items())
    if (not outer_steps or replayed != outer_steps or not counted
            or counted["outer"] != outer_steps or "respa_fast" not in rep):
        return None
    if (rep["respa_fast"]["fwd"]["count"] != outer_steps
            or any(rep["bonded"][p]["count"] != counted["inner"]
                   for p in PASSES)
            or any(rep[s][p]["count"] != outer_steps for s in SLOW_STAGES
                   for p in PASSES)):
        return None

    def ms(stage, passes=PASSES):
        return 1e3 * sum(rep[stage][p]["seconds"]
                         for p in passes) / outer_steps
    out = {s: ms(s) for s in SLOW_STAGES}
    out.update(fast=ms("respa_fast", ("fwd",)), bonded=ms("bonded"),
               slow=sum(out[s] for s in SLOW_STAGES))
    return out


def _is_program_span(name: str) -> bool:
    return name.startswith("cf.") or name.startswith("cf_")


def idle_by_span(prof) -> dict:
    """What the host was doing while the card sat idle, from a finished
    ``torch.profiler`` (or a list of its kineto events): each gap between
    the device's operations, from its first to its last, is credited to
    the innermost of the program's host spans (``phase_scope`` names,
    ``cf.`` or ``cf_``) around the gap's midpoint, or to ``"(none)"``.  A
    caller that wants another window clips the events to it first.
    Returns span name -> ``{"seconds", "gaps", "longest_s"}``, the most
    idle first."""
    import numpy as np

    events = (prof.profiler.kineto_results.events()
              if hasattr(prof, "profiler") else prof)
    dev, spans = [], []
    for e in events:
        on_card = str(e.device_type()).endswith("CUDA")
        if on_card and not e.is_user_annotation():
            dev.append((e.start_ns(), e.end_ns()))
        elif not on_card and _is_program_span(e.name()):
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    gaps, end = [], None
    for s, t in sorted(dev):
        if end is not None and s > end:
            gaps.append((end, s))
        end = t if end is None else max(end, t)
    if not gaps:
        return {}
    g = np.array(gaps, dtype=np.int64)
    mids = (g[:, 0] + g[:, 1]) // 2
    order = np.argsort(mids)
    g, mids = g[order], mids[order]
    label = np.full(len(mids), len(spans))
    # longest first, so the innermost span around a midpoint labels it last
    for i in sorted(range(len(spans)),
                    key=lambda i: spans[i][0] - spans[i][1]):
        a = np.searchsorted(mids, spans[i][0], side="left")
        b = np.searchsorted(mids, spans[i][1], side="right")
        label[a:b] = i
    names = [s[2] for s in spans] + ["(none)"]
    length = (g[:, 1] - g[:, 0]) / 1e9
    seconds = np.bincount(label, weights=length, minlength=len(names))
    counts = np.bincount(label, minlength=len(names))
    longest = np.zeros(len(names))
    np.maximum.at(longest, label, length)
    out = {}
    for i, name in enumerate(names):      # a name may label several spans
        if counts[i]:
            r = out.setdefault(name, {"seconds": 0.0, "gaps": 0,
                                      "longest_s": 0.0})
            r["seconds"] += float(seconds[i])
            r["gaps"] += int(counts[i])
            r["longest_s"] = max(r["longest_s"], float(longest[i]))
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["seconds"]))


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where available)
    of the block into ``log_dir/trace.json`` (Chrome trace format); yields
    the profiler, whose ``key_averages()`` tables it by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class step_timer:
    """Elapsed seconds of a block of work, which may be asynchronous on the
    card:

        with step_timer() as t:
            out = step(...)
            t.sync(out)
        print(t.elapsed)

    On a CUDA device (``device``, by default the card when there is one)
    the block is timed by two CUDA events on the current stream, so it
    counts the device's work up to ``sync``; elsewhere by the host clock.
    ``sync`` (optional; the exit calls it if the block did not) waits for
    the card and returns ``out``."""

    def __init__(self, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.cuda = torch.device(device).type == "cuda"
        self.elapsed = None
        self._end = None

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def sync(self, out=None):
        if self.cuda:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
            self._end.synchronize()
            self.elapsed = self._start.elapsed_time(self._end) / 1e3
        else:
            self.elapsed = time.perf_counter() - self._t0
        return out

    def __exit__(self, *exc):
        if self.elapsed is None:
            self.sync()
        return False
