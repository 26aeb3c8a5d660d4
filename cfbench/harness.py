"""One run of a cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

``run_cell`` runs a one-card cell in this process on any device (the
command insists on a card; the CPU tests drive the same code at small
sizes).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import resource
import sys
import time

import torch

from . import spec
from .trace import WINDOW_SPAN, summarize, traced

#: top-level module names that nothing the benchmark runs may load: JAX
#: and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "chargeflux_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Ctx:
    """What a metric's reader reads (``cfbench/metrics/<name>.py``)."""
    setup_s: float
    wall_s: float          # the window, host clock
    steps: int             # MD steps the window completed
    dt_ps: float
    replicas: int          # systems integrated side by side
    evals: int             # energy evaluations in the window
    traces: list           # trace.summarize of the window, if traced
    work: dict             # the problem's sizes (``Driver.work``)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def start(drv, seed: int):
    """The driver's set-up from ``seed``, then one report interval as the
    window runs it, which warms up every shape the window uses (its frame
    is dropped): the first production call after a capture ran slower by
    1-8 % on the card."""
    drv.start(seed)
    drv.interval()
    drv.frames = []


def host_sample() -> tuple:
    """(this thread's CPU seconds, the machine's steal seconds, this
    process's involuntary context switches) now: what the host gave the
    thread that launches the work."""
    try:
        with open("/proc/stat") as fh:
            steal = int(fh.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        steal = float("nan")
    return (time.thread_time(), steal,
            resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw)


def window(drv, seconds: float, trace: bool, device) -> dict:
    """The measured window: report intervals until ``seconds`` have passed
    (with ``trace``: the mix's ``trace_intervals`` under the profiler),
    timed from the first enqueue to the last synchronize.  Per interval
    it also keeps the seconds and what the host gave (``host_sample``)."""
    from torch.profiler import record_function

    n_trace = int(drv.traffic.get("trace_intervals", 1))
    intervals = failed = 0
    times, host = [], []
    with traced(trace) as prof:
        sync(device)
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            while True:
                t1, h1 = time.perf_counter(), host_sample()
                with record_function("cfbench.interval"):
                    ok = drv.interval()
                times.append(time.perf_counter() - t1)
                host.append([round(b - a, 3) for a, b in
                             zip(h1, host_sample())])
                intervals += 1
                failed += not ok
                if (intervals >= n_trace if trace
                        else time.perf_counter() - t0 >= seconds):
                    break
            sync(device)
        wall = time.perf_counter() - t0
    return {"intervals": intervals, "failed": failed, "wall_s": wall,
            "interval_s": times, "interval_host": host,
            "steps": intervals * drv.steps_per_interval,
            "evals": intervals * drv.evals_per_interval,
            "trace": summarize(prof) if trace else None}


def metrics(cell: dict, ctx: Ctx, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones,
    each from its reader; a reader that finds nothing leaves it out."""
    out = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(cell: dict, readings: dict) -> tuple:
    """(correct, compared): each number beside its limit."""
    limits = cell["limits"]["limits"]
    compared = {k: {"value": readings[k], "limit": limits[k]}
                for k in limits}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared


def readings(cell, frames, seed, device, inputs, precision=None) -> dict:
    """The numbers of the mix's comparison (``cfbench/checks/``) at the
    window's frames: the program's, or with ``precision`` the control's."""
    t = cell["traffic"]
    return spec.check(t["check"])(cell["config"], frames, seed, device,
                                  int(t["check_frames"]),
                                  precision=precision, **inputs)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t0: float, log=print) -> dict:
    """One run of a one-card cell on ``device``; ``t0`` is the process's
    start on the host clock, from which set-up counts."""
    device = torch.device(device)
    Driver = spec.driver(cell["traffic"]["driver"])
    drv = Driver(cell["config"], cell["traffic"], device)
    start(drv, seed)
    sync(device)
    setup_s = time.perf_counter() - t0
    log(f"cfbench: set-up {setup_s:.3f} s; {drv.info}")
    win = window(drv, seconds, trace, device)
    log(f"cfbench: window {win['wall_s']:.4f} s, {win['steps']} steps; "
        f"seconds per report interval {win['interval_s']}")
    log(f"cfbench: per interval [thread CPU s, steal s, involuntary "
        f"switches] {win['interval_host']}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    work = drv.work() if trace else {}
    frames, inputs = drv.frames, drv.check_inputs()
    dt_ps, replicas = drv.dt_ps, drv.replicas
    drv.release()
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = readings(cell, frames, seed, device, inputs)
    ctx = Ctx(setup_s, win["wall_s"], win["steps"], dt_ps, replicas,
              win["evals"], [win["trace"]] if trace else [], work)
    return assemble(cell, ctx, win, found, trace, peak, device)


def assemble(cell, ctx, win, found, trace, peak, device) -> dict:
    correct, compared = judge(cell, found)
    if win["failed"]:
        correct = False
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": win["intervals"],
           "failed": win["failed"], "metrics": metrics(cell, ctx, trace),
           "device": dev}
    if trace:
        tr = ctx.traces
        dev["busy_s"] = sum(t["busy_ns"] for t in tr) / len(tr) / 1e9
        dev["window_s"] = sum(t["wall_ns"] for t in tr) / len(tr) / 1e9
        out["breakdown"] = {"device_ops": tr[0]["device_ops"],
                            "idle_gaps": tr[0]["idle_gaps"]}
    out["compared"] = compared
    return out
