"""Tracing and timing helpers (torch counterpart of
``chargeflux_tpu.utils.profiling``).

:func:`phase_scope` names an engine phase in a profiler trace: a
``torch.profiler.record_function`` range, which ``torch.profiler`` lists
with the device time of the kernels launched inside it, and on the card an
NVTX range.  Both are host-side: a CUDA graph captures none of it, so a
replay pays nothing for the scopes.  :func:`trace` records a
``torch.profiler`` trace of a block into a directory; :class:`step_timer`
times a block with CUDA events on the card, with the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def phase_scope(name: str):
    """A named range around an engine phase: a ``record_function`` range
    and, when CUDA is available, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
