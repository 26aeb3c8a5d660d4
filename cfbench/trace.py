"""Reading a ``torch.profiler`` trace of a measured window: device busy
time (the union of the device events' intervals), kernel time and counts
by name, and the idle gaps labelled by what the host was doing.

The raw kineto events are read directly (``kineto_results.events()``),
which is far cheaper than building the profiler's ``FunctionEvent``
tree for the million events of a long window.
"""

from __future__ import annotations

from contextlib import contextmanager

#: the span the harness opens around a traced window
WINDOW_SPAN = "cfbench.window"


def _is_device(ev) -> bool:
    """A device operation: a kernel, copy or fill on the card (not a
    user span the profiler mirrors onto the device's timeline)."""
    return (str(ev.device_type()).endswith("CUDA")
            and not ev.is_user_annotation()
            and not ev.name().startswith("cfbench."))


def is_kernel(name: str) -> bool:
    """A device event that is a kernel (not a copy or a fill)."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextmanager
def traced(enabled: bool):
    """A profiler over the body (CPU and CUDA activity) where ``enabled``;
    yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def summarize(prof, top: int = 10) -> dict:
    """The trace of one window (the span ``WINDOW_SPAN``): its wall time,
    device busy time, kernel count, per-name kernel (count, ns), the
    device operations that took most time and the longest idle gaps, each
    gap named by the innermost host event around its middle."""
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW_SPAN
              and not str(e.device_type()).endswith("CUDA")]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    dev, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t < w0 or s > w1:
            continue
        if _is_device(e):
            dev.append((e.name(), max(s, w0), min(t, w1)))
        elif (e.name() != WINDOW_SPAN
              and not str(e.device_type()).endswith("CUDA")):
            host.append((t - s, s, t, e.name()))
    by_name = {}
    for name, s, t in dev:
        c, ns = by_name.get(name, (0, 0))
        by_name[name] = (c + 1, ns + (t - s))
    busy = union_ns([(s, t) for _n, s, t in dev])
    gaps, prev = [], w0
    for s, t in merged([(s, t) for _n, s, t in dev]) + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    host.sort()

    def label(a, b):
        mid = (a + b) // 2
        for _d, s, t, name in host:          # shortest first
            if s <= mid <= t:
                return name
        return "no host event"

    gaps.sort(key=lambda g: g[0] - g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "wall_ns": w1 - w0, "busy_ns": busy,
        "kernels": sum(c for n, (c, _t) in by_name.items() if is_kernel(n)),
        "by_name": by_name,
        "device_ops": [[n[:200], ns / 1e9] for n, (_c, ns) in ops],
        "idle_gaps": [[label(a, b)[:200], (b - a) / 1e9]
                      for a, b in gaps[:top]],
    }
