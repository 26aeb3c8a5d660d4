"""The arithmetic the metric readers share (``cfbench/metrics/``): rates
over the window, idle shares and kernel counts of the trace, and a
stage's roofline share from its kernels' device time and the least time
of ``cfbench.work``.  Each returns None where the trace has nothing to
read, and never 0 for a share of a roofline."""

from __future__ import annotations

import re

#: seconds per day over nanoseconds per picosecond
_NS_PER_DAY = 86400.0 * 1e-3


def ns_per_day(ctx) -> float:
    """Simulated nanoseconds per day of wall time: every step the window
    completed times dt over the window's seconds, summed over the systems
    integrated side by side (an ensemble's replicas)."""
    return ctx.replicas * ctx.steps * ctx.dt_ps * _NS_PER_DAY / ctx.wall_s


def idle_share(ctx):
    """The largest share of the traced window, over the cards, in which no
    operation ran on the card, in %."""
    if not ctx.traces or not any(t["busy_ns"] for t in ctx.traces):
        return None
    return 100.0 * max(1.0 - t["busy_ns"] / t["wall_ns"] for t in ctx.traces)


def kernels_per_step(ctx, pattern=None):
    """Kernels the first card ran per MD step in the traced window (those
    whose name ``pattern`` finds, where given)."""
    if not ctx.traces or not ctx.traces[0]["busy_ns"]:
        return None
    t = ctx.traces[0]
    if pattern is None:
        n = t["kernels"]
    else:
        rx = re.compile(pattern)
        n = sum(c for name, (c, _ns) in t["by_name"].items()
                if rx.search(name))
    return n / ctx.steps if n else None


def roofline(ctx, pattern: str, least_seconds: float):
    """100 x (evaluations x least seconds of one) over the device seconds
    of the stage's kernels (``pattern`` on their names), summed over the
    cards; None where no such kernel ran."""
    rx = re.compile(pattern)
    ns = sum(ns for t in ctx.traces for name, (_c, ns) in
             t["by_name"].items() if rx.search(name))
    if not ns:
        return None
    return 100.0 * ctx.evals * least_seconds / (ns / 1e9)
