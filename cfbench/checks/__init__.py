"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (``cfbench.reference``) in float64.

A mix names its comparison by ``check``: ``cfbench/checks/<check>.py``,
whose ``readings(cfg, frames, seed, device, sample, precision=None,
**inputs)`` returns each number the cell's limits file
(``cfbench/limits/<workload>.json``) holds a limit for; ``inputs`` are
what the driver's ``check_inputs()`` handed over before its state was
freed.  With ``precision`` the reference computed so takes the program's
place: the control.  This module holds what the comparisons share.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: a frame that moved less than this RMS (nm) since the one before did
#: not move: a step that returns its state unchanged
UNMOVED_NM = 1e-4


def sample_frames(n: int, seed: int, count: int) -> list:
    """Indices of ``count`` frames of ``n``, drawn from the seed, the last
    frame always among them."""
    rng = np.random.default_rng([seed, 7])
    rest = rng.permutation(n - 1)[:max(count - 1, 0)]
    return sorted(set(int(i) for i in rest) | {n - 1})


def worst(a: float, b: float) -> float:
    """The larger of two readings, a NaN reading counting as infinite."""
    return max(math.inf if math.isnan(a) else a,
               math.inf if math.isnan(b) else b)


def rms_rel(f, f_ref) -> float:
    """RMS(f - f_ref) / RMS(f_ref), in float64."""
    f, f_ref = f.double(), f_ref.double()
    return float(torch.sqrt(torch.mean((f - f_ref) ** 2))
                 / torch.sqrt(torch.mean(f_ref ** 2)))


def unmoved(frames) -> int:
    """Frames whose positions moved less than ``UNMOVED_NM`` RMS since the
    frame before."""
    count = 0
    for a, b in zip(frames, frames[1:]):
        d = (b["x"].double() - a["x"].double()) ** 2
        count += int(torch.sqrt(torch.mean(d)) < UNMOVED_NM)
    return count
