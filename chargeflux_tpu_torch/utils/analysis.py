"""Trajectory analysis observables (torch counterpart of
``chargeflux_tpu.utils.analysis``).

:func:`total_dipole` and :func:`radial_distribution` run on the tensors'
device; the time-correlation functions and the IR line shape are host-side
NumPy, as in the JAX package (analysis of saved trajectories).  The radial
distribution histograms min-image pair distances in chunks of ``idx_a``
rows, binned by ``torch.bucketize`` and a weighted ``scatter_add_`` (no
``torch.histogram`` on CUDA), with ``jnp.histogram``'s edge rule: a
distance equal to the last edge falls in the last bin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..pairs import delta_periodic
from .trajectory import _host


def _lags(f: int, max_lag):
    return f - 1 if max_lag is None else min(max_lag, f - 1)


def mean_squared_displacement(frames, max_lag: int = None):
    """MSD(lag) over UNWRAPPED [F, N, 3] coordinates (the engine never
    wraps positions), [max_lag] averaged over start times and atoms
    (host-side NumPy).  D = slope / (6 dt) in the linear regime."""
    frames = _host(frames)
    max_lag = _lags(frames.shape[0], max_lag)
    out = np.empty(max_lag, np.float64)
    for lag in range(1, max_lag + 1):
        d = frames[lag:] - frames[:-lag]
        out[lag - 1] = np.mean(np.sum(d * d, axis=-1))
    return out


def velocity_autocorrelation(vel_frames, max_lag: int = None):
    """Normalized VACF over [F, N, 3] velocity frames, C(lag) =
    <v(t).v(t+lag)> / <v.v>, [max_lag + 1] averaged over start times and
    atoms (host-side NumPy)."""
    v = _host(vel_frames)
    max_lag = _lags(v.shape[0], max_lag)
    c0 = np.mean(np.sum(v * v, axis=-1))
    out = np.empty(max_lag + 1, np.float64)
    out[0] = 1.0
    for lag in range(1, max_lag + 1):
        out[lag] = np.mean(np.sum(v[lag:] * v[:-lag], axis=-1)) / c0
    return out


def total_dipole(positions, system) -> torch.Tensor:
    """Total dipole M = sum_i q_i(x) x_i (e nm) with the geometry-dependent
    effective charges; translation-invariant for a neutral system (every
    flux term conserves the total charge)."""
    from ..charges import effective_charges

    q = effective_charges(positions, system)
    return torch.sum(q[:, None] * positions, dim=0)


def dipole_autocorrelation(m_frames, max_lag: int = None):
    """Normalized total-dipole fluctuation ACF over [F, 3] dipole frames,
    C(lag) = <dM(t).dM(t+lag)> / <dM.dM> with dM = M - <M> (host-side
    NumPy); identically 1 for a constant dipole."""
    m = _host(m_frames)
    dm = m - m.mean(axis=0, keepdims=True)
    max_lag = _lags(m.shape[0], max_lag)
    if not np.any(dm):
        return np.ones(max_lag + 1, np.float64)
    return velocity_autocorrelation(dm, max_lag)


def infrared_spectrum(m_frames, dt: float):
    """IR line shape from a total-dipole trajectory [F, 3] sampled every
    ``dt`` ps: (frequencies in THz, I(nu) ~ nu^2 |FT{M}|^2), the
    harmonic-approximation absorption profile up to constants (host-side
    NumPy)."""
    m = _host(m_frames)
    m = m - m.mean(axis=0, keepdims=True)
    ft = np.fft.rfft(m, axis=0)
    power = np.sum(np.abs(ft) ** 2, axis=-1)
    freq = np.fft.rfftfreq(m.shape[0], d=dt)
    return freq, (2.0 * np.pi * freq) ** 2 * power


def radial_distribution(positions, box, idx_a, idx_b, r_max: float,
                        n_bins: int = 100, chunk: int = 512):
    """g(r) between the selections ``idx_a`` and ``idx_b`` (atom index
    arrays) in an orthorhombic box; returns (r_centers [n_bins],
    g [n_bins]) on the positions' device.

    Ordered pairs i != j are histogrammed in chunks of ``idx_a`` rows and
    normalized by the ideal-gas shell count N_a N_b(-1) 4 pi r^2 dr / V, so
    a uniform fluid gives g = 1; ``r_max`` should be <= min(box) / 2."""
    positions = torch.as_tensor(positions)
    dtype, dev = positions.dtype, positions.device
    box = torch.as_tensor(box, device=dev).to(dtype)
    idx_a = np.asarray(idx_a, np.int64).reshape(-1)
    idx_b = np.asarray(idx_b, np.int64).reshape(-1)
    n_a, n_b = idx_a.shape[0], idx_b.shape[0]
    # the i == j pairs dropped by the mask leave the ideal count too, for
    # any overlap of the selections
    overlap = len(np.intersect1d(idx_a, idx_b))
    ia_all = torch.as_tensor(idx_a, device=dev)
    ib = torch.as_tensor(idx_b, device=dev)
    pb = positions[ib]
    edges = torch.as_tensor(np.linspace(0.0, r_max, n_bins + 1),
                            device=dev).to(dtype)
    # bins 1..n_bins are the histogram; 0 and n_bins + 1 catch r < 0 and
    # r > r_max
    hist = torch.zeros((n_bins + 2,), dtype=dtype, device=dev)
    for c0 in range(0, n_a, chunk):
        ia = ia_all[c0:c0 + chunk]
        d = delta_periodic(positions[ia][:, None, :], pb[None, :, :], box)
        r = torch.sqrt(torch.sum(d * d, dim=-1)).reshape(-1)
        w = (ia[:, None] != ib[None, :]).reshape(-1).to(dtype)
        k = torch.bucketize(r, edges, right=True)
        k = torch.where(r == edges[-1], n_bins, k)
        hist.scatter_add_(0, k, w)
    hist = hist[1:n_bins + 1]
    vol = box[0] * box[1] * box[2]
    r_lo, r_hi = edges[:-1], edges[1:]
    shell = 4.0 / 3.0 * math.pi * (r_hi ** 3 - r_lo ** 3)
    ideal = (n_a * n_b - overlap) * shell / vol
    g = torch.where(ideal > 0, hist / ideal, 0.0)
    return 0.5 * (r_lo + r_hi), g
