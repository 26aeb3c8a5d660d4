"""The comparison of a molecular-dynamics window (``"check": "md"``).

The driver copies a frame to the host at the end of every report
interval: the positions, velocities and forces of the last step, and the
per-step records.  Once the window has closed the reference evaluates a
sample of the frames drawn from the seed, the last one always in it:

``force_rms``
    the largest, over the sampled frames, of RMS(F - F_ref) / RMS(F_ref):
    the forces the last step used, against the reference's at the same
    positions;
``energy_rel``
    the largest |E - E_ref| / sum |E_ref,c| of the potential energy at the
    same frames, over the sum of the magnitudes of the reference's terms
    (direct, exclusion, self, reciprocal, bonded), the scale of a float32
    sum's rounding; E is the last step's record (potential plus kinetic
    energy) less the kinetic energy of the frame's velocities;
``unmoved``
    the frames whose positions moved less than 1e-4 nm RMS since the frame
    before: a step that returns its state unchanged.

The control (``precision="tf32"``) puts the reference computed in TF32 in
the program's place at the same frames.
"""

from __future__ import annotations

import torch

from . import rms_rel, sample_frames, unmoved, worst
from ..reference.water import Model


def _kinetic(v, masses) -> float:
    v = v.double()
    return float(0.5 * torch.sum(masses[:, None] * v * v))


def readings(cfg: dict, frames: list, seed: int, device, sample: int,
             masses, box, precision: str = None) -> dict:
    """The numbers of a window's frames: the program's (``precision``
    None) or the control's, the reference computed in ``precision`` in
    the program's place."""
    ref = Model(cfg["water"], cfg["system"], box, "f64", device)
    ctl = (None if precision is None
           else Model(cfg["water"], cfg["system"], box, precision, device))
    m64 = torch.as_tensor(masses, dtype=torch.float64)
    force_rms = energy_rel = 0.0
    for k in sample_frames(len(frames), seed, sample):
        fr = frames[k]
        e_ref, f_ref, scale = ref.energy_forces(fr["x"])
        if ctl is not None:
            e, f, _s = ctl.energy_forces(fr["x"])
            e = float(e)
        else:
            f = fr["f"]
            e = float(fr["es"][-1]) - _kinetic(fr["v"], m64)
        force_rms = worst(force_rms, rms_rel(f.cpu(), f_ref.cpu()))
        energy_rel = worst(energy_rel, abs(e - float(e_ref)) / scale)
    out = {"force_rms": force_rms, "energy_rel": energy_rel}
    if precision is None:
        out["unmoved"] = unmoved(frames)
    return out
