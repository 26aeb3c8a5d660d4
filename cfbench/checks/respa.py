"""The comparison of an r-RESPA Langevin window (``"check": "respa"``).

The driver copies a frame to the host at the end of every report
interval: the positions and velocities, the final forces and potential
(evaluated afresh at those positions), the tier forces the last replayed
outer step left (``f_slow``, ``f_fast``, at the same positions), and the
interval's per-outer-step kinetic energies.  Once the window has closed
the reference (``cfbench.reference.respa.tiers``) evaluates a sample of
the frames drawn from the seed, the last one always in it:

``force_rms``, ``energy_rel``
    as the ``md`` check: the final forces against the reference's total,
    and |E - E_ref| over the sum of the magnitudes of the reference's
    terms, E the final potential;
``force_rms_slow``, ``force_rms_fast``
    the replay's own tier forces against the reference's slow tier
    (direct, exclusion, self, reciprocal) and fast tier (bonds and
    angles) at the frame's positions;
``unmoved``
    the frames whose positions moved less than 1e-4 nm RMS since the frame
    before;
``temperature_rel``
    |T - T0| / T0 of the mean kinetic temperature T over every outer step
    of the window against the thermostat's T0.

The control (``precision="tf32"``) puts the reference computed in TF32 in
the program's place at the same frames (the forces, the tiers and the
energy; it has no trajectory of its own).
"""

from __future__ import annotations

import torch

from . import rms_rel, sample_frames, unmoved, worst
from ..reference.respa import kinetic_temperature, tiers
from ..reference.water import Model


def temperature_rel(frames: list, n_atoms: int, target: float) -> float:
    """|mean kinetic temperature over the frames' outer steps - target|
    / target."""
    ke = torch.cat([fr["ke"].double() for fr in frames])
    return abs(kinetic_temperature(float(ke.mean()), n_atoms)
               - target) / target


def readings(cfg: dict, frames: list, seed: int, device, sample: int,
             masses, box, precision: str = None) -> dict:
    """The numbers of a window's frames: the program's (``precision``
    None) or the control's, the reference computed in ``precision`` in
    the program's place."""
    ref = Model(cfg["water"], cfg["system"], box, "f64", device)
    ctl = (None if precision is None
           else Model(cfg["water"], cfg["system"], box, precision, device))
    out = dict.fromkeys(("force_rms", "energy_rel", "force_rms_slow",
                         "force_rms_fast"), 0.0)
    for k in sample_frames(len(frames), seed, sample):
        fr = frames[k]
        want = tiers(ref, fr["x"])
        if ctl is not None:
            got = tiers(ctl, fr["x"])
            f_slow, f_fast = got["f_slow"].cpu(), got["f_fast"].cpu()
            f, e = f_slow + f_fast, float(got["e_slow"] + got["e_fast"])
        else:
            f_slow, f_fast, f = fr["f_slow"], fr["f_fast"], fr["f"]
            e = float(fr["e"])
        f_ref = (want["f_slow"] + want["f_fast"]).cpu()
        e_ref = float(want["e_slow"] + want["e_fast"])
        found = {"force_rms": rms_rel(f, f_ref),
                 "energy_rel": abs(e - e_ref) / want["scale"],
                 "force_rms_slow": rms_rel(f_slow, want["f_slow"].cpu()),
                 "force_rms_fast": rms_rel(f_fast, want["f_fast"].cpu())}
        out = {name: worst(out[name], v) for name, v in found.items()}
    if precision is None:
        out["unmoved"] = unmoved(frames)
        out["temperature_rel"] = temperature_rel(
            frames, len(masses), float(cfg["dynamics"]["temperature_K"]))
    return out
