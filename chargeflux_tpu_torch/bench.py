"""The JAX package's bench.py, measured on the CUDA card: ms per MD step of
one configuration, printed as one JSON line with bench.py's metric names
and fields.

    python3 -m chargeflux_tpu_torch.bench [216|4k|30k|100k|tri30k|hetero30k|rigid|respa|npt]

Each configuration is built as bench.py builds it
(``utils.measure.bench_path``; rigid, respa and npt through
``utils.measure.rigid_path``, ``respa_path`` and ``npt_path``), the cell
configurations burned in and re-provisioned as there
(``utils.measure.burn_in``).  The
trajectory drivers replay each rebuild chunk as a CUDA graph, as a user's
call does.  Timing keeps bench.py's pairing: after a warm-up, per
repetition the CUDA-event times of two calls of k1 and k2 = 6 k1 rebuild
chunks from the same state, and the median over the repetitions of
t(k2) - t(k1) over the steps between them, which cancels the copy-in and
the eager final evaluation of a call.  Beside it, ``replays_alone_ms``:
ten back-to-back replays of the captured chunk, and ``card``: the SM
clock, power draw and temperature ``nvidia-smi`` reads after the timing.

The 30k line adds ``phases_ms``: device times of the fwd+grad variants of
bench.py's ``measure_phases`` (base = flux charges, blockify, self and
exclusion terms on a frozen binning; base + walk; base + SPME; the whole
evaluation with its binning; the binning alone), each a CUDA graph of
calls (``utils.measure.interleaved_ms``), and the walk's and the
reciprocal's marginal costs; and bench.py's rc 0.9 and rc 1.0 legs, whose
failure is recorded in the line as bench.py records it.  Every line
carries ``device``: the card's name and power limit from ``nvidia-smi``.

Not ported: ``vs_baseline`` and ``last_measured_tpu_ms`` (TPU targets and
TPU times), and the CPU fallback: without CUDA this raises unless
``--device cpu`` is given (the tests' small runs).

The replicas line (``ms_per_step_64x216_replica_ensemble``: ms per step
of x <- x - 1e-9 grad E for each of 64 replicas of the 216-water box,
``utils.measure.replicas_path`` / ``replica_drive``) times bench.py's
k1 = 3 and k2 = 13 steps, 5 repetitions, on the route
``recip_method="auto"`` takes for a batch (``route``), and in the same
call the other reciprocal route: ``route_ms`` holds both, "xla" the plain
batched product and "pallas" the batched structure-factor kernels.

The npt line (``ms_per_npt_md_step_30k_ewald_f32``: ms per NPT step, the
attempt and its re-binning amortised over the barostat interval) adds
bench.py's ``barostat_interval``, and from one more replayed call of
:data:`NPT_ATTEMPTS` attempts after the timing, the accept fraction and
the count of poisoned proposals.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import torch

from . import cells
from .charges import effective_charges
from .device import resolve_device
from .energy import _energy, _exclusion_correction
from .ewald import self_energy
from .integrate import init_state_nb, make_nb_energy_fn
from .pme import pme_cell_column_reciprocal_energy
from .utils import measure

CONFIGS = ("216", "4k", "30k", "100k", "tri30k", "hetero30k", "rigid",
           "respa", "npt", "replicas")
#: Configurations of the JAX package's bench.py the port does not run yet,
#: and the ROADMAP item that ports each (none left).
NOT_PORTED = {}
REPLICA_STEPS = (3, 13)    # bench.py replicas' k1, k2
REPLICA_REPS = 5           # and its repetitions
NPT_ATTEMPTS = 100         # attempts of the npt line's acceptance call
REPS = 7                   # bench.py's repetitions of the paired timing
WARM_S = 10.0              # bench.py's warm-up under sustained load (card)


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def device_name(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "cpu"."""
    return _smi("name,power.limit") if dev.type == "cuda" else "cpu"


def card_state(dev):
    """The card's SM clock, its maximum, power draw and temperature as
    ``nvidia-smi`` reads them just after the timed calls (None on the
    CPU)."""
    if dev.type != "cuda":
        return None
    return _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")


def replays_alone_ms(owner, k: int, dev):
    """ms per step of ten back-to-back replays of the captured ``k``-step
    chunk kept on ``owner`` (no copy-in, no final evaluation), CUDA
    events; None on the CPU."""
    if dev.type != "cuda":
        return None
    chunk = next(c for c in owner.nve_chunks.values()
                 if c.k == k and c.graph is not None)
    start, stop = _clock(dev)
    start()
    for _ in range(10):
        chunk()
    return stop() / (10 * k)


def _clock(dev):
    """``start()``/``stop() -> ms`` around a call: CUDA events on the card,
    the host clock on the CPU."""
    if dev.type == "cuda":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def start():
            torch.cuda.synchronize(dev)
            a.record()

        def stop():
            b.record()
            torch.cuda.synchronize(dev)
            return a.elapsed_time(b)
    else:
        t0 = [0.0]

        def start():
            t0[0] = time.perf_counter()

        def stop():
            return (time.perf_counter() - t0[0]) * 1e3
    return start, stop


def paired_ms(drive, k1: int, k2: int, dev, reps: int = REPS):
    """ms per step: the median over ``reps`` of t(k2) - t(k1) over
    (k2 - k1), each t the time of one ``drive(n_steps)`` call (bench.py's
    ``_timed_scan``), after calls of k2 steps for WARM_S seconds on the
    card (one call on the CPU).  Raises if a timed call's per-step records
    are not all finite.  Returns (ms/step, the last record of the longest
    call)."""
    drive(k1)                               # captures the chunk graphs
    t_end = time.perf_counter() + (WARM_S if dev.type == "cuda" else 0.0)
    while True:
        drive(k2)
        if time.perf_counter() >= t_end:
            break
    start, stop = _clock(dev)

    def t(k):
        start()
        out = drive(k)
        ms = stop()
        if not torch.isfinite(out[1]).all():
            raise RuntimeError(f"a timed run of {k} steps NaN-poisoned")
        return ms, out

    diffs = []
    for _ in range(reps):
        ms2, out = t(k2)
        ms1, _ = t(k1)
        diffs.append(ms2 - ms1)
    return statistics.median(diffs) / (k2 - k1), float(out[1][-1])


def _chunks(rebuild_every: int, steps):
    """(k1, k2) in steps: bench.py's k1 = max(1, 10 // rebuild_every)
    rebuild chunks, or ``steps``; k2 = 6 k1."""
    k1 = steps or max(1, 10 // rebuild_every) * rebuild_every
    return k1, 6 * k1


def measure_md_step(config, dev, steps=None, cutoff=None):
    """ms per NVE step of a bench config with neighbor reuse (bench.py's
    ``measure_md_step``): the dense 216 box from its lattice at rest in
    10-step chunks; a cell box after ``utils.measure.burn_in``.  Returns
    (ms, fields, context)."""
    force, x, m, box, bonded, system = measure.bench_path(config, dev, cutoff)
    if system.spec.direct_method != "cell":
        state = init_state_nb(x, torch.zeros_like(x),
                              *make_nb_energy_fn(system, bonded=bonded))
        rebuild_every = 10
    else:
        system, state, rebuild_every, _info = measure.burn_in(
            force, system, x, m, box, bonded)
    drive, owner, _ = measure.nve_drive(system, state, rebuild_every, m,
                                        bonded)
    k1, k2 = _chunks(rebuild_every, steps)
    ms, e_last = paired_ms(lambda n: drive(n, True, False), k1, k2, dev)
    fields = dict(replays_alone_ms=replays_alone_ms(owner, rebuild_every,
                                                    dev),
                  card=card_state(dev),
                  dt_fs=measure.DT_PS * 1e3, atoms=system.n_atoms,
                  rebuild_every=rebuild_every,
                  cell_capacity=system.spec.cell_capacity,
                  cell_grid=(list(system.spec.cell_grid)
                             if system.spec.cell_grid else None),
                  energy=e_last)
    return ms, fields, (system, state)


def measure_phases(system, state):
    """bench.py's per-phase split as device times of fwd+grad calls, each
    a CUDA graph of ``utils.measure.GRAPH_REPS`` calls (median of
    ``utils.measure.ROUNDS`` rounds in turns), on the state's frozen
    neighbor state: the base (flux charges, blockify, self and exclusion
    terms), base + walk, base + SPME, the whole evaluation with its own
    binning, and the binning alone; with the walk's and the reciprocal's
    marginal costs."""
    spec = system.spec
    x, nb = state.positions, state.nb
    ids = nb.slots.reshape(tuple(spec.cell_grid) + (spec.cell_capacity,))

    def make_e(with_walk, with_recip):
        def f(xx):
            q = effective_charges(xx, system)
            b = cells.blockify(xx, q, system, nb.slots, nb.inv_slot,
                               wrap=nb.wrap)
            e = (torch.sum(b.x) * 1e-20 + self_energy(q, spec.alpha)
                 + _exclusion_correction(xx, q, system, True))
            if with_walk:
                e = e + cells.direct_energy_on_blocks(b, ids, system)
            if with_recip:
                e = e + pme_cell_column_reciprocal_energy(b, ids, system)
            return e
        return f

    def fwd_grad(f):
        def run():
            xx = x.detach().requires_grad_(True)
            with torch.enable_grad():
                torch.autograd.grad(f(xx), xx)
        return run

    def binning():
        cells.build_cell_list_full(x, system.box, spec.cell_grid,
                                   spec.cell_capacity,
                                   plain=not system.uses_kernels)

    base, walk, recip, full, binned = measure.interleaved_ms([
        fwd_grad(make_e(False, False)), fwd_grad(make_e(True, False)),
        fwd_grad(make_e(False, True)),
        fwd_grad(lambda xx: _energy(xx, system)), binning])
    return {"base_charges_blockify_excl": base,
            "direct_in_context": walk - base,
            "recip_in_context": recip - base,
            "binning_standalone": binned,
            "full_fwd_grad_incl_binning": full}


def bench_md(config, dev, steps=None) -> dict:
    """bench.py's NVE configs: 216, 4k, 30k, 100k, tri30k, hetero30k."""
    ms, fields, (system, state) = measure_md_step(config, dev, steps)
    line = {"metric": f"ms_per_md_step_{config}_ewald_f32", "value": ms,
            "unit": "ms", "ns_per_day": measure.ns_per_day(measure.DT_PS, ms),
            **fields}
    if config == "hetero30k":
        line["solute_atoms"] = 300
        line["remainder_rows"] = dict(system.spec.flux_template.remainder)
    if config == "30k" and dev.type == "cuda":
        line["phases_ms"] = measure_phases(system, state)
        line["model_cutoff_nm"] = system.spec.cutoff
        # bench.py's side legs: the rounds 1-2 cutoff and the reference's
        # default one, each on the planner's cell grid; a failure is
        # recorded in the line and does not sink the headline metric
        for tag, rc in (("rc09", 0.9), ("rc10", 1.0)):
            try:
                ms_rc, f_rc, _ = measure_md_step(config, dev, steps, rc)
                if not math.isfinite(f_rc["energy"]):
                    raise RuntimeError("non-finite energy")
                line[f"ms_per_md_step_{tag}"] = ms_rc
                line[f"{tag}_cell_capacity"] = f_rc["cell_capacity"]
                line[f"{tag}_cell_grid"] = f_rc["cell_grid"]
            except Exception as exc:  # noqa: BLE001 - bench.py's side legs
                line[f"{tag}_error"] = f"{type(exc).__name__}: {exc}"[:120]
    return line


def bench_nvt(config, dev, steps=None) -> dict:
    """bench.py's rigid (RATTLE-BAOAB at 2 fs) and respa (4 bonded
    substeps per 2 fs outer step) configs at the 30k box; steps are
    (outer) steps of 2 fs."""
    if config == "rigid":
        path = measure.rigid_path(dev)
        drive, owner, _ = measure.rigid_drive(path)
        metric = "ms_per_rigid_md_step_30k_ewald_f32"
        extra = {"dt_fs": measure.DT_RIGID * 1e3}
        dt_ps = measure.DT_RIGID
    else:
        path = measure.respa_path(dev)
        drive, owner, _ = measure.respa_drive(path)
        metric = "ms_per_respa_outer_step_30k_ewald_f32"
        dt_ps = measure.DT_PS * measure.N_INNER
        extra = {"dt_fs": dt_ps * 1e3, "dt_outer_fs": dt_ps * 1e3,
                 "n_inner": measure.N_INNER}
    every = path["rebuild_every"]
    k1, k2 = _chunks(every, steps)
    ms, ke_last = paired_ms(lambda n: drive(n, True, False), k1, k2, dev)
    system = path["system"]
    return {"metric": metric, "value": ms, "unit": "ms",
            "ns_per_day": measure.ns_per_day(dt_ps, ms),
            "replays_alone_ms": replays_alone_ms(owner, every, dev),
            "card": card_state(dev), **extra,
            "atoms": system.n_atoms, "rebuild_every": every,
            "cell_capacity": system.spec.cell_capacity,
            "cell_grid": list(system.spec.cell_grid),
            "kinetic_energy": ke_last}


def bench_npt(dev, steps=None, path=None) -> dict:
    """bench.py's npt config (``utils.measure.npt_path``, or ``path``):
    NPT steps of 0.5 fs, one barostat attempt per interval, timed as the
    other configs; then one call of :data:`NPT_ATTEMPTS` attempts for the
    acceptance statistics, whose energies must be finite too."""
    path = path or measure.npt_path(dev)
    drive, owner, _ = measure.npt_drive(path)
    every = path["rebuild_every"]
    k1, k2 = _chunks(every, steps)
    if k1 % every:
        raise ValueError(f"--steps must be a multiple of the barostat "
                         f"interval {every}")
    ms, e_last = paired_ms(lambda n: drive(n, True, False), k1, k2, dev)
    run, es = drive(NPT_ATTEMPTS * every, True, False)
    diag = run.diag
    system = path["system"]
    return {"metric": "ms_per_npt_md_step_30k_ewald_f32", "value": ms,
            "unit": "ms", "ns_per_day": measure.ns_per_day(measure.DT_PS, ms),
            "replays_alone_ms": replays_alone_ms(owner, every, dev),
            "card": card_state(dev), "dt_fs": measure.DT_PS * 1e3,
            "barostat_interval": every, "atoms": system.n_atoms,
            "cell_capacity": system.spec.cell_capacity,
            "cell_grid": list(system.spec.cell_grid),
            "attempts": NPT_ATTEMPTS,
            "accept_fraction": float(diag["accepts"].double().mean()),
            "poisoned": int(diag["poisoned"].sum()),
            "energy": e_last,
            "energies_finite": bool(torch.isfinite(es).all())}


def bench_replicas(dev, steps=None, n_replicas=None) -> dict:
    """bench.py's replicas config: ms per step of the 64 x 216 ensemble
    on both reciprocal routes in one call (the headline on the route
    "auto" takes for a batch, ``parallel.replicas.vmap_friendly_system``)."""
    n_replicas = n_replicas or measure.REPLICAS
    k1, k2 = (steps, 13 * steps // 3) if steps else REPLICA_STEPS
    auto = measure.replicas_path(dev, n_replicas).get("system")
    route = auto.spec.recip_method
    route_ms, e_last = {}, {}
    for recip in ("xla", "pallas"):
        path = measure.replicas_path(dev, n_replicas, recip=recip)
        drive, _owner = measure.replica_drive(path)
        route_ms[recip], e_last[recip] = paired_ms(drive, k1, k2, dev,
                                                   REPLICA_REPS)
    ms = route_ms[route]
    return {"metric": f"ms_per_step_{n_replicas}x216_replica_ensemble",
            "value": ms, "unit": "ms", "route": route, "route_ms": route_ms,
            "replicas": n_replicas, "atoms": auto.n_atoms,
            "steps": [k1, k2], "card": card_state(dev),
            "energy": e_last[route], "energy_other_route": e_last[
                "pallas" if route == "xla" else "xla"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="30k",
                    choices=CONFIGS + tuple(NOT_PORTED))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of the shorter timed call (default: "
                         "bench.py's, 10 steps rounded to whole chunks)")
    args = ap.parse_args(argv)
    if args.config in NOT_PORTED:
        raise SystemExit(f"bench {args.config}: not ported yet, "
                         f"{NOT_PORTED[args.config]}")
    dev = resolve_device(args.device)
    if args.config == "replicas":
        line = bench_replicas(dev, args.steps)
        finite = math.isfinite(line["energy"])
    elif args.config == "npt":
        line = bench_npt(dev, args.steps)
        finite = math.isfinite(line["energy"]) and line["energies_finite"]
    elif args.config in ("rigid", "respa"):
        line = bench_nvt(args.config, dev, args.steps)
        finite = math.isfinite(line["kinetic_energy"])
    else:
        line = bench_md(args.config, dev, args.steps)
        finite = math.isfinite(line["energy"])
    line["device"] = device_name(dev)
    print(json.dumps(line), flush=True)
    if not finite:
        raise SystemExit(f"bench {args.config}: the trajectory produced NaN")


if __name__ == "__main__":
    main()
