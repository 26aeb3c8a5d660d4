"""Mean kinetic temperature of every NVT driver of the port and of the JAX
package, in f64 on the CPU, from one shared equilibrated start.

    JAX_PLATFORMS=cpu python tests/thermostat_bias.py [--steps N] [--jobs K]
        [--seed S] [--drivers D ...]

The box is the dense 192-atom water box of ``tests/test_torch_csvr.py``
(``jax_water(4, 0.6, direct_method="dense")``: classical Ewald, charge
flux, the water bonds and angles).  The port equilibrates it once with
BAOAB Langevin at 20/ps for 6000 steps from a NumPy Maxwell start, and
the centre-of-mass velocity is removed; then each driver runs ``N``
(20000) steps (RESPA: outer steps) from that state on both packages,
each package drawing its own noise (the port from a ``torch.Generator``,
the JAX package from its key chain):

* BAOAB Langevin, 0.5 fs, 5/ps;
* CSVR, tau 0.1 ps;
* the Nose-Hoover chain, 3 links, tau 0.02 ps (3N - 3 degrees of freedom);
* RESPA Langevin, 2 fs outer steps of 4 bonded BAOAB substeps, 5/ps
  (the settings of the JAX package's ``bench.py respa``);
* temperature REMD on a geometric 300-450 K ladder of 4 slots, 5/ps, a
  sweep every 10 steps (slot temperatures sampled every 100 steps).

The first tenth of each run is dropped; the mean temperature's standard
error comes from 20 block means.  Each (package, driver) runs in its own
process (``--jobs`` at a time, one thread each).  Prints one line per run
and a JSON object of them all.  This compares the two packages and so
imports both; it is a script beside the tests, not a test (a run takes
tens of minutes of CPU).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

DT = 5e-4             # ps
TEMP = 300.0          # K
GAMMA = 5.0           # 1/ps
TAU_CSVR = 0.1        # ps
TAU_NHC = 0.02        # ps
DT_OUTER, N_INNER = 2e-3, 4
LADDER = 300.0 * 1.5 ** (np.arange(4) / 3)
REMD_CALL = 100       # REMD steps between slot samples
EQ_STEPS = 6000       # the shared equilibration (3 ps at 20/ps)
BLOCKS = 20
KB = 0.00831446261815324
DRIVERS = ("baoab", "csvr", "nhc", "respa", "remd")


def _box():
    """(jax system, port system, positions, masses, jax bonded, port
    bonded) of the dense 192-atom box, in f64."""
    import jax.numpy as jnp
    import torch

    from chargeflux_tpu.models import water_bonded_params as jax_bonded
    from chargeflux_tpu_torch.models import water_bonded_params
    from torch_helpers import jax_water

    jsys, tsys, pos, masses = jax_water(4, 0.6, direct_method="dense")
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)
    return (jsys, tsys, pos, np.asarray(masses, np.float64),
            jax_bonded(n_w, box=box, dtype=jnp.float64),
            water_bonded_params(n_w, box=box, dtype=torch.float64,
                                device="cpu"))


def _setup_process():
    import jax
    import torch

    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)


def equilibrate(seed: int = 11):
    """The shared start: the port's BAOAB at 20/ps for EQ_STEPS from a
    NumPy Maxwell start at 300 K, the centre-of-mass velocity removed."""
    import torch

    from chargeflux_tpu_torch import integrate
    from torch_helpers import maxwell_start

    _, tsys, pos, masses, _, tb = _box()
    x0, v0 = maxwell_start(pos, masses, seed=seed)
    e_fn = integrate.make_energy_fn(tsys, bonded=tb)
    s = integrate.init_state(torch.as_tensor(x0), torch.as_tensor(v0), e_fn)
    fin, _ = integrate.langevin_trajectory(
        s, e_fn, torch.as_tensor(masses), DT, TEMP, 20.0,
        torch.Generator().manual_seed(seed), EQ_STEPS)
    x, v = fin.positions.numpy(), fin.velocities.numpy()
    v = v - (masses[:, None] * v).sum(0) / masses.sum()
    return x, v


def _temps(kes, n_dof):
    return 2.0 * np.asarray(kes, np.float64) / (n_dof * KB)


def run_port(driver: str, x0, v0, n_steps: int, seed: int):
    """The port's temperatures: [samples] (REMD: [samples, slots])."""
    import torch

    from chargeflux_tpu_torch import csvr, integrate, nosehoover
    from chargeflux_tpu_torch.parallel.replicas import (
        _forces, remd_langevin_trajectory, replica_energy_fn)

    _, tsys, _, masses, _, tb = _box()
    m = torch.as_tensor(masses)
    x, v = torch.as_tensor(x0), torch.as_tensor(v0)
    gen = torch.Generator().manual_seed(seed)
    n3 = 3 * x.shape[0]
    if driver == "respa":
        slow, fast, init_nb = integrate.make_respa_force_fns(tsys, tb)
        e_nb, _ = integrate.make_nb_energy_fn(tsys, bonded=tb)
        s = integrate.init_state_nb(x, v, e_nb, init_nb)
        _, kes = integrate.respa_langevin_trajectory_nb(
            s, slow, fast, init_nb, m, DT_OUTER, N_INNER, TEMP, GAMMA, gen,
            n_steps, rebuild_every=10)
        return _temps(kes.numpy(), n3)
    if driver == "remd":
        e_fn = replica_energy_fn(tsys, bonded=tb)
        xb = x.expand(len(LADDER), -1, -1).contiguous()
        scale = torch.as_tensor(np.sqrt(LADDER / TEMP))[:, None, None]
        pot, f = _forces(e_fn, xb)
        state = integrate.MDState(xb, v * scale, f, pot)
        out = []
        for _ in range(n_steps // REMD_CALL):
            state, _, _ = remd_langevin_trajectory(
                state, e_fn, m, DT, LADDER, GAMMA, gen, REMD_CALL)
            ke = 0.5 * torch.sum(m[:, None] * state.velocities ** 2,
                                 dim=(1, 2))
            out.append(_temps(ke.numpy(), n3))
        return np.stack(out)
    e_fn = integrate.make_energy_fn(tsys, bonded=tb)
    s = integrate.init_state(x, v, e_fn)
    if driver == "baoab":
        _, kes = integrate.langevin_trajectory(s, e_fn, m, DT, TEMP, GAMMA,
                                               gen, n_steps)
        return _temps(kes.numpy(), n3)
    if driver == "csvr":
        _, diag = csvr.csvr_trajectory(s, e_fn, m, DT, TEMP, TAU_CSVR, gen,
                                       n_steps)
        return _temps(diag["kinetic"].numpy(), n3)
    _, _, kes = nosehoover.nose_hoover_trajectory(s, e_fn, m, DT, TEMP,
                                                  TAU_NHC, n_steps)
    return _temps(kes.numpy(), n3 - 3)


def run_jax(driver: str, x0, v0, n_steps: int, seed: int):
    """The JAX package's temperatures, as :func:`run_port`."""
    import jax
    import jax.numpy as jnp

    from chargeflux_tpu import csvr as jcsvr
    from chargeflux_tpu import integrate as ji
    from chargeflux_tpu import nosehoover as jnh
    from chargeflux_tpu.parallel.replicas import remd_langevin_trajectory

    jsys, _, _, masses, jb, _ = _box()
    m = jnp.asarray(masses)
    x, v = jnp.asarray(x0), jnp.asarray(v0)
    key = jax.random.PRNGKey(seed)
    n3 = 3 * x.shape[0]
    if driver == "respa":
        slow, fast, init_nb = ji.make_respa_force_fns(jsys, jb)
        e_nb, _ = ji.make_nb_energy_fn(jsys, bonded=jb)
        s = ji.init_state_nb(x, v, e_nb, init_nb)
        _, kes = ji.respa_langevin_trajectory_nb(
            s, slow, fast, init_nb, m, DT_OUTER, N_INNER, TEMP, GAMMA, key,
            n_steps, rebuild_every=10)
        return _temps(kes, n3)
    e_fn = ji.make_energy_fn(jsys, bonded=jb)
    if driver == "remd":
        r = len(LADDER)
        xb = jnp.broadcast_to(x, (r,) + x.shape)
        vb = v[None] * jnp.sqrt(jnp.asarray(LADDER) / TEMP)[:, None, None]
        pot, g = jax.vmap(jax.value_and_grad(e_fn))(xb)
        state = ji.MDState(xb, vb, -g, pot)
        call = jax.jit(lambda st, k: remd_langevin_trajectory(
            st, e_fn, m, DT, LADDER, GAMMA, k, REMD_CALL)[0])
        out = []
        for _ in range(n_steps // REMD_CALL):
            key, sub = jax.random.split(key)
            state = call(state, sub)
            ke = 0.5 * jnp.sum(m[:, None] * state.velocities ** 2,
                               axis=(1, 2))
            out.append(_temps(ke, n3))
        return np.stack(out)
    s = ji.init_state(x, v, e_fn)
    if driver == "baoab":
        _, kes = ji.langevin_trajectory(s, e_fn, m, DT, TEMP, GAMMA, key,
                                        n_steps)
        return _temps(kes, n3)
    if driver == "csvr":
        _, diag = jcsvr.csvr_trajectory(s, e_fn, m, DT, TEMP, TAU_CSVR, key,
                                        n_steps)
        return _temps(diag["kinetic"], n3)
    _, _, kes = jnh.nose_hoover_trajectory(s, e_fn, m, DT, TEMP, TAU_NHC,
                                           n_steps)
    return _temps(kes, n3 - 3)


def block_stats(temps, blocks: int = BLOCKS):
    """(mean, standard error) over the last nine tenths of ``temps``
    (samples first; REMD: per slot) from ``blocks`` block means."""
    t = np.asarray(temps, np.float64)
    t = t[len(t) // 10:]
    t = t[:len(t) - len(t) % blocks]
    means = t.reshape((blocks, -1) + t.shape[1:]).mean(axis=1)
    return means.mean(axis=0), means.std(axis=0, ddof=1) / np.sqrt(blocks)


def _job(args):
    package, driver, x0, v0, n_steps, seed = args
    _setup_process()
    t0 = time.perf_counter()
    run = run_port if package == "port" else run_jax
    temps = run(driver, x0, v0, n_steps, seed)
    mean, se = block_stats(temps)
    return package, driver, np.atleast_1d(mean).tolist(), \
        np.atleast_1d(se).tolist(), time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20000,
                    help="steps of each driver (RESPA: outer steps)")
    ap.add_argument("--jobs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--drivers", nargs="+", choices=DRIVERS, default=DRIVERS)
    args = ap.parse_args(argv)
    _setup_process()
    t0 = time.perf_counter()
    x0, v0 = equilibrate()
    print(f"equilibrated: {EQ_STEPS} BAOAB steps at 20/ps in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    jobs = [(p, d, x0, v0, args.steps, args.seed)
            for d in args.drivers for p in ("port", "jax")]
    out = {}
    with mp.get_context("spawn").Pool(args.jobs) as pool:
        for package, driver, mean, se, secs in pool.imap_unordered(_job,
                                                                    jobs):
            out.setdefault(driver, {})[package] = {"mean_k": mean,
                                                   "se_k": se,
                                                   "seconds": secs}
            print(f"{driver} {package}: mean T "
                  + ", ".join(f"{m:.2f} +- {e:.2f}" for m, e in zip(mean, se))
                  + f" K ({secs:.0f} s)", flush=True)
    for driver, res in out.items():
        p, j = res["port"], res["jax"]
        res["z"] = [(a - b) / np.hypot(c, d) for a, b, c, d in
                    zip(p["mean_k"], j["mean_k"], p["se_k"], j["se_k"])]
    print(json.dumps({"steps": args.steps, "ladder_k": LADDER.tolist(),
                      "drivers": out}), flush=True)


if __name__ == "__main__":
    main()
