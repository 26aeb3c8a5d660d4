"""The r-RESPA cell (``water96k.respa``): it loads by name, a small run on
the CPU is correct and loads no JAX, and its comparison fails where a
fault is planted underneath the driver: the fast tier left out of the
reported tiers, the slow tier altered, the noise left out or weakened,
the state returned unchanged; its readers of ``profiling.respa_ms`` read a record
that accounts for the window and nothing else."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import pytest
import torch

import chargeflux_tpu_torch as port
from chargeflux_tpu_torch import integrate
from chargeflux_tpu_torch.utils import profiling
from cfbench import harness, spec
from cfbench.harness import Ctx
from cfbench.tests.small import small_cell

SEED = 2 ** 31 + 4099
TIER_METRICS = ["respa_ms.fast", "respa_ms.bonded", "respa_ms.slow"] + [
    f"respa_ms.{s}" for s in profiling.SLOW_STAGES]


def respa_cell() -> dict:
    """The cell cut to a CPU size: the small box's 0.064 nm skin wants a
    rebuild every outer step, and its lattice a longer warm start, rescaled
    more often, before it holds 300 K; one burn-in call.  The friction is
    50/ps: 192 atoms' kinetic temperature wanders by about 6 % a step,
    and at the cell's 1/ps a CPU window of a few dozen outer steps is too
    short for its mean to settle within the limit (it read 0.044); 50/ps
    decorrelates it within a few outer steps, and a window without noise
    cools far below 300 K (the card's readings at 1/ps are in the limits
    file)."""
    cell = small_cell("water96k.respa")
    cell["config"]["dynamics"].update(rebuild_every=1, friction_per_ps=50.0)
    cell["traffic"].update(warm_start_steps=480, warm_call_steps=8,
                           warm_rebuild_every=2, burn_in_calls=1)
    return cell


def _run(cell=None, seconds=4.0):
    torch.manual_seed(0)
    return harness.run_cell(cell or respa_cell(), SEED, seconds, False,
                            "cpu", time.perf_counter(), log=lambda m: None)


def test_the_cell_loads_by_name_with_one_chip():
    c = spec.load_cell("water96k.respa")
    d = c["config"]["dynamics"]
    assert c["chips"] == 1 and c["config"]["name"] == "cfwater-96k-mts"
    assert (d["integrator"], d["dt_ps"], d["n_inner"]) == (
        "respa_langevin", 0.002, 4)
    assert c["traffic"]["driver"] == c["traffic"]["check"] == "respa"
    assert set(c["limits"]["limits"]) == {
        "force_rms", "energy_rel", "force_rms_slow", "force_rms_fast",
        "unmoved", "temperature_rel"}
    assert {m["name"] for m in c["end_to_end"]} == {"ns_per_day", "setup_s"}
    assert {m["name"] for m in c["per_layer"]} == {
        "idle_share.md", "kernels_per_step.md", "pme_spread_roofline",
        "direct_walk_roofline", *TIER_METRICS}
    nve = spec.load_cell("water96k.nve")["config"]
    for group in ("system", "water", "lattice"):
        assert c["config"][group] == nve[group], group


def test_a_small_run_is_correct():
    out = _run()
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out)[-1] == "compared"


def test_a_small_run_loads_no_jax():
    code = (
        "import time, torch; torch.set_num_threads(2)\n"
        "from cfbench import harness\n"
        "from cfbench.tests.test_cfbench_respa import respa_cell\n"
        "out = harness.run_cell(respa_cell(), 3, 0.1, False, 'cpu', "
        "time.perf_counter(), log=lambda m: None)\n"
        "print(harness.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_control_fails_the_limits():
    cell = respa_cell()
    t = cell["traffic"]
    drv = spec.driver(t["driver"])(cell["config"], t, torch.device("cpu"))
    drv.start(SEED)
    for _ in range(2):
        drv.interval()
    found = harness.readings(cell, drv.frames, SEED, "cpu",
                             drv.check_inputs(), precision="tf32")
    limits = cell["limits"]["limits"]
    assert any(found[k] > limits[k] for k in found), found


def _fault(monkeypatch, alter):
    real = port.respa_langevin_trajectory_nb

    def broken(state, *args, **kwargs):
        out, kes = real(state, *args, **kwargs)
        return alter(state, out), kes
    monkeypatch.setattr(port, "respa_langevin_trajectory_nb", broken)


def test_the_fast_tier_left_out_fails(monkeypatch):
    _fault(monkeypatch, lambda before, after: dataclasses.replace(
        after, f_fast=torch.zeros_like(after.f_fast)))
    out = _run()
    assert out["compared"]["force_rms_fast"]["value"] >= 1.0
    assert not out["correct"]


def test_the_slow_tier_altered_fails(monkeypatch):
    _fault(monkeypatch, lambda before, after: dataclasses.replace(
        after, f_slow=after.f_slow * 1.001))
    out = _run()
    assert out["compared"]["force_rms_slow"]["value"] > 5e-4
    assert not out["correct"]


def test_the_state_left_unchanged_fails(monkeypatch):
    _fault(monkeypatch, lambda before, after: dataclasses.replace(
        after, positions=before.positions, velocities=before.velocities))
    out = _run()
    assert not out["correct"] and out["compared"]["unmoved"]["value"] > 0


def test_the_noise_left_out_fails(monkeypatch):
    """Friction without noise cools the box: the thermostat holds 300 K
    with its noise and the box cools far below it without."""
    assert _run()["correct"]
    monkeypatch.setattr(integrate, "normal_noise",
                        lambda like, generator: torch.zeros_like(like))
    out = _run()
    assert out["compared"]["temperature_rel"]["value"] > 0.5
    assert not out["correct"]


def test_the_noise_weakened_fails(monkeypatch):
    """The noise at 0.8 of its amplitude settles the box near 0.64 of
    300 K."""
    real = integrate.normal_noise
    monkeypatch.setattr(integrate, "normal_noise",
                        lambda like, generator: 0.8 * real(like, generator))
    out = _run()
    assert out["compared"]["temperature_rel"]["value"] > 0.2
    assert not out["correct"]


def _ctx(steps: int) -> Ctx:
    return Ctx(setup_s=1.0, wall_s=4.0, steps=steps, dt_ps=2e-3,
               replicas=1, evals=steps + 1, traces=[], work={})


def _record(outer=125, n_inner=4, chunk=5, count=None) -> dict:
    """A record of ``profiling.totals``' shape: ``outer`` replayed outer
    steps in chunks of ``chunk``, the fast tier 0.25 s, each bonded pass
    0.05 s and each slow stage's pass 0.1 s."""
    rec = {"host": {}, "replays": {chunk: outer // chunk},
           "respa": {"outer": outer, "inner": outer * n_inner},
           "stages": {m: {s: {p: {"seconds": 0.0, "count": 0}
                              for p in profiling.PASSES}
                          for s in profiling.TIMED}
                      for m in profiling.MODES}}
    rep = rec["stages"]["replay"]
    rep["respa_fast"]["fwd"] = {"seconds": 0.25, "count": outer}
    for p in profiling.PASSES:
        rep["bonded"][p] = {"seconds": 0.05, "count": outer * n_inner}
        for s in profiling.SLOW_STAGES:
            rep[s][p] = {"seconds": 0.1,
                         "count": outer if count is None else count}
    return rec


@pytest.mark.parametrize("metric", TIER_METRICS)
def test_each_reader_has_its_entry(metric):
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[metric]
    assert entry["workloads"] == ["water96k.respa"]
    assert entry["moves"] == "ns_per_day" and entry["better"] == "lower"


@pytest.mark.parametrize("metric", TIER_METRICS)
def test_the_readers_on_a_record_that_accounts_for_the_window(
        monkeypatch, metric):
    monkeypatch.setattr(profiling, "totals", lambda: _record())
    want = {"fast": 2.0, "bonded": 0.8, "slow": 8.0}.get(
        metric.split(".")[1], 1.6)
    assert spec.reader(metric)(_ctx(125)) == pytest.approx(want)


@pytest.mark.parametrize("metric", TIER_METRICS)
@pytest.mark.parametrize("case", ["steps", "passes", "program"])
def test_the_readers_are_none_on_a_mismatched_record_or_without_it(
        monkeypatch, metric, case):
    if case == "program":
        monkeypatch.delattr(profiling, "respa_ms")
    rec = _record(count=124) if case == "passes" else _record()
    monkeypatch.setattr(profiling, "totals", lambda: rec)
    steps = 120 if case == "steps" else 125
    assert spec.reader(metric)(_ctx(steps)) is None
