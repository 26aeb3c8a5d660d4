"""The comparison that decides ``correct`` can fail: the harness driven
without the chip's check, on small cells on the CPU, with the timed path
sound (correct), with the control (the reference in TF32) in the
program's place (past the limits), and with a fault planted underneath
the driver (not correct) — a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced."""

from __future__ import annotations

import time

import torch

import chargeflux_tpu_torch as port
from cfbench import harness, spec
from cfbench.tests.small import small_cell

SEED = 2 ** 31 + 977


def _run(workload, seconds=4.0, seed=SEED):
    torch.manual_seed(0)
    return harness.run_cell(small_cell(workload), seed, seconds, False,
                            "cpu", time.perf_counter(), log=lambda m: None)


def test_a_sound_run_is_correct():
    out = _run("water96k.nve")
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out)[-1] == "compared"


def test_the_control_fails_the_limits():
    cell = small_cell("water96k.nve")
    t = cell["traffic"]
    drv = spec.driver(t["driver"])(cell["config"], t, torch.device("cpu"))
    drv.start(SEED)
    for _ in range(2):
        drv.interval()
    found = harness.readings(cell, drv.frames, SEED, "cpu",
                             drv.check_inputs(), precision="tf32")
    limits = cell["limits"]["limits"]
    assert any(found[k] > limits[k] for k in found), found


def _nve_fault(monkeypatch, alter):
    real = port.nve_trajectory_nb

    def broken(state, *args, **kwargs):
        out, es = real(state, *args, **kwargs)
        return alter(state, out), es
    monkeypatch.setattr(port, "nve_trajectory_nb", broken)


def test_nve_state_left_unchanged_fails(monkeypatch):
    _nve_fault(monkeypatch, lambda before, after: before)
    out = _run("water96k.nve")
    assert not out["correct"] and out["compared"]["unmoved"]["value"] > 0


def test_nve_half_the_atoms_left_out_fails(monkeypatch):
    def half(before, after):
        f = after.forces.clone()
        f[f.shape[0] // 2:] = 0.0
        return type(after)(after.positions, after.velocities, f,
                           after.potential, after.nb)
    _nve_fault(monkeypatch, half)
    assert not _run("water96k.nve")["correct"]


def test_nve_answer_altered_fails(monkeypatch):
    def altered(before, after):
        return type(after)(after.positions, after.velocities,
                           after.forces * 1.001, after.potential, after.nb)
    _nve_fault(monkeypatch, altered)
    out = _run("water96k.nve")
    assert out["compared"]["force_rms"]["value"] > 5e-4
    assert not out["correct"]
