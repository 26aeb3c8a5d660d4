"""The readers of the program's stage stamps and host spans
(``metrics/stage_ms.*``, ``final_ms``): a number
from a record that accounts for the window, None from an empty or
mismatched one, and None from a program that keeps no record."""

from __future__ import annotations

import pytest

from cfbench import spec
from cfbench.harness import Ctx
from chargeflux_tpu_torch.utils import profiling

STAGE_METRICS = [f"stage_ms.{s}" for s in profiling.STAGES[:-1]] + [
    "stage_ms.other"]
HOST_METRICS = {"final_ms": "cf.md.final"}


def _ctx(steps: int) -> Ctx:
    return Ctx(setup_s=1.0, wall_s=4.0, steps=steps, dt_ps=5e-4, replicas=1,
               evals=steps + 1, traces=[], work={})


def _record(chunks: int = 25, k: int = 20, stage_s: float = 0.01,
            count=None, host=None) -> dict:
    """A record of ``profiling.totals``' shape: ``chunks`` replays of ``k``
    steps, each energy stage ``stage_s`` seconds a pass."""
    steps = chunks * k
    rec = {"host": host or {}, "replays": {k: chunks} if chunks else {},
           "stages": {m: {s: {p: {"seconds": 0.0, "count": 0}
                              for p in profiling.PASSES}
                          for s in profiling.STAGES}
                      for m in profiling.MODES}}
    rep = rec["stages"]["replay"]
    for s in profiling.ENERGY_STAGES:
        for p in profiling.PASSES:
            rep[s][p] = {"seconds": stage_s,
                         "count": steps if count is None else count}
    rep["rebuild"]["fwd"] = {"seconds": stage_s, "count": chunks}
    rep["replay"]["fwd"] = {"seconds": 20 * stage_s, "count": chunks}
    return rec


def _span(count: int, total_s: float) -> dict:
    return {"count": count, "total_s": total_s, "self_s": total_s,
            "parents": ["cf.md.call"]}


@pytest.mark.parametrize("metric", STAGE_METRICS + list(HOST_METRICS))
def test_each_reader_has_its_entry(metric):
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[metric]
    assert entry["workloads"] == ["water96k.nve"]
    assert entry["moves"] == "ns_per_day" and entry["better"] == "lower"


@pytest.mark.parametrize("metric", STAGE_METRICS)
def test_stage_readers_on_a_record_that_accounts_for_the_window(
        monkeypatch, metric):
    monkeypatch.setattr(profiling, "totals", lambda: _record())
    value = spec.reader(metric)(_ctx(500))
    stage = metric.split(".", 1)[1]
    want = {"rebuild": 1e3 * 0.01 / 500,
            "other": 1e3 * (20 * 0.01 - 13 * 0.01) / 500}.get(
                stage, 1e3 * 2 * 0.01 / 500)
    assert value == pytest.approx(want)


@pytest.mark.parametrize("metric", STAGE_METRICS)
@pytest.mark.parametrize("case", ["empty", "steps", "passes"])
def test_stage_readers_are_none_on_an_empty_or_mismatched_record(
        monkeypatch, metric, case):
    rec = {"empty": _record(chunks=0), "steps": _record(),
           "passes": _record(count=499)}[case]
    monkeypatch.setattr(profiling, "totals", lambda: rec)
    steps = 480 if case == "steps" else 500
    assert spec.reader(metric)(_ctx(steps)) is None


@pytest.mark.parametrize("metric", list(HOST_METRICS))
def test_host_span_readers(monkeypatch, metric):
    span = HOST_METRICS[metric]
    monkeypatch.setattr(profiling, "totals", lambda: _record(
        host={span: _span(25, 0.5)}))
    assert spec.reader(metric)(_ctx(500)) == pytest.approx(20.0)
    monkeypatch.setattr(profiling, "totals", lambda: _record(host={}))
    assert spec.reader(metric)(_ctx(500)) is None


@pytest.mark.parametrize("metric", STAGE_METRICS + list(HOST_METRICS))
def test_readers_are_none_for_a_program_without_the_record(monkeypatch,
                                                          metric):
    monkeypatch.delattr(profiling, "totals")
    monkeypatch.delattr(profiling, "stage_ms")
    assert spec.reader(metric)(_ctx(500)) is None
