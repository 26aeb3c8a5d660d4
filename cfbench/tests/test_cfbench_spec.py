"""The benchmark is data: every configuration, mix, limit file and metric
is found by its name in BENCHMARK.json, and the file keeps the contract's
shape."""

from __future__ import annotations

import json
import re

import pytest

from cfbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert spec.driver(c["traffic"]["driver"]) is not None
    assert set(c["limits"]["limits"]) >= {"force_rms", "energy_rel",
                                          "unmoved"}
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"], "every cell reports a per-layer metric"
    assert c["chips"] == 1 and len(c["workload"]["why"]) <= 200


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_file_is_its_own(conf):
    cfg = json.loads((spec.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("cfbench/configs/")
    assert cfg["name"] == conf["name"]
    assert cfg["reduced"] == conf["reduced"]
    assert set(cfg["water"]) >= {"charge_O", "flux_bond_k", "bond_k"}
