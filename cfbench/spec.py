"""Finding a cell's files by the names in ``BENCHMARK.json``.

* a configuration: the file its entry names (``cfbench/configs/``);
* a traffic mix: ``cfbench/traffic/<traffic>.json``, whose ``driver``
  names a module of ``cfbench/drivers/``;
* a mix's comparison that decides ``correct``: its ``check`` names
  ``cfbench/checks/<check>.py``;
* a cell's limits of that comparison: ``cfbench/limits/<workload>.json``;
* a metric, end-to-end or per-layer: ``cfbench/metrics/<name>.py``, a
  reader with ``read(ctx)`` that returns a number or None.

A later change adds a cell, a configuration, a mix or a metric as new
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(workload: str, bench: dict = None) -> dict:
    """The cell ``workload``: its entry, configuration, traffic, limits
    and metric entries (``end_to_end``, ``per_layer``: those it
    reports)."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"workload": w, "name": workload, "chips": int(w["chips"]),
            "config": cfg, "traffic": traffic, "limits": limits,
            "end_to_end": e2e, "per_layer": per_layer}


def driver(name: str):
    """The driver class of ``cfbench/drivers/<name>.py``."""
    return importlib.import_module(f"cfbench.drivers.{name}").Driver


def check(name: str):
    """``readings(...)`` of ``cfbench/checks/<name>.py``."""
    return importlib.import_module(f"cfbench.checks.{name}").readings


def reader(metric: str):
    """``read(ctx)`` of ``cfbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "cfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
