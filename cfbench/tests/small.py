"""Small versions of the benchmark's cells, for the CPU tests: the same
configurations and mixes with the sizes cut to what a test run holds
(a 4^3-water box)."""

from __future__ import annotations

import copy

from cfbench import spec


def small_cell(workload: str) -> dict:
    """The cell ``workload`` of BENCHMARK.json, cut to a CPU size."""
    cell = copy.deepcopy(spec.load_cell(workload))
    cfg, traffic = cell["config"], cell["traffic"]
    s, d = cfg["system"], cfg["dynamics"]
    s.update(n_waters=64, lattice_side=4, cutoff_nm=0.35, cell_grid=[3, 3, 3],
             cell_capacity=48, pme_grid=[24, 24, 24])
    d.update(rebuild_every=4)
    traffic.update(warm_rebuild_every=4, report_steps=4, warm_start_steps=8,
                   warm_call_steps=4)
    return cell
