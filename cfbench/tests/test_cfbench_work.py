"""The roofline counts are the physical problem's: the same atoms give the
same counts whatever capacity or cell grid the program runs with."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from cfbench import readers, spec, water, work
from cfbench.harness import Ctx
from cfbench.tests.small import small_cell


def _driver(grid, capacity):
    cell = small_cell("water96k.nve")
    cfg = copy.deepcopy(cell["config"])
    cfg["system"].update(n_waters=125, lattice_side=5, cell_grid=grid,
                         cell_capacity=capacity, pme_grid=[30, 30, 30])
    return spec.driver("nve")(cfg, cell["traffic"], torch.device("cpu")), cfg


@pytest.mark.parametrize("grid,capacity", [([3, 3, 3], 40), ([3, 3, 3], 96),
                                           ([4, 4, 4], 32), ([4, 4, 4], 64)])
def test_counts_do_not_see_capacity_or_grid(grid, capacity):
    drv, cfg = _driver(grid, capacity)
    x = torch.tensor(water.lattice_waters(cfg, np.random.default_rng(3)),
                     dtype=torch.float32)
    drv.frames = [{"x": x}]
    got = drv.work()
    base, _ = _driver([3, 3, 3], 48)
    base.frames = [{"x": x}]
    assert got == base.work()
    assert got["pairs"] == work.pairs_within_cutoff(
        x.double(), water.box_of(cfg), cfg["system"]["cutoff_nm"])


def test_pairs_leave_out_the_molecules_own():
    x = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0],
                      [0.5, 0.0, 0.0], [0.6, 0.0, 0.0], [0.5, 0.1, 0.0]])
    # across molecules within 0.45 nm: (1, 3) at 0.4, (1, 5) at 0.41
    assert work.pairs_within_cutoff(x, [3.0, 3.0, 3.0], 0.45) == 2


def test_a_share_is_below_100_for_any_time_the_bound_allows():
    least = work.walk(n_pairs=20_000_000, n_atoms=98_304)
    ctx = Ctx(0.0, 1.0, 10, 5e-4, 1, 10, [{
        "busy_ns": 1, "wall_ns": 1, "kernels": 1,
        "by_name": {"direct_walk_kernel": (10, int(10 * least * 1e9))}}],
        {"pairs": 20_000_000, "n_atoms": 98_304})
    share = readers.roofline(ctx, r"direct_walk", least)
    assert share == pytest.approx(100, rel=1e-3)
    assert readers.roofline(ctx, r"spread", least) is None
    assert work.spread(98_304, 8, (64, 64, 64)) > 0
