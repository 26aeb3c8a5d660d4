"""PyTorch port: the helpers of ``chargeflux_tpu_torch.utils.measure`` that
run without a card (interval union of the profiler's device events, the
bench.py burn-in at a small size, and the bench.py 216 system)."""

import math

import pytest
import torch

from chargeflux_tpu_torch.cells import suggest_capacity
from chargeflux_tpu_torch.models import water_bonded_params, water_box
from chargeflux_tpu_torch.utils import measure

torch.set_num_threads(2)


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 1.0), (2.0, 3.5)], 2.5),
    ([(2.0, 3.0), (0.0, 2.5)], 3.0),          # overlap, unsorted
    ([(0.0, 4.0), (1.0, 2.0), (3.0, 5.0)], 5.0),  # nested, then chained
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),          # touching
])
def test_union_length(intervals, length):
    assert measure.union_length(intervals) == length


def test_burn_in_small_box():
    """The burn-in at n_side=7 (3^3 cells): finite state evaluated on the
    returned system, a capacity no smaller than the start's, 300 K after
    the last rescaling."""
    force, pos, masses, box = water_box(n_side=7, flux="bond_angle",
                                        cutoff=0.65)
    grid = (3, 3, 3)
    cap = suggest_capacity(pos, box, grid, margin=1.05)
    system0 = measure.build_system(force, box, cap, torch.device("cpu"),
                                   grid=grid)
    x = torch.tensor(pos, dtype=torch.float32)
    m = torch.tensor(masses, dtype=torch.float32)
    bonded = water_bonded_params(len(masses) // 3, box=box)
    system, state, rebuild_every, info = measure.burn_in(
        force, system0, x, m, box, bonded, n_steps=8)
    assert system.spec.cell_grid == grid
    assert system.spec.cell_capacity >= cap
    assert info["chunks"] == math.ceil(8 / info["chunk"])
    assert 1 <= rebuild_every <= 40
    assert torch.isfinite(state.potential) and torch.isfinite(
        state.forces).all()
    v = state.velocities.double()
    t = float(torch.sum(m.double()[:, None] * v * v)) / (
        3 * len(masses) * measure.KB)
    assert abs(t - 300.0) < 1e-3 * 300.0


def test_dense_path_is_bench_216():
    """648 atoms in a 1.8642 nm box, dense, alpha 3.2427 and kmax (7, 7, 7)
    (1183 half-space k-vectors): "auto" takes the structure-factor kernel
    on a CUDA card in f32 and the plain factorized product here."""
    from chargeflux_tpu_torch.energy import resolve_recip_method

    _, x, m, box, bonded, system = measure.dense_path(torch.device("cpu"))
    spec = system.spec
    assert x.shape == (648, 3) and m.shape == (648,)
    assert x.dtype == torch.float32 and float(box[0]) == pytest.approx(1.8642)
    assert spec.direct_method == "dense" and spec.recip_method == "auto"
    assert spec.kmax == (7, 7, 7) and spec.alpha == pytest.approx(3.2427,
                                                                 abs=1e-4)
    assert resolve_recip_method(spec, torch.float32,
                                torch.device("cuda")) == "pallas"
    assert resolve_recip_method(spec, torch.float32, x.device) == "xla"
    assert bonded is not None
