"""PyTorch port: cell binning (``ops/cell_bin.py``) on the CPU.

The plain version is held to an independent NumPy loop and to the JAX
package's ``cells.rank_into_slots`` (slots, inverse slots and the overflow
count, with empty cells, atoms binned nowhere, N not a multiple of the
kernel's chunk, and overflow); the wrapper takes the plain version on a
CPU tensor and raises, rather than falls back, on any other device; the
kernel's size gate.  The halo route's local binning goes through the same
wrapper: on every rank of (4, 1) slabs and (2, 2) bricks it gives the
global binning's slots of the rank's own cells and counts only its own
atoms past a cell's capacity, and an overflow on one rank's cells puts NaN
on every rank's energy (gloo ranks).  The kernel itself is held to the
plain version on the card (``test_torch_kernels_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from chargeflux_tpu_torch import ops
from chargeflux_tpu_torch.cells import build_cell_list_full, rank_into_slots
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.ops import cell_bin as cb
from chargeflux_tpu_torch.parallel.halo import _local_bin

from torch_helpers import dist_worker, fake_kernel_limits, run_ranks

torch.set_num_threads(1)


def _reference(cell, n_cells, cap):
    """Atom by atom in increasing id: a cell's next free slot, or dropped
    and counted past its capacity; ids >= n_cells bin nowhere."""
    n = len(cell)
    slots = np.full(n_cells * cap, n, np.int32)
    slot_of = np.full(n, n_cells * cap, np.int32)
    fill = np.zeros(n_cells, np.int64)
    over = 0
    for i, c in enumerate(cell):
        if c >= n_cells:
            continue
        if fill[c] < cap:
            slots[c * cap + fill[c]] = i
            slot_of[i] = c * cap + fill[c]
        else:
            over += 1
        fill[c] += 1
    return slots.reshape(n_cells, cap), slot_of, over


def _ids(n, n_cells, nowhere, seed, skew=0.0):
    rng = np.random.default_rng(seed)
    cell = rng.integers(0, n_cells, n)
    if skew:                      # a share of the atoms in cell 3
        cell[rng.random(n) < skew] = 3
    cell[rng.random(n) < nowhere] = n_cells
    return cell


# (id, N, n_cells, capacity, share binned nowhere, skew)
CASES = [
    ("30k-like", 2500, 64, 64, 0.0, 0.0),
    ("overflow", 2500, 64, 36, 0.0, 0.0),
    ("empty-cells", 100, 512, 4, 0.0, 0.0),
    ("nowhere-n-2049", 2049, 27, 80, 0.3, 0.0),
    ("skewed-overflow", 3000, 125, 40, 0.1, 0.2),
    ("no-atoms", 0, 8, 4, 0.0, 0.0),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_binning_matches_the_atom_by_atom_reference(case):
    _, n, n_cells, cap, nowhere, skew = case
    cell = _ids(n, n_cells, nowhere, seed=n + n_cells, skew=skew)
    slots, slot_of, over = cb.cell_bin_plain(torch.as_tensor(cell), n_cells,
                                             cap)
    r_slots, r_slot_of, r_over = _reference(cell, n_cells, cap)
    assert slots.dtype == slot_of.dtype == over.dtype == torch.int32
    assert over.shape == ()
    assert np.array_equal(slots.numpy(), r_slots)
    assert np.array_equal(slot_of.numpy(), r_slot_of)
    assert int(over) == r_over


# (case id, z cells a column: the JAX ranking's stage A ranks columns of gz)
JAX_COLUMNS = {"30k-like": 4, "empty-cells": 8, "nowhere-n-2049": 3,
               "skewed-overflow": 125}


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in JAX_COLUMNS],
                         ids=[c[0] for c in CASES if c[0] in JAX_COLUMNS])
def test_plain_binning_matches_jax_rank_into_slots(case):
    """The JAX package's two-stage one-hot ranking (columns of gz cells)
    gives the same slots and count whenever no column overflows gz
    capacities (under heavy overflow it also counts the atoms its column
    stage drops: ROADMAP C.3); "skewed-overflow" overflows cells, not its
    one column."""
    import jax.numpy as jnp

    from chargeflux_tpu.cells import rank_into_slots as j_rank

    name, n, n_cells, cap, nowhere, skew = case
    gz = JAX_COLUMNS[name]
    cell = _ids(n, n_cells, nowhere, seed=n + n_cells, skew=skew)
    owned = cell < n_cells
    col = np.where(owned, cell // gz, 0)
    cz = np.where(owned, cell % gz, 0)
    assert np.bincount(col[owned], minlength=n_cells // gz).max() <= gz * cap
    js, jso, jo = j_rank(jnp.asarray(col, jnp.int32),
                         jnp.asarray(cz, jnp.int32), jnp.asarray(owned), n,
                         n_cells // gz, gz, cap)
    slots, slot_of, over = cb.cell_bin_plain(torch.as_tensor(cell), n_cells,
                                             cap)
    assert np.array_equal(slots.numpy(), np.asarray(js))
    assert np.array_equal(slot_of.numpy(), np.asarray(jso))
    assert int(over) == int(jo)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    cell = torch.as_tensor(_ids(2049, 27, 0.3, seed=5))
    ops.reset_launch_counts()
    for got in (cb.cell_bin(cell, 27, 80),
                rank_into_slots(cell, 27, 80),
                rank_into_slots(cell, 27, 80, plain=True)):
        for u, v in zip(got, cb.cell_bin_plain(cell, 27, 80)):
            assert torch.equal(u, v)
    assert ops.launch_counts()["cell_bin"] == 0


# (id, device, N, n_cells, capacity, refusal)
GATE = [
    ("card-30k", "cuda", 31944, 512, 88, None),
    ("card-100k", "cuda", 98304, 1331, 96, None),
    ("card-max-cells", "cuda", 1000, 49152, 8, None),
    ("card-too-many-cells", "cuda", 1000, 49153, 8, ValueError),
    ("card-capacity-0", "cuda", 1000, 512, 0, ValueError),
    ("card-2^31-slots", "cuda", 1000, 32768, 65536, ValueError),
    ("cpu", "cpu", 31944, 512, 88, TypeError),
    ("meta", "meta", 31944, 512, 88, TypeError),
]


@pytest.mark.parametrize("case", GATE, ids=[c[0] for c in GATE])
def test_kernel_gate(monkeypatch, case):
    fake_kernel_limits(monkeypatch)
    _, dev, n, n_cells, cap, want = case
    got = cb._refusal(torch.device(dev), n, n_cells, cap)
    assert (None if got is None else got[0]) is want


def test_a_tensor_off_the_cpu_raises_rather_than_falls_back(monkeypatch):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's gate and raises with its reason (no build is tried)."""
    def no_build(*args):
        raise AssertionError("the gate must refuse before any build")

    monkeypatch.setattr(cb.native, "library", no_build)
    fake_kernel_limits(monkeypatch)
    cell = torch.zeros(100, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="CUDA tensor"):
        cb.cell_bin(cell, 8, 16)
    with pytest.raises(TypeError, match="CUDA tensor"):
        rank_into_slots(cell, 8, 16)


def _halo_box():
    # box 2.4856 nm, cutoff 0.29: an 8^3 cell grid, (4, 1) and (2, 2) divide it
    force, pos, _, box = water_box(n_side=8, flux="bond_angle", cutoff=0.29,
                                   seed=44)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", device="cpu")
    assert system.spec.cell_grid == (8, 8, 8)
    return system, torch.tensor(pos)


@pytest.mark.parametrize("decomp", [(4, 1), (2, 2)])
def test_halo_owned_cell_overflow_counts_owned_atoms_and_poisons_every_rank(
        decomp, tmp_path):
    system, x = _halo_box()
    gx, gy, gz = system.spec.cell_grid
    full, _, _ = build_cell_list_full(x, system.box, (gx, gy, gz), 64)
    occupancy = (full < x.shape[0]).sum(-1).reshape(gx, gy, gz)
    # the fullest cells overflow by one atom each, on some ranks only
    cap = int(occupancy.max()) - 1
    tiny = system._swap(spec=dataclasses.replace(system.spec,
                                                 cell_capacity=cap))
    g_slots, _, g_over = build_cell_list_full(x, system.box, (gx, gy, gz),
                                              cap)
    g_slots = g_slots.reshape(gx, gy, gz, cap)
    ddx, ddy = decomp
    gxl, gyl = gx // ddx, gy // ddy
    overs = []
    for rank in range(ddx * ddy):
        dev_x, dev_y = rank // ddy, rank % ddy
        cells_x = slice(dev_x * gxl, (dev_x + 1) * gxl)
        cells_y = slice(dev_y * gyl, (dev_y + 1) * gyl)
        slots, slot_of, over = _local_bin(x, tiny, dev_x, dev_y, gxl, gyl)
        own = occupancy[cells_x, cells_y]
        assert int(over) == int(torch.clamp(own - cap, min=0).sum())
        assert torch.equal(slots, g_slots[cells_x, cells_y].reshape(-1, cap))
        kept = slot_of < gxl * gyl * gz * cap
        assert int(kept.sum()) == int(torch.clamp(own, max=cap).sum())
        overs.append(int(over))
    assert sum(overs) == int(g_over) > 0
    res = run_ranks(ddx * ddy, dist_worker,
                    ("overflow", tiny, x, {"decomp": decomp}), tmp_path)
    assert all(np.isnan(r["e"]) for r in res)
