"""PyTorch port: the helpers of ``chargeflux_tpu_torch.utils.measure`` that
run without a card (interval union of the profiler's device events, the
bench.py burn-in at a small size, and the bench.py 216 system)."""

import math

import pytest
import torch

from chargeflux_tpu_torch.cells import suggest_capacity
from chargeflux_tpu_torch.models import water_bonded_params, water_box
from chargeflux_tpu_torch.utils import measure

from torch_helpers import fake_kernel_limits

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
    bonded = water_bonded_params(len(masses) // 3, box=box, device="cpu")
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


def test_dense_path_is_bench_216(monkeypatch):
    """648 atoms in a 1.8642 nm box, dense, alpha 3.2427 and kmax (7, 7, 7)
    (1183 half-space k-vectors): "auto" takes the structure-factor kernel
    on a CUDA card in f32 and the plain factorized product here."""
    from chargeflux_tpu_torch.energy import resolve_recip_method

    fake_kernel_limits(monkeypatch)
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


SPREAD_30K = dict(n_col=64, wx=20, wy=20, wyp=24, rows=704, order=8, px=76,
                  py=80, gz=64, n_real=31_944)


def test_kernel_bound_at_the_30k_spread_shapes():
    """The 30k spread (64 columns, Wx = Wy 20 padded to 24, 704 rows of
    which 31,944 hold an atom, order 8, Qpad 76 x 80 x 64).  Only the
    nonzero weights of the atom rows make work: 8 x 8 (x, y) pairs a row,
    17 flops each forward; backward 256 mesh dot products of 16, 160 + 160
    x / y cotangent updates of 2 and 64 tap terms of 17.  Each input is
    read once and each output written once, so bytes set both bounds."""
    fwd = measure.kernel_bound("spread_fwd", **SPREAD_30K)
    assert fwd["flops"] == 31_944 * 64 * 17 == 34_755_072
    assert fwd["bytes"] == 11_108_352
    bwd = measure.kernel_bound("spread_bwd", **SPREAD_30K)
    assert bwd["flops"] == 31_944 * 5_824 == 186_041_856
    assert bwd["bytes"] == 20_480_000
    for b in (fwd, bwd):
        t_ops = b["flops"] / measure.PEAK_F32_FLOPS * 1e3
        t_mem = b["bytes"] / measure.PEAK_BYTES_PER_S * 1e3
        assert b["bound_ms"] == max(t_ops, t_mem)
        assert b["bound_by"] == "bytes"
    assert fwd["bound_ms"] == pytest.approx(3.316e-3, rel=1e-3)
    assert bwd["bound_ms"] == pytest.approx(6.113e-3, rel=1e-3)


@pytest.mark.parametrize("name, per_term", [("spread_fwd", 17),
                                            ("spread_bwd", 37)])
def test_kernel_bound_spread_dense_limit(name, per_term):
    """With every weight nonzero (Wx = Wy = order, every row an atom) the
    count is the dense one, 2 order + 1 (forward) and 4 order + 5
    (backward) flops per (column, x, y, row) term; at order 16 that is
    enough work for the operations to set the bound."""
    dense = dict(SPREAD_30K, wx=8, wy=8, wyp=8, n_real=64 * 704)
    assert (measure.kernel_bound(name, **dense)["flops"]
            == 64 * 8 * 8 * 704 * per_term)
    wide = measure.kernel_bound(name, **dict(dense, wx=16, wy=16, wyp=16,
                                             order=16))
    assert wide["bound_by"] == "operations"
    assert wide["bound_ms"] == wide["flops"] / measure.PEAK_F32_FLOPS * 1e3


def test_kernel_bound_structure_factor_and_walk():
    """216 shapes (Kx 7, Ky 13, 2Kz 26, N 648) and the walk's per-pair
    count; unknown kernels raise."""
    dims = dict(kx=7, ky=13, kz2=26, n=648)
    fwd = measure.kernel_bound("sf_fwd", **dims)
    assert fwd["flops"] == 4 * 91 * 648 * 26 + 6 * 91 * 648
    assert fwd["bytes"] == 4 * (2 * 20 * 648 + 648 * 26 + 2 * 91 * 26)
    tables = measure.kernel_bound("sf_bwd_tables", **dims)
    assert tables["flops"] == 4 * 91 * 648 * 26 + 16 * 91 * 648
    assert tables["bytes"] == fwd["bytes"] + 4 * 2 * 20 * 648
    assert measure.kernel_bound("sf_bwd_zq", **dims)["bytes"] == fwd["bytes"]
    walk = measure.kernel_bound("direct_walk", n_pairs=1000, n_slots=88,
                                n_cells=1, ncoef=13)
    assert walk["flops"] == 99_000
    assert walk["bytes"] == 4 * (11 * 88 + 109 + 3 + 13)
    with pytest.raises(ValueError):
        measure.kernel_bound("fft", n=1)


def test_kernel_bound_binning_at_the_30k_shapes():
    """The binning moves the positions in and the slots, inverse slots and
    overflow count out: 31,944 atoms, 8^3 cells of capacity 88, 691,332
    bytes, 0.2064 us at 3.35 TB/s; it does no flops worth counting."""
    b = measure.kernel_bound("binning", n_atoms=31944, n_slots=512 * 88)
    assert b["bytes"] == 4 * (3 * 31944 + 512 * 88 + 31944 + 1) == 691332
    assert b["flops"] == 0 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(691332 / 3.35e12 * 1e3)


def test_kernel_bound_cell_bin_at_the_30k_shapes():
    """The binning kernel reads the cell ids and writes the slots, inverse
    slots and overflow count: 31,944 atoms, 8^3 cells of capacity 88,
    435,780 bytes, 0.1301 us at 3.35 TB/s."""
    b = measure.kernel_bound("cell_bin", n_atoms=31944, n_slots=512 * 88)
    assert b["bytes"] == 4 * (2 * 31944 + 512 * 88 + 1) == 435780
    assert b["flops"] == 0 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(435780 / 3.35e12 * 1e3)


def test_pairs_within_cutoff_is_the_brute_force_count():
    """Minimum-image pair count against a loop over all pairs in NumPy."""
    import numpy as np

    rng = np.random.default_rng(3)
    box = np.array([1.3, 1.5, 1.7])
    x = rng.random((150, 3)) * box
    want = 0
    for i in range(len(x)):
        d = x[i + 1:] - x[i]
        d -= box * np.round(d / box)
        want += int(np.sum(np.sum(d * d, axis=1) < 0.4 ** 2))
    got = measure.pairs_within_cutoff(torch.as_tensor(x), torch.as_tensor(box),
                                      0.4, chunk=64)
    assert got == want > 0


def test_spread_inputs_small_box():
    """The spread's arguments at n_side 7 (3^3 cells): one column per
    (x, y) cell column, rows z-cell-major (cell z, then slot), and each
    atom's B-spline weights sum to 1 along each axis (the x weights carry
    its charge; sentinel slots carry q = 0)."""
    force, pos, _, box = water_box(n_side=7, flux="bond_angle", cutoff=0.65)
    grid = (3, 3, 3)
    cap = suggest_capacity(pos, box, grid, margin=1.05)
    system = measure.build_system(force, box, cap, torch.device("cpu"),
                                  grid=grid)
    x = torch.tensor(pos, dtype=torch.float32)
    args, blocks, ids = measure.spread_inputs(x, system)
    qwlxt, wlyt, wzt, zorg, offsets, pad_xy = args
    assert qwlxt.shape[0] == 9 and qwlxt.shape[2] == 3 * cap
    assert wlyt.shape[1] % 8 == 0 and zorg.dtype == torch.int32
    assert ids.shape == blocks.x.shape
    real = (ids < system.n_atoms).reshape(9, -1)
    q_rows = torch.where(real, blocks.q.reshape(9, -1), 0.0)
    torch.testing.assert_close(qwlxt.sum(1), q_rows, rtol=0, atol=1e-5)
    torch.testing.assert_close(wlyt.sum(1)[real], torch.ones(int(real.sum())),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(wzt.sum(1), torch.ones_like(q_rows),
                               rtol=0, atol=1e-5)
    assert len(offsets[0]) == 9 and pad_xy[2] == system.spec.pme_grid[2]


def test_drifted_blocks_small_box():
    """Five NVE steps at n_side 7 on one neighbor state: the blocks keep
    the rebuild's slots while the atoms move, the plain walk on them gives
    the energy's direct-space walk at the moved positions, and no rebuild
    happened (the slots are the start state's)."""
    from chargeflux_tpu_torch import cells
    from chargeflux_tpu_torch.integrate import init_state_nb, make_nb_energy_fn
    from chargeflux_tpu_torch.ops.direct_walk import direct_walk_plain

    force, pos, masses, box = water_box(n_side=7, flux="bond_angle",
                                        cutoff=0.65)
    system = measure.build_system(
        force, box, suggest_capacity(pos, box, (3, 3, 3), margin=1.2),
        torch.device("cpu"), dtype=torch.float64, grid=(3, 3, 3))
    x = torch.tensor(pos, dtype=torch.float64)
    m = torch.tensor(masses, dtype=torch.float64)
    bonded = water_bonded_params(len(masses) // 3, box=box,
                                 dtype=torch.float64, device="cpu")
    e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)
    state = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    args, info = measure.drifted_blocks(system, state, e_fn, m, 5)
    assert torch.equal(args[6].reshape(-1), state.nb.slots.reshape(-1))
    assert info["moved"] > 0.0 and info["outside"] >= 0
    blocks0 = cells.blockify(x, args[3].new_zeros(len(x)), system,
                             state.nb.slots, state.nb.inv_slot,
                             wrap=state.nb.wrap)
    real = args[6] < system.n_atoms
    moved = (args[0] - blocks0.x)[real].abs().max()
    assert 0.0 < float(moved) <= info["moved"]
    e, g, dq = direct_walk_plain(*args)
    assert torch.isfinite(e) and torch.isfinite(g).all()
    assert not g[:, ~real].any() and not dq[~real].any()


def test_sf_tables_are_the_216_path_shapes():
    """The tables the structure-factor kernels are timed at, built on the
    CPU: the 216 path's Kx 7, Ky 13, 2Kz 26, N 648, f32, contiguous, in the
    kernels' layouts, from a dense system with kmax (7, 7, 7)."""
    tabs, system = measure.sf_tables("216", torch.device("cpu"))
    assert measure.sf_dims(tabs) == dict(kx=7, ky=13, kz2=26, n=648)
    assert system.spec.kmax == (7, 7, 7)
    assert [tuple(t.shape) for t in tabs] == [(7, 648), (7, 648), (13, 648),
                                              (13, 648), (648, 26)]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in tabs)
    assert set(measure.SF_SHAPES) == {"216", "4k"}


def test_traced_launches_counts_each_wrappers_kernel():
    """The profiler names of the port's kernels map onto the launch
    counters: the wrapper's counted kernel only (not spread_fwd's fold or
    the exclusion and bonded forwards' final sums), device events only."""
    class Event:
        def __init__(self, name, device="DeviceType.CUDA"):
            self.name, self.device_type = name, device

    events = [
        Event("void (anonymous namespace)::spread_patch_kernel<3>(float "
              "const*, float const*)"),
        Event("(anonymous namespace)::spread_fold_kernel(float const*)"),
        Event("void (anonymous namespace)::spread_bwd_kernel<8, false>(float "
              "const*)"),
        Event("void (anonymous namespace)::direct_walk_kernel<13, 384, 2>("
              "float const*)"),
        Event("void (anonymous namespace)::direct_walk_kernel<13, 384, 2>("
              "float const*)", "DeviceType.CPU"),
        Event("void (anonymous namespace)::direct_walk_tri_kernel<13, 1024, "
              "1>(float const*)"),
        Event("void (anonymous namespace)::direct_walk_slab_kernel<13, 384, "
              "2, true>(float const*)"),
        Event("(anonymous namespace)::sf_bwd_tables_kernel(float const*)"),
        Event("(anonymous namespace)::sf_bwd_tables_kernel(float const*)"),
        Event("(anonymous namespace)::cell_bin_count_kernel(int const*)"),
        Event("(anonymous namespace)::cell_bin_rank_kernel(int const*)"),
        Event("void (anonymous namespace)::bspline_patch_fwd_kernel<8>("
              "float const*)"),
        Event("void (anonymous namespace)::bspline_patch_bwd_kernel<8>("
              "float const*)"),
        Event("(anonymous namespace)::exclusion_pairs_fwd_kernel(float "
              "const*)"),
        Event("(anonymous namespace)::exclusion_pairs_total_kernel(double "
              "const*)"),
        Event("(anonymous namespace)::exclusion_pairs_bwd_kernel(float "
              "const*)"),
        Event("(anonymous namespace)::bonded_terms_fwd_kernel(float "
              "const*)"),
        Event("(anonymous namespace)::bonded_terms_total_kernel(double "
              "const*)"),
        Event("(anonymous namespace)::bonded_terms_bwd_kernel(float "
              "const*)"),
        Event("cudaGraphLaunch", "DeviceType.CPU"),
    ]
    assert measure.traced_launches(events) == {
        "spread_fwd": 1, "spread_bwd": 1, "direct_walk": 1,
        "direct_walk_tri": 1, "direct_walk_halo": 1, "sf_fwd": 0,
        "sf_bwd_tables": 2, "sf_bwd_zq": 0, "cell_bin": 1,
        "patch_weights_fwd": 1, "patch_weights_bwd": 1, "exclusion_fwd": 1,
        "exclusion_bwd": 1, "bonded_fwd": 1, "bonded_bwd": 1}
    assert len(measure.device_events(events)) == 18


def test_rigid_path_small_box():
    """rigid_path at n_side 6 (3^3 cells at cutoff 0.5) with two burn-in
    chunks: a finite state on the returned system, on the constraint
    manifold within 1e-4 nm^2 (the f32 tolerance), capacity no smaller
    than the lattice's; its driver takes a remainder on the kernel and the
    plain paths, and the step's projection work runs."""
    from chargeflux_tpu_torch.constraints import constraint_residuals

    path = measure.rigid_path(torch.device("cpu"), n_side=6, cutoff=0.5,
                              grid=(3, 3, 3), burn_chunks=2)
    state, every = path["state"], path["rebuild_every"]
    assert path["info"]["steps"] == 2 * path["info"]["chunk"]
    assert 1 <= every <= 40 and path["system"].spec.cell_grid == (3, 3, 3)
    assert torch.isfinite(state.potential) and torch.isfinite(
        state.forces).all()
    assert float(constraint_residuals(state.positions,
                                      path["params"]).abs().max()) <= 1e-4
    drive, owner, init_nb = measure.rigid_drive(path)
    for plain in (False, True):
        fin, kes = drive(every + 1, True, plain)
        assert kes.shape == (every + 1,) and torch.isfinite(kes).all()
    assert measure.projection_work(path)().shape == state.positions.shape
    assert measure.ns_per_day(measure.DT_RIGID, 4.0) == pytest.approx(43.2)


def test_respa_path_small_box():
    """respa_path at n_side 6 (3^3 cells at cutoff 0.55) with an 8-step
    burn-in: a finite state on the returned system; one outer RESPA step
    on the kernel and the plain paths is finite, and an outer step's
    bonded substeps run."""
    path = measure.respa_path(torch.device("cpu"), n_side=6, cutoff=0.55,
                              grid=(3, 3, 3), burn_steps=8)
    state = path["state"]
    assert path["info"]["steps"] >= 8
    assert torch.isfinite(state.potential) and torch.isfinite(
        state.forces).all()
    drive, owner, init_nb = measure.respa_drive(path)
    for plain in (False, True):
        fin, kes = drive(1, True, plain)
        assert kes.shape == (1,) and torch.isfinite(kes).all()
    assert measure.substep_work(path)().shape == state.positions.shape


def test_npt_path_small_box():
    """npt_path at n_side 6 (3^3 cells at cutoff 0.55) with a 40-step
    burn-in from rest: a finite state on the returned system, a barostat
    interval within the cap; two attempts through its drive are finite
    and record a box per attempt, the drive refuses a plain path, and the
    barostat proposal's work runs."""
    path = measure.npt_path(torch.device("cpu"), n_side=6, cutoff=0.55,
                            grid=(3, 3, 3), burn_steps=40)
    state, every = path["state"], path["rebuild_every"]
    assert path["info"]["steps"] >= 40
    assert 1 <= every <= 40 and path["system"].spec.cell_grid == (3, 3, 3)
    assert torch.isfinite(state.potential) and torch.isfinite(
        state.forces).all()
    drive, owner, init_nb = measure.npt_drive(path)
    run, es = drive(2 * every, True, False)
    assert es.shape == (2 * every,) and torch.isfinite(es).all()
    assert run.diag["boxes"].shape == (2, 3)
    assert torch.isfinite(run.box).all()
    with pytest.raises(ValueError):
        drive(every, True, True)
    assert torch.isfinite(measure.proposal_work(path)())


@pytest.mark.parametrize("kind", ["csvr", "nhc"])
def test_thermostat_drives_small_box(kind):
    """The CSVR and Nose-Hoover chain drives on the small burned-in box:
    a chunk and a remainder finite, kinetic records per step; the NHC
    chain work runs."""
    force, pos, masses, box = water_box(n_side=6, flux="bond_angle",
                                        cutoff=0.55)
    grid = (3, 3, 3)
    cap = suggest_capacity(pos, box, grid, margin=1.05)
    system0 = measure.build_system(force, box, cap, torch.device("cpu"),
                                   grid=grid)
    x = torch.tensor(pos, dtype=torch.float32)
    m = torch.tensor(masses, dtype=torch.float32)
    bonded = water_bonded_params(len(masses) // 3, box=box, device="cpu")
    system, state, every, _ = measure.burn_in(force, system0, x, m, box,
                                              bonded, n_steps=4)
    drive, owner, init_nb = measure.thermostat_drive(
        kind, system, state, every, m, bonded, torch.Generator())
    fin, kes = drive(every + 1, True, False)
    assert kes.shape == (every + 1,) and torch.isfinite(kes).all()
    assert torch.isfinite(fin.positions).all()
    if kind == "nhc":
        scale, chain = measure.chain_work(state, m)()
        assert torch.isfinite(scale) and chain.v_xi.shape == (3,)


def test_thermo_windows_small_box(capsys, monkeypatch):
    """``measure thermo`` on the CPU at n_side 6 (3^3 cells at cutoff 0.55)
    from a Maxwell start: BAOAB, CSVR and the Nose-Hoover chain in f32 and
    BAOAB and CSVR in f64 on the plain route, each with finite window
    means (two windows of 4 steps; one for the f64 runs), one line each."""
    from chargeflux_tpu_torch.integrate import (init_state_nb,
                                                make_nb_energy_fn,
                                                maxwell_velocities)

    force, pos, masses, box = water_box(n_side=6, flux="bond_angle",
                                        cutoff=0.55)
    system = measure.build_system(force, box, 32, "cpu", grid=(3, 3, 3))
    m = torch.tensor(masses, dtype=torch.float32)
    bonded = water_bonded_params(len(masses) // 3, box=box, device="cpu")
    x = torch.tensor(pos, dtype=torch.float32)
    v = maxwell_velocities(m, 300.0, torch.Generator().manual_seed(1),
                           dtype=torch.float32)
    state = init_state_nb(x, v, *make_nb_energy_fn(system, bonded=bonded))
    monkeypatch.setattr(measure, "THERMO_STEPS", 8)
    monkeypatch.setattr(measure, "THERMO_F64_STEPS", 4)
    monkeypatch.setattr(measure, "THERMO_WINDOW", 4)
    out = measure.thermo_windows(system, state, 4, m, bonded, "cpu")
    assert list(out) == ["baoab f32 kernels", "csvr f32 kernels",
                         "nhc f32 kernels", "baoab f64 plain",
                         "csvr f64 plain"]
    assert [len(w) for w in out.values()] == [2, 2, 2, 1, 1]
    assert all(math.isfinite(t) and t > 0 for w in out.values() for t in w)
    assert capsys.readouterr().out.count("thermo ") == 5


@pytest.mark.parametrize("name, flops, words", [
    ("patch_weights_fwd", 3 * 165 + 20, 5 + 20 + 24 + 8 + 1),
    ("patch_weights_bwd", 3 * 125 + 17 * 8, 5 + 3 * 8 + 4)])
def test_kernel_bound_patch_weights_at_the_96k_shapes(name, flops, words):
    """The B-spline patch weights at the benchmark box's shapes (8^3 cells
    of 256 slots, Wx 20, Wyp 24, order 8): de Boor's recursion (5 flops a
    point, 165 to order 8, 125 to order 7), the words a slot moves, and
    bytes set the bound."""
    b = measure.kernel_bound(name, n_slots=131_072, wx=20, wyp=24, order=8)
    assert b["flops"] == 131_072 * flops
    assert b["bytes"] == 4 * 131_072 * words
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e9)


@pytest.mark.parametrize("name, flops, words", [
    ("exclusion_fwd", 67, 6), ("exclusion_bwd", 67 + 62, 6 + 4)])
def test_kernel_bound_exclusions_at_the_96k_shapes(name, flops, words):
    """The exclusion kernels at the benchmark box (32,768 waters, three
    pairs each): the flops a pair, the words an atom moves (positions,
    q, sigma, epsilon in; dE/dx, dE/dq out), and bytes set the bound."""
    b = measure.kernel_bound(name, n_atoms=98_304, n_pairs=98_304)
    assert b["flops"] == 98_304 * flops
    assert b["bytes"] == 4 * 98_304 * words
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e9)


@pytest.mark.parametrize("name, flops, words", [
    ("bonded_fwd", 2 * 29 + 63, 9 + 2 * 2 + 2),
    ("bonded_bwd", 2 * (29 + 11) + 63 + 45 + 9, 9 + 2 * 2 + 2 + 9)])
def test_kernel_bound_bonded_at_the_96k_shapes(name, flops, words):
    """The bonded kernels at the benchmark box (32,768 waters, two bonds
    and an angle each): the flops a molecule, the words it moves
    (positions and two parameters a row in; dE/dx out), and bytes set the
    bound."""
    b = measure.kernel_bound(name, n_molecules=32_768, stride=3, n_bonds=2,
                             n_angles=1)
    assert b["flops"] == 32_768 * flops
    assert b["bytes"] == 4 * 32_768 * words
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e9)


def test_patch_weight_inputs_are_the_reciprocal_energy_cotangents():
    """The weights' arguments give the column spread's weights, and the
    cotangents are autograd's dE_rec / d(qwlxt, wlyt, wzt) through the
    plain spread and the mesh energy (f64, 1e-12 of their max)."""
    from chargeflux_tpu_torch import cells, pme
    from chargeflux_tpu_torch.charges import effective_charges
    from chargeflux_tpu_torch.neighbors import build_neighbor_state
    from chargeflux_tpu_torch.ops import pme_spread as ps
    from chargeflux_tpu_torch.ops import pme_weights as pw

    force, pos, _, box = water_box(n_side=6, cutoff=0.42)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", recip_method="pme",
                                 device="cpu")
    x = torch.as_tensor(pos)
    nb = build_neighbor_state(x, system)
    b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                       nb.inv_slot, wrap=nb.wrap)
    ids = nb.slots.reshape(b.x.shape)
    args, cts = measure.patch_weight_inputs(b, ids, system)
    ins = pme.column_spread_inputs(b, ids, system)
    w = [t.detach().clone().requires_grad_(True) for t in ins[:3]]
    for got, want in zip(pw.patch_weights_fwd_plain(*args), ins[:4]):
        assert torch.equal(got, want)
    e = pme.mesh_energy(ps.spread_fwd_plain(*w, *ins[3:]), system)
    for got, want in zip(cts, torch.autograd.grad(e, w)):
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
