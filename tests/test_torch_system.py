"""PyTorch port: builder planning, system carry-over, binning and tables
held to the JAX package (chargeflux_tpu is the reference)."""

import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import cells as jcells
from chargeflux_tpu.cells import suggest_capacity as jax_suggest_capacity
from chargeflux_tpu.models import water_box as jax_water_box
from chargeflux_tpu.ops.erfc import erf_over_r_coeffs as jax_coeffs
from chargeflux_tpu.ops.erfc import erfc_fast as jax_erfc_fast
from chargeflux_tpu.utils import max_cell_occupancy as jax_max_occupancy
from chargeflux_tpu_torch import cells, ops
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.ops.erfc import erf_over_r_coeffs, erfc_fast
from chargeflux_tpu_torch.system import ARRAY_FIELDS, system_from_arrays
from chargeflux_tpu_torch.utils import max_cell_occupancy

from torch_helpers import jax_dtype, water_systems

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

# (n_side, cutoff, create_system keywords): the test box, and the 30k main
# path's forced 8^3 grid with its suggest_capacity(margin=1.05) capacity
CONFIGS = {
    "7": (7, 0.65, dict(direct_method="cell", recip_method="pme")),
    "22": (22, 0.72, dict(direct_method="cell", cell_grid=(8, 8, 8),
                          cell_capacity=88)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_builder_spec_and_arrays_match_jax(name, dtype):
    n_side, cutoff, kw = CONFIGS[name]
    f_t, pos_t, m_t, box_t = water_box(n_side=n_side, cutoff=cutoff)
    f_j, pos_j, m_j, box_j = jax_water_box(n_side=n_side, cutoff=cutoff)
    assert np.array_equal(pos_t, pos_j) and np.array_equal(m_t, m_j)
    assert np.array_equal(box_t, box_j)
    st = f_t.create_system(box=box_t, dtype=dtype, device="cpu", **kw)
    sj = f_j.create_system(box=box_j, dtype=jax_dtype(dtype), **kw)
    assert dataclasses.asdict(st.spec) == dataclasses.asdict(sj.spec)
    for field in ARRAY_FIELDS:
        a, b = getattr(st, field).numpy(), np.asarray(getattr(sj, field))
        assert a.shape == b.shape, field
        assert np.array_equal(a.astype(b.dtype), b), field
        assert getattr(st, field).dtype == (
            torch.int64 if a.dtype.kind == "i" else dtype), field


def test_builder_derived_capacity_and_overrides_match_jax():
    """Without overrides the capacity, cell grid and walk chunking are
    derived; the override checks raise in both packages alike."""
    f_t, _, _, box = water_box(n_side=22, cutoff=0.72)
    f_j, _, _, _ = jax_water_box(n_side=22, cutoff=0.72)
    st = f_t.create_system(box=box, direct_method="cell", device="cpu")
    sj = f_j.create_system(box=box, direct_method="cell")
    assert dataclasses.asdict(st.spec) == dataclasses.asdict(sj.spec)
    for bad in (dict(cell_grid=(12, 12, 12)), dict(pme_grid=(32, 32, 32))):
        with pytest.raises(ValueError):
            f_t.create_system(box=box, direct_method="cell", device="cpu",
                              **bad)
        with pytest.raises(ValueError):
            f_j.create_system(box=box, direct_method="cell", **bad)


def test_system_from_arrays_round_trip():
    jsys, sys_t, _, _ = water_systems(torch.float64)
    assert dataclasses.asdict(sys_t.spec) == dataclasses.asdict(jsys.spec)
    back = system_from_arrays(
        {f: getattr(sys_t, f).numpy() for f in ARRAY_FIELDS},
        dataclasses.asdict(sys_t.spec), dtype=torch.float64, device="cpu")
    assert back.spec == sys_t.spec
    for f in ARRAY_FIELDS:
        assert torch.equal(getattr(back, f), getattr(sys_t, f)), f
        assert np.array_equal(getattr(back, f).numpy(),
                              np.asarray(getattr(jsys, f))), f
    with pytest.raises(ValueError, match="missing"):
        system_from_arrays({"q0": np.zeros(3)}, dataclasses.asdict(
            sys_t.spec), device="cpu")


def _entry_points():
    from chargeflux_tpu_torch.bonded import BondedParams
    from chargeflux_tpu_torch.models import water_bonded_params

    force, _, _, box = water_box(n_side=7, cutoff=0.65)
    _, sys_t, _, _ = water_systems(torch.float64)
    arrays = {f: getattr(sys_t, f).numpy() for f in ARRAY_FIELDS}
    spec = dataclasses.asdict(sys_t.spec)
    return {
        "create_system": lambda **kw: force.create_system(box=box, **kw),
        "water_bonded_params": lambda **kw: water_bonded_params(
            9, box=box, **kw),
        "system_from_arrays": lambda **kw: system_from_arrays(arrays, spec,
                                                              **kw),
        "BondedParams.create": lambda **kw: BondedParams.create(
            [[0, 1]], [1.0], [0.1], np.zeros((0, 3)), [], [], box, True,
            **kw),
    }


@pytest.mark.parametrize("entry", ["create_system", "water_bonded_params",
                                   "system_from_arrays",
                                   "BondedParams.create"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` the entry points build on the CUDA card: on a
    host without CUDA they raise (never a silent CPU fallback), and
    ``device="cpu"`` builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default builds there")
    build = _entry_points()[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()
    out = build(device="cpu")
    tensors = [v for v in vars(out).values() if isinstance(v, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import chargeflux_tpu_torch, chargeflux_tpu_torch.cells, "
        "chargeflux_tpu_torch.pme, chargeflux_tpu_torch.energy, "
        "chargeflux_tpu_torch.integrate, chargeflux_tpu_torch.neighbors, "
        "chargeflux_tpu_torch.ops.native, chargeflux_tpu_torch.models, "
        "chargeflux_tpu_torch.utils\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'chargeflux_tpu.')) or m == 'chargeflux_tpu']\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_binning_slots_equal_jax(dtype):
    jsys, sys_t, pos, _ = water_systems(dtype)
    spec = jsys.spec
    x = np.asarray(pos, np.dtype(str(dtype).split(".")[1]))
    sj, ij, oj = jcells.build_cell_list_full(
        jnp.asarray(x), jsys.box, spec.cell_grid, spec.cell_capacity)
    st, it, ot = cells.build_cell_list_full(
        torch.as_tensor(x), sys_t.box, spec.cell_grid, spec.cell_capacity)
    assert int(oj) == int(ot) == 0
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(it.numpy(), np.asarray(ij))


def test_binning_overflow_is_counted():
    jsys, sys_t, pos, _ = water_systems(torch.float64)
    grid = jsys.spec.cell_grid
    cap = max_cell_occupancy(pos, sys_t) - 4
    sj, ij, oj = jcells.build_cell_list_full(jnp.asarray(pos), jsys.box,
                                             grid, cap)
    st, it, ot = cells.build_cell_list_full(torch.as_tensor(pos), sys_t.box,
                                            grid, cap)
    assert int(ot) > 0 and int(oj) > 0
    n = pos.shape[0]
    kept = st.numpy().ravel()
    kept = kept[kept < n]
    assert len(kept) == n - int(ot) and len(np.unique(kept)) == len(kept)
    # every kept atom's inverse slot points back at it; dropped ones at the
    # sentinel
    inv = it.numpy()
    assert np.array_equal(st.numpy().ravel()[inv[kept]], kept)
    assert np.sum(inv == st.numel()) == int(ot)


def test_capacity_helpers_match_jax():
    _, pos, _, box = water_box(n_side=22, cutoff=0.72)
    for margin in (1.05, 1.35):
        assert cells.suggest_capacity(pos, box, (8, 8, 8), margin) == \
            jax_suggest_capacity(pos, box, (8, 8, 8), margin)
    jsys, sys_t, pos7, _ = water_systems(torch.float64)
    assert max_cell_occupancy(pos7, sys_t) == jax_max_occupancy(pos7, jsys)
    assert max_cell_occupancy(torch.as_tensor(pos7), sys_t) == \
        jax_max_occupancy(pos7, jsys)


@pytest.mark.parametrize("grid", [(3, 3, 3), (8, 8, 8), (3, 4, 5)])
def test_neighbor_tables_match_jax_and_full_shell_is_distinct(grid):
    nbr, img = cells.full_shell_tables(grid)
    assert np.array_equal(nbr, jcells.neighbor_cell_table(grid))
    assert np.array_equal(cells.neighbor_cell_table(grid), nbr)
    for a, b in zip(cells.half_shell_tables(grid),
                    jcells.half_shell_tables(grid)):
        assert np.array_equal(a, b)
    # at three cells per axis the +1 and -1 neighbors are distinct cells:
    # no neighbor cell is walked twice, and the self cell appears once
    assert all(len(set(row)) == 27 for row in nbr)
    c = np.arange(nbr.shape[0])
    assert np.array_equal(nbr[:, 13], c) and not img[:, 13].any()
    # the image offset is the wrap of the unwrapped neighbor coordinate
    gx, gy, gz = grid
    cc = np.stack([c // (gy * gz), (c // gz) % gy, c % gz], axis=-1)
    shifts = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                       for dz in (-1, 0, 1)])
    raw = cc[:, None, :] + shifts[None]
    wrapped = raw - img * np.array(grid)
    assert np.array_equal(
        (wrapped[..., 0] * gy + wrapped[..., 1]) * gz + wrapped[..., 2], nbr)


def test_erfc_helpers_match_jax():
    assert erf_over_r_coeffs(4.05, 0.72) == jax_coeffs(4.05, 0.72)
    x = np.linspace(0.0, 4.0, 257)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        a = erfc_fast(torch.as_tensor(x).to(dt)).numpy()
        b = np.asarray(jax_erfc_fast(jnp.asarray(x, jdt)))
        np.testing.assert_allclose(a, b, rtol=2e-6 if dt == torch.float32
                                   else 1e-14, atol=1e-7)


def test_cpu_wrappers_take_the_plain_path():
    """On CPU tensors the kernel wrappers run their plain versions and
    launch nothing (the CUDA kernels are tested on the card)."""
    jsys, sys_t, pos, _ = water_systems(torch.float32)
    ops.reset_launch_counts()
    from chargeflux_tpu_torch.energy import energy_and_forces
    e, f = energy_and_forces(torch.as_tensor(pos, dtype=torch.float32), sys_t)
    assert torch.isfinite(e) and torch.isfinite(f).all()
    assert ops.launch_counts() == {"spread_fwd": 0, "spread_bwd": 0,
                                   "direct_walk": 0, "direct_walk_tri": 0,
                                   "direct_walk_halo": 0, "sf_fwd": 0,
                                   "sf_bwd_tables": 0, "sf_bwd_zq": 0,
                                   "cell_bin": 0, "patch_weights_fwd": 0,
                                   "patch_weights_bwd": 0,
                                   "exclusion_fwd": 0, "exclusion_bwd": 0,
                                   "bonded_fwd": 0, "bonded_bwd": 0}
    assert jax.devices()[0].platform == "cpu"


def test_the_system_route_decides_every_kernel_entry(monkeypatch):
    """``make_nb_energy_fn``'s ``init_nb`` and one evaluation over a system
    on the kernel route (forced to "cuda" through ``_swap``; recorders in
    place of the kernel entries run the plain versions) send the binning,
    walk, weights, spread and exclusions to the kernel entries; over its
    ``with_kernel_route("plain")`` copy every one goes to the plain
    versions, the binning included.  No launch is counted, and the copy
    shares the system's tensors.  ``with_kernel_route("cuda")`` refuses a
    system on the CPU, in f32 and in f64."""
    from chargeflux_tpu_torch import pme
    from chargeflux_tpu_torch.integrate import make_nb_energy_fn
    from chargeflux_tpu_torch.ops import cell_bin as cb
    from chargeflux_tpu_torch.ops import direct_walk as dw
    from chargeflux_tpu_torch.ops import exclusion as ex

    # the module (the package exports a function of the same name)
    energy = importlib.import_module("chargeflux_tpu_torch.energy")
    calls = []

    def recorder(stage, route, plain_fn):
        def entry(*args, **kw):
            calls.append((stage, route))
            return plain_fn(*args, **kw)
        return entry

    def flag_recorder(stage, wrapper):
        def entry(*args, plain):
            calls.append((stage, "plain" if plain else "kernel"))
            return wrapper(*args, plain=True)
        return entry

    for module, name, stage, route, plain_fn in (
            (cells, "cell_bin", "binning", "kernel", cb.cell_bin_plain),
            (cells, "cell_bin_plain", "binning", "plain", cb.cell_bin_plain),
            (cells, "direct_walk", "walk", "kernel", dw.direct_walk_plain),
            (cells, "direct_walk_plain", "walk", "plain",
             dw.direct_walk_plain),
            (energy, "template_exclusion_energy", "exclusions", "kernel",
             ex.exclusion_fwd_plain),
            (energy, "exclusion_fwd_plain", "exclusions", "plain",
             ex.exclusion_fwd_plain)):
        monkeypatch.setattr(module, name, recorder(stage, route, plain_fn))
    monkeypatch.setattr(pme, "patch_weights",
                        flag_recorder("weights", pme.patch_weights))
    monkeypatch.setattr(pme, "spread_columns",
                        flag_recorder("spread", pme.spread_columns))

    force, pos, _, box = water_box(n_side=7, cutoff=0.65)
    system = force.create_system(box=box, dtype=torch.float32, device="cpu",
                                 direct_method="cell", recip_method="pme")
    assert system.kernel_route == "plain" and not system.uses_kernels
    kern = system._swap(kernel_route="cuda")
    x = torch.as_tensor(pos, dtype=torch.float32)
    ops.reset_launch_counts()
    out = {}
    for route, sys_ in (("kernel", kern),
                        ("plain", kern.with_kernel_route("plain"))):
        calls.clear()
        e_fn, init_nb = make_nb_energy_fn(sys_)
        nb = init_nb(x)
        assert calls == [("binning", route)]
        out[route] = e_fn(x, nb)[:2]
        assert sorted(calls) == sorted(
            (stage, route) for stage in ("binning", "walk", "weights",
                                         "spread", "exclusions")), calls
    assert not any(ops.launch_counts().values())
    for u, v in zip(out["kernel"], out["plain"]):
        assert torch.allclose(u, v, rtol=1e-6, atol=1e-6 * float(
            v.abs().max()))
    copy = kern.with_kernel_route("plain")
    assert copy.box is kern.box and copy.q0 is kern.q0
    assert copy.with_box(box).kernel_route == "plain"
    for sys_ in (system, system.astype(torch.float64)):
        with pytest.raises(ValueError, match="for an f32 system on the CUDA card"):
            sys_.with_kernel_route("cuda")
    with pytest.raises(ValueError, match="kernel route 'triton'"):
        system.with_kernel_route("triton")
