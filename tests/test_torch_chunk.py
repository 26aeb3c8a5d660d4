"""PyTorch port: the trajectory chunk (the counterpart of the JAX package's
compiled NVE chunk) and the rest of the NVE surface, held to the JAX
package in f64 on the CPU.

On the CPU a chunk runs eagerly: the same code that a CUDA graph captures
on the card.  The guard test stands in for the capture here: after a
warm-up, a whole chunk runs with every host-to-device copy and host read
patched to raise."""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import cells as jcells
from chargeflux_tpu.models import water_bonded_params as jax_bonded_params
from chargeflux_tpu_torch import cells, integrate, ops
from chargeflux_tpu_torch.models import water_bonded_params

from torch_helpers import forbid_host_traffic, jax_water, water_systems

jintegrate = importlib.import_module("chargeflux_tpu.integrate")

torch.set_num_threads(2)

DT = 5e-4


def _start(pos, masses, seed=11):
    """Maxwell velocities at 300 K from a NumPy seed (both packages get
    the same numbers)."""
    rng = np.random.default_rng(seed)
    sig = np.sqrt(0.008314462618 * 300.0 / masses)[:, None]
    return pos, rng.standard_normal(pos.shape) * sig


def _rank_by_bincount(cell, n_cells, capacity):
    """The binning as the port had it before it was made capturable
    (cell starts from ``torch.bincount``): the slots it must keep."""
    n = cell.shape[0]
    sentinel = n_cells * capacity
    order = torch.sort(cell, stable=True).indices
    sorted_cell = cell[order]
    counts = torch.bincount(cell, minlength=n_cells)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n) - starts[sorted_cell]
    ok = rank < capacity
    slot = torch.where(ok, sorted_cell * capacity + rank, sentinel)
    slots = torch.full((sentinel + 1,), n, dtype=torch.int32)
    slots[slot] = order.to(torch.int32)
    slot_of = torch.empty((n,), dtype=torch.int32)
    slot_of[order] = slot.to(torch.int32)
    return (slots[:sentinel].reshape(n_cells, capacity), slot_of,
            torch.sum(~ok).to(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_binning_matches_jax_with_empty_full_and_overflowing_cells(dtype):
    """A 3^3 grid at capacity 4: cell 0 empty, cell 5 at capacity, cell 13
    two atoms over (its column stays within the column capacity), the
    others 1-3 atoms, atom ids shuffled and some atoms an image away.
    Slots, inverse slots and overflow equal the JAX package's and the
    bincount binning's, bit for bit."""
    rng = np.random.default_rng(5)
    grid, cap, edge = (3, 3, 3), 4, 1.0
    counts = {0: 0, 5: 4, 13: 6}
    pos = []
    for c in range(27):
        k = counts.get(c, int(rng.integers(1, 4)))
        origin = np.array([c // 9, (c // 3) % 3, c % 3]) * edge
        pos.append(origin + rng.uniform(0.05, 0.95, (k, 3)) * edge)
    pos = np.concatenate(pos)[rng.permutation(sum(map(len, pos)))]
    pos[::7] += 3.0 * edge * rng.integers(-1, 2, (len(pos[::7]), 3))
    box = np.full(3, 3.0 * edge)

    x = torch.as_tensor(pos).to(dtype)
    slots, inv, over = cells.build_cell_list_full(
        x, torch.as_tensor(box).to(dtype), grid, cap)
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    js, ji, jo = jcells.build_cell_list_full(jnp.asarray(pos, jd),
                                             jnp.asarray(box, jd), grid, cap)
    assert int(over) == int(jo) == 2
    assert np.array_equal(slots.numpy(), np.asarray(js))
    assert np.array_equal(inv.numpy(), np.asarray(ji))
    assert (slots[0] == len(pos)).all() and (slots[5] < len(pos)).all()

    frac = x / torch.as_tensor(box).to(dtype)
    ci = torch.clamp(((frac - torch.floor(frac)) * 3).to(torch.int32), 0, 2)
    cell = ((ci[:, 0] * 3 + ci[:, 1]) * 3 + ci[:, 2]).long()
    for u, v in zip((slots, inv, over), _rank_by_bincount(cell, 27, cap)):
        assert torch.equal(u, v)


def test_chunked_nve_trajectory_nb_matches_jax_with_a_remainder():
    """23 steps, rebuilt every 5 (four chunks and a 3-step remainder
    chunk), against the JAX package's nve_trajectory_nb in f64: positions
    within 1e-9 nm, energies within rtol 1e-9.  (The replays against the
    eager chunks are the card tests'.)"""
    jsys, sys_t, pos, masses = water_systems(torch.float64)
    x0, v0 = _start(pos, masses)
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)

    jb = jax_bonded_params(n_w, box=box, dtype=jnp.float64)
    je_fn, jinit = jintegrate.make_nb_energy_fn(jsys, bonded=jb)
    js = jintegrate.init_state_nb(jnp.asarray(x0), jnp.asarray(v0), je_fn,
                                  jinit)
    jfin, jes = jintegrate.nve_trajectory_nb(js, je_fn, jinit,
                                             jnp.asarray(masses), DT, 23,
                                             rebuild_every=5)

    tb = water_bonded_params(n_w, box=box, dtype=torch.float64, device="cpu")
    e_fn, init_nb = integrate.make_nb_energy_fn(sys_t, bonded=tb)
    s = integrate.init_state_nb(torch.as_tensor(x0), torch.as_tensor(v0),
                                e_fn, init_nb)
    m = torch.as_tensor(masses)
    fin, es = integrate.nve_trajectory_nb(s, e_fn, init_nb, m, DT, 23,
                                          rebuild_every=5)
    assert es.shape == (23,) and torch.isfinite(es).all()
    assert np.abs(fin.positions.numpy() - np.asarray(jfin.positions)).max() \
        <= 1e-9
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-9)
    assert abs(float(fin.potential) - float(jfin.potential)) <= \
        1e-9 * abs(float(jfin.potential))
    for f in ("slots", "inv_slot", "overflow"):
        assert np.array_equal(getattr(fin.nb, f).numpy(),
                              np.asarray(getattr(jfin.nb, f))), f


def _routes():
    return {"cell": lambda: water_systems(torch.float64),
            "dense": lambda: jax_water(4, 0.6, direct_method="dense")}


@pytest.mark.parametrize("route", ["cell", "dense"])
def test_nve_trajectory_and_step_match_jax(route):
    """nve_trajectory (12 steps: a chunk of 10 and a remainder of 2; on
    the cell route each step bins anew) and one nve_step against the
    JAX package's in f64: positions within 1e-9 nm, energies within rtol
    1e-9; the initial state's energy and forces too."""
    jsys, sys_t, pos, masses = _routes()[route]()
    x0, v0 = _start(pos, masses, seed=3)
    n_w = pos.shape[0] // 3
    box = np.asarray(jsys.box)
    je_fn = jintegrate.make_energy_fn(
        jsys, bonded=jax_bonded_params(n_w, box=box, dtype=jnp.float64))
    e_fn = integrate.make_energy_fn(
        sys_t, bonded=water_bonded_params(n_w, box=box, dtype=torch.float64,
                                          device="cpu"))
    jm, m = jnp.asarray(masses), torch.as_tensor(masses)
    js = jintegrate.init_state(jnp.asarray(x0), jnp.asarray(v0), je_fn)
    s = integrate.init_state(torch.as_tensor(x0), torch.as_tensor(v0), e_fn)
    assert abs(float(s.potential) - float(js.potential)) <= \
        1e-10 * abs(float(js.potential))
    assert np.abs(s.forces.numpy() - np.asarray(js.forces)).max() <= \
        1e-9 * np.abs(np.asarray(js.forces)).max()

    j1, s1 = jintegrate.nve_step(js, je_fn, jm, DT), \
        integrate.nve_step(s, e_fn, m, DT)
    assert np.abs(s1.positions.numpy() - np.asarray(j1.positions)).max() \
        <= 1e-12
    assert abs(float(s1.potential) - float(j1.potential)) <= \
        1e-10 * abs(float(j1.potential))

    jfin, jes = jintegrate.nve_trajectory(js, je_fn, jm, DT, 12)
    fin, es = integrate.nve_trajectory(s, e_fn, m, DT, 12)
    assert es.shape == (12,) and torch.isfinite(es).all()
    assert np.abs(fin.positions.numpy() - np.asarray(jfin.positions)).max() \
        <= 1e-9
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-9)
    np.testing.assert_allclose(float(fin.potential), float(jfin.potential),
                               rtol=1e-9)


def test_temperature_and_remove_com_motion_match_jax():
    """The same arithmetic as the JAX package's, in f64; only the order of
    the sums over atoms is the library's own, so the results agree to the
    last bit or two (rtol 1e-15, 4.5 ulp)."""
    rng = np.random.default_rng(2)
    masses = np.tile([15.999, 1.008, 1.008], 40)
    v = rng.standard_normal((120, 3))
    for n_c in (0, 3):
        np.testing.assert_allclose(
            float(integrate.temperature(torch.as_tensor(v),
                                        torch.as_tensor(masses), n_c)),
            float(jintegrate.temperature(jnp.asarray(v), jnp.asarray(masses),
                                         n_c)), rtol=1e-15, atol=0)
    got = integrate.remove_com_motion(torch.as_tensor(v), masses)
    want = jintegrate.remove_com_motion(jnp.asarray(v), masses)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15 * np.abs(v).max())


def test_maxwell_velocities_statistics():
    """Zero momentum; over 16 draws of 3000 atoms at 300 K the mean
    temperature within 1% (its standard error is 0.4%), and per species
    m <v_x^2> / kT within 3%; the type follows ``dtype`` (default: torch's
    default float, as JAX's default float)."""
    masses = torch.as_tensor(np.tile([15.999, 1.008, 1.008], 1000))
    gen = torch.Generator().manual_seed(7)
    temps, ratio = [], {0: [], 1: []}
    for _ in range(16):
        v = integrate.maxwell_velocities(masses, 300.0, gen,
                                         dtype=torch.float64)
        p = torch.sum(masses[:, None] * v, dim=0)
        assert float(p.abs().max()) <= 1e-10
        temps.append(float(integrate.temperature(v, masses)))
        for species in ratio:
            sel = v[species::3]
            ratio[species].append(float(
                masses[species] * (sel * sel).mean()
                / (0.008314462618 * 300.0)))
    assert abs(np.mean(temps) / 300.0 - 1.0) <= 0.01
    for vals in ratio.values():
        assert abs(np.mean(vals) - 1.0) <= 0.03
    assert integrate.maxwell_velocities(masses, 300.0, gen).dtype == \
        torch.get_default_dtype()


@pytest.mark.parametrize("case", ["generator_elsewhere", "masses_not_tensor"])
def test_maxwell_velocities_refuse_a_generator_of_another_device(case):
    """The velocities are made where the masses are (a tensor), else on
    the card; a generator of another device raises rather than moving the
    work.  Masses that are not a tensor name no device: without CUDA they
    raise as every entry point does, with it the CPU generator is the
    wrong one."""
    masses = np.tile([15.999, 1.008, 1.008], 4)
    if case == "generator_elsewhere":
        masses = torch.as_tensor(masses)
        gen = types.SimpleNamespace(device=torch.device("cuda", 0))
        want = ValueError
    else:
        gen = torch.Generator().manual_seed(1)
        want = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(want):
        integrate.maxwell_velocities(masses, 300.0, gen)


@pytest.mark.parametrize("route", ["cell_nb", "dense_nb", "cell_binning"])
def test_a_chunk_makes_no_host_copy_and_reads_nothing_back(route,
                                                           monkeypatch):
    """After one warm-up step, ``torch.tensor``, ``torch.as_tensor``,
    ``torch.bincount`` and the Tensor methods that read a value on the host
    raise; a whole chunk (rebuild and 5 steps; on the dense route the
    steps; without a neighbor state a 5-step chunk whose steps each bin
    anew) still runs, and gives the bits of the same chunk run
    unpatched."""
    kind = route.split("_")[0]
    jsys, sys_t, pos, masses = _routes()[kind]()
    x0, v0 = _start(pos, masses)
    m = torch.as_tensor(masses)
    x0, v0 = torch.as_tensor(x0), torch.as_tensor(v0)
    if route.endswith("nb"):
        e_fn, init_nb = integrate.make_nb_energy_fn(sys_t)
        s = integrate.init_state_nb(x0, v0, e_fn, init_nb)

        def run(n):
            return integrate.nve_trajectory_nb(s, e_fn, init_nb, m, DT, n,
                                               rebuild_every=5)
    else:
        e_fn = integrate.make_energy_fn(sys_t)
        s = integrate.init_state(x0, v0, e_fn)

        def run(n):
            return integrate.nve_trajectory(s, e_fn, m, DT, n)
    run(1)
    want = run(5)
    with monkeypatch.context() as patch:
        forbid_host_traffic(patch)
        got = run(5)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].positions, want[0].positions)
    assert torch.isfinite(got[1]).all()


def test_chunks_are_kept_on_the_energy_function():
    """``chunk_for`` keeps every chunk it makes on the energy function, by
    key, and hands the same chunk back for the same key.  A capture's
    launches are kept apart (``ops.captured_launches``: the totals stay
    as they were) and each replay adds them."""
    def e_fn(x):
        return x

    made = []

    def make():
        made.append(object())
        return made[-1]

    first = integrate.chunk_for(e_fn, make, "a")
    assert integrate.chunk_for(e_fn, make, "a") is first and len(made) == 1
    for key in range(6):
        integrate.chunk_for(e_fn, make, key)
    assert e_fn.nve_chunks["a"] is first and len(e_fn.nve_chunks) == 7
    assert integrate.chunk_for(e_fn, make, 0) is made[1] and len(made) == 7

    ops.reset_launch_counts()
    ops.add_launches({"sf_fwd": 2})
    with ops.captured_launches() as captured:
        ops.direct_walk.LAUNCHES["direct_walk"] += 3
        ops.structure_factor.LAUNCHES["sf_fwd"] += 1
    assert captured["direct_walk"] == 3 and captured["sf_fwd"] == 1
    assert sum(captured.values()) == 4
    assert ops.launch_counts() == {**dict.fromkeys(captured, 0), "sf_fwd": 2}
    ops.add_launches(captured)
    ops.add_launches(captured)
    counts = ops.launch_counts()
    assert counts["direct_walk"] == 6 and counts["sf_fwd"] == 4
    assert sum(counts.values()) == 10
    assert set(ops.KERNEL_SYMBOLS) == set(counts)
    ops.reset_launch_counts()


def test_chunk_key_holds_what_a_chunk_computes_not_identities():
    """``integrate.chunk_key``: fresh masses tensors and generators of the
    same shapes give one key (they replay one graph); the chunk length, the
    carry's shape, type or device, the masses' shape or type, and the
    driver's coefficients each give another."""
    x = torch.zeros((6, 3), dtype=torch.float64)
    m = torch.ones(6, dtype=torch.float64)
    base = ("langevin_nb", 5e-4, 300.0, 20.0)
    key = integrate.chunk_key(base, 4, x, m)
    assert key == integrate.chunk_key(base, 4, x.clone(), m.clone() * 2.0)
    assert hash(key) == hash(integrate.chunk_key(base, 4, x.clone(),
                                                 m.clone()))
    others = [integrate.chunk_key(base, 5, x, m),
              integrate.chunk_key(base, 4, torch.zeros((9, 3),
                                                       dtype=torch.float64),
                                  torch.ones(9, dtype=torch.float64)),
              integrate.chunk_key(base, 4, x.float(), m),
              integrate.chunk_key(base, 4, x, m.float()),
              integrate.chunk_key(("langevin_nb", 5e-4, 310.0, 20.0), 4, x,
                                  m)]
    assert len({key, *others}) == 1 + len(others)
    assert not any(isinstance(v, torch.Tensor) for v in key)


def test_eager_chunk_reads_the_callers_masses_and_generator():
    """On the CPU (and with ``graph=False``) a chunk's step reads the
    caller's masses tensor and generator themselves; a chunk that would
    replay a graph is given buffers of its own (checked on the card)."""
    seen = {}

    def make_step(masses, generator):
        seen.update(masses=masses, generator=generator)
        return lambda carry, nb: (carry, carry[0].sum(), carry[0].sum())

    x = torch.zeros((6, 3), dtype=torch.float64)
    m = torch.ones(6, dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    chunk = integrate.Chunk(make_step, None, 2, (x,) * 3, True, m, gen)
    assert not chunk.want_graph
    assert seen["masses"] is m and seen["generator"] is gen
    chunk.load(x, x, x, masses=m, generator=gen)
    chunk()
    assert torch.equal(chunk.es, torch.zeros(2, dtype=torch.float64))
