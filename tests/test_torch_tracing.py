"""PyTorch port: the stage stamps and host spans of ``utils.profiling``.

On the CPU the stamps read the host clock with the bookkeeping the card's
stamp kernels do, so these tests hold the record's counts, its gating by
the profiler and its bit-neutrality here; the tests marked ``cuda`` hold
the chunk graphs' stamps on the card.  This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chargeflux_tpu_torch import integrate
from chargeflux_tpu_torch.integrate import (init_state_nb,
                                            langevin_trajectory_nb,
                                            make_nb_energy_fn,
                                            make_respa_force_fns,
                                            nve_trajectory_nb,
                                            respa_langevin_trajectory_nb)
from chargeflux_tpu_torch.models import water_bonded_params, water_box
from chargeflux_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _water(dtype, device="cpu", n_side=5, cutoff=0.45, tiers=False,
           **kw):
    """(e_fn, init_nb, x, masses) of a cell + SPME water box with its water
    bonds: every energy stage runs.  ``kw`` goes to ``create_system``.
    With ``tiers``, also the r-RESPA tiers ``make_respa_force_fns`` makes
    of the same system and bonds."""
    force, pos, masses, box = water_box(n_side=n_side, flux="bond_angle",
                                        cutoff=cutoff)
    system = force.create_system(box=box, dtype=dtype, direct_method="cell",
                                 recip_method="pme", device=device, **kw)
    bonded = water_bonded_params(len(masses) // 3, box=box, device=device)
    e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)
    out = (e_fn, init_nb, torch.tensor(pos, dtype=dtype, device=device),
           torch.tensor(masses, dtype=dtype, device=device))
    return out + (make_respa_force_fns(system, bonded),) if tiers else out


def _recorded(fn):
    """``fn()`` under a CPU profiler; (its result, the record)."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.totals()


def _counts(record, mode="eager"):
    return {s: (v["fwd"]["count"], v["bwd"]["count"])
            for s, v in record["stages"][mode].items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_recording_profiler_leaves_energy_and_forces_bit_identical(dtype):
    e_fn, init_nb, x, _ = _water(dtype)
    nb = init_nb(x)
    e0, f0, _ = e_fn(x, nb)
    (e1, f1, _), rec = _recorded(lambda: e_fn(x, nb))
    assert _counts(rec)["charges"] == (1, 1)
    assert torch.equal(e0, e1) and torch.equal(f0, f1)
    e2, f2, _ = e_fn(x, nb)
    assert torch.equal(e0, e2) and torch.equal(f0, f2)


def test_each_stage_is_recorded_once_per_pass_per_evaluation():
    e_fn, init_nb, x, _ = _water(torch.float64)
    nb = init_nb(x)
    _, rec = _recorded(lambda: e_fn(x, nb))
    counts = _counts(rec)
    for s in profiling.ENERGY_STAGES:
        assert counts[s] == (1, 1), s
        for p in profiling.PASSES:
            assert rec["stages"]["eager"][s][p]["seconds"] > 0.0
    assert counts["rebuild"] == (0, 0) and counts["replay"] == (0, 0)
    assert all(c == (0, 0) for c in _counts(rec, "replay").values())
    _, rec = _recorded(lambda: [init_nb(x), init_nb(x)])
    assert _counts(rec)["rebuild"] == (2, 0)
    assert rec["host"]["cf_rebuild"]["count"] == 2


def test_nothing_is_recorded_and_no_stamp_runs_without_a_profiler(
        monkeypatch):
    e_fn, init_nb, x, _ = _water(torch.float32)
    calls = []
    real = profiling._Buffer.stamp
    monkeypatch.setattr(profiling._Buffer, "stamp",
                        lambda self, *a: (calls.append(a), real(self, *a)))
    _, before = _recorded(lambda: e_fn(x, init_nb(x)))
    assert len(calls) == 6 * 4 + 2          # six stages and the rebuild
    calls.clear()
    e_fn(x, init_nb(x))
    assert calls == []
    assert profiling.totals() == before


def test_a_new_profiler_starts_an_empty_record():
    e_fn, init_nb, x, _ = _water(torch.float32)
    nb = init_nb(x)
    _recorded(lambda: [e_fn(x, nb), e_fn(x, nb)])
    _, rec = _recorded(lambda: e_fn(x, nb))
    assert _counts(rec)["direct"] == (1, 1)
    assert rec["host"]["cf_direct"]["count"] == 1


def test_the_device_flag_changes_only_with_the_profiler():
    """The record's open state (on the card, whether the chunk graphs hold
    their stamps) follows ``set``; a new session clears the record."""
    buf = profiling._Buffer(torch.device("cpu"))
    buf.set(True, 1)
    buf.stamp(0, True)
    buf.stamp(0, False)
    assert buf.on and buf.read()[2 * profiling.SLOTS] == 1
    buf.set(True, 1)                          # no change: the record stays
    assert buf.read()[2 * profiling.SLOTS] == 1
    buf.set(False, 1)
    buf.stamp(0, True)
    buf.stamp(0, False)                       # closed: nothing counted
    assert not buf.on and buf.read()[2 * profiling.SLOTS] == 1
    buf.set(True, 2)                          # off to on: cleared
    assert buf.read() == [0] * (3 * profiling.SLOTS)


def test_graph_stamps_choose_the_stamped_graph_only_while_recording():
    """``GraphStamps.sync`` asks for the graph with the stamps while a
    profiler records, and for the graph's own otherwise or where the
    capture held no stamp."""
    stamps = profiling.GraphStamps(torch.device("cpu"))
    assert not stamps.sync()
    with profile(activities=[ProfilerActivity.CPU]):
        assert not stamps.sync()               # no stamped graph
        stamps._set = 1234
        assert stamps.sync()
    assert not stamps.sync()
    stamps._set = None


def test_host_spans_nest_and_self_time_is_at_most_total():
    def work():
        with profiling.phase_scope("cf.test.outer"):
            time.sleep(0.01)
            for _ in range(2):
                with profiling.phase_scope("cf.test.inner"):
                    time.sleep(0.01)
    _, rec = _recorded(work)
    outer, inner = rec["host"]["cf.test.outer"], rec["host"]["cf.test.inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert outer["parents"] == [] and inner["parents"] == ["cf.test.outer"]
    for r in (outer, inner):
        assert 0.0 < r["self_s"] <= r["total_s"]
    assert inner["self_s"] == pytest.approx(inner["total_s"])
    assert outer["total_s"] >= inner["total_s"] + outer["self_s"] - 1e-9
    assert outer["self_s"] == pytest.approx(outer["total_s"]
                                            - inner["total_s"])


def test_nve_trajectory_nb_records_the_md_spans():
    e_fn, init_nb, x, m = _water(torch.float32)
    state = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    (_, es), rec = _recorded(lambda: nve_trajectory_nb(
        state, e_fn, init_nb, m, 5e-4, 8, 4))
    host = rec["host"]
    assert host["cf.md.call"]["count"] == 1
    assert host["cf.md.load"]["count"] == 1         # one chunk length
    assert host["cf.md.final"]["count"] == 1
    assert host["cf.md.load"]["parents"] == ["cf.md.call"]
    assert host["cf.md.final"]["parents"] == []
    assert "cf.md.replay" not in host and "cf.md.capture" not in host
    assert rec["replays"] == {}                     # eager on the CPU
    counts = _counts(rec)
    assert counts["charges"] == (9, 9)              # 8 steps and the final
    assert counts["rebuild"] == (3, 0)              # 2 chunks and the final
    assert set(host["cf_charges"]["parents"]) == {"cf.md.call",
                                                  "cf.md.final"}
    assert torch.isfinite(es).all()


def _record(replays, per_stage, counts=None, rebuild=None, bounds=None):
    """A synthetic record of ``totals``' shape: every energy stage
    ``per_stage`` seconds a pass over ``counts`` spans a pass."""
    chunks = sum(replays.values())
    steps = sum(k * n for k, n in replays.items())
    counts = steps if counts is None else counts
    rec = {"host": {}, "replays": dict(replays),
           "stages": {m: {s: {p: {"seconds": 0.0, "count": 0}
                              for p in profiling.PASSES}
                          for s in profiling.STAGES}
                      for m in profiling.MODES}}
    rep = rec["stages"]["replay"]
    for s in profiling.ENERGY_STAGES:
        for p in profiling.PASSES:
            rep[s][p] = {"seconds": per_stage, "count": counts}
    rep["rebuild"]["fwd"] = {"seconds": 0.5 * per_stage,
                             "count": chunks if rebuild is None else rebuild}
    rep["replay"]["fwd"] = {"seconds": 20 * per_stage,
                            "count": chunks if bounds is None else bounds}
    return rec


def test_stage_ms_reads_the_replays_per_step():
    rec = _record({20: 5}, per_stage=0.1)
    ms = profiling.stage_ms(rec, 100)
    assert set(ms) == set(profiling.STAGES[:-1]) | {"other"}
    assert ms["charges"] == pytest.approx(2.0)
    assert ms["rebuild"] == pytest.approx(0.5)
    assert ms["other"] == pytest.approx(20 - 12 - 0.5)
    assert sum(ms.values()) == pytest.approx(20.0)


@pytest.mark.parametrize("case", ["empty", "steps", "counts", "rebuild",
                                  "bounds"])
def test_stage_ms_is_none_on_an_empty_or_mismatched_record(case):
    rec = {"empty": _record({}, 0.1),
           "steps": _record({20: 5}, 0.1),
           "counts": _record({20: 5}, 0.1, counts=99),
           "rebuild": _record({20: 5}, 0.1, rebuild=4),
           "bounds": _record({20: 5}, 0.1, bounds=6)}[case]
    assert profiling.stage_ms(rec, 80 if case == "steps" else 100) is None


# r-RESPA: 4 outer steps of 1 fs, 2 substeps each, rebuilt every 2
RESPA = dict(dt=1e-3, n_inner=2, n_steps=4, every=2)


def _respa_run(dtype=torch.float64, device="cpu", seed=7, **kw):
    """(final state, kinetic energies) of ``respa_langevin_trajectory_nb``
    on the water box, from rest, and the call itself (for re-runs)."""
    e_fn, init_nb, x, m, (slow_fn, fast_fn, init_slow) = _water(
        dtype, device, tiers=True, **kw)
    state = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)

    def run(n_steps=RESPA["n_steps"], gen=None):
        gen = gen or torch.Generator(device).manual_seed(seed)
        return respa_langevin_trajectory_nb(
            state, slow_fn, fast_fn, init_slow, m, RESPA["dt"],
            RESPA["n_inner"], 300.0, 1.0, gen, n_steps, RESPA["every"])
    return run


def _chunks_recorded(monkeypatch, run):
    """``run()`` with a CPU profiler around its chunks alone (not the
    driver's eager evaluations at the call's start and end); (its result,
    the chunks' record)."""
    real, box = integrate._run_chunks, {}

    def recorded(*args, **kwargs):
        out, box["rec"] = _recorded(lambda: real(*args, **kwargs))
        return out
    monkeypatch.setattr(integrate, "_run_chunks", recorded)
    return run(), box["rec"]


def _as_replayed(rec, chunks: dict, respa: dict) -> dict:
    """A CPU record's eager stages read as replays of ``chunks`` (chunk
    length -> replays) that ran the r-RESPA steps ``respa``."""
    return {"host": rec["host"], "replays": dict(chunks),
            "stages": {"eager": rec["stages"]["replay"],
                       "replay": rec["stages"]["eager"]},
            "respa": dict(respa)}


def test_respa_ms_reads_a_cpu_respa_record(monkeypatch):
    """A RESPA call's chunks on the CPU: one respa_fast stage per outer
    step with n_inner bonded evaluations inside it, one forward and one
    backward of each slow-tier stage, and no r-RESPA steps counted (only a
    replay counts them); respa_ms reads that record, as a replay's, per
    outer step."""
    n, k = RESPA["n_steps"], RESPA["n_inner"]
    (_fin, kes), rec = _chunks_recorded(monkeypatch, _respa_run())
    counts = _counts(rec)
    assert counts["respa_fast"] == (n, 0)
    assert counts["bonded"] == (n * k, n * k)
    assert all(counts[s] == (n, n) for s in profiling.SLOW_STAGES)
    assert rec["respa"] == {"outer": 0, "inner": 0}
    assert rec["host"]["cf_bonded"]["parents"] == ["cf_respa_fast"]
    assert "cf_respa_fast" not in rec["host"]["cf_direct"]["parents"]
    assert profiling.respa_ms(rec, n) is None              # nothing replayed
    ms = profiling.respa_ms(_as_replayed(
        rec, {RESPA["every"]: 2}, {"outer": n, "inner": n * k}), n)
    eager = rec["stages"]["eager"]
    assert ms["fast"] == pytest.approx(
        1e3 * eager["respa_fast"]["fwd"]["seconds"] / n)
    assert ms["bonded"] == pytest.approx(1e3 * sum(
        eager["bonded"][p]["seconds"] for p in profiling.PASSES) / n)
    for s in profiling.SLOW_STAGES:
        assert ms[s] == pytest.approx(1e3 * sum(
            eager[s][p]["seconds"] for p in profiling.PASSES) / n), s
    assert ms["slow"] == pytest.approx(
        sum(ms[s] for s in profiling.SLOW_STAGES))
    assert 0.0 < ms["bonded"] < ms["fast"] and ms["slow"] > 0.0
    assert torch.isfinite(kes).all()


def _respa_record(outer=100, n_inner=4, chunk=5, fast=None, bonded=None,
                  slow=None, counted=None):
    """A synthetic record of ``totals``' shape for ``outer`` replayed
    r-RESPA outer steps in chunks of ``chunk``: the fast tier 0.3 s, each
    bonded pass 0.05 s, each slow stage's pass 0.1 s."""
    rec = _record({chunk: outer // chunk}, 0.1, counts=outer)
    rep = rec["stages"]["replay"]
    for m in profiling.MODES:
        rec["stages"][m]["respa_fast"] = {
            p: {"seconds": 0.0, "count": 0} for p in profiling.PASSES}
    rep["respa_fast"]["fwd"] = {"seconds": 0.3,
                                "count": outer if fast is None else fast}
    for p in profiling.PASSES:
        rep["bonded"][p] = {"seconds": 0.05, "count": outer * n_inner
                            if bonded is None else bonded}
        for s in profiling.SLOW_STAGES:
            rep[s][p]["count"] = outer if slow is None else slow
    rec["respa"] = counted or {"outer": outer, "inner": outer * n_inner}
    return rec


def test_respa_ms_reads_the_replays_per_outer_step():
    ms = profiling.respa_ms(_respa_record(), 100)
    assert ms == pytest.approx({"fast": 3.0, "bonded": 1.0, "slow": 10.0,
                                **dict.fromkeys(profiling.SLOW_STAGES, 2.0)})


@pytest.mark.parametrize("case", ["steps", "counted", "fast", "bonded",
                                  "slow", "no_counter", "no_stage"])
def test_respa_ms_is_none_on_a_mismatched_record(case):
    rec = {"steps": _respa_record(),
           "counted": _respa_record(counted={"outer": 100, "inner": 300}),
           "fast": _respa_record(fast=99),
           "bonded": _respa_record(bonded=399),
           "slow": _respa_record(slow=101),
           "no_counter": _record({5: 20}, 0.1),
           "no_stage": _respa_record()}[case]
    if case == "no_stage":
        for m in profiling.MODES:
            del rec["stages"][m]["respa_fast"]
    steps = 95 if case == "steps" else 100
    assert profiling.respa_ms(rec, steps) is None


def test_stage_ms_of_an_nve_record_is_unchanged_by_the_respa_stage():
    """An NVE call's record holds the new stage and counters at zero, and
    stage_ms reads a record the same with and without them."""
    e_fn, init_nb, x, m = _water(torch.float64)
    state = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    _, rec = _recorded(lambda: nve_trajectory_nb(state, e_fn, init_nb, m,
                                                 5e-4, 8, 4))
    assert _counts(rec)["respa_fast"] == (0, 0)
    assert rec["respa"] == {"outer": 0, "inner": 0}
    plain = _record({20: 5}, 0.1)
    timed = _record({20: 5}, 0.1)
    for mode in profiling.MODES:
        timed["stages"][mode]["respa_fast"] = {
            p: {"seconds": 0.0, "count": 0} for p in profiling.PASSES}
    timed["respa"] = rec["respa"]
    assert profiling.stage_ms(timed, 100) == profiling.stage_ms(plain, 100)
    assert profiling.respa_ms(timed, 100) is None


def test_a_recording_profiler_leaves_respa_trajectories_bit_identical():
    run = _respa_run(torch.float32)
    fin0, kes0 = run()
    (fin1, kes1), rec = _recorded(run)
    assert _counts(rec)["respa_fast"] == (RESPA["n_steps"], 0)
    assert torch.equal(kes0, kes1) and torch.isfinite(kes0).all()
    for f in ("positions", "velocities", "forces", "f_slow", "f_fast"):
        assert torch.equal(getattr(fin0, f), getattr(fin1, f)), f


class _Event:
    def __init__(self, name, start, end, cuda=False):
        self._v = (name, start, end, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def is_user_annotation(self):
        return False


def test_idle_by_span_on_a_synthetic_event_list():
    ev = [_Event("cf.md.call", 0, 1000), _Event("cf.md.replay", 100, 200),
          _Event("cf.md.final", 700, 1000), _Event("cf_charges", 800, 900),
          _Event("aten::eq", 750, 760), _Event("cfbench.window", 0, 2000),
          _Event("k1", 0, 150, cuda=True), _Event("k2", 140, 300, cuda=True),
          # idle 300-400: midpoint 350, in the call only
          _Event("k3", 400, 740, cuda=True),
          # idle 740-780: midpoint 760, in the final
          _Event("k4", 780, 820, cuda=True),
          # idle 820-880: midpoint 850, in the final's charges
          _Event("k5", 880, 1200, cuda=True),
          # idle 1200-1300: outside every program span
          _Event("k6", 1300, 1400, cuda=True)]
    out = profiling.idle_by_span(ev)
    assert list(out) == ["cf.md.call", "(none)", "cf_charges", "cf.md.final"]
    assert out["cf.md.call"] == {"seconds": pytest.approx(100e-9),
                                 "gaps": 1, "longest_s": pytest.approx(100e-9)}
    assert out["(none)"]["seconds"] == pytest.approx(100e-9)
    assert out["cf_charges"]["seconds"] == pytest.approx(60e-9)
    assert out["cf.md.final"]["seconds"] == pytest.approx(40e-9)
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    assert profiling.idle_by_span(prof) == out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_chunk():
    """A warm 20-step NVE chunk graph on the card (its stamps captured in
    it) and the state it starts from: 5,184 atoms on 4^3 cells, whose
    0.28 nm skin keeps the neighbor state fresh through a chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stamp kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    e_fn, init_nb, x, m = _water(torch.float32, dev, n_side=12, cutoff=0.65,
                                 cell_grid=(4, 4, 4))
    state = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    state, es = nve_trajectory_nb(state, e_fn, init_nb, m, 5e-4, 40, 20)
    assert torch.isfinite(es).all()
    (chunk,) = e_fn.nve_chunks.values()
    return chunk, tuple(t.clone() for t in chunk.carry)


def _replay(chunk, start):
    chunk._copy_in(start)
    chunk()
    torch.cuda.synchronize()
    return [t.clone() for t in (*chunk.carry, chunk.potential, chunk.es)]


@pytest.mark.cuda
def test_a_chunk_graph_with_live_stamps_replays_the_flag_off_bits(
        card_chunk):
    chunk, start = card_chunk
    off = _replay(chunk, start)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = _replay(chunk, start)
    rec = profiling.totals()
    assert rec["replays"] == {20: 1}
    assert _counts(rec, "replay")["charges"] == (20, 20)
    assert all(torch.isfinite(t).all() for t in off)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert all(torch.equal(a, b) for a, b in zip(off, _replay(chunk, start)))


@pytest.mark.cuda
def test_the_stage_record_matches_cuda_events_around_the_replays(
        card_chunk):
    """The record's replay time (the stamps at each graph's first and last
    node) against CUDA events around ten back-to-back replays.  A profiler
    start opens the record (as a chunk call does); the replays of the graph
    with its stamps then run outside it, queued behind a sleep on the card,
    so neither the profiler's nor any other host work sets their pace."""
    chunk, start = card_chunk
    chunk._copy_in(start)
    with profile(activities=[ProfilerActivity.CPU]):
        assert chunk.stamps.sync()                 # record empty and open
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e8))                    # ~0.2 s of clock cycles
    a.record()
    for _ in range(10):
        chunk.stamps.launch()
    b.record()
    torch.cuda.synchronize()
    rec = profiling.totals()
    assert not chunk.stamps.sync()                 # no profiler: closed
    rep = rec["stages"]["replay"]
    assert rep["replay"]["fwd"]["count"] == 10
    assert rep["replay"]["fwd"]["seconds"] * 1e3 == pytest.approx(
        a.elapsed_time(b), rel=0.02)
    for s in profiling.ENERGY_STAGES:
        assert (rep[s]["fwd"]["count"], rep[s]["bwd"]["count"]) == (200, 200)
    staged = sum(rep[s][p]["seconds"] for s in profiling.STAGES[:-1]
                 for p in profiling.PASSES)
    assert 0.5 * rep["replay"]["fwd"]["seconds"] < staged
    assert staged < rep["replay"]["fwd"]["seconds"]


@pytest.mark.cuda
def test_without_a_profiler_the_graph_holds_no_stamp_and_counts_nothing(
        card_chunk):
    """Every stamp of the chunk's capture is collected (six stages, two
    passes, two edges a step; the rebuild and the graph's bounds once), and
    the graph a replay with no profiler runs holds none of them."""
    chunk, start = card_chunk
    n_stages = len(profiling.ENERGY_STAGES)
    assert len(chunk.stamps.nodes) == n_stages * 4 * chunk.k + 4
    assert chunk.stamps.bridged > 0
    _replay(chunk, start)
    buf = profiling._buffer(chunk.x.device)
    before = buf.read()
    _replay(chunk, start)
    assert buf.read() == before


@pytest.mark.cuda
def test_a_stamped_langevin_replay_draws_what_the_graph_s_own_draws():
    """A Langevin chunk replayed with its stamps (under a profiler) takes
    its noise from the generator as its own graph does: the same
    trajectory bits, and the generator left in the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    e_fn, init_nb, x, m = _water(torch.float32, dev, n_side=12, cutoff=0.65,
                                 cell_grid=(4, 4, 4))
    state = init_state_nb(x, torch.zeros_like(x), e_fn, init_nb)
    gen = torch.Generator(dev).manual_seed(11)
    seed = gen.get_state()

    def run():
        return langevin_trajectory_nb(state, e_fn, init_nb, m, 5e-4, 300.0,
                                      1.0, gen, 40, 20)

    run()                                      # captures the chunk
    gen.set_state(seed)
    plain, kes = run()
    after = gen.get_state()
    gen.set_state(seed)
    (stamped, kes2), rec = _recorded(run)
    assert rec["replays"] == {20: 2}
    assert _counts(rec, "replay")["charges"] == (40, 40)
    assert torch.equal(kes, kes2) and torch.isfinite(kes).all()
    assert torch.equal(plain.positions, stamped.positions)
    assert torch.equal(plain.velocities, stamped.velocities)
    assert torch.equal(after, gen.get_state())


@pytest.mark.cuda
def test_a_stamped_respa_replay_keeps_the_bits_and_reads_its_tiers():
    """An r-RESPA Langevin chunk graph replayed with its stamps (under a
    profiler) gives its own graph's bits from the same generator state;
    the record counts the outer steps and substeps the replays ran, and
    respa_ms reads the tiers, the fast one wider than its bonded
    evaluations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    run = _respa_run(torch.float32, dev, n_side=12, cutoff=0.65,
                     cell_grid=(4, 4, 4))
    n, k = 8, RESPA["n_inner"]
    gen = torch.Generator(dev).manual_seed(11)
    run(n, gen)                                # captures the chunk
    seed = gen.get_state()
    plain, kes = run(n, gen)
    after = gen.get_state()
    gen.set_state(seed)
    (stamped, kes2), rec = _recorded(lambda: run(n, gen))
    assert rec["replays"] == {RESPA["every"]: n // RESPA["every"]}
    assert rec["respa"] == {"outer": n, "inner": n * k}
    assert _counts(rec, "replay")["respa_fast"] == (n, 0)
    assert _counts(rec, "replay")["bonded"] == (n * k, n * k)
    ms = profiling.respa_ms(rec, n)
    assert 0.0 < ms["bonded"] < ms["fast"] and ms["slow"] > 0.0
    assert torch.equal(kes, kes2) and torch.isfinite(kes).all()
    for f in ("positions", "velocities", "f_slow", "f_fast"):
        assert torch.equal(getattr(plain, f), getattr(stamped, f)), f
    assert torch.equal(after, gen.get_state())
