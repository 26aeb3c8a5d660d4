"""The multi-device routes across the cards of one host: ``python3 -m
chargeflux_tpu_torch.utils.measure multigpu`` (the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``).

One process per card (``torch.multiprocessing.spawn``, joined against a
deadline), an NCCL group over all of them (``tcp://localhost``), and in
every process the same routes at real size, each held against the
single-card route that rank 0 computes on the same inputs:

(a) ``parallel.halo`` at bench.py's 30k box (f32, 8^3 cells, the slab walk
    kernel) on (4, 1) x slabs and (2, 2) bricks (the decompositions of the
    group's size that exist), on the halo PME mesh and on classical Ewald;
    energy and forces against the single-card kernel route (|dE| <= 1e-5
    of sum|E_c|, force RMS <= 1e-5); a binning overflow poisons every rank;
(b) NVE over the halo energy with its chunks captured as CUDA graphs (NCCL
    point-to-point exchanges and all-reduces inside them): replays
    bit-equal to ``graph=False`` on every rank, then ms/step replayed;
(c) NPT over the halo energy (isotropic MC barostat at 1 bar, one attempt
    every 10 steps, four intervals): finite, boxes alike on every rank,
    the accept fraction;
(d) ``shard.make_sharded_energy_fn`` on bench.py's 100k box at its 11^3
    grid, where no halo decomposition fits, against the single-card route
    on classical Ewald (the sharded route's reciprocal);
(e) ``make_replica_sharded_energy_fn`` with bench.py's 64 x 216 ensemble
    (R / world replicas a card) and ``make_multislice_energy_fn`` on a
    (slices, space) mesh with ``ensemble_mean``, against the single-card
    batch (``replica_energy_and_forces`` on "xla").

Each route prints one line on rank 0: for (a) the device ms per
evaluation (CUDA graphs of calls replayed in step on every rank) and the
NCCL kernels' ms in a traced replay (waits for the other ranks
included), for (b) and (c) ms per replayed step, for (d) and (e) eager ms
(their routes read host tables or loop in Python), each beside the
single-card route in the same call; ``shard.COLLECTIVES`` of one
evaluation, and the agreement.  The last line is one JSON object of them
all (rank 0 hands it to the parent through a temporary file).
``--device cpu`` runs the same routes on gloo ranks at small sizes (a
rehearsal, no timing claims).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

import torch

from .measure import (HALO_TOL_F32, eager_ms, energy_forces, energy_scale,
                      rel_errors)

DEADLINE_S = 1200    # the whole spawned group
PG_TIMEOUT_S = 600   # one collective
TEARDOWN_S = 60      # the group's teardown, after every route is done
NVE_CHECK_STEPS = 20
NVE_STEPS = 100
NPT_INTERVAL = 10
NPT_INTERVALS = 4
NPT_WINDOWS = 5      # timed runs of (c)
EVALS = 3            # timed evaluations after a warm one


@dataclasses.dataclass
class Ctx:
    rank: int
    world: int
    dev: torch.device
    small: bool
    #: the subgroups the routes made, in the order they were made
    groups: list = dataclasses.field(default_factory=list)

    @property
    def cuda(self) -> bool:
        return self.dev.type == "cuda"

    def say(self, msg: str):
        if self.rank == 0:
            print(f"multigpu {msg}", flush=True)


def _ms(ctx, fn, reps: int = EVALS, together: bool = True) -> float:
    """``measure.eager_ms`` of ``fn``: with ``together`` every rank in
    step (a barrier before the timed calls), else this rank alone (rank
    0's single-card runs)."""
    import torch.distributed as dist

    return eager_ms(fn, reps, dist.barrier if together else None, ctx.cuda)


def _device_ms(ctx, fn, together: bool = True):
    """(ms per call of ``fn`` on the device, NCCL kernels' ms per call) on
    the card: ``measure.replayed_ms`` of a graph of GRAPH_REPS calls, with
    ``together`` every rank replaying in step (a barrier before each
    replay), so the time includes waiting for the slowest rank.  The NCCL
    share is the union of the NCCL kernels' intervals in a
    ``torch.profiler`` trace of one more replay (None where the trace
    shows no device time).  On the CPU: (:func:`_ms`, None)."""
    import torch.distributed as dist

    if not ctx.cuda:
        return _ms(ctx, fn, together=together), None
    from torch.profiler import ProfilerActivity, profile

    from .measure import (GRAPH_REPS, call_graph, device_events,
                          replayed_ms, union_length)

    graph = call_graph(fn)
    (ms,) = replayed_ms([graph], dist.barrier if together else None)
    if together:
        dist.barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize(ctx.dev)
    events = device_events(prof.events())
    nccl = None
    if events:
        nccl = union_length([(e.time_range.start, e.time_range.end)
                             for e in events if "nccl" in e.name.lower()]
                            ) / 1e3 / GRAPH_REPS
    return ms, nccl


def _ranks_apart(ctx, *tensors) -> float:
    """Largest |difference| of these tensors from rank 0's, over every rank
    (NaN counts as apart)."""
    import torch.distributed as dist

    worst = torch.zeros((), dtype=torch.float64, device=ctx.dev)
    for t in tensors:
        t = t.detach().reshape(-1)
        ref = t.clone()
        dist.broadcast(ref, 0)
        d = (t.double() - ref.double()).abs()
        d = torch.where(torch.isnan(d) & ~(torch.isnan(t) & torch.isnan(ref)),
                        torch.inf, torch.nan_to_num(d, nan=0.0))
        worst = torch.maximum(worst, d.max())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst)


def _systems(ctx):
    """((halo system, positions, masses, water bonds), (sharded box's
    system, positions)): bench.py's 30k and 100k at real size on the card;
    small boxes of the same kinds on the CPU."""
    from ..cells import suggest_capacity
    from ..models import water_bonded_params, water_box
    from .measure import bench_path, build_system

    if not ctx.small:
        force, x, m, box, bonded, _s = bench_path("30k", ctx.dev)
        pos = x.cpu().numpy()
    else:
        force, pos, masses, box = water_box(n_side=8, flux="bond_angle",
                                            cutoff=0.29, seed=44)
        x = torch.tensor(pos, dtype=torch.float32, device=ctx.dev)
        m = torch.tensor(masses, dtype=torch.float32, device=ctx.dev)
        bonded = water_bonded_params(len(masses) // 3, box=box,
                                     device=ctx.dev)
    # room for the dynamics of (b) and (c) from the lattice (chip_smoke's
    # burn-in twin margin; the small box's cells hold a few atoms)
    cap = suggest_capacity(pos, box, (8, 8, 8),
                           margin=2.0 if ctx.small else 1.35)
    system = build_system(force, box, cap, ctx.dev)
    if not ctx.small:
        force, x100, _m, box, _bd, _s = bench_path("100k", ctx.dev)
        s100 = force.create_system(box=box, dtype=torch.float32,
                                   direct_method="cell", recip_method="xla",
                                   cell_grid=_s.spec.cell_grid,
                                   cell_capacity=_s.spec.cell_capacity,
                                   device=ctx.dev)
        return (system, x, m, bonded), (s100, x100)
    # a 3^3 grid: no decomposition of 4 ranks fits it
    force, pos, _m, box = water_box(n_side=9, flux="bond_angle", cutoff=0.8)
    s3 = force.create_system(box=box, dtype=torch.float32,
                             direct_method="cell", recip_method="xla",
                             device=ctx.dev)
    return (system, x, m, bonded), (s3, torch.tensor(
        pos, dtype=torch.float32, device=ctx.dev))


def _fmt(v):
    return "not measured" if v is None else f"{v:.3f}"


def _halo_system(system, rt, decomp):
    from ..pme import pme_halo_mesh

    return system._swap(spec=dataclasses.replace(
        system.spec, recip_method=rt,
        pme_grid=pme_halo_mesh(system.spec, pad_y=decomp[1] > 1)))


def _all_true(ctx, flag: bool) -> bool:
    import torch.distributed as dist

    t = torch.tensor(float(flag), device=ctx.dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t)


def halo_decomps(world: int, grid):
    """The decompositions route (a) runs: (world, 1) slabs and
    (world / 2, 2) bricks, where the grid divides."""
    out = []
    for d in ((world, 1), (world // 2, 2)):
        if (d[0] >= 1 and d[0] * d[1] == world and grid[0] % d[0] == 0
                and grid[1] % d[1] == 0 and d not in out):
            out.append(d)
    return out


def route_halo(ctx, system, x):
    """(a): the halo route against the single-card route, then the
    overflow poison."""
    import torch.distributed as dist

    from ..energy import energy_and_forces
    from ..parallel import shard
    from ..parallel.halo import make_halo_energy_fn

    decomps = halo_decomps(ctx.world, system.spec.cell_grid)
    scale = energy_scale(x, system)
    rows, single = {}, {}
    for rt in ("pme", "xla"):
        for decomp in decomps:
            sysr = _halo_system(system, rt, decomp)
            if ctx.rank == 0:
                e_ref, f_ref = energy_and_forces(x, sysr)
                single[f"{decomp[1]}_{rt}"] = _device_ms(
                    ctx, lambda: energy_and_forces(x, sysr),
                    together=False)[0]
            dist.barrier()
            e_fn = make_halo_energy_fn(sysr, None, decomp=decomp)
            shard.reset_collectives()
            e, f = energy_forces(e_fn, x)
            coll = dict(shard.COLLECTIVES)
            apart = _ranks_apart(ctx, e, f)
            ms, ex = _device_ms(ctx, lambda: energy_forces(e_fn, x))
            eager = _ms(ctx, lambda: energy_forces(e_fn, x))
            row = {"ms_per_eval": ms, "exchange_ms": ex, "eager_ms": eager,
                   "collectives": coll, "ranks_apart": apart}
            if ctx.rank == 0:
                d_e, d_f = rel_errors(e, f, e_ref, f_ref, scale)
                ms1 = single[f"{decomp[1]}_{rt}"]
                row.update(d_e=d_e, d_f=d_f, single_ms=ms1,
                           ok=max(d_e, d_f) <= HALO_TOL_F32
                           and apart == 0.0)
                where = ("on the device (graphs in step on every rank"
                         if ctx.cuda else "on the host clock (the CPU")
                ctx.say(f"(a) halo {decomp} {rt!r}: energy and forces "
                        f"{_fmt(ms)} ms per evaluation {where}; the single "
                        f"card's route {_fmt(ms1)}), NCCL kernels "
                        f"{_fmt(ex)} ms of it "
                        f"(waits included); eager {eager:.3f}; "
                        f"|dE|/sum|E_c| {d_e:.3e}, force RMS {d_f:.3e} "
                        f"(limit {HALO_TOL_F32}); ranks apart {apart:.3e}; "
                        f"collectives {coll}")
            rows[f"{decomp[0]}x{decomp[1]}_{rt}"] = row
    cap = system.spec.cell_capacity // 8
    tiny = system._swap(spec=dataclasses.replace(system.spec,
                                                 cell_capacity=cap))
    e, f = energy_forces(make_halo_energy_fn(tiny, None, decomp=decomps[0]), x)
    poisoned = _all_true(ctx, bool(torch.isnan(e)) and bool(
        torch.isnan(f).all()))
    ctx.say(f"(a) overflow (capacity {cap}) on {decomps[0]}: every rank's "
            f"energy and forces NaN: {poisoned}")
    return {"rows": rows, "overflow_poisons": poisoned,
            "ok": poisoned and all(r.get("ok", True) for r in rows.values())}


def route_nve(ctx, system, x, masses, bonded):
    """(b): NVE over the halo energy plus the water bonds (replicated, added
    on every rank) on each decomposition: chunk graphs against
    graph=False, then ms/step replayed; beside them, on rank 0 alone, the
    same driver over the halo energy on a group of one and over the
    single-card route (each step bins anew on all three)."""
    import torch.distributed as dist

    from ..bonded import bonded_energy
    from ..energy import energy
    from ..integrate import init_state, maxwell_velocities, nve_trajectory
    from ..parallel.halo import make_halo_energy_fn
    from .measure import DT_PS

    gen = torch.Generator(ctx.dev).manual_seed(3)
    v = maxwell_velocities(masses, 300.0, gen, dtype=torch.float32)
    # the CPU rehearsal: a chunk and a remainder, then one timed chunk
    n_check, n_steps = ((12, 10) if ctx.small
                        else (NVE_CHECK_STEPS, NVE_STEPS))

    def with_bonds(e_elec):
        def e_fn(xx):
            return e_elec(xx) + bonded_energy(xx, bonded)
        return e_fn

    def timed(e_fn, together=True):
        s0 = init_state(x, v, e_fn)
        runs = [nve_trajectory(s0, e_fn, masses, DT_PS, n_check, graph=g)
                for g in (False, True, True)]
        same = all(torch.equal(u, w) for r in runs[1:] for u, w in (
            (runs[0][1], r[1]), (runs[0][0].positions, r[0].positions),
            (runs[0][0].velocities, r[0].velocities)))
        ms = _ms(ctx, lambda: nve_trajectory(s0, e_fn, masses, DT_PS,
                                             n_steps),
                 reps=1, together=together) / n_steps
        _fin, es = nve_trajectory(s0, e_fn, masses, DT_PS, n_steps)
        return same, ms, es, runs[1][0].positions

    one = dist.new_group([0])
    ctx.groups.append(one)
    base = {}
    if ctx.rank == 0:
        sys1 = _halo_system(system, "pme", (1, 1))
        for name, e_elec in (
                ("single", lambda xx: energy(xx, sys1)),
                ("halo_1", make_halo_energy_fn(sys1, one))):
            same, ms, es, _x = timed(with_bonds(e_elec), together=False)
            base[name] = {"ms_per_step": ms, "bit_equal": same,
                          "finite": bool(torch.isfinite(es).all())}
        ctx.say(f"(b) one card, same call, same driver: the single-card "
                f"route {base['single']['ms_per_step']:.4f} ms/step, the "
                f"halo route on a group of one "
                f"{base['halo_1']['ms_per_step']:.4f} ms/step ({n_steps} "
                f"steps replayed; bit-equal to graph=False "
                f"{base['single']['bit_equal']}, "
                f"{base['halo_1']['bit_equal']})")
    dist.barrier()
    rows, ok = {}, all(r["bit_equal"] and r["finite"]
                       for r in base.values())
    for decomp in halo_decomps(ctx.world, system.spec.cell_grid):
        e_fn = with_bonds(make_halo_energy_fn(
            _halo_system(system, "pme", decomp), None, decomp=decomp))
        same, ms, es, xf = timed(e_fn)
        same = _all_true(ctx, same)
        finite = _all_true(ctx, bool(torch.isfinite(es).all()))
        apart = _ranks_apart(ctx, xf)
        ctx.say(f"(b) NVE over the halo energy on {decomp} ('pme'): chunks "
                f"of 10 steps (on the card CUDA graphs, the NCCL exchanges "
                f"and all-reduces captured); {n_check} steps "
                f"bit-equal to graph=False on every rank: {same}; ranks "
                f"apart {apart:.3e}; {n_steps} steps replayed: {ms:.4f} "
                f"ms/step, total energy {float(es[0]):.2f} -> "
                f"{float(es[-1]):.2f} kJ/mol, finite: {finite}")
        rows[f"{decomp[0]}x{decomp[1]}"] = {
            "ms_per_step": ms, "bit_equal": same, "ranks_apart": apart}
        ok = ok and same and finite and apart == 0.0
    return {"rows": rows, "one_card": base, "ok": ok}


def route_npt(ctx, system, x, masses, bonded):
    """(c): NPT over the halo energy."""
    from ..integrate import maxwell_velocities
    from ..npt import npt_langevin_trajectory
    from ..parallel.halo import make_halo_energy_fn
    from .measure import DT_PS, FRICTION, PRESSURE_BAR, TEMP

    decomp = halo_decomps(ctx.world, system.spec.cell_grid)[0]
    sysr = _halo_system(system, "pme", decomp)
    e_fn = make_halo_energy_fn(sysr, None, decomp=decomp)
    gen = torch.Generator(ctx.dev).manual_seed(11)
    v = maxwell_velocities(masses, TEMP, gen, dtype=torch.float32)
    n = NPT_INTERVAL * NPT_INTERVALS

    def run():
        gen.manual_seed(12)
        return npt_langevin_trajectory(
            x, v, sysr, masses, DT_PS, TEMP, FRICTION, PRESSURE_BAR, gen, n,
            bonded=bonded, barostat_interval=NPT_INTERVAL, energy_fn=e_fn)

    # the same replayed trajectory timed in NPT_WINDOWS windows: single
    # windows on four H100s have read up to twice apart
    windows = [_ms(ctx, run, reps=1) / n for _ in range(NPT_WINDOWS)]
    ms = statistics.median(windows)
    xf, _vf, box, diag = run()
    acc = diag["accepts"].float()
    finite = _all_true(ctx, bool(torch.isfinite(diag["energies"]).all()
                                 and torch.isfinite(xf).all()))
    apart = _ranks_apart(ctx, box, xf)
    ctx.say(f"(c) NPT over the halo energy on {decomp}: {n} steps, a "
            f"barostat attempt every {NPT_INTERVAL}, replayed: {ms:.4f} "
            f"ms/step, the median of {NPT_WINDOWS} windows "
            f"{[round(w, 4) for w in windows]}; accept fraction "
            f"{float(acc.mean()):.3f} of {acc.numel()}; poisoned "
            f"{int(diag['poisoned'].sum())}; finite {finite}; boxes and "
            f"positions apart across ranks {apart:.3e}")
    return {"decomp": list(decomp), "ms_per_step": ms,
            "ms_per_step_windows": windows,
            "accept_fraction": float(acc.mean()), "ranks_apart": apart,
            "ok": finite and apart == 0.0}


def route_shard(ctx, system, x):
    """(d): work sharding where no halo decomposition fits."""
    import torch.distributed as dist

    from ..energy import energy_and_forces
    from ..parallel import shard
    from ..parallel.halo import halo_decomp

    if ctx.rank == 0:
        e_ref, f_ref = energy_and_forces(x, system)
        ms1 = _ms(ctx, lambda: energy_and_forces(x, system), together=False)
    dist.barrier()
    fits = halo_decomp(system, ctx.world) is not None
    if fits:
        # a world of one: the halo route fits; call the work sharding
        e_fn = shard._local_energy_builder(system, None, ctx.rank, ctx.world)
    else:
        e_fn = shard.make_sharded_energy_fn(system, None)
    shard.reset_collectives()
    e, f = energy_forces(e_fn, x)
    coll = dict(shard.COLLECTIVES)
    apart = _ranks_apart(ctx, e, f)
    ms = _ms(ctx, lambda: energy_forces(e_fn, x))
    row = {"ms_per_eval_eager": ms, "collectives": coll,
           "ranks_apart": apart, "grid": list(system.spec.cell_grid)}
    if ctx.rank == 0:
        d_e, d_f = rel_errors(e, f, e_ref, f_ref, energy_scale(x, system))
        row.update(d_e=d_e, d_f=d_f, single_ms=ms1,
                   ok=max(d_e, d_f) <= HALO_TOL_F32 and apart == 0.0)
        how = ("a halo decomposition fits; the work sharding called "
               "directly" if fits else "no halo decomposition fits")
        ctx.say(f"(d) sharded {system.n_atoms} atoms, cells "
                f"{system.spec.cell_grid} on {ctx.world} ranks ({how}), "
                f"classical Ewald kmax {system.spec.kmax}: "
                f"{ms:.3f} ms per evaluation, eager (the single card's "
                f"route {ms1:.3f}; the sharded walk reads host tables, so "
                f"no graph); |dE|/sum|E_c| "
                f"{d_e:.3e}, force RMS {d_f:.3e} (limit {HALO_TOL_F32}); "
                f"ranks apart {apart:.3e}; collectives {coll}")
    return row


def route_replicas(ctx):
    """(e): the replica x space engine and the multislice route against
    the single-card batch (bench.py's 64 replicas on the card, 8 on the
    CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..parallel import (ensemble_mean, make_multislice_energy_fn,
                            make_replica_sharded_energy_fn,
                            replica_energy_and_forces, shard, shard_batch,
                            shard_replicas)
    from ..parallel.replicas import _forces
    from .measure import REPLICAS, replicas_path

    path = replicas_path(ctx.dev, 8 if ctx.small else REPLICAS, recip="xla")
    system, xb = path["system"], path["x"]
    if ctx.rank == 0:
        e_ref, f_ref = replica_energy_and_forces(xb, system)
        ms1 = _ms(ctx, lambda: replica_energy_and_forces(xb, system),
                  together=False)
        scale = energy_scale(xb[0], system)
    out = {}
    kind = "cuda" if ctx.cuda else "cpu"
    w = ctx.world
    meshes = {"replica": ((w, 1), ("replica", "space")),
              "multislice": ((max(w // 2, 1), w // max(w // 2, 1)),
                             ("slice", "space"))}
    for name, (shape, names) in meshes.items():
        mesh = init_device_mesh(kind, shape, mesh_dim_names=names)
        ctx.groups.extend(g for g in mesh.get_all_groups()
                          if g.group_name != dist.group.WORLD.group_name)
        if name == "replica":
            local = shard_replicas(xb, mesh)
            e_fn = make_replica_sharded_energy_fn(system, mesh)
        else:
            local = shard_batch(xb, mesh)
            e_fn = make_multislice_energy_fn(system, mesh)
        shard.reset_collectives()
        e, f = _forces(e_fn, local)
        coll = dict(shard.COLLECTIVES)
        mean = ensemble_mean(e, mesh, names[0])
        ms = _ms(ctx, lambda: _forces(e_fn, local))
        row = {"mesh": list(shape), "ms_per_eval": ms, "collectives": coll}
        if ctx.rank == 0:
            r_loc = local.shape[0]
            d_e = float((e.double() - e_ref[:r_loc].double()).abs().max()
                        ) / scale
            d_f = max(rel_errors(e[k], f[k], e_ref[k], f_ref[k], scale)[1]
                      for k in range(r_loc))
            d_mean = abs(float(mean) - float(e_ref.double().mean())) / scale
            row.update(d_e=d_e, d_f=d_f, d_mean=d_mean, single_ms=ms1,
                       ok=max(d_e, d_f, d_mean) <= HALO_TOL_F32)
            ctx.say(f"(e) {name} mesh {shape} {names}: {r_loc} of "
                    f"{xb.shape[0]} replicas of {xb.shape[1]} atoms on rank "
                    f"0, {ms:.3f} ms per evaluation of its block, eager (the "
                    f"single card's batch of {xb.shape[0]}: {ms1:.3f}); "
                    f"largest |dE|/sum|E_c| {d_e:.3e}, force RMS {d_f:.3e}, "
                    f"ensemble_mean {d_mean:.3e} (limit {HALO_TOL_F32}); "
                    f"collectives {coll}")
        out[name] = row
    return out


def _rank(rank, world, port, small, out_file):
    """One process of the group: every route, then the teardown; rank 0
    prints and writes the results."""
    import torch.distributed as dist

    torch.set_num_threads(2 if small else 4)
    if small:
        dev = torch.device("cpu")
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, device_id=dev,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    ctx = Ctx(rank, world, dev, small)
    failed = None
    try:
        _routes(ctx, out_file)
    except Exception:
        # kept as text: the traceback would keep the routes' frames, and
        # with them their graphs, alive through the teardown
        failed = traceback.format_exc()
    _teardown(ctx, Path(out_file).with_name(f"teardown_rank{rank}.txt"))
    if failed is not None:
        raise RuntimeError(f"rank {rank}: a route failed:\n{failed}")


def _routes(ctx, out_file):
    """Every route on this rank; rank 0 writes the results to
    ``out_file``.  Whatever the routes built (systems, energy functions and
    the chunk graphs kept on them) is unreachable once this returns."""
    t0 = time.perf_counter()
    (system, x, m, bonded), (s100, x100) = _systems(ctx)
    ctx.say(f"{ctx.world} ranks on {ctx.dev.type}; halo box "
            f"{system.n_atoms} atoms, cells {system.spec.cell_grid} capacity "
            f"{system.spec.cell_capacity}; sharded box {s100.n_atoms} "
            f"atoms, cells {s100.spec.cell_grid}")
    res = {"world": ctx.world, "device": ctx.dev.type}
    res["halo"] = route_halo(ctx, system, x)
    res["nve"] = route_nve(ctx, system, x, m, bonded)
    res["npt"] = route_npt(ctx, system, x, m, bonded)
    res["shard"] = route_shard(ctx, s100, x100)
    res["replicas"] = route_replicas(ctx)
    res["seconds"] = time.perf_counter() - t0
    if ctx.rank == 0:
        res["ok"] = (res["halo"]["ok"] and res["nve"]["ok"]
                     and res["npt"]["ok"] and res["shard"]["ok"]
                     and all(r["ok"] for r in res["replicas"].values()))
        Path(out_file).write_text(json.dumps(res))


def _teardown(ctx, dump_file):
    """Tear the group down, given TEARDOWN_S.  In order: collect the
    routes' garbage (a chunk on its energy function is a reference cycle,
    so the chunk graphs, with NCCL sends, receives and all-reduces
    captured in them, live until the cyclic GC runs), synchronize the
    card, a barrier, destroy the subgroups the routes made (newest first,
    on every rank alike), then the default group.  Past the limit
    ``faulthandler`` writes every thread's stack to ``dump_file`` and the
    process exits with code 1, which fails the command (:func:`run` prints
    the dump)."""
    import faulthandler
    import gc

    import torch.distributed as dist

    gc.collect()
    if ctx.cuda:
        torch.cuda.synchronize(ctx.dev)
    with open(dump_file, "w") as dump:
        faulthandler.dump_traceback_later(TEARDOWN_S, exit=True, file=dump)
        if ctx.cuda:
            dist.barrier(device_ids=[ctx.rank])
        else:
            dist.barrier()
        for group in reversed(ctx.groups):
            dist.destroy_process_group(group)
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()
    Path(dump_file).unlink()


def run(small: bool = False) -> dict:
    """Spawn the group (one rank per visible card, or four gloo ranks on
    the CPU with ``small``), join it against DEADLINE_S, print the JSON
    line; raises unless every route agreed."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    if small:
        world = 4
    else:
        if not torch.cuda.is_available():
            raise SystemExit("measure multigpu: needs CUDA cards (or "
                             "--device cpu for the small gloo rehearsal)")
        world = torch.cuda.device_count()
        from ..ops import native

        native.build()          # once, before the ranks load it
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out_file = str(Path(tmp) / "multigpu.json")
        ctx = mp.spawn(_rank, args=(world, port, small, out_file),
                       nprocs=world, join=False)
        deadline = time.monotonic() + DEADLINE_S
        try:
            while not ctx.join(
                    timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise SystemExit(f"measure multigpu: {world} ranks did "
                                     f"not finish in {DEADLINE_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            for dump in sorted(Path(tmp).glob("teardown_rank*.txt")):
                print(f"measure multigpu: {dump.stem}: the teardown did not "
                      f"return in {TEARDOWN_S} s; every thread's stack:\n"
                      f"{dump.read_text()}", file=sys.stderr, flush=True)
        res = json.loads(Path(out_file).read_text())
    print(json.dumps(res), flush=True)
    if not res["ok"]:
        raise SystemExit("measure multigpu: a route disagreed")
    return res
