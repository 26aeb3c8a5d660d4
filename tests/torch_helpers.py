"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py):
systems built by both packages from one builder, converted through NumPy.
JAX is imported only inside the helpers that build a JAX system, so that
tests/test_torch_kernels_cuda.py, which runs where JAX is not installed,
can use the others."""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import numpy as np
import torch

from chargeflux_tpu_torch.cells import CellBlocks
from chargeflux_tpu_torch.system import ARRAY_FIELDS, system_from_arrays

# The kernels' compile-time limits, as ``ops.native.limits`` reads them
# from the built library: kMaxWy, kMaxOrder, kMaxWx (pme_spread.cu);
# kMaxCoef, kMaxCap (direct_walk.cu); kMaxKy, kMaxKz2 and the forward's
# plan inputs (``ops.structure_factor.ForwardLimits``: atom chunk, most
# threads per block, most splits, most ky rows per block, micro-tile rows
# and columns, most threads per micro-tile; structure_factor.cu); kMaxCells,
# kChunk (cell_bin.cu); kSlots, kStages (stage_stamp.cu); kThreads
# (exclusion_pairs.cu).  Building
# needs nvcc, so tests that ask for them without a card use these values;
# a test on the card holds this table to the built library.
KERNEL_LIMITS = {"cf_spread_limits": (32, 16, 36),
                 "cf_walk_limits": (16, 1024),
                 "cf_sf_limits": (64, 128, 128, 256, 8, 32, 2, 4, 16),
                 "cf_cell_bin_limits": (49152, 1024),
                 "cf_bspline_limits": (4, 8),
                 "cf_exclusion_limits": (256,),
                 "cf_stamp_limits": (36, 9)}


def fake_kernel_limits(monkeypatch):
    """Make ``native.limits`` return :data:`KERNEL_LIMITS` (no build)."""
    from chargeflux_tpu_torch.ops import native

    monkeypatch.setattr(native, "limits",
                        lambda name, count=2: KERNEL_LIMITS[name][:count])


def jax_dtype(dtype):
    """The JAX float type of a torch float type."""
    import jax.numpy as jnp

    return {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]


def port_system(jsys, dtype=torch.float64):
    """The port's system with the JAX system's leaves and spec."""
    arrays = {name: np.asarray(getattr(jsys, name)) for name in ARRAY_FIELDS}
    spec = {f.name: getattr(jsys.spec, f.name)
            for f in dataclasses.fields(jsys.spec)}
    return system_from_arrays(arrays, spec, dtype=dtype, device="cpu")


def jax_water(n_side, cutoff, dtype=torch.float64, pbc=True, **kw):
    """(jax_system, port_system, positions float64 [N, 3], masses) from the
    JAX builder's water box; ``kw`` goes to ``create_system``."""
    from chargeflux_tpu.models import water_box as jax_water_box

    force, pos, masses, box = jax_water_box(n_side=n_side, flux="bond_angle",
                                            cutoff=cutoff)
    if not pbc:
        force.setUsesPeriodicBoundaryConditions(False)
        box = None
    with warnings.catch_warnings():   # small boxes: cutoff > half the box
        warnings.simplefilter("ignore")
        jsys = force.create_system(box=box, dtype=jax_dtype(dtype), **kw)
    return jsys, port_system(jsys, dtype), pos, masses


def water_systems(dtype=torch.float64, n_side=7, cutoff=0.65, **kw):
    """:func:`jax_water` on the cell + PME route."""
    return jax_water(n_side, cutoff, dtype, direct_method="cell",
                     recip_method="pme", **kw)


def port_blocks(jblocks, dtype):
    return CellBlocks(*(torch.as_tensor(np.array(getattr(jblocks, f)))
                        .to(dtype) for f in CellBlocks._fields))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


def untemplated(system):
    """The same port system with no flux or exclusion template: every term
    row takes the remainder path."""
    arrays = {f: getattr(system, f).cpu().numpy() for f in ARRAY_FIELDS}
    spec = {f.name: getattr(system.spec, f.name)
            for f in dataclasses.fields(system.spec)}
    spec.update(flux_template=None, excl_template=None)
    return system_from_arrays(arrays, spec, device=system.q0.device,
                              dtype=system.q0.dtype)


def lattice_blocks(grid, cap, counts, edge, seed, dtype=torch.float64,
                   device="cpu", scattered=False, drift=0.0,
                   shift=(0.0, 0.0, 0.0), per_side=None):
    """Cell blocks made by hand, for the walk's tests: (x, y, z, q, hs,
    se, ids, box, n_atoms), the blocks [gx, gy, gz, cap], ids int32 with
    sentinel n_atoms, box [3] = grid * edge.  Cell c holds ``counts[c %
    len(counts)]`` atoms on a jittered ``per_side``^3 lattice inside its
    nominal bounds (so no two atoms come closer than 0.4 of the lattice
    step); then all atoms are moved by ``shift`` and each by up to
    ``drift`` per axis more, which takes atoms out of those bounds while
    they stay in their cell's block, as positions do between two neighbor
    rebuilds.  Charges are positive, so the energy's terms do not cancel.
    The atoms fill the first slots of their cell, or with ``scattered`` a
    random subset of the slots; every other slot is a sentinel holding
    zeros."""
    rng = np.random.default_rng(seed)
    gx, gy, gz = grid
    n_cells = gx * gy * gz
    counts = [counts[c % len(counts)] for c in range(n_cells)]
    if per_side is None:
        per_side = int(np.ceil(max(counts) ** (1.0 / 3.0) - 1e-9))
    assert max(counts) <= min(cap, per_side ** 3)
    step = edge / per_side
    sites = np.stack(np.meshgrid(*[np.arange(per_side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    cols = np.zeros((6, n_cells, cap))
    n_atoms = sum(counts)
    ids = np.full((n_cells, cap), n_atoms, np.int32)
    first = 0
    for c, n in enumerate(counts):
        origin = np.array([c // (gy * gz), (c // gz) % gy, c % gz]) * edge
        pick = rng.permutation(len(sites))[:n]
        pos = origin + (sites[pick] + 0.5
                        + rng.uniform(-0.3, 0.3, (n, 3))) * step
        pos += np.asarray(shift) + rng.uniform(-drift, drift, (n, 3))
        slots = (np.sort(rng.permutation(cap)[:n]) if scattered
                 else np.arange(n))
        cols[:3, c, slots] = pos.T
        cols[3, c, slots] = rng.uniform(0.2, 0.8, n)
        cols[4, c, slots] = rng.uniform(0.2, 0.3, n) * step
        cols[5, c, slots] = rng.uniform(0.5, 1.5, n)
        ids[c, slots] = first + np.arange(n)
        first += n
    shape = (gx, gy, gz, cap)
    blocks = [torch.tensor(a.reshape(shape), dtype=dtype, device=device)
              for a in cols]
    box = torch.tensor([gx * edge, gy * edge, gz * edge], dtype=dtype,
                       device=device)
    return (*blocks, torch.tensor(ids.reshape(shape), device=device), box,
            n_atoms)


def maxwell_start(pos, masses, seed=11, temp=300.0):
    """(positions, Maxwell velocities at ``temp`` K from a NumPy seed): both
    packages get the same numbers."""
    rng = np.random.default_rng(seed)
    sig = np.sqrt(0.008314462618 * temp / np.asarray(masses))[:, None]
    return pos, rng.standard_normal(pos.shape) * sig


def jax_chunk_normals(key, n_chunks, rebuild_every, shape, n_inner=1):
    """The normals a chunked JAX driver draws, in draw order: per chunk
    ``k, sub = split(k)`` and one key of ``split(sub, rebuild_every)`` per
    step; a RESPA outer step splits its key once more into ``n_inner``
    (and uses it whole when ``n_inner`` is 1)."""
    import jax
    import jax.numpy as jnp

    out = []
    k = key
    for _ in range(n_chunks):
        k, sub = jax.random.split(k)
        for kk in jax.random.split(sub, rebuild_every):
            keys = [kk] if n_inner == 1 else jax.random.split(kk, n_inner)
            out.extend(np.asarray(jax.random.normal(ki, shape, jnp.float64))
                       for ki in keys)
    return out


def jax_normals(keys, shape):
    """``jax.random.normal`` of each key, in f64."""
    import jax
    import jax.numpy as jnp

    return [np.asarray(jax.random.normal(k, shape, jnp.float64))
            for k in keys]


def inject_noise(monkeypatch, normals):
    """Make the port's ``integrate.normal_noise`` hand out ``normals`` in
    order (the JAX package's, so both draw the same noise)."""
    from chargeflux_tpu_torch import integrate

    it = iter(normals)

    def given(like, generator):
        return torch.tensor(next(it)).to(like.dtype)

    monkeypatch.setattr(integrate, "normal_noise", given)
    return it


_PATCHED = ("tensor", "as_tensor", "bincount")
_PATCHED_METHODS = ("item", "tolist", "__bool__", "__float__", "__int__")


def forbid_host_traffic(monkeypatch):
    """Make ``torch.tensor``, ``torch.as_tensor``, ``torch.bincount`` and the
    Tensor methods that read a value on the host raise: the CPU stand-in
    for a CUDA graph capture, which refuses host copies and reads."""
    for name in _PATCHED:
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"torch.{_name} inside a chunk")
        monkeypatch.setattr(torch, name, refuse)
    for name in _PATCHED_METHODS:
        def refuse_m(self, *a, _name=name, **k):
            raise AssertionError(f"Tensor.{_name} inside a chunk")
        monkeypatch.setattr(torch.Tensor, name, refuse_m)


# ---------------------------------------------------------------------------
# torch.distributed groups on the CPU (gloo) for the multi-rank tests
# ---------------------------------------------------------------------------

#: Seconds a spawned group may take before its test fails (each process
#: group's own collectives time out after :data:`PG_TIMEOUT_S`).
SPAWN_DEADLINE_S = 240
PG_TIMEOUT_S = 60


@contextlib.contextmanager
def gloo_group():
    """A one-rank gloo group in this process (file store in a temporary
    directory), destroyed on exit; yields the default group."""
    import datetime
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "gloo", init_method=f"file://{d}/store", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def _spawned(rank, world, store, fn, args, out_dir):
    """Body of one spawned rank: a gloo group over ``store``, one thread,
    then ``fn(rank, world, *args)``, whose result is pickled to
    ``out_dir/rank.pkl``."""
    import datetime
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def run_ranks(world: int, fn, args, tmp_path):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks started with
    ``torch.multiprocessing.spawn``; returns their results by rank.  The
    ranks are joined against :data:`SPAWN_DEADLINE_S`: past it they are
    killed and the test fails, so a hung group cannot hang the suite.
    ``fn`` must be importable at module level; the children import no
    JAX."""
    import pickle
    import time

    import torch.multiprocessing as mp

    store = tmp_path / "store"
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.spawn(_spawned, args=(world, str(store), fn, args, str(out)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{world} ranks did not finish in "
                                     f"{SPAWN_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for rank in range(world):
        with open(out / f"{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _energy_forces(e_fn, x, *args):
    xg = x.detach().clone().requires_grad_(True)
    e = e_fn(xg, *args)
    (g,) = torch.autograd.grad(e.sum(), xg)
    return e.detach().numpy(), (-g).numpy()


def dist_worker(rank, world, task, system, x, opts):
    """One rank of the multi-rank tests (run by :func:`run_ranks`): the
    port's ``parallel`` routes on the default gloo group (or a 2-D
    ``DeviceMesh``), returning NumPy results.  Tasks: "halo" (energy and
    forces, ``opts["decomp"]``), "sharded" (``make_sharded_energy_and_
    forces_fn``), "box" (moved boxes, the shrink poison, the creation-time
    refusal), "overflow", "poisons" (finite, then the shrink and the
    overflow poisons, energy and forces, on ``opts["decomp"]``), "nve" (``opts["steps"]`` NVE steps over the halo
    energy), "replica2d" and "multislice" (2 x 2 meshes over a replica
    batch)."""
    from chargeflux_tpu_torch.parallel import halo, multislice, shard

    shard.reset_collectives()
    out = {}
    if task == "halo":
        e_fn = halo.make_halo_energy_fn(system, None,
                                        decomp=opts.get("decomp"))
        out["e"], out["f"] = _energy_forces(e_fn, x)
    elif task == "sharded":
        e, f = shard.make_sharded_energy_and_forces_fn(system, None)(x)
        out["e"], out["f"] = e.numpy(), f.numpy()
    elif task == "box":
        e_fn = halo.make_halo_energy_fn(system, None)
        for s in opts["scales"]:
            out[s] = _energy_forces(e_fn, s * x, s * system.box)
        out["shrunk"] = float(e_fn(0.7 * x, 0.7 * system.box))
        try:
            halo.make_halo_energy_fn(system.with_box(0.7 * system.box), None)
            out["refused"] = ""
        except ValueError as exc:
            out["refused"] = str(exc)
    elif task == "overflow":
        out["e"] = float(halo.make_halo_energy_fn(
            system, None, decomp=opts.get("decomp"))(x))
    elif task == "poisons":
        decomp = opts["decomp"]
        e_fn = halo.make_halo_energy_fn(system, None, decomp=decomp)
        out["ok"] = _energy_forces(e_fn, x)
        out["shrunk"] = _energy_forces(e_fn, 0.7 * x, 0.7 * system.box)
        out["overflow"] = _energy_forces(
            halo.make_halo_energy_fn(opts["tiny"], None, decomp=decomp), x)
    elif task == "nve":
        from chargeflux_tpu_torch.integrate import init_state, nve_trajectory

        e_fn = halo.make_halo_energy_fn(system, None)
        masses = torch.full((x.shape[0],), 10.0, dtype=x.dtype)
        s0 = init_state(x, torch.zeros_like(x), e_fn)
        fin, es = nve_trajectory(s0, e_fn, masses, opts["dt"], opts["steps"])
        out["es"], out["x"] = es.numpy(), fin.positions.numpy()
    elif task == "npt":
        from chargeflux_tpu_torch.npt import npt_langevin_trajectory

        e_fn = halo.make_halo_energy_fn(system, None)
        xf, vf, box, diag = npt_langevin_trajectory(
            x, torch.zeros_like(x), system, opts["masses"],
            generator=torch.Generator().manual_seed(opts["seed"]),
            energy_fn=e_fn, **opts["kw"])
        out.update(x=xf.numpy(), box=box.numpy(),
                   energies=diag["energies"].numpy())
    elif task in ("replica2d", "multislice"):
        from torch.distributed.device_mesh import init_device_mesh

        if task == "replica2d":
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("replica", "space"))
            from chargeflux_tpu_torch.parallel import (
                make_replica_sharded_energy_fn, shard_replicas)
            local = shard_replicas(x, mesh)
            e_fn = make_replica_sharded_energy_fn(system, mesh)
        else:
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("slice", "space"))
            local = multislice.shard_batch(x, mesh)
            e_fn = multislice.make_multislice_energy_fn(system, mesh)
        out["e"], out["f"] = _energy_forces(e_fn, local)
        out["mean"] = float(multislice.ensemble_mean(
            torch.as_tensor(out["e"]), mesh,
            "replica" if task == "replica2d" else "slice"))
    out["collectives"] = dict(shard.COLLECTIVES)
    return out
