"""PyTorch port: the fused direct walk.  The plain version is held to the
JAX package's fused walk (cells._concat_fused_walk); an emulation of the
CUDA kernel's traversal (the 27 neighbor tiles of an i-cell staged without
their sentinel slots and without the atoms beyond the cutoff of the real i
atoms' bounding box, in rounds that fit a stage, each thread group's share
of the entries tested into per-atom lists that a warp evaluates whenever
one might overflow, self pair skipped, energy halved) is held to the plain
version, so the tables, the cull and the list bookkeeping the kernel relies
on are tested on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import cells as jcells
from chargeflux_tpu.charges import effective_charges as jax_charges
from chargeflux_tpu_torch import cells
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.neighbors import build_neighbor_state
from chargeflux_tpu_torch.ops.direct_walk import direct_walk_plain
from chargeflux_tpu_torch.units import ONE_4PI_EPS0

from torch_helpers import lattice_blocks, port_blocks, rel_err, water_systems

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_walk_and_autograd_match_jax_fused_walk(dtype):
    """(E, dE/dx, dE/dq) on the same blocks.  f64: 1e-10; f32: E rel
    <= 1e-5, gradients within 1e-4 of their max (sum-order roundoff)."""
    jsys, sys_t, pos, _ = water_systems(dtype)
    spec = jsys.spec
    x = jnp.asarray(pos, jsys.box.dtype)
    slots, inv, _ = jcells.build_cell_list_full(x, jsys.box, spec.cell_grid,
                                                spec.cell_capacity)
    jb = jcells.blockify(x, jax_charges(x, jsys), jsys, slots, inv)
    ids = slots.reshape(jb.x.shape)
    e_j, g_j, dq_j = jax.jit(
        lambda b: jcells._concat_fused_walk(b, ids, jsys))(jb)

    tb = port_blocks(jb, dtype)
    ids_t = torch.as_tensor(np.array(ids))
    e_t, g_t, dq_t = direct_walk_plain(*tb, ids_t, sys_t.box, sys_t.n_atoms,
                                       spec.alpha, spec.cutoff)
    tol_e, tol_g = (1e-10, 1e-10) if dtype == torch.float64 else (1e-5, 1e-4)
    assert abs(float(e_t) - float(e_j)) <= tol_e * abs(float(e_j))
    for k in range(3):
        assert rel_err(g_t[k], g_j[k]) <= tol_g
    assert rel_err(dq_t, dq_j) <= tol_g

    # the autograd function hands the fused gradients to x, y, z and q
    leaves = [getattr(tb, f).clone().requires_grad_(True)
              for f in ("x", "y", "z", "q")]
    e2 = cells.direct_energy_on_blocks(
        cells.CellBlocks(*leaves, tb.hs, tb.se), ids_t, sys_t)
    grads = torch.autograd.grad(3.0 * e2, leaves)
    assert float(e2.detach()) == float(e_t)
    for k in range(3):
        torch.testing.assert_close(grads[k], 3.0 * g_t[k], rtol=0, atol=0)
    torch.testing.assert_close(grads[3], 3.0 * dq_t, rtol=0, atol=0)


def _kernel_traversal(x, y, z, q, hs, se, ids, box, n_atoms, alpha, cutoff,
                      stage_tiles=2, list_cap=8, chunk=4):
    """The CUDA kernel's traversal (csrc/direct_walk.cu) in f64 with the
    exact erfc, at a small stage and list capacity so that several rounds
    and the list-full evaluation are taken.  Per i-cell: the real slots
    ranked in ascending slot order and their bounding box; each neighbor
    tile of full_shell_tables, image offset added, compacted in slot order
    to its real atoms within the cutoff of that box (the self tile keeps
    every real atom; a [3, 3] box adds the lattice rows); rounds of whole
    tiles that fit ``stage_tiles * cap``
    entries; a round's entries dealt out in chunks of ``chunk`` to the
    thread groups in turn (a block has four warps per 32 slots of
    capacity, 32 at most, and forms as many groups as the warps of its
    real atoms fit in); per group and warp of 32 i atoms, a chunk tested
    at a time into each atom's list, the warp evaluating all its lists first
    whenever one could overflow ``list_cap`` in the next chunk; the self
    pair is the self tile's entry at the atom's own rank.  The pair terms
    are summed on the i side in the order they were evaluated.  Returns
    (e, g, dq, flushes): the energy halved, and how many evaluations a
    possibly full list forced."""
    gx, gy, gz, cap = x.shape
    n_cells = gx * gy * gz
    nbr, img = cells.full_shell_tables((gx, gy, gz))
    pos = np.stack([a.reshape(n_cells, cap).numpy() for a in (x, y, z)], -1)
    idn = ids.reshape(n_cells, cap).numpy()
    boxn = box.numpy()
    cut2 = cutoff * cutoff
    stage = stage_tiles * cap
    n_warps = min(32, 4 * -(-cap // 32))
    pairs_i, pairs_j, pairs_s = [], [], []
    flushes = 0
    for c in range(n_cells):
        islot = np.flatnonzero(idn[c] < n_atoms)
        n_real = len(islot)
        if n_real == 0:
            continue
        lo, hi = pos[c, islot].min(0), pos[c, islot].max(0)
        groups = n_warps // -(-n_real // 32)
        tiles = []                       # per tile: (slots kept, positions)
        for s in range(27):
            cj = nbr[c, s]
            pj = pos[cj] + (img[c, s] @ boxn if boxn.ndim == 2
                            else img[c, s] * boxn)
            d = np.maximum(np.maximum(lo - pj, pj - hi), 0.0)
            keep = (idn[cj] < n_atoms) & (
                (s == 13) | ((d * d).sum(-1) < cut2 * 1.00001))
            kept = np.flatnonzero(keep)
            assert len(kept) <= stage
            tiles.append((kept, pj[kept]))
        assert nbr[c, 13] == c and np.array_equal(tiles[13][0], islot)
        s0 = 0
        while s0 < 27:
            s1, m, self_base = s0, 0, -1
            while s1 < 27 and m + len(tiles[s1][0]) <= stage:
                if s1 == 13:
                    self_base = m
                m += len(tiles[s1][0])
                s1 += 1
            assert s1 > s0
            st_pos = np.concatenate([tiles[s][1] for s in range(s0, s1)])
            st_slot = np.concatenate([nbr[c, s] * cap + tiles[s][0]
                                      for s in range(s0, s1)])
            st_tile = np.concatenate([np.full(len(tiles[s][0]), s)
                                      for s in range(s0, s1)])
            d = pos[c, islot][:, None, :] - st_pos[None, :, :]
            hit = (d * d).sum(-1) < cut2                       # [n_real, m]
            if self_base >= 0:
                hit[np.arange(n_real), self_base + np.arange(n_real)] = False
            for g in range(groups):
                for w0 in range(0, n_real, 32):
                    lanes = range(w0, min(w0 + 32, n_real))
                    lists = {t: [] for t in lanes}

                    def evaluate():
                        for t, entries in lists.items():
                            assert len(entries) <= list_cap
                            pairs_i.extend([c * cap + islot[t]] * len(entries))
                            pairs_j.extend(st_slot[entries])
                            pairs_s.extend(st_tile[entries])
                            entries.clear()

                    for jb in range(g * chunk, m, groups * chunk):
                        if any(len(v) + chunk > list_cap
                               for v in lists.values()):
                            evaluate()
                            flushes += 1
                        for t in lanes:
                            lists[t].extend(
                                jb + np.flatnonzero(
                                    hit[t, jb:min(jb + chunk, m)]))
                    evaluate()
            s0 = s1
    pi = torch.as_tensor(np.array(pairs_i, np.int64))
    pj = torch.as_tensor(np.array(pairs_j, np.int64))
    ps = np.array(pairs_s, np.int64)
    cell_of = (pi // cap).numpy()
    im = torch.as_tensor(img[cell_of, ps].astype(np.float64))
    off = im @ box if box.ndim == 2 else im * box
    flat = [a.reshape(-1) for a in (x, y, z)]
    d = [a[pi] - (a[pj] + off[:, k]) for k, a in enumerate(flat)]
    r2 = d[0] ** 2 + d[1] ** 2 + d[2] ** 2
    assert bool((r2 < cut2).all()) and bool((r2 > 0).all())
    inv_r = torch.rsqrt(r2)
    xa = alpha * r2 * inv_r
    kern = inv_r * torch.special.erfc(xa)
    qf, hf, sf = (a.reshape(-1) for a in (q, hs, se))
    qq = ONE_4PI_EPS0 * qf[pi] * qf[pj]
    coul = qq * kern
    dcoul = (qq * (-2.0 / np.sqrt(np.pi)) * torch.exp(-xa * xa) * alpha
             - coul) * inv_r * inv_r
    s6 = ((hf[pi] + hf[pj]) * inv_r) ** 6
    epr = sf[pi] * sf[pj]
    e = 0.5 * torch.sum(coul + epr * s6 * (s6 - 1.0))
    f = dcoul - epr * s6 * (12.0 * s6 - 6.0) * inv_r ** 2
    zero = torch.zeros(n_cells * cap, dtype=x.dtype)
    g = torch.stack([zero.index_add(0, pi, f * dk).reshape(x.shape)
                     for dk in d])
    dq = zero.index_add(0, pi, kern * ONE_4PI_EPS0 * qf[pj]).reshape(x.shape)
    return e, g, dq, flushes


def _water_blocks(n_side, drift=0.0):
    """Blocks of a water box on the cell route, cutoff 0.65 (3 cells per
    axis at n_side 7, 4 at 9); with ``drift``, every atom is moved by up to
    that much per axis after the binning and the wrap were frozen."""
    force, pos, _, box = water_box(n_side=n_side, cutoff=0.65)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", recip_method="pme",
                                 device="cpu")
    x = torch.as_tensor(pos)
    nb = build_neighbor_state(x, system)
    if drift:
        rng = np.random.default_rng(n_side)
        x = x + torch.as_tensor(rng.uniform(-drift, drift, pos.shape))
    b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                       nb.inv_slot, wrap=nb.wrap)
    return (*b, nb.slots.reshape(b.x.shape), system.box, system.n_atoms,
            system.spec.alpha, system.spec.cutoff), system.spec.cell_grid


# (id, the walk's arguments): water boxes with 3 and 4 cells per axis (3:
# the +-1 neighbors are distinct, no tile is walked twice); a non-cubic
# grid with uneven cells, one of them empty; water moved by up to 0.04 nm
# per axis after the wrap was frozen, so atoms lie outside their cells'
# nominal bounds; cells whose real slots have sentinels between them (and
# whose atoms were all moved by one vector out of the nominal bounds).
TRAVERSALS = {
    "7": lambda: _water_blocks(7)[0],
    "9": lambda: _water_blocks(9)[0],
    "grid-3-4-5": lambda: (*lattice_blocks((3, 4, 5), 24, [20, 0, 11, 24, 5],
                                           0.7, seed=1), 3.4, 0.65),
    "drifted": lambda: _water_blocks(7, drift=0.04)[0],
    "scattered-sentinels": lambda: (*lattice_blocks(
        (3, 3, 4), 40, [27, 9, 40, 1], 0.7, seed=2, scattered=True,
        drift=0.01, shift=(0.08, -0.06, 0.05)), 3.4, 0.65),
}


@pytest.mark.parametrize("case", list(TRAVERSALS), ids=list(TRAVERSALS))
def test_full_shell_traversal_matches_plain_walk(case):
    """The kernel's traversal, emulated, against the plain walk in f64
    within 1e-12; the emulation's lists are small enough that the warps
    evaluate early (a list that could overflow) in every case."""
    args = TRAVERSALS[case]()
    if case in ("7", "9"):
        assert min(args[0].shape[:3]) == (3 if case == "7" else 4)
    e_f, g_f, dq_f, flushes = _kernel_traversal(*args)
    e_p, g_p, dq_p = direct_walk_plain(*args)
    assert flushes > 0
    assert abs(float(e_f - e_p)) <= 1e-12 * abs(float(e_p))
    assert rel_err(g_f, g_p) <= 1e-12
    assert rel_err(dq_f, dq_p) <= 1e-12
    sentinel = args[6] >= args[8]
    assert not g_f[:, sentinel].any() and not dq_f[sentinel].any()
