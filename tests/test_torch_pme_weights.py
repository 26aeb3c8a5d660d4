"""PyTorch port: the B-spline patch weights of the cell route's SPME spread
(``ops.pme_weights``).  Their plain version against the chain of
``bspline`` compositions it replaced (kept here as the oracle), its
hand-written backward against autograd through that chain, on
orthorhombic and triclinic boxes, the sentinel slots, and the wrappers'
refusals.  The CUDA kernels are held to the plain version on the card
(``test_torch_kernels_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from chargeflux_tpu_torch import cells, pme
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.neighbors import build_neighbor_state
from chargeflux_tpu_torch.ops import pme_weights as pw
from chargeflux_tpu_torch.utils.measure import shear_box

from torch_helpers import fake_kernel_limits, rel_err

torch.set_num_threads(2)

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _blocks(lattice: str, dtype, order: int = 8):
    """(system, blocks, ids) of a 6^3-water box, orthorhombic or sheared,
    on the CPU, with the positions drifted up to 0.03 nm from where the
    cells were binned (atoms outside their cells' nominal bounds, as
    between two rebuilds); the cells hold sentinel slots."""
    force, pos, _, box = water_box(n_side=6, cutoff=0.42, seed=3)
    box = shear_box(box) if lattice == "tri" else box
    system = force.create_system(box=box, dtype=dtype, direct_method="cell",
                                 recip_method="pme", device="cpu")
    if order != system.spec.pme_order:
        system = system._swap(spec=dataclasses.replace(system.spec,
                                                       pme_order=order))
    x = torch.as_tensor(pos, dtype=dtype)
    nb = build_neighbor_state(x, system)
    x = x + torch.as_tensor(np.random.default_rng(6).uniform(
        -0.03, 0.03, pos.shape), dtype=dtype)
    b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                       nb.inv_slot, wrap=nb.wrap)
    ids = nb.slots.reshape(b.x.shape)
    assert bool((ids >= system.n_atoms).any()), "no sentinel slot"
    return system, b, ids


def _chain(blocks, ids, system):
    """The column weights (qwlxt, wlyt, wzt, zorg) as the cell route formed
    them before ``ops.pme_weights``: ``bspline`` on the transposed tap
    arguments of each patch axis, differentiable by autograd."""
    spec = system.spec
    box, order, dtype = system.box, spec.pme_order, blocks.x.dtype
    ngx, ngy, ngz = spec.cell_grid
    gx, gy, gz = spec.pme_grid
    n_col, rows = ngx * ngy, ngz * blocks.x.shape[-1]
    qv = torch.where(ids < system.n_atoms, blocks.q, 0.0)
    if box.ndim == 2:
        inv = pme.box_inverse(box)
        axes = ((blocks.x * inv[0, 0] + blocks.y * inv[1, 0]
                 + blocks.z * inv[2, 0], 1.0),
                (blocks.y * inv[1, 1] + blocks.z * inv[2, 1], 1.0),
                (blocks.z * inv[2, 2], 1.0))
    else:
        axes = ((blocks.x, box[0]), (blocks.y, box[1]), (blocks.z, box[2]))

    def patch(axis, n_cells, grid_n):
        coord, length = axes[axis]
        extra = spec.pme_slack[axis]
        u = coord * (grid_n / length)
        org = pme._patch_origins(n_cells, grid_n, order, extra)
        w = pme._patch_width(n_cells, grid_n, order, extra)
        shape = [1, 1, 1, 1, 1]
        shape[axis] = n_cells
        base = torch.tensor(org.tolist(), dtype=dtype).reshape(shape)
        j = torch.arange(w).to(dtype).reshape(1, 1, w, 1, 1)
        return pme.bspline(u[:, :, None, :, :] - (base + j), order), w

    wlxt, wx = patch(0, ngx, gx)
    wlyt5, wy = patch(1, ngy, gy)
    coord, length = axes[2]
    uz = coord * (gz / length)
    org_f = torch.floor(uz).detach() - (order - 1)
    tzk = (uz - org_f)[:, :, None, :, :] - torch.arange(order).to(
        dtype).reshape(1, 1, order, 1, 1)
    wyp = -(-wy // 8) * 8
    return ((qv[:, :, None] * wlxt).reshape(n_col, wx, rows),
            torch.nn.functional.pad(wlyt5.reshape(n_col, wy, rows),
                                    (0, 0, 0, wyp - wy)),
            pme.bspline(tzk, order).reshape(n_col, order, rows),
            torch.remainder(org_f, gz).to(torch.int32).reshape(
                n_col, 1, rows))


def _leaves(blocks):
    """Fresh leaves of the blocks' coordinates and charges, and the blocks
    built on them."""
    leaves = [getattr(blocks, f).detach().clone().requires_grad_(True)
              for f in ("x", "y", "z", "q")]
    return leaves, cells.CellBlocks(*leaves, blocks.hs, blocks.se)


def _cotangents(weights, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(tuple(w.shape)),
                            dtype=w.dtype) for w in weights[:3]]


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("lattice", ["ortho", "tri"])
def test_plain_weights_are_the_chain_they_replaced(lattice, dtype):
    """The plain version's four outputs bit for bit the chain's, and the
    offsets and padded mesh of ``column_spread_inputs`` as before."""
    system, b, ids = _blocks(lattice, DTYPES[dtype])
    ins = pme.column_spread_inputs(b, ids, system)
    for got, want in zip(ins[:4], _chain(b, ids, system)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.is_contiguous()
        assert torch.equal(got, want.detach())
    spec = system.spec
    (ngx, ngy, _), order = spec.cell_grid, spec.pme_order
    gx, gy, gz = spec.pme_grid
    ex, ey, _ = spec.pme_slack
    opx = pme._patch_origins(ngx, gx, order, ex) + order + ex
    opy = pme._patch_origins(ngy, gy, order, ey) + order + ey
    assert ins[4] == (tuple(int(opx[c // ngy]) for c in range(ngx * ngy)),
                      tuple(int(opy[c % ngy]) for c in range(ngx * ngy)))
    assert ins[5] == (int(opx.max()) + ins[0].shape[1],
                      int(opy.max()) + ins[1].shape[1], gz)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("lattice", ["ortho", "tri"])
def test_hand_backward_matches_autograd_through_the_chain(lattice, dtype):
    """dE/d(x, y, z, q) of the blocks for random cotangents of the three
    weight tensors: the op's hand-written backward against autograd
    through the ``bspline`` chain (on a lattice through the fractional
    transform as well), within 1e-10 of their max in f64 and 1e-5 in
    f32 (sum orders)."""
    system, b, ids = _blocks(lattice, DTYPES[dtype])
    tol = 1e-10 if dtype == "f64" else 1e-5
    leaves, lb = _leaves(b)
    ins = pme.column_spread_inputs(lb, ids, system)
    cts = _cotangents(ins, 1)
    hand = torch.autograd.grad(ins[:3], leaves, cts)
    leaves, lb = _leaves(b)
    auto = torch.autograd.grad(_chain(lb, ids, system)[:3], leaves, cts)
    for f, g, want in zip("xyzq", hand, auto):
        assert rel_err(g, want) <= tol, f


@pytest.mark.parametrize("order", [4, 6])
def test_other_orders_match_the_chain(order):
    """Orders 4 and 6 (f64): the weights bit for bit, the backward within
    1e-10 of its max."""
    system, b, ids = _blocks("ortho", torch.float64, order)
    leaves, lb = _leaves(b)
    ins = pme.column_spread_inputs(lb, ids, system)
    assert ins[2].shape[1] == order
    leaves_c, lc = _leaves(b)
    chain = _chain(lc, ids, system)
    for got, want in zip(ins[:4], chain):
        assert torch.equal(got, want.detach())
    cts = _cotangents(ins, 2)
    hand = torch.autograd.grad(ins[:3], leaves, cts)
    auto = torch.autograd.grad(chain[:3], leaves_c, cts)
    for f, g, want in zip("xyzq", hand, auto):
        assert rel_err(g, want) <= 1e-10, f


@pytest.mark.parametrize("lattice", ["ortho", "tri"])
def test_sentinel_slots_weigh_nothing_and_take_no_gradient(lattice):
    """The slots of id >= n_atoms: zero q-weighted x taps and zero dE/dx,
    dE/dq for any cotangents; through the plain reciprocal energy (the
    spread's real cotangents) zero gradients of all four."""
    system, b, ids = _blocks(lattice, torch.float64)
    sentinel = ids >= system.n_atoms
    leaves, lb = _leaves(b)
    ins = pme.column_spread_inputs(lb, ids, system)
    n_col, wx, rows = ins[0].shape
    qw = ins[0].detach().reshape(*b.x.shape[:2], wx, *b.x.shape[2:])
    assert bool((qw.permute(0, 1, 3, 4, 2)[sentinel] == 0).all())
    g = torch.autograd.grad(ins[:3], leaves, _cotangents(ins, 3))
    assert bool((g[0][sentinel] == 0).all() and (g[3][sentinel] == 0).all())
    leaves, lb = _leaves(b)
    e = pme.pme_cell_column_reciprocal_energy(lb, ids, system)
    for f, g in zip("xyzq", torch.autograd.grad(e, leaves)):
        assert bool((g[sentinel] == 0).all()), f
        assert bool((g[~sentinel] != 0).any()), f


def test_a_non_finite_coordinate_poisons_its_taps():
    """A NaN coordinate gives NaN on every tap of its axis in its row
    (as the chain's clamp does), and the energy is NaN; the other rows
    stay finite."""
    system, b, ids = _blocks("ortho", torch.float64)
    s = tuple(int(v) for v in (ids < system.n_atoms).nonzero()[0])
    x = b.x.clone()
    x[s] = float("nan")
    bad = cells.CellBlocks(x, *b[1:])
    qwlxt = pme.column_spread_inputs(bad, ids, system)[0]
    ngz, cap = b.x.shape[2:]
    col, row = s[0] * b.x.shape[1] + s[1], s[2] * cap + s[3]
    assert bool(torch.isnan(qwlxt[col, :, row]).all())
    others = torch.ones_like(qwlxt, dtype=torch.bool)
    others[col, :, row] = False
    assert bool(torch.isfinite(qwlxt[others]).all())
    assert torch.isnan(pme.pme_cell_column_reciprocal_energy(
        bad, ids, system))


def test_the_kernels_refuse_what_they_do_not_take(monkeypatch):
    """The refusals read types, devices and the order only: a CPU or
    float64 tensor is a TypeError (the plain version serves them), an
    order outside the built instantiations a ValueError."""
    fake_kernel_limits(monkeypatch)
    assert pw._refusal([("x", torch.float32, "cuda:0")], 8) is None
    assert pw._refusal([("x", torch.float32, "cuda:0")], 4) is None
    for named in ([("x", torch.float64, "cuda:0")],
                  [("q", torch.float32, "cpu")]):
        assert pw._refusal(named, 8)[0] is TypeError
    for order in (3, 9, 16):
        err, msg = pw._refusal([("x", torch.float32, "cuda:0")], order)
        assert err is ValueError and "[4, 8]" in msg


def test_the_other_routes_keep_the_plain_bspline():
    """The dense route's weights (and the halo route's patches) stay on
    ``bspline``, which ``pme`` re-exports from the op's module."""
    assert pme.bspline is pw.bspline
    u = torch.tensor([0.0, 3.25, 15.9], dtype=torch.float64)
    t = u[:, None] - torch.arange(16).double()[None, :]
    t = t - 16 * torch.floor(t / 16)
    assert torch.equal(pme.spread_weights(u, 16, 8), pw._bspline_raw(t, 8)[0])
