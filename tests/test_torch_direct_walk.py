"""PyTorch port: the fused direct walk.  The plain version is held to the
JAX package's fused walk (cells._concat_fused_walk); a full-shell emulation
of the CUDA kernel's traversal (27 neighbor tiles per i-cell, self slot
skipped, energy halved) is held to the plain version, so the tables and
masks the kernel reads are tested on the CPU."""

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

from torch_helpers import port_blocks, rel_err, water_systems

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


def _full_shell_walk(b, ids, box, n_atoms, alpha, cutoff):
    """The CUDA kernel's traversal in tensor ops (f64, exact erfc): for
    every i-cell the 27 neighbor tiles of full_shell_tables with their
    image offsets, all ordered pairs except the self slot, E halved."""
    gx, gy, gz, cap = b.x.shape
    c = gx * gy * gz
    nbr, img = cells.full_shell_tables((gx, gy, gz))
    nbr = torch.as_tensor(nbr).long()
    img = torch.as_tensor(img).to(b.x.dtype)

    def tile(a, k=None):
        t = a.reshape(c, cap)[nbr]                        # [C, 27, cap]
        if k is not None:
            t = t + img[..., k, None] * box[k]
        return t.reshape(c, 27 * cap)

    xi = [a.reshape(c, cap, 1) for a in (b.x, b.y, b.z)]
    xj = [tile(a, k)[:, None, :] for k, a in enumerate((b.x, b.y, b.z))]
    d = [u - v for u, v in zip(xi, xj)]
    r2 = d[0] ** 2 + d[1] ** 2 + d[2] ** 2
    idi = ids.reshape(c, cap, 1)
    idj = tile(ids)[:, None, :]
    slot = torch.arange(27 * cap)
    self_slot = (slot[None, :] // cap == 13) & (
        slot[None, :] % cap == torch.arange(cap)[:, None])
    mask = (idi < n_atoms) & (idj < n_atoms) & (r2 < cutoff ** 2) & ~self_slot
    r2s = torch.where(mask, r2, 1.0)
    inv_r = torch.rsqrt(r2s)
    xa = alpha * r2s * inv_r
    kern = inv_r * torch.special.erfc(xa)
    qq = ONE_4PI_EPS0 * b.q.reshape(c, cap, 1) * tile(b.q)[:, None, :]
    coul = qq * kern
    dcoul = (qq * (-2.0 / np.sqrt(np.pi)) * torch.exp(-xa * xa) * alpha
             - coul) * inv_r * inv_r
    s6 = ((b.hs.reshape(c, cap, 1) + tile(b.hs)[:, None, :]) * inv_r) ** 6
    epr = b.se.reshape(c, cap, 1) * tile(b.se)[:, None, :]
    e = 0.5 * torch.sum(torch.where(mask, coul + epr * s6 * (s6 - 1.0), 0.0))
    f = torch.where(mask, dcoul - epr * s6 * (12.0 * s6 - 6.0) * inv_r ** 2,
                    0.0)
    g = torch.stack([torch.sum(f * dk, -1).reshape(b.x.shape) for dk in d])
    dq = torch.sum(torch.where(mask, kern, 0.0) * ONE_4PI_EPS0
                   * tile(b.q)[:, None, :], -1).reshape(b.x.shape)
    return e, g, dq


@pytest.mark.parametrize("n_side", [7, 9])
def test_full_shell_traversal_matches_plain_walk(n_side):
    """3 cells per axis (n_side 7: the +-1 neighbors are distinct, no tile
    is walked twice) and 4 (n_side 9)."""
    force, pos, _, box = water_box(n_side=n_side, cutoff=0.65)
    system = force.create_system(box=box, dtype=torch.float64,
                                 direct_method="cell", recip_method="pme",
                                 device="cpu")
    assert min(system.spec.cell_grid) == (3 if n_side == 7 else 4)
    x = torch.as_tensor(pos)
    nb = build_neighbor_state(x, system)
    b = cells.blockify(x, effective_charges(x, system), system, nb.slots,
                       nb.inv_slot, wrap=nb.wrap)
    ids = nb.slots.reshape(b.x.shape)
    args = (b, ids, system.box, system.n_atoms, system.spec.alpha,
            system.spec.cutoff)
    e_f, g_f, dq_f = _full_shell_walk(*args)
    e_p, g_p, dq_p = direct_walk_plain(*b, *args[1:])
    assert abs(float(e_f - e_p)) <= 1e-12 * abs(float(e_p))
    assert rel_err(g_f, g_p) <= 1e-12
    assert rel_err(dq_f, dq_p) <= 1e-12
