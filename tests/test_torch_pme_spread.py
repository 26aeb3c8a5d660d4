"""PyTorch port: the cell-column PME spread (plain version of the CUDA
kernels), its folds, B-splines and the reciprocal energy, held to the JAX
package.  The JAX Pallas spread runs in interpret mode on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu import cells as jcells
from chargeflux_tpu import pme as jpme
from chargeflux_tpu.charges import effective_charges as jax_charges
from chargeflux_tpu.ops import pallas_pme
from chargeflux_tpu_torch import pme
from chargeflux_tpu_torch.cells import CellBlocks
from chargeflux_tpu_torch.ops import pme_spread

from torch_helpers import port_blocks, rel_err, water_systems

torch.set_num_threads(2)

# small random spread shapes: 3x3 columns, patches overlapping on a
# stride-3 lattice like the production cell patches
N_COL, WX, WYP, ROWS, ORDER, GZ = 9, 6, 8, 64, 8, 16
OFFSETS = (tuple(3 * (c // 3) for c in range(N_COL)),
           tuple(3 * (c % 3) for c in range(N_COL)))
PAD = (3 * 2 + WX, 3 * 2 + WYP, GZ)


def _spread_inputs(seed=0):
    rng = np.random.default_rng(seed)
    qwlxt = rng.standard_normal((N_COL, WX, ROWS)).astype(np.float32)
    wlyt = rng.random((N_COL, WYP, ROWS)).astype(np.float32)
    wlyt[:, WYP - 2:] = 0.0                    # zero Wy pad rows
    wzt = rng.random((N_COL, ORDER, ROWS)).astype(np.float32)
    zorg = rng.integers(0, GZ, (N_COL, 1, ROWS)).astype(np.int32)
    ct = rng.standard_normal(PAD).astype(np.float32)
    return qwlxt, wlyt, wzt, zorg, ct


def test_plain_spread_matches_pallas_interpret_fwd_and_vjp():
    qwlxt, wlyt, wzt, zorg, ct = _spread_inputs()

    def jfwd(a, b, c):
        return pallas_pme.spread_columns(a, b, c, jnp.asarray(zorg), OFFSETS,
                                         PAD, 1)

    out_j, vjp = jax.vjp(jfwd, jnp.asarray(qwlxt), jnp.asarray(wlyt),
                         jnp.asarray(wzt))
    grads_j = vjp(jnp.asarray(ct))

    t = [torch.tensor(a, requires_grad=True) for a in (qwlxt, wlyt, wzt)]
    out_t = pme_spread.spread_columns(*t, torch.as_tensor(zorg), OFFSETS, PAD)
    assert out_t.dtype == torch.float32 and out_t.shape == PAD
    assert rel_err(out_t.detach(), out_j) <= 1e-6
    grads_t = torch.autograd.grad(out_t, t, torch.as_tensor(ct))
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        assert np.abs(gt.numpy() - gj).max() <= 2e-5 * np.abs(gj).max()
    # the zero-padded Wy rows get their (nonzero) cotangents too
    assert np.abs(grads_t[1][:, WYP - 2:].numpy()).max() > 0


def test_plain_spread_backward_is_the_adjoint():
    """<spread(w), ct> is linear in each weight tensor: the hand backward
    equals autograd of the plain forward."""
    qwlxt, wlyt, wzt, zorg, ct = (torch.as_tensor(a).double()
                                  if a.dtype != np.int32 else
                                  torch.as_tensor(a)
                                  for a in _spread_inputs(1))
    t = [a.clone().requires_grad_(True) for a in (qwlxt, wlyt, wzt)]
    out = pme_spread.spread_fwd_plain(*t, zorg, OFFSETS, PAD)
    auto = torch.autograd.grad(out, t, ct)
    hand = pme_spread.spread_bwd_plain(qwlxt, wlyt, wzt, zorg, OFFSETS, ct)
    for a, b in zip(auto, hand):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("axis,grid_n,order", [(0, 8, 3), (1, 9, 2)])
def test_fold_padded_axis_matches_jax(axis, grid_n, order):
    shape = [12, 13, 5]
    qpad = np.random.default_rng(2).standard_normal(shape)
    a = pme_spread.fold_padded_axis(torch.as_tensor(qpad), grid_n, order,
                                    axis)
    b = pallas_pme.fold_padded_axis(jnp.asarray(qpad), grid_n, order, axis)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)


def test_bspline_and_derivative_match_jax():
    t = np.linspace(-0.5, 8.5, 301)
    tt = torch.tensor(t, requires_grad=True)
    m = pme.bspline(tt, 8)
    (dm,) = torch.autograd.grad(m.sum(), tt)
    jm, jvjp = jax.vjp(lambda u: jpme.bspline(u, 8), jnp.asarray(t))
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(dm.numpy(), np.asarray(jvjp(jnp.ones_like(jm))[0]),
                               rtol=0, atol=1e-14)


def test_mesh_helpers_match_jax():
    assert pme.good_fft_size(61) == jpme.good_fft_size(61)
    assert pme.pme_grid_size([6.8354] * 3, 4.05, 1e-4) == \
        jpme.pme_grid_size([6.8354] * 3, 4.05, 1e-4)
    assert np.array_equal(pme._patch_origins(8, 64, 8, 1),
                          jpme._patch_origins(8, 64, 8, 1))
    assert pme._patch_width(8, 64, 8, 1) == jpme._patch_width(8, 64, 8, 1)
    box = np.array([2.1, 2.2, 2.3])
    a = pme.influence_function((24, 20, 18), torch.as_tensor(box), 4.4, 8)
    b = jpme.influence_function((24, 20, 18), jnp.asarray(box), 4.4, 8)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reciprocal_energy_and_grads_match_jax_cell_route(dtype):
    """The port's cell-column route against the JAX cell-blocked route
    (pme_cell_reciprocal_energy): same weights and influence function,
    other placement machinery.  f64: energy rel <= 1e-10; f32: energy rel
    <= 1e-5, gradients within 2e-5 of their max (f32 roundoff of two sum
    orders)."""
    jsys, sys_t, pos, _ = water_systems(dtype)
    spec = jsys.spec
    x = jnp.asarray(pos, jsys.box.dtype)
    slots, inv, _ = jcells.build_cell_list_full(x, jsys.box, spec.cell_grid,
                                                spec.cell_capacity)
    jb = jcells.blockify(x, jax_charges(x, jsys), jsys, slots, inv)
    ids = slots.reshape(jb.x.shape)
    e_j, g_j = jax.value_and_grad(
        lambda b: jpme.pme_cell_reciprocal_energy(b, ids, jsys))(jb)

    tb = port_blocks(jb, dtype)
    leaves = [getattr(tb, f).requires_grad_(True) for f in ("x", "y", "z", "q")]
    tb = CellBlocks(*leaves, tb.hs, tb.se)
    e_t = pme.pme_cell_column_reciprocal_energy(
        tb, torch.as_tensor(np.array(ids)), sys_t)
    grads = torch.autograd.grad(e_t, leaves)
    tol_e, tol_g = (1e-10, 1e-8) if dtype == torch.float64 else (1e-5, 2e-5)
    assert abs(float(e_t.detach()) - float(e_j)) <= tol_e * abs(float(e_j))
    for f, g in zip(("x", "y", "z", "q"), grads):
        assert rel_err(g, getattr(g_j, f)) <= tol_g, f
