"""PyTorch port: the structure-factor contraction (ops/structure_factor.py).
Its plain versions, forward and VJP, are held to the JAX package's Pallas
kernel (make_structure_factor_fn, interpret mode on the CPU) on the same
tables; the autograd function's hand VJP is held to finite differences."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.ops.pallas_recip import _ceil_to, make_structure_factor_fn
from chargeflux_tpu_torch import ewald, ops
from chargeflux_tpu_torch.charges import effective_charges
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.ops import structure_factor as sf

from torch_helpers import rel_err

torch.set_num_threads(2)


def _tables(n_side, kmax=None):
    """(cxT, sxT, cyT, syT, zq) float32 NumPy from the water box's positions
    and flux charges (the 216-water path's shapes at n_side 6, the 4k box's
    at n_side 11), and kmax (the system's own unless given)."""
    force, pos, _, box = water_box(n_side=n_side, cutoff=0.9)
    with warnings.catch_warnings():   # n_side 3: cutoff > half the box
        warnings.simplefilter("ignore")
        system = force.create_system(box=box, dtype=torch.float64,
                                     direct_method="dense", device="cpu")
    kmax = kmax or system.spec.kmax
    x = torch.as_tensor(pos)
    q = effective_charges(x, system)
    tabs = ewald.kernel_inputs(x, q, system.box, kmax)
    return [t.float().numpy() for t in tabs], kmax


@pytest.mark.parametrize("n_side, kmax", [(3, None), (6, None), (11, None),
                                          (6, (4, 9, 6))],
                         ids=["3", "6", "11", "6-kmax4x9x6"])
def test_plain_forward_and_vjp_match_pallas_interpret(n_side, kmax):
    """f32: A, B within 1e-5 of their max; each VJP output within 2e-5 of
    its max (the tolerances of tests/test_pallas_recip.py), compared on the
    real rows (the JAX kernel pads Ky to 8 and N to 128 with zeros).  n_side
    11 is the 4k shapes the CUDA kernels are timed at (Kx 13, Ky 25, 2Kz
    50, N 3993); kmax (4, 9, 6) makes Kx, Ky and 2Kz all differ (4, 17, 22)
    so a transposed [Kx, N] / [Ky, N] / [N, 2Kz] layout cannot pass."""
    tabs, kmax = _tables(n_side, kmax)
    cxT, sxT, cyT, syT, zq = tabs
    kx, n = cxT.shape
    ky, kz2 = cyT.shape[0], zq.shape[1]
    rng = np.random.default_rng(n_side)
    abar = rng.standard_normal((kx * ky, kz2)).astype(np.float32)
    bbar = rng.standard_normal((kx * ky, kz2)).astype(np.float32)

    fn, n_pad = make_structure_factor_fn(kmax, n)
    ky_pad = _ceil_to(ky, 8)

    def pad(a, rows, cols):
        return jnp.pad(jnp.asarray(a), ((0, rows - a.shape[0]),
                                        (0, cols - a.shape[1])))

    def pad_bar(b):
        return jnp.pad(jnp.asarray(b).reshape(kx, ky, kz2),
                       ((0, 0), (0, ky_pad - ky), (0, 0))).reshape(-1, kz2)

    jin = (pad(cxT, kx, n_pad), pad(sxT, kx, n_pad), pad(cyT, ky_pad, n_pad),
           pad(syT, ky_pad, n_pad), pad(zq, n_pad, kz2))

    @jax.jit
    def j_fwd_vjp(args, ab, bb):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp((ab, bb))

    (ja, jb), jgrads = j_fwd_vjp(jin, pad_bar(abar), pad_bar(bbar))

    def real_rows(a):
        return np.asarray(a).reshape(kx, ky_pad, kz2)[:, :ky].reshape(-1, kz2)

    tt = [torch.as_tensor(t).requires_grad_(True) for t in tabs]
    a, b = sf.structure_factor(*tt)
    assert rel_err(a.detach(), real_rows(ja)) <= 1e-5
    assert rel_err(b.detach(), real_rows(jb)) <= 1e-5
    grads = torch.autograd.grad((a, b), tt, (torch.as_tensor(abar),
                                             torch.as_tensor(bbar)))
    ref = (np.asarray(jgrads[0])[:, :n], np.asarray(jgrads[1])[:, :n],
           np.asarray(jgrads[2])[:ky, :n], np.asarray(jgrads[3])[:ky, :n],
           np.asarray(jgrads[4])[:n])
    for g, r in zip(grads, ref):
        assert g.shape == r.shape
        assert rel_err(g, r) <= 2e-5


def test_hand_vjp_matches_finite_differences():
    """f64 gradcheck of the autograd function on random tables."""
    rng = np.random.default_rng(0)
    kx, ky, kz2, n = 2, 3, 4, 5
    shapes = [(kx, n), (kx, n), (ky, n), (ky, n), (n, kz2)]
    tt = [torch.as_tensor(rng.standard_normal(s)).requires_grad_(True)
          for s in shapes]
    assert torch.autograd.gradcheck(
        lambda *t: sf.structure_factor(*t, plain=True), tt)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    """On CPU tensors each wrapper is its plain version, bit for bit, and
    launches nothing."""
    tabs, _ = _tables(3)
    t = [torch.as_tensor(a) for a in tabs]
    rng = np.random.default_rng(1)
    kx, ky, kz2 = t[0].shape[0], t[2].shape[0], t[4].shape[1]
    abar, bbar = (torch.as_tensor(rng.standard_normal(
        (kx * ky, kz2)).astype(np.float32)) for _ in range(2))
    ops.reset_launch_counts()
    pairs = [(sf.sf_fwd(*t), sf.sf_fwd_plain(*t)),
             (sf.sf_bwd_tables(*t, abar, bbar),
              sf.sf_bwd_tables_plain(*t, abar, bbar)),
             ((sf.sf_bwd_zq(*t[:4], abar, bbar),),
              (sf.sf_bwd_zq_plain(*t[:4], abar, bbar),))]
    for got, want in pairs:
        for u, v in zip(got, want):
            assert torch.equal(u, v)
    assert all(v == 0 for k, v in ops.launch_counts().items()
               if k.startswith("sf_"))
