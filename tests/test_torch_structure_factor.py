"""PyTorch port: the structure-factor contraction (ops/structure_factor.py).
Its plain versions, forward and VJP, are held to the JAX package's Pallas
kernel (make_structure_factor_fn, interpret mode on the CPU) on the same
tables; the autograd function's hand VJP is held to finite differences.
The CUDA forward's launch plan (ky groups, atom splits) is pure Python and
is checked here, with a plain-PyTorch replay of the kernel's sum order."""

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

from torch_helpers import KERNEL_LIMITS, rel_err

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


# the built kernel's plan inputs
FWD_LIMITS = sf.ForwardLimits(*KERNEL_LIMITS["cf_sf_limits"][2:])
CHUNK, MAX_THREADS, MAX_SPLITS, MAX_ROWS = FWD_LIMITS[:4]

# (id, Kx, Ky, 2Kz, N)
PLAN_SHAPES = [
    ("216", 7, 13, 26, 648),
    ("4k", 13, 25, 50, 3993),
    ("limits", 4, 63, 126, 1000),
    ("limits-even", 32, 64, 128, 30000),
    ("n1", 3, 5, 6, 1),
    ("n5", 7, 13, 26, 5),
    ("below-a-chunk", 7, 13, 26, CHUNK - 1),
    ("one-chunk", 7, 13, 26, CHUNK),
    ("chunk-plus-1", 7, 13, 26, CHUNK + 1),
    ("not-a-multiple", 7, 13, 26, 2433),
    ("kx1-ky1-2kz2", 1, 1, 2, 5000),
    ("enough-tiles", 70, 63, 126, 700),
    ("mid", 20, 39, 78, 12000),
    ("tall-narrow", 20, 63, 6, 900),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[s[0] for s in PLAN_SHAPES])
@pytest.mark.parametrize("target", [1, sf.FWD_BLOCK_TARGET, 264, 4096])
def test_forward_plan_covers_every_atom_once_in_order(shape, target):
    """The splits are contiguous, in order, none empty, a multiple of 4
    atoms but for the last, a power of two of them within the cluster
    limit, and cover [0, N); the ky groups cover [0, Ky) and a block's
    micro-tiles times their threads stay within the thread limit; the
    threads of a micro-tile take every atom of a split once; there is one
    split where Kx times the ky groups already reach the block target, and
    no more splits than the target needs."""
    _, kx, ky, kz2, n = shape
    plan = sf.plan_forward(kx, ky, kz2, n, FWD_LIMITS, block_target=target)
    ranges = sf.split_ranges(plan, n)
    assert len(ranges) == plan.n_splits
    assert plan.n_splits in (1, 2, 4, 8) and plan.n_splits <= MAX_SPLITS
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:] + [(n, n)]):
        assert lo < hi == lo2
        assert hi - lo == plan.split_len or hi == n
    assert plan.split_len % 4 == 0 and plan.chunk == CHUNK
    for lo, hi in ranges[:2]:
        seen = sorted(a for js in range(plan.j_split)
                      for a in sf.thread_atoms(plan, lo, hi, js))
        assert seen == list(range(lo, hi))
    rows, cols = FWD_LIMITS.tile_rows, FWD_LIMITS.tile_cols
    assert plan.y_rows % rows == 0 and plan.y_rows <= MAX_ROWS
    assert (plan.y_groups - 1) * plan.y_rows < ky <= plan.y_groups * plan.y_rows
    owners = plan.y_rows // rows * -(-kz2 // cols)
    assert 1 <= plan.j_split <= FWD_LIMITS.max_j_split
    assert owners * plan.j_split <= MAX_THREADS
    tiles = kx * plan.y_groups
    if tiles >= target:
        assert plan.n_splits == 1
    elif plan.n_splits > 1:
        assert tiles * plan.n_splits // 2 < target


def test_forward_plan_reads_the_shapes_alone(monkeypatch):
    """The plan is a function of its arguments: no device query, no built
    library (both raise here), and the same plan every time."""
    from chargeflux_tpu_torch.ops import native

    def refuse(*a, **k):
        raise AssertionError("the plan asked the device or the library")

    monkeypatch.setattr(native, "library", refuse)
    monkeypatch.setattr(native, "limits", refuse)
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    plans = {sf.plan_forward(7, 13, 26, 648, FWD_LIMITS) for _ in range(3)}
    assert plans == {sf.ForwardPlan(6, 3, 12, 8, 84, CHUNK)}
    assert sf.FWD_BLOCK_TARGET == 132
    assert sf.plan_forward(13, 25, 50, 3993, FWD_LIMITS
                           ) == sf.ForwardPlan(14, 2, 2, 8, 500, CHUNK)
    assert sf.plan_forward(4, 63, 126, 1000, FWD_LIMITS
                           ) == sf.ForwardPlan(14, 5, 1, 8, 128, CHUNK)
    assert sf.plan_forward(32, 64, 128, 30000, FWD_LIMITS
                           ) == sf.ForwardPlan(16, 4, 1, 2, 15000, CHUNK)


def _forward_in_kernel_order(tabs, plan):
    """(A, B) summed as the CUDA forward sums them: within a split, thread
    js of a micro-tile sums its atoms (js, js + j_split, ... of each chunk,
    chunk after chunk) into one accumulator; the threads' sums are added in
    js order, then the splits' in split order."""
    cxT, sxT, cyT, syT, zq = tabs
    n = cxT.shape[1]
    cxy, sxy = sf.xy_tables(cxT, sxT, cyT, syT)
    out = []
    for left in (cxy, sxy):
        total = torch.zeros((left.shape[0], zq.shape[1]), dtype=zq.dtype)
        for lo, hi in sf.split_ranges(plan, n):
            block = torch.zeros_like(total)
            for js in range(plan.j_split):
                acc = torch.zeros_like(total)
                for a in sf.thread_atoms(plan, lo, hi, js):
                    acc = acc + left[:, a:a + 1] * zq[a:a + 1]
                block = block + acc
            total = total + block
        out.append(total)
    return out


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kx, ky, kz2, n, target",
                         [(7, 13, 26, 648, None), (3, 5, 6, 333, None),
                          (3, 5, 6, 333, 1), (4, 9, 10, 2433, 40),
                          (2, 63, 126, 100, None)],
                         ids=["216", "n333", "n333-one-split", "n2433-target40",
                              "limits"])
def test_forward_sum_order_matches_plain(kx, ky, kz2, n, target, dtype, tol):
    """The kernel's sum order (a thread's atoms in chunk order, the threads
    of a micro-tile in order, then the splits in order), replayed in plain
    PyTorch atom by atom on seeded tables, against sf_fwd_plain: within
    1e-12 of max |plain| in f64 and 1e-5 in f32."""
    rng = np.random.default_rng(100 * kx + n)
    shapes = [(kx, n), (kx, n), (ky, n), (ky, n), (n, kz2)]
    tabs = [torch.as_tensor(rng.uniform(-1.0, 1.0, s)).to(dtype)
            for s in shapes]
    kw = {} if target is None else {"block_target": target}
    plan = sf.plan_forward(kx, ky, kz2, n, FWD_LIMITS, **kw)
    got = _forward_in_kernel_order(tabs, plan)
    for u, v in zip(got, sf.sf_fwd_plain(*tabs)):
        assert u.shape == v.shape
        assert rel_err(u, v) <= tol
