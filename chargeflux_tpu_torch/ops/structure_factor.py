"""Classical-Ewald structure-factor contraction: the CUDA kernel wrappers and
their plain-PyTorch versions.

Counterpart of ``chargeflux_tpu.ops.pallas_recip`` (``make_structure_factor_fn``).
:func:`structure_factor` is an autograd function

    A = cxy @ zq,   B = sxy @ zq,   [Kx*Ky, 2Kz]
    cxy[(kx, ky), n] = cx[kx, n] cy[ky, n] - sx[kx, n] sy[ky, n]
    sxy[(kx, ky), n] = sx[kx, n] cy[ky, n] + cx[kx, n] sy[ky, n]

over the transposed per-axis phase tables cxT/sxT [Kx, N], cyT/syT [Ky, N]
and the charge-folded z table zq = q [cos_z | sin_z] [N, 2Kz], or over a
batch of R replicas, every table with a leading [R] axis (the JAX
package's vmap of its ``pallas_call``): one launch per kernel for all R,
whose replica index only picks the data, so each replica's slice equals
the single-system launch on it bit for bit.  Its forward
and the two halves of its backward each go through a wrapper — ``sf_fwd``,
``sf_bwd_tables`` (cotangents of the four phase tables) and ``sf_bwd_zq``
(cotangent of zq): on a CPU tensor the wrapper runs the plain version; on a
CUDA tensor it launches the kernel in ``csrc/structure_factor.cu`` or
raises.  ``plain=True`` runs the plain versions on any device (the
reference the kernels are checked against on the card).  The TPU layout
padding (Ky to a multiple of 8, N to a multiple of 128) is not carried
over: every shape is taken as it is.  :func:`kernels_take_grid` tells
``recip_method="auto"`` whether the kernels take a k grid.

The forward kernel is one launch whose grid, thread use and sum order
:func:`plan_forward` fixes from the shapes alone (a :class:`ForwardPlan`);
:func:`split_ranges` and :func:`thread_atoms` spell out which atoms each
block and thread sums, and in what order, so the order can be replayed
without a card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import native
from .native import INT, INT64, INT_OUT, PTR
from ..device import ieee_matmul

#: Kernel launches since the last reset, per wrapper (a launch over a
#: replica batch counts one, as a single system's does).
LAUNCHES = {"sf_fwd": 0, "sf_bwd_tables": 0, "sf_bwd_zq": 0}
#: Per wrapper, the kernel it counts, as a profiler trace names it.
SYMBOLS = {"sf_fwd": "sf_fwd_kernel", "sf_bwd_tables": "sf_bwd_tables_kernel",
           "sf_bwd_zq": "sf_bwd_zq_kernel"}
# each launch ends in (R, the replica strides) and the stream
native.declare(cf_sf_limits=[INT_OUT] * 9,
               cf_sf_fwd=[PTR] * 7 + [INT] * 9 + [INT64] * 4 + [PTR],
               cf_sf_bwd_tables=[PTR] * 11 + [INT] * 5 + [INT64] * 4 + [PTR],
               cf_sf_bwd_zq=[PTR] * 7 + [INT] * 5 + [INT64] * 4 + [PTR])

#: Blocks the forward launch aims for: it cuts the ky rows into groups and
#: the atoms into splits until it has them, where the shapes allow.  A
#: constant, not the card's SM count, so the sum order (and so the bits)
#: follows from the shapes alone.
FWD_BLOCK_TARGET = 132


class ForwardLimits(NamedTuple):
    """What the built forward kernel gives its launch plan
    (``cf_sf_limits`` after the Ky and 2Kz bounds): atoms per staged chunk,
    most threads per block, most blocks of a cluster (a power of two), most
    ky rows per block, the ky rows and columns of A and of B that one
    thread owns, and the most threads that share such a micro-tile."""
    chunk: int
    max_threads: int
    max_splits: int
    max_rows: int
    tile_rows: int
    tile_cols: int
    max_j_split: int


def forward_limits() -> ForwardLimits:
    """The built library's :class:`ForwardLimits`."""
    return ForwardLimits(*native.limits("cf_sf_limits", 9)[2:])


class ForwardPlan(NamedTuple):
    """Launch plan of the forward kernel: the grid is (Kx, ``y_groups``,
    ``n_splits``).  A block owns ``y_rows`` ky rows (the last group may
    hold fewer) and the atoms of one split, ``split_len`` each (the last
    may hold fewer).  It stages them ``chunk`` at a time; each of its
    micro-tiles is summed by ``j_split`` threads, thread js taking the
    atoms js, js + j_split, ... of every chunk in order.  The threads'
    sums are added in js order, then the splits' in split order."""
    y_rows: int
    y_groups: int
    j_split: int
    n_splits: int
    split_len: int
    chunk: int

    def blocks(self, kx: int) -> int:
        """Blocks of the launch."""
        return kx * self.y_groups * self.n_splits


def plan_forward(kx: int, ky: int, kz2: int, n: int, limits: ForwardLimits,
                 block_target: int = FWD_BLOCK_TARGET) -> ForwardPlan:
    """The forward's plan from the shapes alone, for a kernel built with
    ``limits``.  The ky rows go to the fewest equal groups that keep a
    block's rows within ``max_rows`` and its micro-tiles within
    ``max_threads``, and to more while Kx x groups x ``max_splits`` blocks
    stay under ``block_target``; the atoms to the fewest splits (a power of
    two, none empty, each a multiple of 4 atoms) that reach the target;
    spare threads of a block split its chunks' atoms among them.  The
    wrapper plans at :data:`FWD_BLOCK_TARGET`."""
    chunk, max_threads, max_splits, max_rows, rows, cols, max_j = limits
    row_groups, col_groups = -(-ky // rows), -(-kz2 // cols)
    groups = -(-row_groups // max(1, min(max_threads // col_groups,
                                         max_rows // rows)))
    while True:
        y_rows = rows * -(-row_groups // groups)
        y_groups = -(-ky // y_rows)
        if (kx * y_groups * max_splits >= block_target
                or groups >= row_groups):
            break
        groups += 1
    n_splits, split_len = 1, -(-n // 4) * 4
    while n_splits < max_splits and kx * y_groups * n_splits < block_target:
        length = -(-n // (4 * 2 * n_splits)) * 4
        if (2 * n_splits - 1) * length >= n:    # a split would be empty
            break
        n_splits, split_len = 2 * n_splits, length
    owners = y_rows // rows * col_groups
    j_split = max(1, min(max_j, max_threads // owners))
    return ForwardPlan(y_rows, y_groups, j_split, n_splits, split_len, chunk)


def split_ranges(plan: ForwardPlan, n: int):
    """[(lo, hi)] atom range of each split of ``plan``, in fold order."""
    return [(s * plan.split_len, min(n, (s + 1) * plan.split_len))
            for s in range(plan.n_splits)]


def thread_atoms(plan: ForwardPlan, lo: int, hi: int, js: int):
    """The atoms of the split [lo, hi) that thread ``js`` of a micro-tile
    sums, in the order it sums them."""
    return [a for c0 in range(lo, hi, plan.chunk)
            for a in range(c0 + js, min(c0 + plan.chunk, hi), plan.j_split)]


def xy_tables(cxT, sxT, cyT, syT):
    """(cxy, sxy), each [..., Kx*Ky, N]: the combined x/y phase tables."""
    kx, n = cxT.shape[-2:]
    ky = cyT.shape[-2]
    lead = cxT.shape[:-2]
    cxy = (cxT[..., :, None, :] * cyT[..., None, :, :]
           - sxT[..., :, None, :] * syT[..., None, :, :])
    sxy = (sxT[..., :, None, :] * cyT[..., None, :, :]
           + cxT[..., :, None, :] * syT[..., None, :, :])
    return cxy.reshape(lead + (kx * ky, n)), sxy.reshape(lead + (kx * ky, n))


def sf_fwd_plain(cxT, sxT, cyT, syT, zq):
    """(A, B) = (cxy @ zq, sxy @ zq) (batched over any leading axes)."""
    cxy, sxy = xy_tables(cxT, sxT, cyT, syT)
    return ieee_matmul(cxy, zq), ieee_matmul(sxy, zq)


def sf_bwd_tables_plain(cxT, sxT, cyT, syT, zq, abar, bbar):
    """(dcxT, dsxT, dcyT, dsyT) for the cotangents (abar, bbar) of (A, B):
    with gc = abar zq^T and gs = bbar zq^T per (kx, ky, n), reduced over ky
    for the x tables and over kx for the y tables."""
    kx, n = cxT.shape[-2:]
    ky = cyT.shape[-2]
    shape = cxT.shape[:-2] + (kx, ky, n)
    zqt = zq.transpose(-1, -2)
    gc = ieee_matmul(abar, zqt).reshape(shape)
    gs = ieee_matmul(bbar, zqt).reshape(shape)
    cy, sy = cyT[..., None, :, :], syT[..., None, :, :]
    cx, sx = cxT[..., :, None, :], sxT[..., :, None, :]
    dcx = torch.sum(gc * cy + gs * sy, dim=-2)
    dsx = torch.sum(-gc * sy + gs * cy, dim=-2)
    dcy = torch.sum(gc * cx + gs * sx, dim=-3)
    dsy = torch.sum(-gc * sx + gs * cx, dim=-3)
    return dcx, dsx, dcy, dsy


def sf_bwd_zq_plain(cxT, sxT, cyT, syT, abar, bbar):
    """dzq = cxy^T abar + sxy^T bbar, [..., N, 2Kz]."""
    cxy, sxy = xy_tables(cxT, sxT, cyT, syT)
    return (ieee_matmul(cxy.transpose(-1, -2), abar)
            + ieee_matmul(sxy.transpose(-1, -2), bbar))


def _refusal(named, ky: int, kz2: int, n: int):
    """Why the structure-factor kernels cannot take float inputs ``named``,
    (name, dtype, device) triples, at Ky, 2Kz and N: (exception class,
    message), or None.  It reads types, devices and sizes only."""
    for name, dtype, device in named:
        if torch.device(device).type != "cuda" or dtype != torch.float32:
            return TypeError, (f"structure-factor kernel: {name} must be a "
                               f"float32 CUDA tensor (got {dtype} on "
                               f"{device}); the plain version serves other "
                               f"types")
    max_ky, max_kz2 = native.limits("cf_sf_limits", 9)[:2]
    if ky > max_ky or kz2 > max_kz2 or n < 1:
        return ValueError, (f"structure-factor kernel: needs Ky <= {max_ky}, "
                            f"2Kz <= {max_kz2} and N >= 1 (got Ky {ky}, 2Kz "
                            f"{kz2}, N {n})")
    return None


def kernels_take_grid(ky: int, kz2: int) -> bool:
    """Whether the three kernels take a k grid of Ky and 2Kz (f32 tables
    on the card of at least one atom); reads the built library's
    limits."""
    return _refusal((), ky, kz2, 1) is None


def _check(cxT, sxT, cyT, syT, zq=None, abar=None, bbar=None):
    """Raise unless every input is what the kernels take: all tables
    [Kx, N]-shaped or all with one leading replica axis [R, ...]; returns
    (R, Kx, Ky, 2Kz, N), R = 0 for unbatched tables."""
    batched = cxT.ndim == 3
    reps = cxT.shape[0] if batched else 0
    kx, n = cxT.shape[-2:]
    ky = cyT.shape[-2]
    named = [("cxT", cxT), ("sxT", sxT), ("cyT", cyT), ("syT", syT)]
    named += [(k, t) for k, t in (("zq", zq), ("abar", abar), ("bbar", bbar))
              if t is not None]
    kz2 = (zq if zq is not None else abar).shape[-1]
    refusal = _refusal([(k, t.dtype, t.device) for k, t in named], ky, kz2, n)
    if refusal is not None:
        raise refusal[0](refusal[1])
    lead = (reps,) if batched else ()
    if cxT.ndim not in (2, 3) or (batched and not 1 <= reps <= 65535):
        raise ValueError("structure-factor kernel: tables must be [Kx, N] "
                         "or [R, Kx, N] with 1 <= R <= 65535")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"structure-factor kernel: {name} must be "
                             f"contiguous")
        if t.device != cxT.device:
            raise ValueError("structure-factor kernel: inputs on different "
                             "devices")
    if (sxT.shape != lead + (kx, n) or cyT.shape != lead + (ky, n)
            or syT.shape != lead + (ky, n)):
        raise ValueError("structure-factor kernel: the phase tables must be "
                         "cxT/sxT [Kx, N] and cyT/syT [Ky, N], all with or "
                         "all without the replica axis")
    if zq is not None and zq.shape != lead + (n, kz2):
        raise ValueError("structure-factor kernel: zq must be [N, 2Kz]")
    for t in (abar, bbar):
        if t is not None and t.shape != lead + (kx * ky, kz2):
            raise ValueError("structure-factor kernel: abar/bbar must be "
                             "[Kx*Ky, 2Kz]")
    return reps, kx, ky, kz2, n


def _launch_args(reps, kx, ky, kz2, n):
    """The trailing (R, replica strides) of a launch: R = 1 with unused
    strides for unbatched tables; the strides of contiguous [R, ...]
    tables otherwise (x tables, y tables, zq, A/B)."""
    return (max(reps, 1), kx * n, ky * n, n * kz2, kx * ky * kz2)


def sf_fwd(cxT, sxT, cyT, syT, zq):
    """Forward contraction: plain version on the CPU, the CUDA kernel on the
    card (one launch by :func:`plan_forward`'s plan, no scratch; for [R, ...]
    tables one launch over every replica, each on the single system's
    plan)."""
    if cxT.device.type == "cpu":
        return sf_fwd_plain(cxT, sxT, cyT, syT, zq)
    reps, kx, ky, kz2, n = _check(cxT, sxT, cyT, syT, zq=zq)
    plan = plan_forward(kx, ky, kz2, n, forward_limits())
    a = torch.empty(((reps,) if reps else ()) + (kx * ky, kz2),
                    dtype=torch.float32, device=cxT.device)
    b = torch.empty_like(a)
    err = native.library().cf_sf_fwd(
        *(t.data_ptr() for t in (cxT, sxT, cyT, syT, zq, a, b)), kx, ky, kz2,
        n, plan.y_rows, plan.j_split, plan.n_splits, plan.split_len,
        *_launch_args(reps, kx, ky, kz2, n), native.stream_ptr(cxT))
    native.check(err, "cf_sf_fwd")
    LAUNCHES["sf_fwd"] += 1
    return a, b


def sf_bwd_tables(cxT, sxT, cyT, syT, zq, abar, bbar):
    """Phase-table cotangents: plain version on the CPU, the CUDA kernel on
    the card."""
    if cxT.device.type == "cpu":
        return sf_bwd_tables_plain(cxT, sxT, cyT, syT, zq, abar, bbar)
    reps, kx, ky, kz2, n = _check(cxT, sxT, cyT, syT, zq=zq, abar=abar,
                                  bbar=bbar)
    outs = [torch.empty_like(t) for t in (cxT, sxT, cyT, syT)]
    err = native.library().cf_sf_bwd_tables(
        *(t.data_ptr() for t in (cxT, sxT, cyT, syT, zq, abar, bbar, *outs)),
        kx, ky, kz2, n, *_launch_args(reps, kx, ky, kz2, n),
        native.stream_ptr(cxT))
    native.check(err, "cf_sf_bwd_tables")
    LAUNCHES["sf_bwd_tables"] += 1
    return tuple(outs)


def sf_bwd_zq(cxT, sxT, cyT, syT, abar, bbar):
    """zq cotangent: plain version on the CPU, the CUDA kernel on the
    card."""
    if cxT.device.type == "cpu":
        return sf_bwd_zq_plain(cxT, sxT, cyT, syT, abar, bbar)
    reps, kx, ky, kz2, n = _check(cxT, sxT, cyT, syT, abar=abar, bbar=bbar)
    dzq = torch.empty(((reps,) if reps else ()) + (n, kz2),
                      dtype=torch.float32, device=cxT.device)
    err = native.library().cf_sf_bwd_zq(
        *(t.data_ptr() for t in (cxT, sxT, cyT, syT, abar, bbar, dzq)),
        kx, ky, kz2, n, *_launch_args(reps, kx, ky, kz2, n),
        native.stream_ptr(cxT))
    native.check(err, "cf_sf_bwd_zq")
    LAUNCHES["sf_bwd_zq"] += 1
    return dzq


class _StructureFactor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cxT, sxT, cyT, syT, zq, plain):
        ctx.save_for_backward(cxT, sxT, cyT, syT, zq)
        ctx.plain = plain
        fwd = sf_fwd_plain if plain else sf_fwd
        return fwd(cxT, sxT, cyT, syT, zq)

    @staticmethod
    def backward(ctx, abar, bbar):
        cxT, sxT, cyT, syT, zq = ctx.saved_tensors
        abar, bbar = abar.contiguous(), bbar.contiguous()
        tables = sf_bwd_tables_plain if ctx.plain else sf_bwd_tables
        zq_fn = sf_bwd_zq_plain if ctx.plain else sf_bwd_zq
        d_tables = (None,) * 4
        if any(ctx.needs_input_grad[:4]):
            d_tables = tables(cxT, sxT, cyT, syT, zq, abar, bbar)
        d_zq = None
        if ctx.needs_input_grad[4]:
            d_zq = zq_fn(cxT, sxT, cyT, syT, abar, bbar)
        return (*d_tables, d_zq, None)


def structure_factor(cxT, sxT, cyT, syT, zq, plain: bool = False):
    """(A, B) [Kx*Ky, 2Kz] (or [R, Kx*Ky, 2Kz] over a replica batch),
    differentiable in all five tables (see the module docstring for the
    contraction and the layouts)."""
    return _StructureFactor.apply(cxT, sxT, cyT, syT, zq, plain)
