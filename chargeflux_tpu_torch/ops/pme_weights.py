"""B-spline patch weights of the cell route's SPME spread: the CUDA kernel
wrappers, their plain-PyTorch versions, and the B-spline recursion.

:func:`patch_weights` turns the cell blocks' coordinates and charges into
the arguments ``ops.pme_spread.spread_columns`` takes (qwlxt, wlyt, wzt,
zorg), differentiable in the coordinates and charges.  Its forward and
backward each go through a wrapper: on a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel in
``csrc/bspline_patch.cu`` or raises.  ``plain=True`` runs the plain
version on any device (the reference the kernels are checked against on
the card, and the route of an f64 system; the kernels are f32 only).

Replaces no Pallas kernel: the JAX package computes these weights as plain
jnp (``pme._cell_patch_weights`` and ``bspline`` inside
``pme_cell_pallas_reciprocal_energy``), which XLA fuses into one loop.
Eagerly, the plain version is some 500 elementwise launches per force
evaluation over [ngx, ngy, W, ngz, cap] tap arrays; bytes bound it, and the
kernels move each word once (``csrc/bspline_patch.cu`` says how).

:func:`bspline` (M_p with the analytic derivative in its backward) also
serves the dense route's and the halo route's plain weights, which do not
go through the kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import native
from .native import INT, INT_OUT, PTR
from ..device import constant

#: Kernel launches since the last reset, per wrapper.
LAUNCHES = {"patch_weights_fwd": 0, "patch_weights_bwd": 0}
#: Per wrapper, the kernel it counts, as a profiler trace names it.
SYMBOLS = {"patch_weights_fwd": "bspline_patch_fwd_kernel",
           "patch_weights_bwd": "bspline_patch_bwd_kernel"}
native.declare(cf_bspline_limits=[INT_OUT] * 2,
               cf_bspline_patch_fwd=[PTR] * 8 + [INT] * 12 + [PTR] * 5,
               cf_bspline_patch_bwd=[PTR] * 11 + [INT] * 12 + [PTR] * 5)


def _bspline_raw(t: torch.Tensor, order: int, depth: int = 1):
    """B-spline recursion M_n(t) = [t M_{n-1}(t) + (n - t) M_{n-1}(t-1)] /
    (n - 1) on a stack whose level j holds M_n(t - j); returns the top
    ``depth`` levels."""
    level = [torch.clamp(1.0 - torch.abs(t - 1.0 - j), min=0.0)
             for j in range(order - 2 + depth)]
    for n in range(3, order + 1):
        tj = [t - j for j in range(len(level) - 1)]
        level = [(tj[j] * level[j] + (n - tj[j]) * level[j + 1]) / (n - 1)
                 for j in range(len(level) - 1)]
    return level[:depth]


def _slope_and_value(t: torch.Tensor, order: int):
    """(M_p'(t), M_p(t)) from the order p - 1 recursion at t and t - 1:
    M_p' = M_{p-1}(t) - M_{p-1}(t - 1), and M_p by the recursion's last
    step (the forward's bits)."""
    lo = _bspline_raw(t, order - 1, depth=2)
    return lo[0] - lo[1], (t * lo[0] + (order - t) * lo[1]) / (order - 1)


class _BSpline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, order):
        ctx.save_for_backward(t)
        ctx.order = order
        return _bspline_raw(t, order)[0]

    @staticmethod
    def backward(ctx, ct):
        (t,) = ctx.saved_tensors
        lo = _bspline_raw(t, ctx.order - 1, depth=2)
        return ct * (lo[0] - lo[1]), None


def bspline(t: torch.Tensor, order: int) -> torch.Tensor:
    """Cardinal B-spline M_p(t), support (0, p), with the analytic
    derivative identity in its backward."""
    return _BSpline.apply(t, order)


class PatchGeometry(NamedTuple):
    """The static layout of the weights: the mesh (Gx, Gy, Gz), the spline
    order, the cell patch origins along x and y (``pme._patch_origins``,
    one per cell), the patch widths Wx, Wy and Wyp (Wy padded with zero
    rows to a multiple of 8)."""
    grid: Tuple[int, int, int]
    order: int
    orgx: Tuple[int, ...]
    orgy: Tuple[int, ...]
    wx: int
    wy: int
    wyp: int


def _scales(lengths, geom: PatchGeometry):
    """The per-axis scale G / L of u = coord * G / L."""
    return [g / lengths[a] for a, g in enumerate(geom.grid)]


def _patch_taps(u, origins, w: int, cell_axis: int):
    """Tap arguments t = u - (origin + j) [ngx, ngy, W, ngz, cap] of one
    patch axis (the tap axis third: the column layout of the spread)."""
    shape = [1, 1, 1, 1, 1]
    shape[cell_axis] = len(origins)
    base = constant(list(origins), u.dtype, u.device).reshape(shape)
    j = torch.arange(w, device=u.device).to(u.dtype).reshape(1, 1, w, 1, 1)
    return u[:, :, None, :, :] - (base + j)


def _z_taps(uz, order: int):
    """The compact z tap arguments [ngx, ngy, order, ngz, cap] and the
    float origins floor(u) - (order - 1) (detached)."""
    org_f = torch.floor(uz).detach() - (order - 1)
    k = torch.arange(order, device=uz.device).to(uz.dtype)
    return (uz - org_f)[:, :, None, :, :] - k.reshape(1, 1, order, 1, 1), \
        org_f


def patch_weights_fwd_plain(x, y, z, q, ids, lengths, n_atoms: int,
                            geom: PatchGeometry):
    """(qwlxt, wlyt, wzt, zorg) of the blocks in plain tensor ops (any
    device)."""
    ngx, ngy, ngz, cap = x.shape
    n_col, rows = ngx * ngy, ngz * cap
    p = geom.order
    sx, sy, sz = _scales(lengths, geom)
    qv = torch.where(ids < n_atoms, q, 0.0)
    wlxt = _bspline_raw(_patch_taps(x * sx, geom.orgx, geom.wx, 0), p)[0]
    wlyt = _bspline_raw(_patch_taps(y * sy, geom.orgy, geom.wy, 1), p)[0]
    tz, org_f = _z_taps(z * sz, p)
    wzt = _bspline_raw(tz, p)[0]
    zorg = torch.remainder(org_f, geom.grid[2]).to(torch.int32)
    qwlxt = (qv[:, :, None] * wlxt).reshape(n_col, geom.wx, rows)
    wlyt = F.pad(wlyt.reshape(n_col, geom.wy, rows),
                 (0, 0, 0, geom.wyp - geom.wy))
    return (qwlxt.contiguous(), wlyt.contiguous(),
            wzt.reshape(n_col, p, rows).contiguous(),
            zorg.reshape(n_col, 1, rows).contiguous())


def patch_weights_bwd_plain(x, y, z, q, ids, lengths, n_atoms: int,
                            geom: PatchGeometry, d_qwlxt, d_wlyt, d_wzt):
    """(dE/dx, dE/dy, dE/dz, dE/dq) of :func:`patch_weights_fwd_plain` for
    the cotangents of qwlxt, wlyt and wzt (any device)."""
    ngx, ngy, ngz, cap = x.shape
    p = geom.order
    sx, sy, sz = _scales(lengths, geom)
    real = ids < n_atoms
    qv = torch.where(real, q, 0.0)

    def taps(d, w):
        return d.reshape(ngx, ngy, -1, ngz, cap)[:, :, :w]

    slope, value = _slope_and_value(
        _patch_taps(x * sx, geom.orgx, geom.wx, 0), p)
    d = taps(d_qwlxt, geom.wx)
    g_x = torch.sum(qv[:, :, None] * d * slope, dim=2) * sx
    g_q = torch.where(real, torch.sum(d * value, dim=2), 0.0)
    slope, _ = _slope_and_value(_patch_taps(y * sy, geom.orgy, geom.wy, 1),
                                p)
    g_y = torch.sum(taps(d_wlyt, geom.wy) * slope, dim=2) * sy
    slope, _ = _slope_and_value(_z_taps(z * sz, p)[0], p)
    g_z = torch.sum(taps(d_wzt, p) * slope, dim=2) * sz
    return g_x, g_y, g_z, g_q


def _refusal(named, order: int):
    """Why the kernels cannot take float inputs ``named``, (name, dtype,
    device) triples, at spline ``order``: (exception class, message), or
    None; it reads types, devices and the order only."""
    for name, dtype, device in named:
        if torch.device(device).type != "cuda" or dtype != torch.float32:
            return TypeError, (f"patch weights kernel: {name} must be a "
                               f"float32 CUDA tensor (got {dtype} on "
                               f"{device}); the plain version serves other "
                               f"types")
    lo, hi = native.limits("cf_bspline_limits")
    if not lo <= order <= hi:
        return ValueError, (f"patch weights kernel: needs a spline order in "
                            f"[{lo}, {hi}] (got {order})")
    return None


def _check(x, y, z, q, ids, lengths, geom: PatchGeometry, cotangents=()):
    """Raise unless every input is what the kernels take (the backward's
    with its ``cotangents``, (name, tensor, rows per column) triples)."""
    floats = (("x", x), ("y", y), ("z", z), ("q", q), ("lengths", lengths),
              *((n, t) for n, t, _ in cotangents))
    refusal = _refusal([(n, t.dtype, t.device) for n, t in floats],
                       geom.order)
    if refusal is not None:
        raise refusal[0](refusal[1])
    for name, t in (*floats, ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"patch weights kernel: {name} must be "
                             f"contiguous")
        if t.device != x.device:
            raise ValueError(f"patch weights kernel: {name} is not on "
                             f"{x.device}")
    if x.ndim != 4 or any(t.shape != x.shape for t in (y, z, q, ids)):
        raise ValueError("patch weights kernel: x, y, z, q and ids must be "
                         "blocks [ngx, ngy, ngz, cap] of one shape")
    if ids.dtype != torch.int32 or lengths.shape != (3,):
        raise ValueError("patch weights kernel: ids must be int32 and "
                         "lengths [3]")
    ngx, ngy, ngz, cap = x.shape
    if (len(geom.orgx), len(geom.orgy)) != (ngx, ngy) or not (
            1 <= geom.wy <= geom.wyp and geom.wx >= 1):
        raise ValueError("patch weights kernel: the patch origins and widths "
                         "do not match the blocks")
    for name, t, w in cotangents:
        if t.shape != (ngx * ngy, w, ngz * cap):
            raise ValueError(f"patch weights kernel: {name} must be "
                             f"[{ngx * ngy}, {w}, {ngz * cap}]")


def _dims(x, n_atoms: int, geom: PatchGeometry):
    return (n_atoms, *x.shape, *geom.grid, geom.order, geom.wx, geom.wy,
            geom.wyp)


def _origins(geom: PatchGeometry, device):
    return (constant(geom.orgx, torch.int32, device),
            constant(geom.orgy, torch.int32, device))


def patch_weights_fwd(x, y, z, q, ids, lengths, n_atoms: int,
                      geom: PatchGeometry):
    """Forward: plain version on the CPU, the CUDA kernel on the card."""
    if x.device.type == "cpu":
        return patch_weights_fwd_plain(x, y, z, q, ids, lengths, n_atoms,
                                       geom)
    _check(x, y, z, q, ids, lengths, geom)
    ngx, ngy, ngz, cap = x.shape
    n_col, rows = ngx * ngy, ngz * cap
    qwlxt = x.new_empty((n_col, geom.wx, rows))
    wlyt = x.new_empty((n_col, geom.wyp, rows))
    wzt = x.new_empty((n_col, geom.order, rows))
    zorg = torch.empty((n_col, 1, rows), dtype=torch.int32, device=x.device)
    err = native.library().cf_bspline_patch_fwd(
        *(t.data_ptr() for t in (x, y, z, q, ids, lengths,
                                 *_origins(geom, x.device))),
        *_dims(x, n_atoms, geom),
        *(t.data_ptr() for t in (qwlxt, wlyt, wzt, zorg)),
        native.stream_ptr(x))
    native.check(err, "cf_bspline_patch_fwd")
    LAUNCHES["patch_weights_fwd"] += 1
    return qwlxt, wlyt, wzt, zorg


def patch_weights_bwd(x, y, z, q, ids, lengths, n_atoms: int,
                      geom: PatchGeometry, d_qwlxt, d_wlyt, d_wzt):
    """Backward: plain version on the CPU, the CUDA kernel on the card."""
    if x.device.type == "cpu":
        return patch_weights_bwd_plain(x, y, z, q, ids, lengths, n_atoms,
                                       geom, d_qwlxt, d_wlyt, d_wzt)
    _check(x, y, z, q, ids, lengths, geom,
           (("d_qwlxt", d_qwlxt, geom.wx), ("d_wlyt", d_wlyt, geom.wyp),
            ("d_wzt", d_wzt, geom.order)))
    grads = [torch.empty_like(x) for _ in range(4)]
    err = native.library().cf_bspline_patch_bwd(
        *(t.data_ptr() for t in (x, y, z, q, ids, lengths,
                                 *_origins(geom, x.device), d_qwlxt, d_wlyt,
                                 d_wzt)),
        *_dims(x, n_atoms, geom), *(g.data_ptr() for g in grads),
        native.stream_ptr(x))
    native.check(err, "cf_bspline_patch_bwd")
    LAUNCHES["patch_weights_bwd"] += 1
    return tuple(grads)


class _PatchWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, z, q, ids, lengths, n_atoms, geom, plain):
        fwd = patch_weights_fwd_plain if plain else patch_weights_fwd
        out = fwd(x, y, z, q, ids, lengths, n_atoms, geom)
        ctx.mark_non_differentiable(out[3])
        ctx.save_for_backward(x, y, z, q, ids, lengths)
        ctx.n_atoms, ctx.geom, ctx.plain = n_atoms, geom, plain
        return out

    @staticmethod
    def backward(ctx, d_qwlxt, d_wlyt, d_wzt, _d_zorg):
        bwd = patch_weights_bwd_plain if ctx.plain else patch_weights_bwd
        grads = bwd(*ctx.saved_tensors, ctx.n_atoms, ctx.geom,
                    d_qwlxt.contiguous(), d_wlyt.contiguous(),
                    d_wzt.contiguous())
        return (*grads, None, None, None, None, None)


def patch_weights(x, y, z, q, ids, lengths, n_atoms: int,
                  geom: PatchGeometry, plain: bool = False):
    """The spread's weights of the cell blocks (differentiable in x, y, z
    and q; no cotangent for ``lengths``).

    x, y, z, q [ngx, ngy, ngz, cap]: the blocks' spread coordinates
    (Cartesian, or a lattice's fractional ones) and charges; ids the same
    shape, int32, with the slots of id >= ``n_atoms`` weighing nothing;
    lengths [3]: the axis lengths L of u = coord * G / L (the box, or ones
    for fractional coordinates), read on the device, so a captured graph
    follows a box that changes between replays.  Returns qwlxt [n_col, Wx,
    rows] (q times the x weights), wlyt [n_col, Wyp, rows] (zero rows above
    Wy), wzt [n_col, order, rows] (the compact z taps) and zorg [n_col, 1,
    rows] int32 (their first mesh plane mod Gz), with n_col = ngx ngy and
    rows = ngz cap.
    """
    return _PatchWeights.apply(x, y, z, q, ids, lengths, n_atoms, geom,
                               plain)
