"""Cell-column SPME spread: the CUDA kernel wrappers, their plain-PyTorch
versions, and the ghost-edge fold.

Counterpart of ``chargeflux_tpu.ops.pallas_pme`` (``spread_columns``,
``fold_padded_axis``).  :func:`spread_columns` is an autograd function
whose forward and backward each go through a wrapper: on a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel in
``csrc/pme_spread.cu`` or raises.  ``plain=True`` runs the plain version on
any device (the reference the kernels are checked against on the card);
an f64 system records that route when it is built (the kernels are f32
only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import native
from .native import INT, INT_OUT, PTR
from ..device import constant, ieee_matmul

#: Kernel launches since the last reset, per wrapper.
LAUNCHES = {"spread_fwd": 0, "spread_bwd": 0}
#: Per wrapper, the kernel it counts, as a profiler trace names it (the
#: forward's second kernel, the fold, is not counted).
SYMBOLS = {"spread_fwd": "spread_patch_kernel",
           "spread_bwd": "spread_bwd_kernel"}
native.declare(cf_spread_limits=[INT_OUT] * 3,
               cf_spread_fwd=[PTR] * 7 + [INT] * 8 + [PTR],
               cf_spread_bwd=[PTR] * 9 + [INT] * 7 + [PTR])


def _placements(zorg, order: int, gz: int):
    """[n_col, order, rows] mesh index (zorg + k) mod Gz of every tap."""
    k = torch.arange(order, device=zorg.device, dtype=zorg.dtype)
    return torch.remainder(zorg + k.view(1, order, 1), gz).long()


def _expand_z(wzt, zorg, gz):
    """Dense z weights [n_col, rows, Gz] from the compact taps."""
    n_col, order, rows = wzt.shape
    idx = _placements(zorg, order, gz).transpose(1, 2)      # [n_col, rows, k]
    out = torch.zeros((n_col, rows, gz), dtype=wzt.dtype, device=wzt.device)
    return out.scatter(2, idx, wzt.transpose(1, 2))


def _a2(qwlxt, wlyt):
    n_col, wx, rows = qwlxt.shape
    return (qwlxt[:, :, None, :] * wlyt[:, None, :, :]).reshape(
        n_col, wx * wlyt.shape[1], rows)


def spread_fwd_plain(qwlxt, wlyt, wzt, zorg, offsets, pad_xy):
    """Qpad [Px, Py, Gz]: each column's patch (q w_x) (x) w_y @ Wz placed at
    its (ox, oy) offset; patches are added in column order."""
    n_col, wx, rows = qwlxt.shape
    wyp = wlyt.shape[1]
    px, py, gz = pad_xy
    p = ieee_matmul(_a2(qwlxt, wlyt), _expand_z(wzt, zorg, gz)).reshape(
        n_col, wx, wyp, gz)
    qpad = torch.zeros((px, py, gz), dtype=qwlxt.dtype, device=qwlxt.device)
    for c, (ox, oy) in enumerate(zip(*offsets)):
        qpad[ox:ox + wx, oy:oy + wyp] += p[c]
    return qpad


def spread_bwd_plain(qwlxt, wlyt, wzt, zorg, offsets, ct):
    """Cotangents (d_qwlxt, d_wlyt, d_wzt) of :func:`spread_fwd_plain`
    for the mesh cotangent ``ct`` [Px, Py, Gz]."""
    n_col, wx, rows = qwlxt.shape
    wyp = wlyt.shape[1]
    order = wzt.shape[1]
    gz = ct.shape[2]
    dp = torch.stack([ct[ox:ox + wx, oy:oy + wyp]
                      for ox, oy in zip(*offsets)]).reshape(n_col, wx * wyp, gz)
    a2 = _a2(qwlxt, wlyt)
    d_dense = ieee_matmul(a2.transpose(1, 2), dp)          # [n_col, rows, Gz]
    d_wzt = torch.gather(d_dense, 2, _placements(zorg, order, gz).transpose(
        1, 2)).transpose(1, 2)
    d_a2 = ieee_matmul(dp, _expand_z(wzt, zorg, gz).transpose(1, 2)).reshape(
        n_col, wx, wyp, rows)
    d_qwlxt = torch.sum(d_a2 * wlyt[:, None, :, :], dim=2)
    d_wlyt = torch.sum(d_a2 * qwlxt[:, :, None, :], dim=1)
    return d_qwlxt, d_wlyt, d_wzt.contiguous()


def _refusal(named, wx: int, wyp: int, order: int, gz=None):
    """Why a spread kernel cannot take float inputs ``named``, (name,
    dtype, device) triples, at patch width Wx, height Wyp and spline
    order: the forward's conditions with its mesh depth ``gz``, the
    backward's with ``gz=None``.  (exception class, message), or None; it
    reads types, devices and sizes only."""
    for name, dtype, device in named:
        if torch.device(device).type != "cuda" or dtype != torch.float32:
            return TypeError, (f"spread kernel: {name} must be a float32 "
                               f"CUDA tensor (got {dtype} on {device}); the "
                               f"plain version serves other types")
    max_wy, max_order, max_wx = native.limits("cf_spread_limits", 3)
    if wyp > max_wy or order > max_order:
        return ValueError, (f"spread kernel: needs Wyp <= {max_wy} and a "
                            f"spline order <= {max_order} (got {wyp}, "
                            f"{order})")
    if gz is not None and gz < 8:
        return ValueError, f"spread kernel: needs Gz >= 8 (got {gz})"
    if gz is None and wx > max_wx:
        return ValueError, (f"spread backward kernel: needs Wx <= {max_wx} "
                            f"(got {wx}), its shared-memory tile")
    return None


def _named(*pairs):
    return [(name, t.dtype, t.device) for name, t in pairs]


def _check(qwlxt, wlyt, wzt, zorg, offsets, pad_xy, extra=()):
    """Raise unless every input is what the kernel takes: the forward's
    with ``pad_xy`` (Px, Py, Gz), the backward's with (Px, Py)."""
    n_col, wx, rows = qwlxt.shape
    wyp, order = wlyt.shape[1], wzt.shape[1]
    named = (("qwlxt", qwlxt), ("wlyt", wlyt), ("wzt", wzt), *extra)
    refusal = _refusal(_named(*named), wx, wyp, order,
                       pad_xy[2] if len(pad_xy) > 2 else None)
    if refusal is not None:
        raise refusal[0](refusal[1])
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"spread kernel: {name} must be contiguous")
    if wlyt.shape != (n_col, wyp, rows) or wzt.shape != (n_col, order, rows):
        raise ValueError("spread kernel: wlyt/wzt shapes do not match qwlxt")
    if (zorg.dtype != torch.int32 or not zorg.is_contiguous()
            or zorg.shape != (n_col, 1, rows) or zorg.device != qwlxt.device):
        raise ValueError("spread kernel: zorg must be contiguous int32 "
                         "[n_col, 1, rows] on the device of the weights")
    if len(offsets) != 2 or any(len(o) != n_col for o in offsets):
        raise ValueError("spread kernel: offsets must be ((ox...), (oy...)) "
                         "with one entry per column")
    if (min(map(min, offsets)) < 0 or max(offsets[0]) + wx > pad_xy[0]
            or max(offsets[1]) + wyp > pad_xy[1]):
        raise ValueError("spread kernel: a column patch leaves the padded "
                         "mesh")


def spread_fwd(qwlxt, wlyt, wzt, zorg, offsets, pad_xy):
    """Forward spread: plain version on the CPU, the CUDA kernel on the
    card."""
    if qwlxt.device.type == "cpu":
        return spread_fwd_plain(qwlxt, wlyt, wzt, zorg, offsets, pad_xy)
    px, py, gz = (int(v) for v in pad_xy)
    _check(qwlxt, wlyt, wzt, zorg, offsets, (px, py, gz))
    n_col, wx, rows = qwlxt.shape
    wyp, order = wlyt.shape[1], wzt.shape[1]
    dev = qwlxt.device
    scratch = torch.empty((n_col, wx, wyp, gz), dtype=torch.float32,
                          device=dev)
    qpad = torch.empty((px, py, gz), dtype=torch.float32, device=dev)
    err = native.library().cf_spread_fwd(
        *(t.data_ptr() for t in (qwlxt, wlyt, wzt, zorg,
                                 constant(offsets, torch.int32, dev), scratch,
                                 qpad)),
        n_col, wx, wyp, order, rows, px, py, gz, native.stream_ptr(qwlxt))
    native.check(err, "cf_spread_fwd")
    LAUNCHES["spread_fwd"] += 1
    return qpad


def spread_bwd(qwlxt, wlyt, wzt, zorg, offsets, ct):
    """Backward spread: plain version on the CPU, the CUDA kernel on the
    card."""
    if qwlxt.device.type == "cpu":
        return spread_bwd_plain(qwlxt, wlyt, wzt, zorg, offsets, ct)
    px, py, gz = ct.shape
    _check(qwlxt, wlyt, wzt, zorg, offsets, (px, py), extra=(("ct", ct),))
    n_col, wx, rows = qwlxt.shape
    wyp, order = wlyt.shape[1], wzt.shape[1]
    d_qwlxt = torch.empty_like(qwlxt)
    d_wlyt = torch.empty_like(wlyt)
    d_wzt = torch.empty_like(wzt)
    err = native.library().cf_spread_bwd(
        *(t.data_ptr() for t in (qwlxt, wlyt, wzt, zorg,
                                 constant(offsets, torch.int32, qwlxt.device), ct,
                                 d_qwlxt, d_wlyt, d_wzt)),
        n_col, wx, wyp, order, rows, py, gz, native.stream_ptr(qwlxt))
    native.check(err, "cf_spread_bwd")
    LAUNCHES["spread_bwd"] += 1
    return d_qwlxt, d_wlyt, d_wzt


class _SpreadColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qwlxt, wlyt, wzt, zorg, offsets, pad_xy, plain):
        ctx.save_for_backward(qwlxt, wlyt, wzt, zorg)
        ctx.offsets, ctx.plain = offsets, plain
        fwd = spread_fwd_plain if plain else spread_fwd
        return fwd(qwlxt, wlyt, wzt, zorg, offsets, pad_xy)

    @staticmethod
    def backward(ctx, ct):
        qwlxt, wlyt, wzt, zorg = ctx.saved_tensors
        bwd = spread_bwd_plain if ctx.plain else spread_bwd
        d = bwd(qwlxt, wlyt, wzt, zorg, ctx.offsets, ct.contiguous())
        return (*d, None, None, None, None)


def spread_columns(qwlxt, wlyt, wzt, zorg, offsets, pad_xy,
                   plain: bool = False):
    """Spread per-column patches onto an x/y-padded mesh (differentiable in
    the three weight tensors).

    qwlxt/wlyt [n_col, Wx|Wyp, rows]: transposed compact x/y spline
    weights (qwlxt carries the charges; wlyt zero-padded to Wyp rows);
    wzt [n_col, order, rows] compact z taps with int32 origins zorg
    [n_col, 1, rows] (mod Gz); offsets ((ox...), (oy...)) per column into
    the padded mesh; pad_xy (Px, Py, Gz).  Returns Qpad [Px, Py, Gz].
    """
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    pad_xy = tuple(int(v) for v in pad_xy)
    return _SpreadColumns.apply(qwlxt, wlyt, wzt, zorg, offsets, pad_xy,
                                plain)


def _pad_along(t, axis, before, after):
    pad = [0, 0] * t.ndim
    k = 2 * (t.ndim - 1 - axis)
    pad[k], pad[k + 1] = before, after
    return F.pad(t, pad)


def fold_padded_axis(qpad, grid_n: int, order: int, axis: int):
    """Wrap-fold one padded axis back onto the mesh: padded index p maps
    to mesh index (p - order) mod grid_n (the pad extents are < grid_n)."""
    pn = qpad.shape[axis]
    core = qpad.narrow(axis, order, grid_n)
    lo = qpad.narrow(axis, 0, order)                  # p < order -> tail
    core = core + _pad_along(lo, axis, grid_n - order, 0)
    if pn > order + grid_n:                           # head wrap
        hi = qpad.narrow(axis, order + grid_n, pn - order - grid_n)
        core = core + _pad_along(hi, axis, 0, grid_n - hi.shape[axis])
    return core
