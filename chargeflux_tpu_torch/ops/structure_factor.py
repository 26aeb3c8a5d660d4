"""Classical-Ewald structure-factor contraction: the CUDA kernel wrappers and
their plain-PyTorch versions.

Counterpart of ``chargeflux_tpu.ops.pallas_recip`` (``make_structure_factor_fn``).
:func:`structure_factor` is an autograd function

    A = cxy @ zq,   B = sxy @ zq,   [Kx*Ky, 2Kz]
    cxy[(kx, ky), n] = cx[kx, n] cy[ky, n] - sx[kx, n] sy[ky, n]
    sxy[(kx, ky), n] = sx[kx, n] cy[ky, n] + cx[kx, n] sy[ky, n]

over the transposed per-axis phase tables cxT/sxT [Kx, N], cyT/syT [Ky, N]
and the charge-folded z table zq = q [cos_z | sin_z] [N, 2Kz].  Its forward
and the two halves of its backward each go through a wrapper — ``sf_fwd``,
``sf_bwd_tables`` (cotangents of the four phase tables) and ``sf_bwd_zq``
(cotangent of zq): on a CPU tensor the wrapper runs the plain version; on a
CUDA tensor it launches the kernel in ``csrc/structure_factor.cu`` or
raises.  ``plain=True`` runs the plain versions on any device (the
reference the kernels are checked against on the card).  The TPU layout
padding (Ky to a multiple of 8, N to a multiple of 128) is not carried
over: every shape is taken as it is.  :func:`kernels_take_grid` tells
``recip_method="auto"`` whether the kernels take a k grid.
"""

from __future__ import annotations

import torch

from . import native

#: Kernel launches since the last reset, per wrapper.
LAUNCHES = {"sf_fwd": 0, "sf_bwd_tables": 0, "sf_bwd_zq": 0}


def xy_tables(cxT, sxT, cyT, syT):
    """(cxy, sxy), each [Kx*Ky, N]: the combined x/y phase tables."""
    kx, n = cxT.shape
    ky = cyT.shape[0]
    cxy = cxT[:, None, :] * cyT[None, :, :] - sxT[:, None, :] * syT[None, :, :]
    sxy = sxT[:, None, :] * cyT[None, :, :] + cxT[:, None, :] * syT[None, :, :]
    return cxy.reshape(kx * ky, n), sxy.reshape(kx * ky, n)


def sf_fwd_plain(cxT, sxT, cyT, syT, zq):
    """(A, B) = (cxy @ zq, sxy @ zq)."""
    cxy, sxy = xy_tables(cxT, sxT, cyT, syT)
    return cxy @ zq, sxy @ zq


def sf_bwd_tables_plain(cxT, sxT, cyT, syT, zq, abar, bbar):
    """(dcxT, dsxT, dcyT, dsyT) for the cotangents (abar, bbar) of (A, B):
    with gc = abar zq^T and gs = bbar zq^T per (kx, ky, n), reduced over ky
    for the x tables and over kx for the y tables."""
    kx, n = cxT.shape
    ky = cyT.shape[0]
    gc = (abar @ zq.T).reshape(kx, ky, n)
    gs = (bbar @ zq.T).reshape(kx, ky, n)
    dcx = torch.sum(gc * cyT[None] + gs * syT[None], dim=1)
    dsx = torch.sum(-gc * syT[None] + gs * cyT[None], dim=1)
    dcy = torch.sum(gc * cxT[:, None] + gs * sxT[:, None], dim=0)
    dsy = torch.sum(-gc * sxT[:, None] + gs * cxT[:, None], dim=0)
    return dcx, dsx, dcy, dsy


def sf_bwd_zq_plain(cxT, sxT, cyT, syT, abar, bbar):
    """dzq = cxy^T abar + sxy^T bbar, [N, 2Kz]."""
    cxy, sxy = xy_tables(cxT, sxT, cyT, syT)
    return cxy.T @ abar + sxy.T @ bbar


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
    max_ky, max_kz2, _ = native.limits("cf_sf_limits", 3)
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
    """Raise unless every input is what the kernels take; returns
    (Kx, Ky, 2Kz, N)."""
    kx, n = cxT.shape
    ky = cyT.shape[0]
    named = [("cxT", cxT), ("sxT", sxT), ("cyT", cyT), ("syT", syT)]
    named += [(k, t) for k, t in (("zq", zq), ("abar", abar), ("bbar", bbar))
              if t is not None]
    kz2 = (zq if zq is not None else abar).shape[1]
    refusal = _refusal([(k, t.dtype, t.device) for k, t in named], ky, kz2, n)
    if refusal is not None:
        raise refusal[0](refusal[1])
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"structure-factor kernel: {name} must be "
                             f"contiguous")
        if t.device != cxT.device:
            raise ValueError("structure-factor kernel: inputs on different "
                             "devices")
    if sxT.shape != (kx, n) or cyT.shape != (ky, n) or syT.shape != (ky, n):
        raise ValueError("structure-factor kernel: the phase tables must be "
                         "cxT/sxT [Kx, N] and cyT/syT [Ky, N]")
    if zq is not None and zq.shape != (n, kz2):
        raise ValueError("structure-factor kernel: zq must be [N, 2Kz]")
    for t in (abar, bbar):
        if t is not None and t.shape != (kx * ky, kz2):
            raise ValueError("structure-factor kernel: abar/bbar must be "
                             "[Kx*Ky, 2Kz]")
    return kx, ky, kz2, n


def sf_fwd(cxT, sxT, cyT, syT, zq):
    """Forward contraction: plain version on the CPU, the CUDA kernel on the
    card."""
    if cxT.device.type == "cpu":
        return sf_fwd_plain(cxT, sxT, cyT, syT, zq)
    kx, ky, kz2, n = _check(cxT, sxT, cyT, syT, zq=zq)
    dev = cxT.device
    n_chunks = -(-n // native.limits("cf_sf_limits", 3)[2])
    partial = torch.empty((2, n_chunks, kx * ky, kz2), dtype=torch.float32,
                          device=dev)
    a = torch.empty((kx * ky, kz2), dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    err = native.library().cf_sf_fwd(
        *(t.data_ptr() for t in (cxT, sxT, cyT, syT, zq, partial, a, b)),
        kx, ky, kz2, n, native.stream_ptr(cxT))
    native.check(err, "cf_sf_fwd")
    LAUNCHES["sf_fwd"] += 1
    return a, b


def sf_bwd_tables(cxT, sxT, cyT, syT, zq, abar, bbar):
    """Phase-table cotangents: plain version on the CPU, the CUDA kernel on
    the card."""
    if cxT.device.type == "cpu":
        return sf_bwd_tables_plain(cxT, sxT, cyT, syT, zq, abar, bbar)
    kx, ky, kz2, n = _check(cxT, sxT, cyT, syT, zq=zq, abar=abar, bbar=bbar)
    outs = [torch.empty_like(t) for t in (cxT, sxT, cyT, syT)]
    err = native.library().cf_sf_bwd_tables(
        *(t.data_ptr() for t in (cxT, sxT, cyT, syT, zq, abar, bbar, *outs)),
        kx, ky, kz2, n, native.stream_ptr(cxT))
    native.check(err, "cf_sf_bwd_tables")
    LAUNCHES["sf_bwd_tables"] += 1
    return tuple(outs)


def sf_bwd_zq(cxT, sxT, cyT, syT, abar, bbar):
    """zq cotangent: plain version on the CPU, the CUDA kernel on the
    card."""
    if cxT.device.type == "cpu":
        return sf_bwd_zq_plain(cxT, sxT, cyT, syT, abar, bbar)
    kx, ky, kz2, n = _check(cxT, sxT, cyT, syT, abar=abar, bbar=bbar)
    dzq = torch.empty((n, kz2), dtype=torch.float32, device=cxT.device)
    err = native.library().cf_sf_bwd_zq(
        *(t.data_ptr() for t in (cxT, sxT, cyT, syT, abar, bbar, dzq)),
        kx, ky, kz2, n, native.stream_ptr(cxT))
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
    """(A, B) [Kx*Ky, 2Kz], differentiable in all five tables (see the
    module docstring for the contraction and the layouts)."""
    return _StructureFactor.apply(cxT, sxT, cyT, syT, zq, plain)
