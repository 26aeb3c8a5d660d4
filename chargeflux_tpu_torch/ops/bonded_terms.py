"""The templated harmonic bonds and angles: the CUDA kernel wrappers of one
molecule template, and the plain-PyTorch chain they are held to.

:func:`template_bonded_energy` is the bond and angle energy of one
template block (``topology.MoleculeTemplate``: ``count`` copies of a
``stride``-atom molecule, each with the same local bond and angle rows and
its own k, r0 and theta0), differentiable in the positions.  Its forward
and backward each go through a wrapper: on a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel in
``csrc/bonded_terms.cu`` or raises.

The plain version, :func:`bonded_fwd_plain`, is the per-row chain of
slices (:func:`_bond_e` and :func:`_angle_e`) that ``bonded.bonded_energy``
runs wherever the kernels do not: the plain route (the CPU, f64,
``with_kernel_route("plain")``), a [3, 3] lattice, a box that requires
grad (the pressure's ``npt._box_grad_potential``) and leading replica
axes.  The remainder rows and the torsions (no template) take
``bonded.bonded_energy``'s gather.

Replaces no Pallas kernel: the JAX package evaluates the same rows as jnp
slices that XLA fuses into one loop; eagerly the chain is some 146 small
compute launches per forward plus backward, whatever N, and the kernels
are three (``csrc/bonded_terms.cu`` says how).
"""

from __future__ import annotations

import torch

from . import native
from .native import INT, PTR
from ..device import constant
from ..pairs import displacement

#: Kernel launches since the last reset, per wrapper.
LAUNCHES = {"bonded_fwd": 0, "bonded_bwd": 0}
#: Per wrapper, the kernel it counts, as a profiler trace names it.
SYMBOLS = {"bonded_fwd": "bonded_terms_fwd_kernel",
           "bonded_bwd": "bonded_terms_bwd_kernel"}
native.declare(
    cf_bonded_limits=[native.INT_OUT],
    cf_bonded_fwd=[PTR] * 7 + [INT] * 9 + [PTR] * 3,
    cf_bonded_bwd=[PTR] * 7 + [INT] * 9 + [PTR] * 3)


def _bond_e(p1, p2, k, r0, box, pbc):
    d = displacement(p1, p2, box, pbc)
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    return 0.5 * torch.sum(k * (r - r0) ** 2, dim=-1)


def _angle_e(p1, p2, p3, k, theta0, box, pbc):
    d21 = displacement(p2, p1, box, pbc)
    d23 = displacement(p2, p3, box, pbc)
    r21 = torch.sqrt(torch.sum(d21 * d21, dim=-1))
    r23 = torch.sqrt(torch.sum(d23 * d23, dim=-1))
    cost = torch.sum(d21 * d23, dim=-1) / (r21 * r23)
    theta = torch.arccos(torch.clamp(cost, -1.0, 1.0))
    return 0.5 * torch.sum(k * (theta - theta0) ** 2, dim=-1)


def bonded_fwd_plain(positions, bond_k, bond_r0, angle_k, angle_theta0, box,
                     tpl, b0, a0, pbc, total=None):
    """``total`` (0 when None) plus the bond and angle energy of template
    ``tpl`` in plain tensor ops (any device), one row at a time over static
    slices; its molecules' k and r0 start at entry ``b0`` of ``bond_k`` and
    ``bond_r0``, their k and theta0 at ``a0`` of ``angle_k`` and
    ``angle_theta0``; positions [..., N, 3] may carry leading replica
    axes."""
    off, s, c = tpl.offset, tpl.stride, tpl.count
    lead = positions.shape[:-2]
    pos_m = positions[..., off:off + c * s, :].reshape(lead + (c, s, 3))
    p = [pos_m[..., l, :] for l in range(s)]
    if total is None:
        total = torch.zeros((), dtype=positions.dtype,
                            device=positions.device)
    rows = tpl.local_rows("bonds")
    if rows:
        m = len(rows)
        k = bond_k[b0:b0 + c * m].reshape(c, m)
        r0 = bond_r0[b0:b0 + c * m].reshape(c, m)
        for t, (l1, l2) in enumerate(rows):
            total = total + _bond_e(p[l1], p[l2], k[:, t], r0[:, t], box,
                                    pbc)
    rows = tpl.local_rows("angles")
    if rows:
        m = len(rows)
        k = angle_k[a0:a0 + c * m].reshape(c, m)
        t0 = angle_theta0[a0:a0 + c * m].reshape(c, m)
        for t, (l1, l2, l3) in enumerate(rows):
            total = total + _angle_e(p[l1], p[l2], p[l3], k[:, t], t0[:, t],
                                     box, pbc)
    return total


def bonded_bwd_plain(positions, bond_k, bond_r0, angle_k, angle_theta0, box,
                     tpl, b0, a0, pbc, ct):
    """ct dE/dx [N, 3] of :func:`bonded_fwd_plain` (zero outside the
    template's atoms), by autograd through the chain (any device)."""
    with torch.enable_grad():
        x = positions.detach().requires_grad_(True)
        e = bonded_fwd_plain(x, bond_k, bond_r0, angle_k, angle_theta0, box,
                             tpl, b0, a0, pbc)
        (g,) = torch.autograd.grad(e, x, ct)
        return g


def _refusal(named):
    """Why the kernels cannot take float inputs ``named``, (name, dtype,
    device) triples: (exception class, message), or None; it reads types
    and devices only."""
    for name, dtype, device in named:
        if torch.device(device).type != "cuda" or dtype != torch.float32:
            return TypeError, (f"bonded kernel: {name} must be a float32 "
                               f"CUDA tensor (got {dtype} on {device}); the "
                               f"plain version serves other types")
    return None


def _rows(tpl):
    return len(tpl.local_rows("bonds")), len(tpl.local_rows("angles"))


def _check(positions, bond_k, bond_r0, angle_k, angle_theta0, box, tpl, b0,
           a0, pbc, ct=None):
    """Raise unless every input is what the kernels take."""
    floats = (("positions", positions), ("bond_k", bond_k),
              ("bond_r0", bond_r0), ("angle_k", angle_k),
              ("angle_theta0", angle_theta0), ("box", box),
              *((("ct", ct),) if ct is not None else ()))
    refusal = _refusal([(n, t.dtype, t.device) for n, t in floats])
    if refusal is not None:
        raise refusal[0](refusal[1])
    for name, t in floats:
        if not t.is_contiguous():
            raise ValueError(f"bonded kernel: {name} must be contiguous")
        if t.device != positions.device:
            raise ValueError(f"bonded kernel: {name} is not on "
                             f"{positions.device}")
    n = positions.shape[0]
    if positions.shape != (n, 3):
        raise ValueError("bonded kernel: positions must be [N, 3] (no "
                         "replica axes)")
    if (pbc and box.shape != (3,)) or (ct is not None and ct.numel() != 1):
        raise ValueError("bonded kernel: box must be [3] (a [3, 3] lattice "
                         "takes the plain chain) and ct one value")
    n_b, n_a = _rows(tpl)
    if (tpl.offset < 0 or tpl.offset + tpl.count * tpl.stride > n
            or n_b + n_a == 0):
        raise ValueError("bonded kernel: the template's atoms lie outside "
                         "the positions, or it has no bond or angle row")
    for name, t, start, m in (("bond", bond_k, b0, n_b),
                              ("bond", bond_r0, b0, n_b),
                              ("angle", angle_k, a0, n_a),
                              ("angle", angle_theta0, a0, n_a)):
        if t.ndim != 1 or start < 0 or start + tpl.count * m > t.shape[0]:
            raise ValueError(f"bonded kernel: the template's {name} "
                             f"parameters lie outside their arrays")


def _args(positions, bond_k, bond_r0, angle_k, angle_theta0, box, tpl, b0,
          a0, pbc):
    n_b, n_a = _rows(tpl)
    flat = [i for row in tpl.local_rows("bonds") + tpl.local_rows("angles")
            for i in row]
    rows = constant(flat, torch.int32, positions.device)
    return (*(t.data_ptr() for t in (positions, bond_k, bond_r0, angle_k,
                                     angle_theta0, box, rows)),
            positions.shape[0], tpl.offset, tpl.stride, tpl.count, n_b, n_a,
            b0, a0, int(pbc))


def bonded_fwd(positions, bond_k, bond_r0, angle_k, angle_theta0, box, tpl,
               b0, a0, pbc):
    """Forward: plain version on the CPU, the CUDA kernel on the card."""
    args = (positions, bond_k, bond_r0, angle_k, angle_theta0, box, tpl, b0,
            a0, pbc)
    if positions.device.type == "cpu":
        return bonded_fwd_plain(*args)
    _check(*args)
    (threads,) = native.limits("cf_bonded_limits", 1)
    partials = torch.empty((tpl.count + threads - 1) // threads,
                           dtype=torch.float64, device=positions.device)
    energy = positions.new_empty(())
    err = native.library().cf_bonded_fwd(
        *_args(*args), partials.data_ptr(), energy.data_ptr(),
        native.stream_ptr(positions))
    native.check(err, "cf_bonded_fwd")
    LAUNCHES["bonded_fwd"] += 1
    return energy


def bonded_bwd(positions, bond_k, bond_r0, angle_k, angle_theta0, box, tpl,
               b0, a0, pbc, ct):
    """Backward: plain version on the CPU, the CUDA kernel on the card."""
    args = (positions, bond_k, bond_r0, angle_k, angle_theta0, box, tpl, b0,
            a0, pbc)
    if positions.device.type == "cpu":
        return bonded_bwd_plain(*args, ct)
    _check(*args, ct)
    g_x = torch.empty_like(positions)
    err = native.library().cf_bonded_bwd(
        *_args(*args), ct.data_ptr(), g_x.data_ptr(),
        native.stream_ptr(positions))
    native.check(err, "cf_bonded_bwd")
    LAUNCHES["bonded_bwd"] += 1
    return g_x


class _TemplateBonded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, bond_k, bond_r0, angle_k, angle_theta0, box,
                tpl, b0, a0, pbc):
        args = tuple(t.contiguous() for t in (positions, bond_k, bond_r0,
                                              angle_k, angle_theta0, box))
        ctx.save_for_backward(*args)
        ctx.static = (tpl, b0, a0, pbc)
        return bonded_fwd(*args, *ctx.static)

    @staticmethod
    def backward(ctx, ct):
        if any(ctx.needs_input_grad[1:6]):
            raise RuntimeError("bonded terms: no cotangent for k, r0, theta0 "
                               "or the box on this route (a box that "
                               "requires grad takes the plain chain)")
        g_x = bonded_bwd(*ctx.saved_tensors, *ctx.static, ct.contiguous())
        return (g_x,) + (None,) * 9


def template_bonded_energy(positions, bond_k, bond_r0, angle_k, angle_theta0,
                           box, tpl, b0: int, a0: int, pbc: bool):
    """The bond and angle energy of template ``tpl`` (differentiable in
    ``positions`` [N, 3]; no cotangent for the parameters or the box [3],
    which is read on the device, so a captured graph follows a box that
    changes between replays; with ``pbc`` False it is not read).  The
    template's molecules take their k and r0 from entry ``b0`` of
    ``bond_k`` and ``bond_r0`` on, their k and theta0 from entry ``a0`` of
    ``angle_k`` and ``angle_theta0`` on, molecule-major."""
    return _TemplateBonded.apply(positions, bond_k, bond_r0, angle_k,
                                 angle_theta0, box, tpl, b0, a0, pbc)
