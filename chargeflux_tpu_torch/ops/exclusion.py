"""The excluded pairs' energy correction: the CUDA kernel wrappers of one
molecule template, and the plain-PyTorch chain they are held to.

:func:`template_exclusion_energy` is the correction of one template block
(``topology.MoleculeTemplate``: ``count`` copies of a ``stride``-atom
molecule, each with the same local exclusion rows), differentiable in the
positions and charges.  Its forward and backward each go through a
wrapper: on a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel in ``csrc/exclusion_pairs.cu`` or raises.

The plain version, :func:`exclusion_fwd_plain`, is the per-row chain of
slices (:func:`pair_terms` with ``template=True``) that
``energy._exclusion_correction`` runs wherever the kernels do not: the
plain route (the CPU, f64, ``with_kernel_route("plain")``), a [3, 3]
lattice, a box that requires grad (the pressure's
``npt._box_grad_potential``) and leading replica axes.  The remainder rows
(no template) go through :func:`pair_terms` with ``template=False``.

Replaces no Pallas kernel: the JAX package evaluates the same rows as jnp
slices that XLA fuses into one loop; eagerly the chain is some 410 small
launches per forward plus backward, whatever N, and the kernels are one
launch each way (``csrc/exclusion_pairs.cu`` says how).
"""

from __future__ import annotations

import torch

from . import native
from .native import FLOAT, INT, INT_OUT, PTR
from ..device import constant
from ..pairs import displacement
from ..units import ONE_4PI_EPS0
from .erfc import erfc_fast

#: Kernel launches since the last reset, per wrapper.
LAUNCHES = {"exclusion_fwd": 0, "exclusion_bwd": 0}
#: Per wrapper, the kernel it counts, as a profiler trace names it.
SYMBOLS = {"exclusion_fwd": "exclusion_pairs_fwd_kernel",
           "exclusion_bwd": "exclusion_pairs_bwd_kernel"}
native.declare(
    cf_exclusion_limits=[INT_OUT],
    cf_exclusion_fwd=[PTR] * 6 + [INT] * 5 + [FLOAT] * 3 + [INT] + [PTR] * 3,
    cf_exclusion_bwd=[PTR] * 6 + [INT] * 5 + [FLOAT] * 3 + [INT] + [PTR] * 4)


def lj_pair_terms(half_sig_sum, eps_prod, inv_r):
    """Prefactored LJ: e * s6 * (s6 - 1) == 4 eps [(sig/r)^12 - (sig/r)^6]."""
    sig2 = (half_sig_sum * inv_r) ** 2
    sig6 = sig2 * sig2 * sig2
    return eps_prod * sig6 * (sig6 - 1.0)


def excl_pair_energy(r, inv_r, qq, half_sig, eps, spec, subtract_direct):
    """Per-pair exclusion correction: always -erf(ar)/r Coulomb; with
    ``subtract_direct`` also remove the erfc/r + LJ the direct walk
    counted inside the cutoff."""
    erfc_ar = erfc_fast(spec.alpha * r)
    e = -ONE_4PI_EPS0 * qq * inv_r * (1.0 - erfc_ar)
    if subtract_direct:
        in_cut = r < spec.cutoff
        direct = (ONE_4PI_EPS0 * qq * inv_r * erfc_ar
                  + lj_pair_terms(half_sig, eps, inv_r))
        e = e - torch.where(in_cut, direct, 0.0)
    return torch.sum(e, dim=-1)


def pair_terms(p1, p2, q1, q2, s1, s2, e1, e2, box, spec, subtract_direct,
               template: bool):
    """The summed correction of pair rows: ends 1 and 2, their charges,
    sigmas and epsilons (rows on the last axis)."""
    d = displacement(p1, p2, box, spec.pbc)
    r2 = torch.sum(d * d, dim=-1)
    if template:
        inv_r = torch.rsqrt(r2)
        r = r2 * inv_r
    else:
        r = torch.sqrt(r2)
        inv_r = 1.0 / r
    return excl_pair_energy(r, inv_r, q1 * q2, 0.5 * (s1 + s2),
                            4.0 * torch.sqrt(e1 * e2), spec,
                            subtract_direct)


def exclusion_fwd_plain(positions, q, sigma, epsilon, box, tpl, spec,
                        subtract_direct, total=None):
    """``total`` (0 when None) plus the correction of template ``tpl``'s
    rows in plain tensor ops (any device), one row at a time over static
    slices; positions [..., N, 3] and charges [..., N] may carry leading
    replica axes."""
    off, s, c = tpl.offset, tpl.stride, tpl.count
    sl = slice(off, off + c * s)
    lead = positions.shape[:-2]
    pos_m = positions[..., sl, :].reshape(lead + (c, s, 3))
    q_m = q[..., sl].reshape(lead + (c, s))
    sig_m = sigma[sl].reshape(c, s)
    eps_m = epsilon[sl].reshape(c, s)
    if total is None:
        total = torch.zeros((), dtype=positions.dtype,
                            device=positions.device)
    for (l1, l2) in tpl.local_rows("exclusions"):
        total = total + pair_terms(
            pos_m[..., l1, :], pos_m[..., l2, :], q_m[..., l1], q_m[..., l2],
            sig_m[:, l1], sig_m[:, l2], eps_m[:, l1], eps_m[:, l2], box,
            spec, subtract_direct, template=True)
    return total


def exclusion_bwd_plain(positions, q, sigma, epsilon, box, tpl, spec,
                        subtract_direct, ct):
    """(ct dE/dx, ct dE/dq) of :func:`exclusion_fwd_plain`, by autograd
    through the chain (any device)."""
    with torch.enable_grad():
        x = positions.detach().requires_grad_(True)
        qg = q.detach().requires_grad_(True)
        e = exclusion_fwd_plain(x, qg, sigma, epsilon, box, tpl, spec,
                                subtract_direct)
        return torch.autograd.grad(e, (x, qg), ct)


def _refusal(named):
    """Why the kernels cannot take float inputs ``named``, (name, dtype,
    device) triples: (exception class, message), or None; it reads types
    and devices only."""
    for name, dtype, device in named:
        if torch.device(device).type != "cuda" or dtype != torch.float32:
            return TypeError, (f"exclusion kernel: {name} must be a float32 "
                               f"CUDA tensor (got {dtype} on {device}); the "
                               f"plain version serves other types")
    return None


def _check(positions, q, sigma, epsilon, box, tpl, ct=None):
    """Raise unless every input is what the kernels take."""
    floats = (("positions", positions), ("q", q), ("sigma", sigma),
              ("epsilon", epsilon), ("box", box),
              *((("ct", ct),) if ct is not None else ()))
    refusal = _refusal([(n, t.dtype, t.device) for n, t in floats])
    if refusal is not None:
        raise refusal[0](refusal[1])
    for name, t in floats:
        if not t.is_contiguous():
            raise ValueError(f"exclusion kernel: {name} must be contiguous")
        if t.device != positions.device:
            raise ValueError(f"exclusion kernel: {name} is not on "
                             f"{positions.device}")
    n = positions.shape[0]
    if positions.shape != (n, 3) or any(t.shape != (n,)
                                        for t in (q, sigma, epsilon)):
        raise ValueError("exclusion kernel: positions must be [N, 3] and q, "
                         "sigma, epsilon [N] (no replica axes)")
    if box.shape != (3,) or (ct is not None and ct.numel() != 1):
        raise ValueError("exclusion kernel: box must be [3] (a [3, 3] "
                         "lattice takes the plain chain) and ct one value")
    if tpl.offset < 0 or tpl.offset + tpl.count * tpl.stride > n:
        raise ValueError("exclusion kernel: the template's atoms lie outside "
                         "the positions")


def _args(positions, q, sigma, epsilon, box, tpl, spec, subtract_direct):
    rows = constant(tpl.local_rows("exclusions"), torch.int32,
                    positions.device)
    return (*(t.data_ptr() for t in (positions, q, sigma, epsilon, box,
                                     rows)),
            positions.shape[0], tpl.offset, tpl.stride, tpl.count,
            rows.shape[0], spec.alpha, spec.cutoff, ONE_4PI_EPS0,
            int(subtract_direct))


def exclusion_fwd(positions, q, sigma, epsilon, box, tpl, spec,
                  subtract_direct):
    """Forward: plain version on the CPU, the CUDA kernel on the card."""
    if positions.device.type == "cpu":
        return exclusion_fwd_plain(positions, q, sigma, epsilon, box, tpl,
                                   spec, subtract_direct)
    _check(positions, q, sigma, epsilon, box, tpl)
    (threads,) = native.limits("cf_exclusion_limits", 1)
    partials = torch.empty((tpl.count + threads - 1) // threads,
                           dtype=torch.float64, device=positions.device)
    energy = positions.new_empty(())
    err = native.library().cf_exclusion_fwd(
        *_args(positions, q, sigma, epsilon, box, tpl, spec,
               subtract_direct),
        partials.data_ptr(), energy.data_ptr(), native.stream_ptr(positions))
    native.check(err, "cf_exclusion_fwd")
    LAUNCHES["exclusion_fwd"] += 1
    return energy


def exclusion_bwd(positions, q, sigma, epsilon, box, tpl, spec,
                  subtract_direct, ct):
    """Backward: plain version on the CPU, the CUDA kernel on the card."""
    if positions.device.type == "cpu":
        return exclusion_bwd_plain(positions, q, sigma, epsilon, box, tpl,
                                   spec, subtract_direct, ct)
    _check(positions, q, sigma, epsilon, box, tpl, ct)
    g_x, g_q = torch.empty_like(positions), torch.empty_like(q)
    err = native.library().cf_exclusion_bwd(
        *_args(positions, q, sigma, epsilon, box, tpl, spec,
               subtract_direct),
        ct.data_ptr(), g_x.data_ptr(), g_q.data_ptr(),
        native.stream_ptr(positions))
    native.check(err, "cf_exclusion_bwd")
    LAUNCHES["exclusion_bwd"] += 1
    return g_x, g_q


class _TemplateExclusion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, q, sigma, epsilon, box, tpl, spec,
                subtract_direct):
        args = (positions.contiguous(), q.contiguous(), sigma.contiguous(),
                epsilon.contiguous(), box.contiguous())
        ctx.save_for_backward(*args)
        ctx.static = (tpl, spec, subtract_direct)
        return exclusion_fwd(*args, tpl, spec, subtract_direct)

    @staticmethod
    def backward(ctx, ct):
        if any(ctx.needs_input_grad[2:5]):
            raise RuntimeError("exclusion correction: no cotangent for sigma, "
                               "epsilon or the box on this route (a box that "
                               "requires grad takes the plain chain)")
        g_x, g_q = exclusion_bwd(*ctx.saved_tensors, *ctx.static,
                                 ct.contiguous())
        return g_x, g_q, None, None, None, None, None, None


def template_exclusion_energy(positions, q, sigma, epsilon, box, tpl, spec,
                              subtract_direct: bool):
    """The correction of template ``tpl``'s exclusion rows (differentiable
    in ``positions`` [N, 3] and ``q`` [N]; no cotangent for ``sigma``,
    ``epsilon`` [N] or the orthorhombic ``box`` [3], which is read on the
    device, so a captured graph follows a box that changes between
    replays).  ``spec`` gives alpha, the cutoff and the periodicity;
    ``subtract_direct`` also removes the erfc/r + LJ that a cell walk
    counted inside the cutoff."""
    return _TemplateExclusion.apply(positions, q, sigma, epsilon, box, tpl,
                                    spec, subtract_direct)
