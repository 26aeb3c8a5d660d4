"""Geometry-dependent effective charges q(x) (torch counterpart of
``chargeflux_tpu.charges``).

q(x) is a plain function of the positions; autograd through it gives the
dE/dq . dq/dx chain-rule term of the forces.  Templated molecule blocks
(topology.py) evaluate on [count, stride, 3] reshapes with static slices;
only the remainder rows (a solute) go through one gather and one
scatter-add, both in the fixed order of the system's ``flux_plan``
(``rows.gather_planned`` / ``scatter_add_planned``), so a run on the card
gives the same bits twice, as the JAX engine does.

The analytic sparse Jacobian dq/dx (:func:`jacobian_index_layout`,
:func:`charge_jacobian_values`) has the reference's COO layout and
formulas; :func:`apply_chain_rule` contracts it with dE/dq, the force path
of ``energy.forces_manual``.
"""

from __future__ import annotations

import torch

from .pairs import displacement
from .rows import gather_planned, scatter_add_planned
from .system import ChargeFluxSystem


def _norm(d):
    return torch.sqrt(torch.sum(d * d, dim=-1))


def _angle(p1, p2, p3, box, pbc):
    """Law-of-cosines angle at p2 from three independent min-image deltas
    (the reference's formula), acos clamped for NaN safety."""
    d21 = displacement(p2, p1, box, pbc)
    d23 = displacement(p2, p3, box, pbc)
    d13 = displacement(p1, p3, box, pbc)
    r21 = _norm(d21)
    r23 = _norm(d23)
    r13_2 = torch.sum(d13 * d13, dim=-1)
    cost = (r23 * r23 + r21 * r21 - r13_2) / (2.0 * r21 * r23)
    return torch.arccos(torch.clamp(cost, -1.0, 1.0))


def _water_dq(p1, p2, p3, k1, k2, kub, b0, ub0, box, pbc):
    """CFF 3-site water charge deltas (dq_O, dq_H1, dq_H2)."""
    r12 = _norm(displacement(p1, p2, box, pbc))
    r13 = _norm(displacement(p1, p3, box, pbc))
    r23 = _norm(displacement(p2, p3, box, pbc))
    dq2 = k1 * (r12 - b0) + k2 * (r13 - b0) + kub * (r23 - ub0)
    dq3 = k1 * (r13 - b0) + k2 * (r12 - b0) + kub * (r23 - ub0)
    return -dq2 - dq3, dq2, dq3


def _template_dq_flat(positions, system: ChargeFluxSystem, tpl, starts):
    """Charge deltas for one template block, flattened to [count*stride];
    advances the per-kind row cursor ``starts`` in place."""
    dtype = positions.dtype
    box, pbc = system.box, system.spec.pbc
    off, s, c = tpl.offset, tpl.stride, tpl.count
    lead = positions.shape[:-2]
    pos_m = positions[..., off:off + c * s, :].reshape(lead + (c, s, 3))
    p = [pos_m[..., l, :] for l in range(s)]
    slot_dq = [[] for _ in range(s)]

    bond_rows = tpl.local_rows("bonds")
    if bond_rows:
        m = len(bond_rows)
        b0_ = starts["bonds"]
        starts["bonds"] += c * m
        k = system.bond_k[b0_:b0_ + c * m].reshape(c, m)
        b = system.bond_b[b0_:b0_ + c * m].reshape(c, m)
        for t, (l1, l2) in enumerate(bond_rows):
            r = _norm(displacement(p[l1], p[l2], box, pbc))
            dq = k[:, t] * (r - b[:, t])
            slot_dq[l1].append(dq)
            slot_dq[l2].append(-dq)

    angle_rows = tpl.local_rows("angles")
    if angle_rows:
        m = len(angle_rows)
        a0_ = starts["angles"]
        starts["angles"] += c * m
        k = system.angle_k[a0_:a0_ + c * m].reshape(c, m)
        t0 = system.angle_theta0[a0_:a0_ + c * m].reshape(c, m)
        for t, (l1, l2, l3) in enumerate(angle_rows):
            theta = _angle(p[l1], p[l2], p[l3], box, pbc)
            dq = k[:, t] * (theta - t0[:, t])
            slot_dq[l1].append(dq)
            slot_dq[l3].append(dq)
            slot_dq[l2].append(-2.0 * dq)

    water_rows = tpl.local_rows("waters")
    if water_rows:
        m = len(water_rows)
        w0_ = starts["waters"]
        starts["waters"] += c * m
        sl = slice(w0_, w0_ + c * m)
        par = [getattr(system, f)[sl].reshape(c, m) for f in
               ("water_k1", "water_k2", "water_kub", "water_b0", "water_ub0")]
        for t, (lo, lh1, lh2) in enumerate(water_rows):
            dqo, dq2, dq3 = _water_dq(p[lo], p[lh1], p[lh2],
                                      *[a[:, t] for a in par], box, pbc)
            slot_dq[lo].append(dqo)
            slot_dq[lh1].append(dq2)
            slot_dq[lh2].append(dq3)

    zero = torch.zeros(lead + (c,), dtype=dtype, device=positions.device)
    dq_slots = torch.stack(
        [sum(sl[1:], sl[0]) if sl else zero for sl in slot_dq], dim=-1)
    return dq_slots.reshape(lead + (-1,))


def _scatter_flux(q, positions, system: ChargeFluxSystem,
                  b0: int = 0, a0: int = 0, w0: int = 0):
    """General charge update on the remainder term rows [b0:], [a0:],
    [w0:] (those of ``system.flux_plan``): one position gather and one
    scatter-add for all kinds, each in the plan's fixed order."""
    box, pbc = system.box, system.spec.pbc
    n_b = system.bond_idx.shape[0] - b0
    n_a = system.angle_idx.shape[0] - a0
    n_w = system.water_idx.shape[0] - w0
    if n_b + n_a + n_w == 0:
        return q
    plan = system.flux_plan
    p_all = gather_planned(positions, plan)
    dq_parts = []
    if n_b:
        pb = p_all[:2 * n_b].reshape(n_b, 2, 3)
        r = _norm(displacement(pb[:, 0], pb[:, 1], box, pbc))
        dq = system.bond_k[b0:] * (r - system.bond_b[b0:])
        dq_parts.append(torch.stack([dq, -dq], dim=1).reshape(-1))
    if n_a:
        pa = p_all[2 * n_b:2 * n_b + 3 * n_a].reshape(n_a, 3, 3)
        theta = _angle(pa[:, 0], pa[:, 1], pa[:, 2], box, pbc)
        dq = system.angle_k[a0:] * (theta - system.angle_theta0[a0:])
        dq_parts.append(torch.stack([dq, -2.0 * dq, dq], dim=1).reshape(-1))
    if n_w:
        pw = p_all[2 * n_b + 3 * n_a:].reshape(n_w, 3, 3)
        dqo, dq2, dq3 = _water_dq(
            pw[:, 0], pw[:, 1], pw[:, 2], system.water_k1[w0:],
            system.water_k2[w0:], system.water_kub[w0:],
            system.water_b0[w0:], system.water_ub0[w0:], box, pbc)
        dq_parts.append(torch.stack([dqo, dq2, dq3], dim=1).reshape(-1))
    return scatter_add_planned(q, torch.cat(dq_parts), plan)


def effective_charges(positions: torch.Tensor,
                      system: ChargeFluxSystem) -> torch.Tensor:
    """q_i = q0_i + the flux-bond/angle/water contributions [N]; every
    term conserves the total charge.  Positions with leading replica axes
    ([..., N, 3] -> [..., N]) take the templated blocks; the remainder
    rows take one system."""
    dtype = positions.dtype
    q = system.q0.to(dtype)
    ts = system.spec.flux_template
    if ts is None:
        return _scatter_flux(q, positions, system)
    q = q.expand(positions.shape[:-1])
    starts = {"bonds": 0, "angles": 0, "waters": 0}
    pieces = []
    cursor = 0
    for tpl in ts.templates:
        off, end = tpl.offset, tpl.offset + tpl.count * tpl.stride
        dq = _template_dq_flat(positions, system, tpl, starts)
        pieces.append(q[..., cursor:off])
        pieces.append(q[..., off:end] + dq)
        cursor = end
    pieces.append(q[..., cursor:])
    q = torch.cat(pieces, dim=-1)
    return _scatter_flux(q, positions, system, b0=starts["bonds"],
                         a0=starts["angles"], w0=starts["waters"])


# ---------------------------------------------------------------------------
# Analytic sparse Jacobian dq/dx
# ---------------------------------------------------------------------------


def _nine(idx):
    """(dq, dx) index rows of a three-atom term: (a, b) for a, b in its
    atoms, a-major."""
    dq = torch.stack([idx[:, a] for a in (0, 0, 0, 1, 1, 1, 2, 2, 2)], dim=1)
    dx = torch.stack([idx[:, b] for b in (0, 1, 2, 0, 1, 2, 0, 1, 2)], dim=1)
    return dq.reshape(-1), dx.reshape(-1)


def jacobian_index_layout(system: ChargeFluxSystem):
    """COO index tensors (dq_idx, dx_idx) [P] in the reference's layout: 4
    entries per bond ((1,1), (1,2), (2,1), (2,2)), then 9 per angle, then
    9 per water (ReferenceCoulKernels.cpp:286-383).  Entry p is
    d q[dq_idx[p]] / d x[dx_idx[p]]."""
    bi = system.bond_idx
    dq_rows = [torch.stack([bi[:, a] for a in (0, 0, 1, 1)], dim=1)
               .reshape(-1)]
    dx_rows = [torch.stack([bi[:, b] for b in (0, 1, 0, 1)], dim=1)
               .reshape(-1)]
    for idx in (system.angle_idx, system.water_idx):
        dq, dx = _nine(idx)
        dq_rows.append(dq)
        dx_rows.append(dx)
    return torch.cat(dq_rows), torch.cat(dx_rows)


def charge_jacobian_values(positions: torch.Tensor,
                           system: ChargeFluxSystem) -> torch.Tensor:
    """Analytic dq/dx COO values [P, 3] in :func:`jacobian_index_layout`'s
    order, by the reference's formulas (bonds ReferenceCoulKernels.cpp:
    64-79, angles :117-161, waters :194-226)."""
    dtype = positions.dtype
    box, pbc = system.box, system.spec.pbc
    chunks = [positions.new_zeros((0, 3))]

    def at(idx, c):
        return positions[idx[:, c]]

    bi = system.bond_idx
    if bi.shape[0] > 0:
        d = displacement(at(bi, 0), at(bi, 1), box, pbc)
        val = (system.bond_k / _norm(d))[:, None] * d
        chunks.append(torch.stack([-val, val, val, -val], dim=1)
                      .reshape(-1, 3))

    ai = system.angle_idx
    if ai.shape[0] > 0:
        p1, p2, p3 = at(ai, 0), at(ai, 1), at(ai, 2)
        d21 = displacement(p2, p1, box, pbc)
        d23 = displacement(p2, p3, box, pbc)
        d13 = displacement(p1, p3, box, pbc)
        r21_2 = torch.sum(d21 * d21, dim=-1)
        r23_2 = torch.sum(d23 * d23, dim=-1)
        r13_2 = torch.sum(d13 * d13, dim=-1)
        r21, r23 = torch.sqrt(r21_2), torch.sqrt(r23_2)
        cost = torch.clamp((r23_2 + r21_2 - r13_2) / (2.0 * r21 * r23),
                           -1.0, 1.0)
        k = system.angle_k
        floor = 1e-300 if dtype == torch.float64 else 1e-30
        one_const = 1.0 / torch.sqrt(torch.clamp(1.0 - cost * cost,
                                                 min=floor))
        c1 = (k * one_const / (r21 * r23))[:, None]
        c2_21 = (k * cost * one_const / (r21 * r21))[:, None]
        c2_23 = (k * cost * one_const / (r23 * r23))[:, None]
        v1 = -c1 * d23 + c2_21 * d21
        v3 = -c1 * d21 + c2_23 * d23
        v2 = -v1 - v3
        chunks.append(torch.stack(
            [v1, v2, v3, -2 * v1, -2 * v2, -2 * v3, v1, v2, v3], dim=1)
            .reshape(-1, 3))

    wi = system.water_idx
    if wi.shape[0] > 0:
        p1, p2, p3 = at(wi, 0), at(wi, 1), at(wi, 2)
        d12 = displacement(p1, p2, box, pbc)
        d13 = displacement(p1, p3, box, pbc)
        d23 = displacement(p2, p3, box, pbc)
        n12 = d12 / _norm(d12)[:, None]
        n13 = d13 / _norm(d13)[:, None]
        n23 = d23 / _norm(d23)[:, None]
        k1 = system.water_k1[:, None]
        k2 = system.water_k2[:, None]
        ub = system.water_kub[:, None] * n23
        a12k1, a12k2 = k1 * n12, k2 * n12
        a13k1, a13k2 = k1 * n13, k2 * n13
        rows = [
            a12k1 + a12k2 + a13k1 + a13k2,      # (O, O)
            -a12k1 - a12k2 + 2 * ub,            # (O, H1)
            -a13k2 - a13k1 - 2 * ub,            # (O, H2)
            -a12k1 - a13k2,                     # (H1, O)
            a12k1 - ub,                         # (H1, H1)
            a13k2 + ub,                         # (H1, H2)
            -a12k2 - a13k1,                     # (H2, O)
            a12k2 - ub,                         # (H2, H1)
            a13k1 + ub,                         # (H2, H2)
        ]
        chunks.append(torch.stack(rows, dim=1).reshape(-1, 3))
    return torch.cat(chunks)


def apply_chain_rule(dedq: torch.Tensor, positions: torch.Tensor,
                     system: ChargeFluxSystem) -> torch.Tensor:
    """The force term -dedq[q_i] * dq_i/dx_j summed into x_j over the
    analytic COO Jacobian (the reference's multdQdX,
    ReferenceCoulKernels.cpp:493-499); returns the force delta [N, 3]."""
    dq_idx, dx_idx = jacobian_index_layout(system)
    vals = charge_jacobian_values(positions, system)
    contrib = -dedq[dq_idx][:, None] * vals
    return torch.zeros_like(positions).index_add_(0, dx_idx, contrib)
