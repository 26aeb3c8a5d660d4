"""Total energy and forces (torch counterpart of ``chargeflux_tpu.energy``).

Because q = q(x), F = -dE/dx - (dE/dq)(dq/dx); here the whole force is
``torch.autograd.grad`` of E(q(x), x), so the chain-rule term comes from
autograd through :func:`charges.effective_charges`.

The port runs the periodic, orthorhombic cell + PME route (the main path of
the JAX package's ``bench.py 30k``): self energy, the fused direct walk on
the cell blocks, the exclusion correction and the cell-column PME
reciprocal.  ``recip_method`` "auto" and "pme" both take that route.  The
dense direct route, the non-periodic route, classical Ewald and triclinic
boxes raise ``NotImplementedError`` (ROADMAP.md lists them).

Three conditions poison the energy and, through ``poison * sum(x)``, every
force component to NaN, as in the JAX package: a binning overflow, a cell
plane spacing below the cutoff, and (with a reused neighbor state) drift
past the PME patch slack.  ``plain=True`` runs the plain versions of the
kernels on any device — the reference the kernel path is held to.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import cells
from .charges import effective_charges
from .ewald import self_energy
from .ops.erfc import erfc_fast
from .pairs import box_volume, displacement, plane_widths
from .pme import pme_cell_column_reciprocal_energy
from .system import ChargeFluxSystem
from .units import ONE_4PI_EPS0


def _lj_pair_terms(half_sig_sum, eps_prod, inv_r):
    """Prefactored LJ: e * s6 * (s6 - 1) == 4 eps [(sig/r)^12 - (sig/r)^6]."""
    sig2 = (half_sig_sum * inv_r) ** 2
    sig6 = sig2 * sig2 * sig2
    return eps_prod * sig6 * (sig6 - 1.0)


def _excl_pair_energy(r, inv_r, qq, half_sig, eps, spec, subtract_direct):
    """Per-pair exclusion correction: always -erf(ar)/r Coulomb; with
    ``subtract_direct`` also remove the erfc/r + LJ the direct walk
    counted inside the cutoff."""
    erfc_ar = erfc_fast(spec.alpha * r)
    e = -ONE_4PI_EPS0 * qq * inv_r * (1.0 - erfc_ar)
    if subtract_direct:
        in_cut = r < spec.cutoff
        direct = (ONE_4PI_EPS0 * qq * inv_r * erfc_ar
                  + _lj_pair_terms(half_sig, eps, inv_r))
        e = e - torch.where(in_cut, direct, 0.0)
    return torch.sum(e)


def _pair_terms(p1, p2, q1, q2, s1, s2, e1, e2, system, subtract_direct,
                template: bool):
    d = displacement(p1, p2, system.box, system.spec.pbc)
    r2 = torch.sum(d * d, dim=-1)
    if template:
        inv_r = torch.rsqrt(r2)
        r = r2 * inv_r
    else:
        r = torch.sqrt(r2)
        inv_r = 1.0 / r
    return _excl_pair_energy(r, inv_r, q1 * q2, 0.5 * (s1 + s2),
                             4.0 * torch.sqrt(e1 * e2), system.spec,
                             subtract_direct)


def _exclusion_correction(positions, q, system: ChargeFluxSystem,
                          subtract_direct: bool):
    """Energy correction for excluded pairs under PBC: templated blocks by
    static slices, remainder rows by one gather of an [N, 6] table."""
    dtype = positions.dtype
    total = torch.zeros((), dtype=dtype, device=positions.device)
    if system.n_exclusions == 0:
        return total
    spec = system.spec
    sig = system.sigma.to(dtype)
    eps = system.epsilon.to(dtype)
    e0 = 0
    if spec.excl_template is not None:
        for tpl in spec.excl_template.templates:
            off, s, c = tpl.offset, tpl.stride, tpl.count
            sl = slice(off, off + c * s)
            pos_m = positions[sl].reshape(c, s, 3)
            q_m = q[sl].reshape(c, s)
            sig_m = sig[sl].reshape(c, s)
            eps_m = eps[sl].reshape(c, s)
            for (l1, l2) in tpl.local_rows("exclusions"):
                total = total + _pair_terms(
                    pos_m[:, l1], pos_m[:, l2], q_m[:, l1], q_m[:, l2],
                    sig_m[:, l1], sig_m[:, l2], eps_m[:, l1], eps_m[:, l2],
                    system, subtract_direct, template=True)
        e0 = spec.excl_template.covered("exclusions",
                                        system.exclusions.shape[0])
    if e0 < system.exclusions.shape[0]:
        table = torch.cat([positions, q[:, None], sig[:, None],
                           eps[:, None]], dim=1)
        ge = table[system.exclusions[e0:].reshape(-1)].reshape(-1, 2, 6)
        a, b = ge[:, 0], ge[:, 1]
        total = total + _pair_terms(
            a[:, 0:3], b[:, 0:3], a[:, 3], b[:, 3], a[:, 4], b[:, 4],
            a[:, 5], b[:, 5], system, subtract_direct, template=False)
    return total


def _check_route(system: ChargeFluxSystem):
    spec = system.spec
    if not spec.pbc:
        raise NotImplementedError(
            "the non-periodic all-pairs route is not ported yet (ROADMAP.md)")
    if spec.direct_method != "cell":
        raise NotImplementedError(
            "the dense direct route is not ported yet (ROADMAP.md); build "
            "the system with direct_method='cell'")
    if spec.recip_method not in ("auto", "pme"):
        raise NotImplementedError(
            f"recip_method={spec.recip_method!r} (classical Ewald) is not "
            f"ported yet (ROADMAP.md); use 'pme'")
    if system.box.ndim == 2:
        raise NotImplementedError(
            "triclinic boxes are not ported yet (ROADMAP.md)")


def energy_components_fixed_charges(positions: torch.Tensor, q: torch.Tensor,
                                    system: ChargeFluxSystem, nb=None,
                                    plain: bool = False
                                    ) -> Dict[str, torch.Tensor]:
    """Energy breakdown {self, [dispersion,] direct, exclusion, reciprocal}
    treating the effective charges as an independent input."""
    _check_route(system)
    spec = system.spec
    dtype = positions.dtype
    comps: Dict[str, torch.Tensor] = {}
    comps["self"] = self_energy(q, spec.alpha)
    if spec.tail_coeff is not None:
        comps["dispersion"] = spec.tail_coeff / box_volume(system.box)

    if nb is None:
        slots, inv_slot, overflow = cells.build_cell_list_full(
            positions.detach(), system.box, spec.cell_grid, spec.cell_capacity)
        wrap = None
    else:
        slots, inv_slot, overflow = nb.slots, nb.inv_slot, nb.overflow
        wrap = nb.wrap
    blocks = cells.blockify(positions, q, system, slots, inv_slot, wrap=wrap)
    ids = slots.reshape(blocks.x.shape)
    e_dir = cells.direct_energy_on_blocks(blocks, ids, system, plain=plain)

    # NaN poisons: overflow dropped pairs, a cell plane below the cutoff
    # (a shrunken box), or drift past the PME patch slack since the
    # rebuild.  The poison multiplies sum(x) so every force is NaN too.
    grid = torch.tensor(spec.cell_grid, dtype=dtype, device=positions.device)
    bad = (overflow > 0) | torch.any(plane_widths(system.box) / grid
                                     < spec.cutoff)
    if nb is not None:
        h = plane_widths(system.box) / torch.tensor(
            spec.pme_grid, dtype=dtype, device=positions.device)
        budget = torch.min(torch.tensor(
            spec.pme_slack, dtype=dtype, device=positions.device) * h)
        d = positions.detach() - nb.x_ref
        max_d2 = torch.max(torch.sum(d * d, dim=-1))
        bad = bad | (max_d2 > budget * budget)
    poison = torch.where(bad, torch.nan, 0.0).to(dtype)
    comps["direct"] = e_dir + poison * torch.sum(positions)
    comps["exclusion"] = _exclusion_correction(positions, q, system,
                                               subtract_direct=True)
    comps["reciprocal"] = pme_cell_column_reciprocal_energy(
        blocks, ids, system, plain=plain)
    return comps


def energy_fixed_charges(positions, q, system, nb=None, plain: bool = False):
    total = 0.0
    for v in energy_components_fixed_charges(positions, q, system, nb=nb,
                                             plain=plain).values():
        total = total + v
    return total


def energy_components(positions, system, nb=None, plain: bool = False):
    """Energy breakdown with the effective charges q(x)."""
    q = effective_charges(positions, system)
    return energy_components_fixed_charges(positions, q, system, nb=nb,
                                           plain=plain)


def _energy(positions: torch.Tensor, system: ChargeFluxSystem, nb=None,
            plain: bool = False) -> torch.Tensor:
    """Total potential energy (kJ/mol) with geometry-dependent charges;
    ``nb`` is an optional reused neighbor state (neighbors.py)."""
    q = effective_charges(positions, system)
    return energy_fixed_charges(positions, q, system, nb=nb, plain=plain)


def energy_and_forces(positions: torch.Tensor, system: ChargeFluxSystem,
                      nb=None, plain: bool = False):
    """(energy, forces) with F = -dE/dx through q(x)."""
    x = positions.detach().requires_grad_(True)
    with torch.enable_grad():
        e = _energy(x, system, nb=nb, plain=plain)
        (g,) = torch.autograd.grad(e, x)
    return e.detach(), -g
