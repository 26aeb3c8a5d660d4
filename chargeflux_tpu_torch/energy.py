"""Total energy and forces (torch counterpart of ``chargeflux_tpu.energy``).

Because q = q(x), F = -dE/dx - (dE/dq)(dq/dx); here the whole force is
``torch.autograd.grad`` of E(q(x), x), so the chain-rule term comes from
autograd through :func:`charges.effective_charges`.

Routes, as in the JAX package:

* non-periodic: the masked all-pairs 1/r Coulomb + LJ, ``{"pair": ...}``;
* periodic, orthorhombic or a reduced [3, 3] lattice (triclinic): self
  energy, [dispersion tail,] direct space,
  exclusion correction and reciprocal.  Direct space is the dense masked
  pair sum (``direct_method="dense"``) or the fused cell walk
  (``"cell"``).  The reciprocal is the cell-column SPME (``"pme"``, cell
  route only) or classical Ewald (``"xla"``: the plain factorized product;
  ``"pallas"``: the hand-written structure-factor kernel — the JAX spec
  string is kept, see ``ewald.py``).

``recip_method="auto"`` resolves as the JAX package does, with a CUDA
device in f32 where JAX has the TPU in f32: the cell route takes "pme";
the dense route "pallas" while the half-space k count
Kx (2 Ky - 1)(2 Kz - 1) is below 4000 and the grid is within the
structure-factor kernels' Ky / 2Kz limits, else "xla"; on the CPU or in
f64, "xla".  Dense direct space with ``recip_method="pme"`` takes the
dense-mesh SPME (``pme.pme_reciprocal_energy``).

The binning, walk, weights, spread and templated exclusion rows take
their kernels or their plain versions by the system's ``kernel_route``,
fixed when it is built: f64 (the kernels are f32 only) or the CPU runs the
plain versions, an f32 system on the card the kernels, whose wrappers
raise on inputs past their limits; ``system.with_kernel_route("plain")``
is the plain reference the kernel path is held to.  The exclusion kernels
also need an orthorhombic box that does not require grad and no replica
axes (:func:`_excl_kernel_route`).

Three conditions poison the energy and, through ``poison * sum(x)``, every
force component to NaN on the cell route, as in the JAX package: a binning
overflow, a cell plane spacing below the cutoff, and (with a reused
neighbor state on the PME route) drift past the PME patch slack.

:func:`forces_manual` is the reference plugin's force algorithm: the
fixed-charge gradient plus the explicit dE/dq . dq/dx chain rule over the
analytic sparse Jacobian (``charges.apply_chain_rule``), the parity
oracle of the autograd forces.  The phases of an evaluation run inside
named ranges (``utils.profiling.phase_scope``: cf_charges, cf_binning,
cf_direct, cf_exclusion, cf_reciprocal, and cf_bonded in
``bonded.bonded_energy``), as in the JAX package.  Each is also a stage
timed on the device: a stamp at each edge of its forward, and an identity
autograd function around its inputs and its output whose backward stamps
the edges of its backward; values and gradients pass unchanged.  With no
profiler recording, an eager evaluation launches no stamp, and the chunk
graphs (``integrate.Chunk``) are instantiated without their 24 stamps a
step, which go in only while a profiler records: the cost with them in
is measured in PERF.md.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import cells
from .charges import apply_chain_rule, effective_charges
from .device import constant
from .ewald import reciprocal_energy, self_energy
from .ops.erfc import erf_over_r_eval, erfc_fast
from .ops.exclusion import (exclusion_fwd_plain,
                            lj_pair_terms as _lj_pair_terms, pair_terms,
                            template_exclusion_energy)
from .ops.structure_factor import kernels_take_grid
from .pairs import box_volume, displacement, pair_matrix_mask, plane_widths
from .pme import pme_cell_column_reciprocal_energy, pme_reciprocal_energy
from .rows import gather_planned
from .system import ChargeFluxSystem
from .units import ONE_4PI_EPS0
from .utils.profiling import phase_scope


def dispersion_energy(box, spec, dtype=None):
    """Long-range LJ tail energy ``C / V`` (kJ/mol), with ``C`` the
    coefficient ``create_system`` computed (``spec.tail_coeff``): no
    position dependence, but a box dependence the virial pressure and the
    barostat's volume moves see.  ``dtype`` is accepted for the JAX
    package's signature: the result takes the box's type."""
    return spec.tail_coeff / box_volume(box)


def _excl_kernel_route(positions, system: ChargeFluxSystem) -> bool:
    """Whether the templated exclusion rows take the kernels
    (``ops.exclusion``): the system on the kernel route (f32 on the card),
    an orthorhombic box [3] that does not require grad, and positions with
    no leading replica axes.  Everything else runs the plain chain."""
    box = system.box
    return (system.uses_kernels and system.spec.pbc
            and box.ndim == 1 and not box.requires_grad
            and positions.ndim == 2)


def _exclusion_correction(positions, q, system: ChargeFluxSystem,
                          subtract_direct: bool):
    """Energy correction for excluded pairs under PBC: templated blocks by
    the kernels where :func:`_excl_kernel_route` allows (else by static
    slices), remainder rows by one gather of an [N, 6] table in the fixed
    order of ``system.excl_plan`` (deterministic backward)."""
    dtype = positions.dtype
    total = torch.zeros((), dtype=dtype, device=positions.device)
    if system.n_exclusions == 0:
        return total
    spec = system.spec
    sig = system.sigma.to(dtype)
    eps = system.epsilon.to(dtype)
    e0 = 0
    if spec.excl_template is not None:
        kernel = _excl_kernel_route(positions, system)
        for tpl in spec.excl_template.templates:
            if kernel:
                total = total + template_exclusion_energy(
                    positions, q, sig, eps, system.box, tpl, spec,
                    subtract_direct)
            else:
                total = exclusion_fwd_plain(positions, q, sig, eps,
                                            system.box, tpl, spec,
                                            subtract_direct, total=total)
        e0 = spec.excl_template.covered("exclusions",
                                        system.exclusions.shape[0])
    if e0 < system.exclusions.shape[0]:
        table = torch.cat([positions, q[:, None], sig[:, None],
                           eps[:, None]], dim=1)
        ge = gather_planned(table, system.excl_plan).reshape(-1, 2, 6)
        a, b = ge[:, 0], ge[:, 1]
        total = total + pair_terms(
            a[:, 0:3], b[:, 0:3], a[:, 3], b[:, 3], a[:, 4], b[:, 4],
            a[:, 5], b[:, 5], system.box, spec, subtract_direct,
            template=False)
    return total


def _dense_pair_energy(positions, q, system: ChargeFluxSystem):
    """Masked all-pairs short-range energy.  Non-periodic: full 1/r Coulomb
    + LJ over every non-excluded pair.  Periodic: erfc(alpha r)/r Coulomb
    (f32 as 1/r - P(r^2), f64 through the exact erfc) + LJ over the
    non-excluded minimum-image pairs within the cutoff.  Positions
    [..., N, 3] give [...] energies: a leading replica axis makes
    [R, N, N] pair tables."""
    spec = system.spec
    d = displacement(positions[..., :, None, :], positions[..., None, :, :],
                     system.box, spec.pbc)
    r2 = torch.sum(d * d, dim=-1)
    mask = pair_matrix_mask(positions.shape[-2], system.exclusions)
    if spec.pbc:
        mask = mask & (r2 < spec.cutoff * spec.cutoff)
    r2_safe = torch.where(mask, r2, 1.0)
    inv_r = torch.rsqrt(r2_safe)
    qq = q[..., :, None] * q[..., None, :]
    if not spec.pbc:
        coul = ONE_4PI_EPS0 * qq * inv_r
    elif positions.dtype == torch.float64:
        coul = ONE_4PI_EPS0 * qq * inv_r * erfc_fast(
            spec.alpha * (r2_safe * inv_r))
    else:
        coul = ONE_4PI_EPS0 * qq * (
            inv_r - erf_over_r_eval(r2_safe, spec.alpha, spec.cutoff))
    half_sig = 0.5 * (system.sigma[:, None] + system.sigma[None, :])
    eps = 4.0 * torch.sqrt(system.epsilon[:, None] * system.epsilon[None, :])
    lj = _lj_pair_terms(half_sig, eps, inv_r)
    return torch.sum(torch.where(mask, coul + lj, 0.0), dim=(-2, -1))


def resolve_recip_method(spec, dtype, device) -> str:
    """The reciprocal route ``spec.recip_method`` stands for on this device
    and type ("auto" resolved as in the JAX package, a CUDA device in f32
    standing where JAX has the TPU in f32, and "pallas" only for a grid
    the structure-factor kernels take)."""
    if spec.recip_method != "auto":
        return spec.recip_method
    if torch.device(device).type == "cuda" and dtype == torch.float32:
        if spec.direct_method == "cell":
            return "pme"
        kx, ky, kz = spec.kmax
        if (kx * (2 * ky - 1) * (2 * kz - 1) < 4000
                and kernels_take_grid(2 * ky - 1, 2 * (2 * kz - 1))):
            return "pallas"
    return "xla"


def _cell_direct(positions, q, system: ChargeFluxSystem, nb, recip: str):
    """(blocks, ids, E_direct) of the cell route: binning (or the reused
    neighbor state), blockify and the fused walk, with the NaN poisons:
    overflow dropped pairs, a cell plane below the cutoff (a shrunken box),
    or, on the PME route, drift past the patch slack since the rebuild.
    The poison multiplies sum(x) so every force is NaN too."""
    spec = system.spec
    dtype, dev = positions.dtype, positions.device
    with phase_scope("cf_binning", positions, q) as st:
        if nb is None:
            slots, inv_slot, overflow = cells.build_cell_list_full(
                positions.detach(), system.box, spec.cell_grid,
                spec.cell_capacity, plain=not system.uses_kernels)
            wrap = None
        else:
            slots, inv_slot, overflow = nb.slots, nb.inv_slot, nb.overflow
            wrap = nb.wrap
        blocks = st.output(cells.blockify(*st.inputs, system, slots,
                                          inv_slot, wrap=wrap))
    ids = slots.reshape(blocks.x.shape)
    with phase_scope("cf_direct", blocks) as st:
        e_dir = st.output(cells.direct_energy_on_blocks(
            *st.inputs, ids, system))
    grid = constant(spec.cell_grid, dtype, dev)
    bad = (overflow > 0) | torch.any(plane_widths(system.box) / grid
                                     < spec.cutoff)
    if nb is not None and recip == "pme":
        h = plane_widths(system.box) / constant(spec.pme_grid, dtype, dev)
        budget = torch.min(constant(spec.pme_slack, dtype, dev) * h)
        d = positions.detach() - nb.x_ref
        max_d2 = torch.max(torch.sum(d * d, dim=-1))
        bad = bad | (max_d2 > budget * budget)
    poison = torch.where(bad, torch.nan, 0.0).to(dtype)
    return blocks, ids, e_dir + poison * torch.sum(positions)


def energy_components_fixed_charges(positions: torch.Tensor, q: torch.Tensor,
                                    system: ChargeFluxSystem, nb=None,
                                    include_recip: bool = True
                                    ) -> Dict[str, torch.Tensor]:
    """Energy breakdown {self, [dispersion,] direct, exclusion, reciprocal}
    under PBC, {pair} otherwise, treating the effective charges as an
    independent input: the gradient with respect to ``q`` of the sum is the
    reference's dE/dq vector.  ``include_recip=False`` leaves the
    reciprocal term out (for a caller with its own k-space estimator,
    ``rbe``)."""
    spec = system.spec
    if not spec.pbc:
        with phase_scope("cf_direct", positions, q) as st:
            return {"pair": st.output(_dense_pair_energy(*st.inputs,
                                                         system))}
    dtype = positions.dtype
    recip = resolve_recip_method(spec, dtype, positions.device)
    comps: Dict[str, torch.Tensor] = {}
    comps["self"] = self_energy(q, spec.alpha)
    if spec.tail_coeff is not None:
        comps["dispersion"] = dispersion_energy(system.box, spec, dtype)

    blocks = ids = None
    cell = spec.direct_method == "cell"
    if cell:
        blocks, ids, comps["direct"] = _cell_direct(positions, q, system, nb,
                                                    recip)
    else:
        with phase_scope("cf_direct", positions, q) as st:
            comps["direct"] = st.output(_dense_pair_energy(*st.inputs,
                                                           system))
    with phase_scope("cf_exclusion", positions, q) as st:
        comps["exclusion"] = st.output(_exclusion_correction(
            *st.inputs, system, subtract_direct=cell))
    if not include_recip:
        return comps
    columns = recip == "pme" and blocks is not None
    with phase_scope("cf_reciprocal",
                     *((blocks,) if columns else (positions, q))) as st:
        if columns:
            e = pme_cell_column_reciprocal_energy(*st.inputs, ids, system)
        elif recip == "pme":
            e = pme_reciprocal_energy(*st.inputs, system.box, spec.alpha,
                                      spec.pme_grid, spec.pme_order)
        else:
            e = reciprocal_energy(*st.inputs, system.box, spec.alpha,
                                  spec.kmax, method=recip,
                                  plain=not system.uses_kernels)
        comps["reciprocal"] = st.output(e)
    return comps


def energy_fixed_charges(positions, q, system, nb=None):
    """Total energy (kJ/mol) at fixed charges ``q``."""
    return sum(energy_components_fixed_charges(positions, q, system,
                                               nb=nb).values())


def energy_components(positions, system, nb=None):
    """Energy breakdown with the effective charges q(x)."""
    q = effective_charges(positions, system)
    return energy_components_fixed_charges(positions, q, system, nb=nb)


def _energy(positions: torch.Tensor, system: ChargeFluxSystem,
            nb=None) -> torch.Tensor:
    """Total potential energy (kJ/mol) with geometry-dependent charges;
    ``nb`` is an optional reused neighbor state (neighbors.py)."""
    with phase_scope("cf_charges", positions) as st:
        q = st.output(effective_charges(*st.inputs, system))
    return energy_fixed_charges(positions, q, system, nb=nb)


def energy(positions: torch.Tensor, system: ChargeFluxSystem,
           nb=None) -> torch.Tensor:
    """Total potential energy (kJ/mol) with geometry-dependent charges
    (differentiable in ``positions``)."""
    return _energy(positions, system, nb=nb)


def energy_and_forces(positions: torch.Tensor, system: ChargeFluxSystem,
                      nb=None):
    """(energy, forces) with F = -dE/dx through q(x)."""
    x = positions.detach().requires_grad_(True)
    with torch.enable_grad():
        e = _energy(x, system, nb=nb)
        (g,) = torch.autograd.grad(e, x)
    return e.detach(), -g


def forces(positions: torch.Tensor, system: ChargeFluxSystem,
           nb=None) -> torch.Tensor:
    """F = -dE/dx including the charge-flux chain rule, by autograd."""
    return energy_and_forces(positions, system, nb=nb)[1]


def forces_manual(positions: torch.Tensor,
                  system: ChargeFluxSystem) -> torch.Tensor:
    """The reference plugin's force algorithm: the fixed-charge gradient
    -dE/dx|_q plus the explicit chain rule -dE/dq . dq/dx over the analytic
    sparse Jacobian (ReferenceCoulKernels.cpp:493-499).  Equals
    :func:`forces` to round-off; kept as the parity oracle of the
    reference's algorithm."""
    x = positions.detach()
    with phase_scope("cf_charges", x) as st:
        q = effective_charges(*st.inputs, system)
    xg = x.clone().requires_grad_(True)
    qg = q.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy_fixed_charges(xg, qg, system)
        gx, dedq = torch.autograd.grad(e, (xg, qg))
    return -gx + apply_chain_rule(dedq, x, system)
