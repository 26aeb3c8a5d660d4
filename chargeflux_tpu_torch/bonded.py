"""Bonded terms (torch counterpart of ``chargeflux_tpu.bonded``): harmonic
bonds and angles, E = 0.5 k (r - r0)^2 + 0.5 k (theta - theta0)^2,
periodic torsions, E = k (1 + cos(n phi - phi0)) (OpenMM's
PeriodicTorsionForce), and harmonic and flat-bottom position restraints.

Templated molecule blocks take one CUDA kernel each way per template
(``ops.bonded_terms``) where :func:`_kernel_route` allows, else their
plain chain on [count, stride, 3] reshapes with static slices; remainder
bond and angle rows and every torsion row take one gather, whose backward
sums in the fixed order of ``BondedParams.plan`` (deterministic on the
card).  ``BondedParams`` records its ``kernel_route`` as a system does:
"cuda" for f32 on the card, else "plain"; the energy-function builders
that hold a system put it on the system's route (:func:`follow_route`), so
``system.with_kernel_route("plain")`` is the plain control of the whole
energy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .ops.bonded_terms import (_angle_e, _bond_e, bonded_fwd_plain,
                               template_bonded_energy)
from .pairs import displacement
from .rows import RowPlan, gather_planned, row_plan
from .topology import TemplateSet, detect_templates
from .utils.profiling import phase_scope


def _torsion_e(p0, p1, p2, p3, k, n, phi0, box, pbc):
    """sum k (1 + cos(n phi - phi0)) with phi the dihedral about the 2-3
    bond by the atan2 form (stable at phi -> 0 and pi), IUPAC sign."""
    b1 = displacement(p0, p1, box, pbc)
    b2 = displacement(p1, p2, box, pbc)
    b3 = displacement(p2, p3, box, pbc)
    n1 = torch.cross(b1, b2, dim=-1)
    n2 = torch.cross(b2, b3, dim=-1)
    b2n = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    m1 = torch.cross(b2n, n1, dim=-1)
    phi = torch.atan2(torch.sum(m1 * n2, dim=-1), torch.sum(n1 * n2, dim=-1))
    return torch.sum(k * (1.0 + torch.cos(n * phi - phi0)))


def harmonic_bond_energy(positions, idx, k, r0, box, pbc):
    """``0.5 k (|r12| - r0)^2`` summed over bonds (idx [B, 2])."""
    if idx.shape[0] == 0:
        return torch.zeros((), dtype=positions.dtype, device=positions.device)
    return _bond_e(positions[idx[:, 0]], positions[idx[:, 1]], k, r0, box,
                   pbc)


def harmonic_angle_energy(positions, idx, k, theta0, box, pbc):
    """``0.5 k (theta - theta0)^2`` summed over angles 1-2-3 (idx [A, 3];
    atom 2 is the vertex)."""
    if idx.shape[0] == 0:
        return torch.zeros((), dtype=positions.dtype, device=positions.device)
    return _angle_e(*(positions[idx[:, c]] for c in range(3)), k, theta0,
                    box, pbc)


def periodic_torsion_energy(positions, idx, k, n, phi0, box, pbc):
    """``sum k (1 + cos(n phi - phi0))`` over torsions 1-2-3-4 (idx
    [T, 4]; ``n`` the integer periodicity), OpenMM's PeriodicTorsionForce
    convention, phi by the atan2 formulation."""
    if idx.shape[0] == 0:
        return torch.zeros((), dtype=positions.dtype, device=positions.device)
    return _torsion_e(*(positions[idx[:, c]] for c in range(4)), k, n, phi0,
                      box, pbc)


@dataclasses.dataclass(frozen=True)
class BondedParams:
    """Bonded-term parameters (companion to ChargeFluxSystem)."""

    bond_idx: torch.Tensor      # [B, 2] int64
    bond_k: torch.Tensor        # [B] kJ/mol/nm^2
    bond_r0: torch.Tensor       # [B] nm
    angle_idx: torch.Tensor     # [A, 3] int64 (vertex = column 1)
    angle_k: torch.Tensor       # [A] kJ/mol/rad^2
    angle_theta0: torch.Tensor  # [A] rad
    box: torch.Tensor           # [3]
    pbc: bool
    # periodic torsions (OpenMM PeriodicTorsionForce): optional, every row
    # on the gather path (counts are small; water models have none)
    torsion_idx: Optional[torch.Tensor] = None    # [T, 4] int64
    torsion_k: Optional[torch.Tensor] = None      # [T] kJ/mol
    torsion_n: Optional[torch.Tensor] = None      # [T] periodicity
    torsion_phi0: Optional[torch.Tensor] = None   # [T] rad
    template: Optional[TemplateSet] = None
    # fixed-order plan of the gathered rows' atoms (remainder bonds, then
    # remainder angles, then torsions), made once at construction; None
    # when there are none
    plan: Optional[RowPlan] = dataclasses.field(init=False, compare=False)
    # "cuda" (the templated rows' kernels, f32 only) for f32 on the card,
    # else "plain", as ChargeFluxSystem records its own; see
    # with_kernel_route
    kernel_route: str = dataclasses.field(init=False, compare=False)

    def __post_init__(self):
        rows = []
        for kind, idx in (("bonds", self.bond_idx),
                          ("angles", self.angle_idx)):
            start = (self.template.covered(kind, idx.shape[0])
                     if self.template is not None else 0)
            rows.append(idx[start:].reshape(-1).cpu().numpy())
        if self.torsion_idx is not None:
            rows.append(self.torsion_idx.reshape(-1).cpu().numpy())
        flat = np.concatenate(rows)
        object.__setattr__(self, "plan", row_plan(
            flat, self.bond_idx.device) if flat.size else None)
        object.__setattr__(self, "kernel_route", "cuda" if (
            self.bond_k.device.type == "cuda"
            and self.bond_k.dtype == torch.float32) else "plain")

    @property
    def uses_kernels(self) -> bool:
        """Whether the templated rows may take the kernels: the route's
        one reader."""
        return self.kernel_route == "cuda"

    def with_kernel_route(self, route: str) -> "BondedParams":
        """The same terms on ``route``: "plain" (the plain chain on any
        device) or "cuda" (the kernels: f32 on the card only).  A copy like
        :meth:`with_box`'s: capture-safe; ``self`` where the route is
        already ``route``."""
        k = self.bond_k
        if route not in ("cuda", "plain") or route == "cuda" and not (
                k.device.type == "cuda" and k.dtype == torch.float32):
            raise ValueError(f"kernel route {route!r}: 'plain', or 'cuda' "
                             f"for f32 bonded terms on the CUDA card, not "
                             f"{k.dtype} on {k.device}")
        return self if route == self.kernel_route else self._swap(
            kernel_route=route)

    def _swap(self, **fields) -> "BondedParams":
        """A shallow copy with ``fields`` replaced: the row plan and the
        kernel route are carried over as they are."""
        new = object.__new__(type(self))
        for f in dataclasses.fields(self):
            object.__setattr__(new, f.name, fields.get(f.name,
                                                       getattr(self, f.name)))
        return new

    @classmethod
    def create(cls, bond_idx, bond_k, bond_r0, angle_idx, angle_k,
               angle_theta0, box, pbc, n_atoms=None, torsion_idx=None,
               torsion_k=None, torsion_n=None, torsion_phi0=None,
               dtype=torch.float32, device=None) -> "BondedParams":
        """Build with molecule-template detection: repeating bond/angle
        index structure is reordered molecule-major for the static-slice
        path; torsions (optional, all four arrays) keep their order.
        ``device`` defaults to the CUDA card (``"cpu"`` for the CPU)."""
        device = resolve_device(device)
        bond_idx = np.asarray(bond_idx, np.int64).reshape(-1, 2)
        angle_idx = np.asarray(angle_idx, np.int64).reshape(-1, 3)
        bond_k, bond_r0 = np.asarray(bond_k), np.asarray(bond_r0)
        angle_k, angle_theta0 = np.asarray(angle_k), np.asarray(angle_theta0)
        if n_atoms is None:
            tops = [int(v.max()) + 1 for v in (bond_idx, angle_idx) if v.size]
            n_atoms = max(tops) if tops else 0
        det = detect_templates({"bonds": bond_idx, "angles": angle_idx},
                               n_atoms=n_atoms) if n_atoms else None
        template = None
        if det is not None:
            template, perms = det
            bp, ap = perms["bonds"], perms["angles"]
            bond_idx, bond_k, bond_r0 = bond_idx[bp], bond_k[bp], bond_r0[bp]
            angle_idx, angle_k, angle_theta0 = (angle_idx[ap], angle_k[ap],
                                                angle_theta0[ap])

        def f(a):
            return torch.as_tensor(np.array(a, np.float64),
                                   device=device).to(dtype)

        def i(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        tor = {}
        if torsion_idx is not None:
            tor = dict(torsion_idx=i(np.asarray(torsion_idx,
                                                np.int64).reshape(-1, 4)),
                       torsion_k=f(torsion_k), torsion_n=f(torsion_n),
                       torsion_phi0=f(torsion_phi0))
        return cls(bond_idx=i(bond_idx), bond_k=f(bond_k), bond_r0=f(bond_r0),
                   angle_idx=i(angle_idx), angle_k=f(angle_k),
                   angle_theta0=f(angle_theta0), box=f(box), pbc=pbc,
                   template=template, **tor)

    def with_box(self, box: torch.Tensor) -> "BondedParams":
        """The same terms with the box tensor ``box`` (the JAX package's
        ``dataclasses.replace(bonded, box=...)``): a shallow copy that
        keeps the row plan and the kernel route, so it makes no host traffic
        and may be made inside a CUDA graph capture."""
        return self._swap(box=box.to(self.box.dtype))

    def astype(self, dtype) -> "BondedParams":
        """Cast the float tensors to ``dtype`` (index tensors untouched);
        the cast terms record their own ``kernel_route``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dtype)
            for f in dataclasses.fields(self)
            if f.init and torch.is_tensor(getattr(self, f.name))
            and getattr(self, f.name).is_floating_point()})


def follow_route(bonded, system):
    """``bonded`` (or None) on ``system``'s kernel route, as the
    energy-function builders hold it: its copy on the plain route where the
    system is on that route, else ``bonded`` as it is."""
    if bonded is None or system.uses_kernels:
        return bonded
    return bonded.with_kernel_route("plain")


def _kernel_route(positions, bonded: BondedParams) -> bool:
    """Whether the templated rows take the kernels
    (``ops.bonded_terms``): the terms on the kernel route (f32 on the
    card), an orthorhombic box [3] that does not require grad (or no
    periodicity, where the box is not read), and positions with no leading
    replica axes.  Everything else runs the plain chain."""
    box = bonded.box
    return (bonded.uses_kernels and positions.ndim == 2
            and (not bonded.pbc
                 or (box.ndim == 1 and not box.requires_grad)))


def bonded_energy(positions: torch.Tensor,
                  bonded: BondedParams) -> torch.Tensor:
    """Total bond + angle + torsion energy (kJ/mol).  The templated rows
    take positions with leading replica axes ([..., N, 3] -> [...]); the
    gathered rows take one system.  Runs in the stage ``cf_bonded``
    (``utils.profiling.phase_scope``)."""
    with phase_scope("cf_bonded", positions) as st:
        return st.output(_bonded_terms(*st.inputs, bonded))


def _bonded_terms(positions: torch.Tensor,
                  bonded: BondedParams) -> torch.Tensor:
    box, pbc = bonded.box, bonded.pbc
    kernel = _kernel_route(positions, bonded)
    # the kernel route adds the templates' energies as they come (no zeros
    # node); the plain chain keeps its order from zero, bit for bit
    e = None if kernel else torch.zeros((), dtype=positions.dtype,
                                        device=positions.device)
    b0 = a0 = 0
    if bonded.template is not None:
        for tpl in bonded.template.templates:
            args = (bonded.bond_k, bonded.bond_r0, bonded.angle_k,
                    bonded.angle_theta0, box, tpl, b0, a0, pbc)
            if not kernel:
                e = bonded_fwd_plain(positions, *args, total=e)
            else:
                t = template_bonded_energy(positions, *args)
                e = t if e is None else e + t
            b0 += tpl.count * len(tpl.local_rows("bonds"))
            a0 += tpl.count * len(tpl.local_rows("angles"))
    if e is None:
        e = torch.zeros((), dtype=positions.dtype, device=positions.device)
    n_b = bonded.bond_idx.shape[0] - b0
    n_a = bonded.angle_idx.shape[0] - a0
    n_t = 0 if bonded.torsion_idx is None else bonded.torsion_idx.shape[0]
    if n_b + n_a + n_t > 0:
        p_all = gather_planned(positions, bonded.plan)
        if n_b:
            pb = p_all[:2 * n_b].reshape(n_b, 2, 3)
            e = e + _bond_e(pb[:, 0], pb[:, 1], bonded.bond_k[b0:],
                            bonded.bond_r0[b0:], box, pbc)
        if n_a:
            pa = p_all[2 * n_b:2 * n_b + 3 * n_a].reshape(n_a, 3, 3)
            e = e + _angle_e(pa[:, 0], pa[:, 1], pa[:, 2],
                             bonded.angle_k[a0:], bonded.angle_theta0[a0:],
                             box, pbc)
        if n_t:
            pt = p_all[2 * n_b + 3 * n_a:].reshape(n_t, 4, 3)
            e = e + _torsion_e(pt[:, 0], pt[:, 1], pt[:, 2], pt[:, 3],
                               bonded.torsion_k, bonded.torsion_n,
                               bonded.torsion_phi0, box, pbc)
    return e


def position_restraint_energy(positions, idx, k, x0) -> torch.Tensor:
    """Harmonic position restraints ``E = sum 0.5 k_i |x[idx_i] - x0_i|^2``
    (OpenMM's ``CustomExternalForce`` equilibration staple), in absolute
    space (no minimum image): ``x0`` lives in the trajectory's unwrapped
    frame.  ``idx`` [R] int, ``k`` [R] or scalar (kJ/mol/nm^2), ``x0``
    [R, 3]."""
    d = positions[idx] - x0
    return 0.5 * torch.sum(torch.as_tensor(k, dtype=positions.dtype,
                                           device=positions.device)
                           * torch.sum(d * d, dim=-1))


def flat_bottom_restraint_energy(positions, idx, k, x0,
                                 radius) -> torch.Tensor:
    """Flat-bottom position restraints: zero inside ``radius``, harmonic in
    the overshoot outside, ``E = sum 0.5 k_i max(0, |d_i| - r_i)^2``;
    grad-safe at |d| = 0 (the double where keeps the sqrt branch
    finite)."""
    d = positions[idx] - x0
    r2 = torch.sum(d * d, dim=-1)
    nonzero = r2 > 0
    r = torch.sqrt(torch.where(nonzero, r2, 1.0))
    like = dict(dtype=positions.dtype, device=positions.device)
    over = torch.clamp(torch.where(nonzero, r, 0.0)
                       - torch.as_tensor(radius, **like), min=0.0)
    return 0.5 * torch.sum(torch.as_tensor(k, **like) * over * over)
