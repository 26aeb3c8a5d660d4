"""Scene specification: builder API + a dataclass of tensors.

Counterpart of ``chargeflux_tpu.system``.  :class:`CoulForce` has the
reference plugin's builder surface, and :meth:`CoulForce.create_system`
does the same host-side planning as the JAX package (Ewald alpha/kmax,
PME mesh and slack, cell grid and capacity, molecule templates), in
NumPy, so both packages pick the same :class:`StaticSpec` for the same
builder — tests/test_torch_system.py holds them to it.  The planning is a
copy rather than an import because importing ``chargeflux_tpu`` loads JAX.

:func:`system_from_arrays` builds the port's system from another
system's leaves (e.g. a JAX ``ChargeFluxSystem`` converted to NumPy), so
the parity tests feed both packages the same system.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .rows import RowPlan, row_plan
from .topology import MoleculeTemplate, TemplateSet, detect_templates


# ---------------------------------------------------------------------------
# Ewald parameter derivation (host-side, pure Python)
# ---------------------------------------------------------------------------


def _ewald_param_value(kmax: int, width: float, alpha: float) -> float:
    """Error estimate for a candidate kmax (OpenMM's classic formula)."""
    temp = kmax * math.pi / (width * alpha)
    return 0.05 * math.sqrt(width * alpha) * kmax * math.exp(-temp * temp)


def ewald_alpha(cutoff: float, tol: float) -> float:
    """alpha = sqrt(-log(2*tol)) / cutoff."""
    return math.sqrt(-math.log(2.0 * tol)) / cutoff


def box_widths(box_arr: np.ndarray) -> Tuple[float, float, float]:
    """Perpendicular widths (lattice-plane spacings) of a [3] or [3, 3]
    box: the edge lengths when orthorhombic, 1 / ||inv(B)[:, i]||
    otherwise."""
    if box_arr.ndim == 2:
        inv = np.linalg.inv(box_arr)
        return tuple(1.0 / np.linalg.norm(inv[:, i]) for i in range(3))
    return tuple(float(b) for b in box_arr)


def _validate_reduced_box(b: np.ndarray):
    """Triclinic boxes must be in reduced lower-triangular row-vector form
    (OpenMM's convention)."""
    if not np.allclose([b[0, 1], b[0, 2], b[1, 2]], 0.0):
        raise ValueError(
            "triclinic box must be lower-triangular (row lattice vectors "
            "a=(ax,0,0), b=(bx,by,0), c=(cx,cy,cz)); rotate your cell")
    if not (b[0, 0] > 0 and b[1, 1] > 0 and b[2, 2] > 0):
        raise ValueError("triclinic box diagonal must be positive")
    tol = 1e-9
    if (abs(b[1, 0]) > 0.5 * b[0, 0] + tol
            or abs(b[2, 0]) > 0.5 * b[0, 0] + tol
            or abs(b[2, 1]) > 0.5 * b[1, 1] + tol):
        raise ValueError(
            "triclinic box is not in reduced form (|b_x|<=a_x/2, "
            "|c_x|<=a_x/2, |c_y|<=b_y/2); subtract integer multiples of "
            "earlier rows (lattice-preserving) to reduce it")


def dispersion_tail_coefficient(sigma, epsilon, cutoff: float) -> float:
    """Isotropic long-range LJ dispersion coefficient C [kJ/mol nm^3]
    (E_tail = C / V), evaluated exactly in O(N) through the binomial
    expansion of (sig_i + sig_j)^p — same formula as the JAX package."""
    sig = np.asarray(sigma, dtype=np.float64).reshape(-1)
    a = 2.0 * np.sqrt(np.asarray(epsilon, dtype=np.float64).reshape(-1))

    def pair_sum(p: int) -> float:
        mom = [float(np.sum(a * sig ** k)) for k in range(p + 1)]
        full = sum(math.comb(p, k) * mom[k] * mom[p - k] for k in range(p + 1))
        self_pairs = float(np.sum(a * a * (2.0 * sig) ** p))
        return (full - self_pairs) / 2.0 ** p

    rc3 = float(cutoff) ** 3
    rc9 = rc3 ** 3
    return 2.0 * math.pi * (pair_sum(12) / (9.0 * rc9)
                            - pair_sum(6) / (3.0 * rc3))


def ewald_kmax(box: Tuple[float, float, float], alpha: float,
               tol: float) -> Tuple[int, int, int]:
    """Per-axis kmax grown until the error estimate drops below tol, then
    forced odd (the reference's quirk)."""
    out = []
    for w in box:
        k = 1
        while _ewald_param_value(k, float(w), alpha) > tol:
            k += 1
        if k % 2 == 0:
            k += 1
        out.append(k)
    return tuple(out)


# ---------------------------------------------------------------------------
# Static (hashable) spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StaticSpec:
    """Hashable build-time metadata; the same fields as the JAX package's
    ``StaticSpec`` so the two can be compared field by field.

    ``walk_layout`` and ``walk_chunks`` are lane-padding knobs of the TPU
    walk.  They are planned identically and kept for that comparison; the
    port's direct walk does not read them.
    """

    pbc: bool
    cutoff: float
    ewald_tol: float
    alpha: Optional[float]
    kmax: Optional[Tuple[int, int, int]]
    direct_method: str = "dense"
    cell_grid: Optional[Tuple[int, int, int]] = None
    cell_capacity: Optional[int] = None
    walk_layout: str = "concat"
    walk_chunks: int = 1
    recip_method: str = "auto"
    pme_grid: Optional[Tuple[int, int, int]] = None
    pme_order: int = 6
    pme_slack: Tuple[int, int, int] = (0, 0, 0)
    tail_coeff: Optional[float] = None
    flux_template: Optional[TemplateSet] = None
    excl_template: Optional[TemplateSet] = None


# ---------------------------------------------------------------------------
# The system: a dataclass of tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChargeFluxSystem:
    """Scene consumed by the energy/force functions.  Tensor fields live
    on one device; ``spec`` is host metadata.  Index fields are int64."""

    q0: torch.Tensor           # [N] base charges (e)
    sigma: torch.Tensor        # [N] LJ sigma (nm)
    epsilon: torch.Tensor      # [N] LJ epsilon (kJ/mol)
    exclusions: torch.Tensor   # [E, 2], p1 < p2
    bond_idx: torch.Tensor     # [B, 2]
    bond_k: torch.Tensor       # [B]
    bond_b: torch.Tensor       # [B]
    angle_idx: torch.Tensor    # [A, 3]
    angle_k: torch.Tensor      # [A]
    angle_theta0: torch.Tensor  # [A]
    water_idx: torch.Tensor    # [W, 3]
    water_k1: torch.Tensor     # [W]
    water_k2: torch.Tensor     # [W]
    water_kub: torch.Tensor    # [W]
    water_b0: torch.Tensor     # [W]
    water_ub0: torch.Tensor    # [W]
    box: torch.Tensor          # [3] edge lengths (zeros when non-periodic)
    #                            or [3, 3] reduced lattice rows (triclinic)
    spec: StaticSpec
    # fixed-order plans of the remainder rows (those no template covers),
    # made once at construction: the flux terms' atoms (bonds, angles,
    # waters, in that order) and the exclusion pairs' atoms; None when
    # every row is templated
    flux_plan: Optional[RowPlan] = dataclasses.field(init=False,
                                                     compare=False)
    excl_plan: Optional[RowPlan] = dataclasses.field(init=False,
                                                     compare=False)
    # the one input that decides kernel or plain, fixed when the system is
    # built: "cuda" (the hand-written kernels, f32 only) for f32 on the
    # card, else "plain" (their plain versions); see with_kernel_route
    kernel_route: str = dataclasses.field(init=False, compare=False)

    def __post_init__(self):
        spec, dev = self.spec, self.q0.device

        def tail(tset, kind, rows):
            start = tset.covered(kind, rows.shape[0]) if tset is not None \
                else 0
            return rows[start:].reshape(-1).cpu().numpy()

        flux = np.concatenate([
            tail(spec.flux_template, kind, getattr(self, name))
            for kind, name in (("bonds", "bond_idx"), ("angles", "angle_idx"),
                               ("waters", "water_idx"))])
        excl = tail(spec.excl_template, "exclusions", self.exclusions)
        object.__setattr__(self, "flux_plan",
                           row_plan(flux, dev) if flux.size else None)
        object.__setattr__(self, "excl_plan",
                           row_plan(excl, dev) if excl.size else None)
        object.__setattr__(self, "kernel_route", "cuda" if (
            dev.type == "cuda" and self.q0.dtype == torch.float32)
            else "plain")

    @property
    def uses_kernels(self) -> bool:
        """Whether the system takes the kernels: the route's one reader."""
        return self.kernel_route == "cuda"

    def with_kernel_route(self, route: str) -> "ChargeFluxSystem":
        """The same system on ``route``: "plain" (the plain versions on any
        device: the card's control) or "cuda" (the kernels: f32 on the card
        only).  A copy like :meth:`with_box`'s: capture-safe."""
        q0 = self.q0
        if route not in ("cuda", "plain") or route == "cuda" and not (
                q0.device.type == "cuda" and q0.dtype == torch.float32):
            raise ValueError(f"kernel route {route!r}: 'plain', or 'cuda' "
                             f"for an f32 system on the CUDA card, not "
                             f"{q0.dtype} on {q0.device}")
        return self._swap(kernel_route=route)

    @property
    def n_atoms(self) -> int:
        return self.q0.shape[0]

    @property
    def n_exclusions(self) -> int:
        return self.exclusions.shape[0]

    def astype(self, dtype) -> "ChargeFluxSystem":
        """Cast all float tensors to ``dtype`` (index tensors untouched);
        the cast system records its own ``kernel_route``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(dtype) for f in ARRAY_FIELDS
            if getattr(self, f).is_floating_point()})

    def _swap(self, **fields) -> "ChargeFluxSystem":
        """A shallow copy with ``fields`` replaced: the row plans and the
        kernel route are carried over as they are (``dataclasses.replace``
        would plan them again on the host), and nothing kept on this
        object (chunks, host caches) comes along."""
        new = object.__new__(type(self))
        for f in dataclasses.fields(self):
            object.__setattr__(new, f.name, fields.get(f.name,
                                                       getattr(self, f.name)))
        return new

    def with_box(self, box) -> "ChargeFluxSystem":
        """The same system with the box ``box``: the basis of the
        constant-pressure drivers (npt.py), as in the JAX package.

        Only the box tensor changes; the spec (alpha, kmax, PME mesh, cell
        grid and capacity) stays the one planned for the build-time box,
        and the energy path NaN-poisons where a shrunken box leaves a cell
        plane below the cutoff.  The copy makes no host-to-device copy and
        reads nothing back, so it may be made inside a CUDA graph capture:
        a tensor ``box`` on the system's device is used as it is, so a
        graph that reads the copy reads ``box`` by address.  A [3] box
        given to a system built triclinic is diagonalised; a [3, 3]
        lattice may be given to an orthorhombic one (the pressure tensor
        strains the box that way); other shapes broadcast."""
        ref = self.box
        if torch.is_tensor(box):
            box = box.to(dtype=ref.dtype, device=ref.device)
        else:
            box = torch.as_tensor(np.asarray(box, np.float64),
                                  device=ref.device).to(ref.dtype)
        if box.shape != ref.shape:
            if box.shape == (3,) and ref.shape == (3, 3):
                box = torch.diag(box)
            elif box.shape != (3, 3):
                box = torch.broadcast_to(box, ref.shape)
        return self._swap(box=box)

    def with_particle_parameters(self, q0=None, sigma=None,
                                 epsilon=None) -> "ChargeFluxSystem":
        """The same system with new per-particle parameters (the OpenMM
        ``updateParametersInContext`` analog), shapes unchanged.  Where
        the dispersion tail correction is on and sigma or epsilon change,
        the tail coefficient is recomputed on the host, as in the JAX
        package."""
        new = {}
        for name, val in (("q0", q0), ("sigma", sigma), ("epsilon", epsilon)):
            if val is None:
                continue
            old = getattr(self, name)
            arr = (val.to(dtype=old.dtype, device=old.device)
                   if torch.is_tensor(val) else torch.as_tensor(
                       np.asarray(val, np.float64), device=old.device
                   ).to(old.dtype))
            if arr.shape != old.shape:
                raise ValueError(
                    f"{name} shape {tuple(arr.shape)} != {tuple(old.shape)}; "
                    f"the particle count is fixed when the system is built")
            new[name] = arr
        if self.spec.tail_coeff is not None and (
                sigma is not None or epsilon is not None):
            new["spec"] = dataclasses.replace(
                self.spec, tail_coeff=dispersion_tail_coefficient(
                    new.get("sigma", self.sigma).cpu().double().numpy(),
                    new.get("epsilon", self.epsilon).cpu().double().numpy(),
                    self.spec.cutoff))
        return self._swap(**new)


ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(ChargeFluxSystem)
                     if f.init and f.name != "spec")
_INDEX_FIELDS = ("exclusions", "bond_idx", "angle_idx", "water_idx")


def _template_set(obj) -> Optional[TemplateSet]:
    """A TemplateSet from this package's class, from ``dataclasses.asdict``
    output, or from any object with the same attributes (the JAX
    package's TemplateSet)."""
    if obj is None or isinstance(obj, TemplateSet):
        return obj
    get = (obj.get if isinstance(obj, dict)
           else lambda k: getattr(obj, k))
    tpls = []
    for t in get("templates"):
        tget = (t.get if isinstance(t, dict) else lambda k, t=t: getattr(t, k))
        tpls.append(MoleculeTemplate(
            offset=int(tget("offset")), stride=int(tget("stride")),
            count=int(tget("count")),
            rows=tuple((str(k), tuple(tuple(int(i) for i in r) for r in v))
                       for k, v in tget("rows"))))
    return TemplateSet(
        templates=tuple(tpls),
        remainder=tuple((str(k), int(v)) for k, v in get("remainder")))


def system_from_arrays(arrays: dict, spec_fields: dict, device=None,
                       dtype=torch.float32) -> ChargeFluxSystem:
    """Build the port's system from NumPy leaves.

    ``arrays`` maps each field of :class:`ChargeFluxSystem` (``q0``,
    ``sigma``, ..., ``box``) to an array; ``spec_fields`` maps each field
    of :class:`StaticSpec` to its value (templates may be given as
    ``dataclasses.asdict`` dictionaries or as objects with the same
    attributes).  Float leaves become ``dtype``, index leaves int64, on
    ``device`` (default the CUDA card; ``"cpu"`` for the CPU).
    """
    device = resolve_device(device)
    missing = set(ARRAY_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"system_from_arrays: missing arrays {sorted(missing)}")
    fields = dict(spec_fields)
    for key in ("flux_template", "excl_template"):
        fields[key] = _template_set(fields.get(key))
    for key in ("kmax", "cell_grid", "pme_grid", "pme_slack"):
        if fields.get(key) is not None:
            fields[key] = tuple(int(v) for v in fields[key])
    spec = StaticSpec(**fields)
    tensors = {}
    for name in ARRAY_FIELDS:
        a = np.asarray(arrays[name])
        if name in _INDEX_FIELDS:
            tensors[name] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            tensors[name] = torch.as_tensor(
                a.astype(np.float64), device=device).to(dtype)
    return ChargeFluxSystem(spec=spec, **tensors)


# ---------------------------------------------------------------------------
# Builder with the reference's API surface
# ---------------------------------------------------------------------------


class CoulForce:
    """Builder mirroring the reference ``CoulPlugin::CoulForce`` API
    (defaults: cutoff 1.0 nm, Ewald tolerance 1e-4, non-periodic).  Index
    arguments are validated."""

    def __init__(self):
        self._charges: list[float] = []
        self._sigmas: list[float] = []
        self._epsilons: list[float] = []
        self._exclusions: list[tuple[int, int]] = []
        self._bonds: list[tuple[int, int, float, float]] = []
        self._angles: list[tuple[int, int, int, float, float]] = []
        self._waters: list[tuple] = []
        self._cutoff = 1.0
        self._ewald_tol = 1e-4
        self._pbc = False
        self._use_dispersion = False

    # -- particles ------------------------------------------------------------

    def addParticle(self, charge: float, sigma: float, epsilon: float) -> int:
        self._charges.append(float(charge))
        self._sigmas.append(float(sigma))
        self._epsilons.append(float(epsilon))
        return len(self._charges) - 1

    def getNumParticles(self) -> int:
        return len(self._charges)

    def getParticleParameters(self, index: int):
        return self._charges[index], self._sigmas[index], self._epsilons[index]

    def setParticleParameters(self, index: int, charge: float, sigma: float,
                              epsilon: float):
        self._charges[index] = float(charge)
        self._sigmas[index] = float(sigma)
        self._epsilons[index] = float(epsilon)

    # -- cutoff / PBC / tolerance ----------------------------------------------

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def setCutoffDistance(self, cutoff: float):
        self._cutoff = float(cutoff)

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._pbc

    def setUsesPeriodicBoundaryConditions(self, if_period: bool):
        self._pbc = bool(if_period)

    def setEwaldErrorTolerance(self, tol: float):
        self._ewald_tol = float(tol)

    def getEwaldErrorTolerance(self) -> float:
        return self._ewald_tol

    def setUseDispersionCorrection(self, use: bool):
        """Opt into the isotropic long-range LJ tail correction E += C/V
        (requires PBC)."""
        self._use_dispersion = bool(use)

    def getUseDispersionCorrection(self) -> bool:
        return self._use_dispersion

    # -- exclusions -------------------------------------------------------------

    def addException(self, p1: int, p2: int):
        self._check_particle(p1)
        self._check_particle(p2)
        if p1 == p2:
            raise ValueError("exclusion pair must be two distinct particles")
        self._exclusions.append((p1, p2))

    def getNumExceptions(self) -> int:
        return len(self._exclusions)

    def getExceptionParameters(self, index: int):
        return self._exclusions[index]

    # -- flux terms ---------------------------------------------------------------

    def addFluxBond(self, p1: int, p2: int, k: float, b: float):
        self._check_particle(p1)
        self._check_particle(p2)
        self._bonds.append((p1, p2, float(k), float(b)))

    def getNumFluxBonds(self) -> int:
        return len(self._bonds)

    def getFluxBondParameters(self, index: int):
        return self._bonds[index]

    def addFluxAngle(self, p1: int, p2: int, p3: int, k: float, theta: float):
        for p in (p1, p2, p3):
            self._check_particle(p)
        self._angles.append((p1, p2, p3, float(k), float(theta)))

    def getNumFluxAngles(self) -> int:
        return len(self._angles)

    def getFluxAngleParameters(self, index: int):
        return self._angles[index]

    def addFluxWater(self, po: int, ph1: int, ph2: int, k1: float, k2: float,
                     kub: float, b0: float, ub0: float):
        for p in (po, ph1, ph2):
            self._check_particle(p)
        self._waters.append((po, ph1, ph2, float(k1), float(k2), float(kub),
                             float(b0), float(ub0)))

    def getNumFluxWaters(self) -> int:
        return len(self._waters)

    def getFluxWaterParameters(self, index: int):
        return self._waters[index]

    @staticmethod
    def cast(force) -> "CoulForce":
        if not isinstance(force, CoulForce):
            raise TypeError("force is not a CoulForce")
        return force

    @staticmethod
    def isinstance(force) -> bool:
        return isinstance(force, CoulForce)

    # -- compilation to a system ------------------------------------------------

    def create_system(
        self,
        box=None,
        dtype=torch.float32,
        direct_method: str = "auto",
        cell_capacity: Optional[int] = None,
        recip_method: str = "auto",
        skin_frac: float = 0.05,
        walk_layout: str = "auto",
        halo_devices: Optional[int] = None,
        cell_grid=None,
        pme_grid=None,
        device=None,
    ) -> ChargeFluxSystem:
        """Plan and build the system (same planning and arguments as the
        JAX package's ``create_system``, plus ``device``: the CUDA card by
        default, ``"cpu"`` for the CPU; without CUDA the default raises).

        ``cell_grid`` may only reduce the derived grid (never below the
        cutoff); ``pme_grid`` may only raise the derived mesh; both raise
        otherwise.  The port's energy path runs the periodic routes, on an
        orthorhombic box or a reduced triclinic lattice, and the
        non-periodic one (see energy.py for the routes and for what
        raises).
        """
        device = resolve_device(device)
        n = len(self._charges)
        if n == 0:
            raise ValueError("system has no particles")
        pme_grid_override = pme_grid
        if direct_method not in ("auto", "dense", "cell"):
            raise ValueError(
                f"unknown direct_method {direct_method!r}: expected 'auto', "
                f"'dense' or 'cell'")
        if recip_method not in ("auto", "xla", "pallas", "pme"):
            raise ValueError(
                f"unknown recip_method {recip_method!r}: expected 'auto', "
                f"'xla', 'pallas' or 'pme'")
        if walk_layout not in ("auto", "shift", "concat"):
            raise ValueError(
                f"unknown walk_layout {walk_layout!r}: expected 'auto', "
                f"'shift' or 'concat'")
        if walk_layout == "auto":
            walk_layout = "concat"
        if self._use_dispersion and not self._pbc:
            raise ValueError(
                "the dispersion tail correction needs a periodic box "
                "(E_tail = C/V); disable it or enable PBC")
        triclinic = False
        if self._pbc:
            if box is None:
                raise ValueError("PBC system requires a box")
            box_arr = np.asarray(box, dtype=np.float64)
            if box_arr.size == 9:
                box_arr = box_arr.reshape(3, 3)
                if np.all(box_arr == np.diag(np.diag(box_arr))):
                    box_arr = np.diag(box_arr).copy()
                else:
                    triclinic = True
                    _validate_reduced_box(box_arr)
            else:
                box_arr = box_arr.reshape(3)
            widths = box_widths(box_arr)
            if triclinic and self._cutoff > min(widths) / 2:
                raise ValueError(
                    f"cutoff {self._cutoff} exceeds half the smallest "
                    f"perpendicular box width {min(widths) / 2:.4g}; the "
                    f"reduced-form minimum image is only exact below it")
            alpha = ewald_alpha(self._cutoff, self._ewald_tol)
            kmax = ewald_kmax(tuple(widths), alpha, self._ewald_tol)
            from .pme import DEFAULT_ORDER, pme_grid_size
            pme_order = DEFAULT_ORDER
            pme_grid = pme_grid_size(widths, alpha, self._ewald_tol,
                                     pme_order)
            if pme_grid_override is not None:
                if recip_method in ("xla", "pallas"):
                    raise ValueError(
                        f"pme_grid applies only to the PME reciprocal "
                        f"route; recip_method={recip_method!r} is a "
                        f"kmax-Ewald route that ignores the mesh")
                req = tuple(int(v) for v in pme_grid_override)
                if len(req) != 3 or any(
                        r < d for r, d in zip(req, pme_grid)):
                    raise ValueError(
                        f"pme_grid {req} must be a [3] mesh with every "
                        f"axis >= the tolerance-derived {pme_grid}")
                pme_grid = req
        else:
            if pme_grid_override is not None:
                raise ValueError("pme_grid applies only to periodic systems")
            box_arr = np.zeros(3, dtype=np.float64)
            alpha = None
            kmax = None
            pme_grid = None
            pme_order = 6

        grid = None
        capacity = None
        method = direct_method
        if not self._pbc:
            method = "dense"
        else:
            # cells sized with skin_frac * cutoff of Verlet skin
            eff = self._cutoff * (1.0 + skin_frac)
            ncells = tuple(int(np.floor(w / eff)) for w in widths)
            if halo_devices is not None and halo_devices > 1:
                best = None
                for ddx in range(min(halo_devices, ncells[0]), 0, -1):
                    if halo_devices % ddx:
                        continue
                    ddy = halo_devices // ddx
                    gxh = (ncells[0] // ddx) * ddx
                    gyh = (ncells[1] // ddy) * ddy
                    if gxh < max(3, ddx) or gyh < max(3, ddy):
                        continue
                    key = (gxh * gyh, ddy == 1)
                    if best is None or key > best[0]:
                        best = (key, (gxh, gyh))
                if best is None:
                    raise ValueError(
                        f"halo_devices={halo_devices}: the box fits only "
                        f"{ncells[0]}x{ncells[1]} x/y cells at cutoff "
                        f"{self._cutoff} — no >=3-cell grid factors over "
                        f"the device count")
                ncells = best[1] + ncells[2:]
            cell_ok = all(c >= 3 for c in ncells)
            if method == "auto":
                if halo_devices is not None and halo_devices > 1:
                    method = "cell"
                else:
                    method = "cell" if (cell_ok and n > 2048) else "dense"
            elif method == "dense" and halo_devices is not None \
                    and halo_devices > 1:
                raise ValueError(
                    "halo_devices requires the cell route "
                    "(direct_method='cell' or 'auto')")
            if method == "cell":
                if not cell_ok:
                    raise ValueError(
                        f"box (plane widths {tuple(widths)}) too small for "
                        f"a cell list at cutoff {self._cutoff} (need >=3 "
                        f"cells per axis)")
                if cell_grid is not None:
                    req = tuple(int(g) for g in cell_grid)
                    if len(req) != 3 or any(g < 3 for g in req):
                        raise ValueError(
                            f"cell_grid override {req} needs 3 axes of "
                            f">=3 cells")
                    hard_max = tuple(int(np.floor(w / self._cutoff))
                                     for w in widths)
                    if any(r > d for r, d in zip(req, hard_max)):
                        raise ValueError(
                            f"cell_grid override {req} exceeds the "
                            f"zero-skin bound {hard_max}: cells would "
                            f"shrink below the cutoff and miss pairs")
                    if halo_devices is not None and halo_devices > 1 \
                            and req[0] % halo_devices:
                        raise ValueError(
                            f"cell_grid override x-axis {req[0]} not "
                            f"divisible by halo_devices={halo_devices}")
                    ncells = req
                grid = ncells
                if cell_capacity is None:
                    n_total_cells = ncells[0] * ncells[1] * ncells[2]
                    avg = n / n_total_cells
                    # ~4-sigma Poisson headroom, padded to a multiple of 8
                    # and snapped up (never down) to a 128 multiple when
                    # within 16 — the JAX package's rule, kept so both
                    # packages plan the same capacity
                    capacity = int(np.ceil(
                        max(avg + 4 * math.sqrt(max(avg, 1.0)) + 4, 8.0)))
                    capacity = ((capacity + 7) // 8) * 8
                    snapped = -(-capacity // 128) * 128
                    if snapped - capacity <= 16:
                        capacity = snapped
                else:
                    capacity = int(cell_capacity)

        walk_chunks = 1
        if method == "cell" and walk_layout.startswith("concat"):
            s_width = 14
            lane_w = -(-s_width * capacity // 128) * 128
            itemsize = torch.empty((), dtype=dtype).element_size()
            tile_bytes = (grid[0] * grid[1] * grid[2] * capacity
                          * lane_w * itemsize)
            budget = 320 * 2 ** 20
            for d in range(1, grid[0] + 1):
                if grid[0] % d == 0 and tile_bytes // d <= budget:
                    walk_chunks = d
                    break
            else:
                walk_chunks = grid[0]

        if self._pbc and not triclinic and \
                self._cutoff > float(np.min(box_arr)) / 2 and \
                method == "dense":
            import warnings
            warnings.warn(
                f"cutoff {self._cutoff} exceeds min(box)/2 = "
                f"{float(np.min(box_arr)) / 2:.4g}; the dense min-image sum "
                f"counts only the nearest periodic image of each pair",
                stacklevel=2)

        excl = sorted({(min(p), max(p)) for p in self._exclusions})
        bonds = self._bonds
        angles = self._angles
        waters = self._waters

        flux_template = None
        det = detect_templates({
            "bonds": np.asarray([[b[0], b[1]] for b in bonds],
                                dtype=np.int64).reshape(len(bonds), 2),
            "angles": np.asarray([[a[0], a[1], a[2]] for a in angles],
                                 dtype=np.int64).reshape(len(angles), 3),
            "waters": np.asarray([[w[0], w[1], w[2]] for w in waters],
                                 dtype=np.int64).reshape(len(waters), 3),
        }, n_atoms=n)
        if det is not None:
            flux_template, perms = det
            bonds = [bonds[i] for i in perms["bonds"]]
            angles = [angles[i] for i in perms["angles"]]
            waters = [waters[i] for i in perms["waters"]]

        excl_template = None
        det = detect_templates({
            "exclusions": np.asarray([list(e) for e in excl],
                                     dtype=np.int64).reshape(len(excl), 2),
        }, n_atoms=n)
        if det is not None:
            excl_template, perms = det
            excl = [excl[i] for i in perms["exclusions"]]

        tail_coeff = None
        if self._use_dispersion:
            tail_coeff = dispersion_tail_coefficient(
                self._sigmas, self._epsilons, self._cutoff)

        pme_slack = (0, 0, 0)
        if self._pbc and grid is not None and pme_grid is not None:
            skin = max(float(min(widths[a] / grid[a] for a in range(3)))
                       - self._cutoff, 0.0)
            pme_slack = tuple(
                int(math.ceil(0.5 * skin / (widths[a] / pme_grid[a])))
                for a in range(3))

        spec = StaticSpec(
            pbc=self._pbc, cutoff=self._cutoff, ewald_tol=self._ewald_tol,
            alpha=alpha, kmax=kmax, direct_method=method, cell_grid=grid,
            cell_capacity=capacity, walk_layout=walk_layout,
            walk_chunks=walk_chunks, recip_method=recip_method,
            pme_grid=pme_grid, pme_order=pme_order, pme_slack=pme_slack,
            tail_coeff=tail_coeff, flux_template=flux_template,
            excl_template=excl_template)

        def rows(x, width):
            return np.asarray(x, dtype=np.float64).reshape(-1, width) \
                if width else np.asarray(x, dtype=np.float64)

        arrays = dict(
            q0=self._charges, sigma=self._sigmas, epsilon=self._epsilons,
            exclusions=rows([list(e) for e in excl], 2),
            bond_idx=rows([[b[0], b[1]] for b in bonds], 2),
            bond_k=[b[2] for b in bonds], bond_b=[b[3] for b in bonds],
            angle_idx=rows([[a[0], a[1], a[2]] for a in angles], 3),
            angle_k=[a[3] for a in angles],
            angle_theta0=[a[4] for a in angles],
            water_idx=rows([[w[0], w[1], w[2]] for w in waters], 3),
            water_k1=[w[3] for w in waters], water_k2=[w[4] for w in waters],
            water_kub=[w[5] for w in waters], water_b0=[w[6] for w in waters],
            water_ub0=[w[7] for w in waters],
            box=box_arr)
        return system_from_arrays(
            arrays, {f.name: getattr(spec, f.name)
                     for f in dataclasses.fields(spec)},
            device=device, dtype=dtype)

    # -- serialization -----------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "particles": [[q, s, e] for q, s, e in zip(
                self._charges, self._sigmas, self._epsilons)],
            "exclusions": [list(e) for e in self._exclusions],
            "flux_bonds": [list(b) for b in self._bonds],
            "flux_angles": [list(a) for a in self._angles],
            "flux_waters": [list(w) for w in self._waters],
            "cutoff": self._cutoff,
            "ewald_tolerance": self._ewald_tol,
            "pbc": self._pbc,
            "dispersion_correction": self._use_dispersion,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CoulForce":
        force = cls()
        for q, s, e in d["particles"]:
            force.addParticle(q, s, e)
        for p1, p2 in d.get("exclusions", []):
            force.addException(p1, p2)
        for b in d.get("flux_bonds", []):
            force.addFluxBond(*b)
        for a in d.get("flux_angles", []):
            force.addFluxAngle(*a)
        for w in d.get("flux_waters", []):
            force.addFluxWater(*w)
        force.setCutoffDistance(d.get("cutoff", 1.0))
        force.setEwaldErrorTolerance(d.get("ewald_tolerance", 1e-4))
        force.setUsesPeriodicBoundaryConditions(d.get("pbc", False))
        force.setUseDispersionCorrection(d.get("dispersion_correction", False))
        return force

    def _check_particle(self, p: int):
        if not (0 <= p < len(self._charges)):
            raise IndexError(
                f"particle index {p} out of range [0, {len(self._charges)})")
