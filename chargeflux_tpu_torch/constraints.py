"""Holonomic constraints (torch counterpart of ``chargeflux_tpu.constraints``):
rigid 3-site water by SETTLE or a Newton-iterated RATTLE projection, and
general distance constraints by parallel SHAKE/RATTLE, with the
constrained velocity-Verlet and BAOAB drivers.

Rigid waters live in the contiguous template layout (``count`` molecules
of sites O, H1, H2 from atom ``offset``), seen as structure-of-arrays
[M] vectors, one per (site, coordinate): every projection is a fixed
chain of elementwise torch operations, with no iteration that depends on
the data, so a trajectory chunk that runs it is captured into a CUDA graph
whole.  The JAX package wrote these projections as plain XLA too, not as
Pallas kernels.  Failure is visible, as there: a Newton residual past its
tolerance, a SHAKE sweep that does not converge, and a SETTLE proposal no
rotation can restore (a negative square-root argument) NaN-poison the
positions, never a silently wrong geometry.

The drivers take a ``torch.Generator`` for their noise and run in chunks
as ``integrate``'s do (``integrate.Chunk``: static buffers, one CUDA graph
replay per chunk on the card unless ``graph=False``).  Resuming
:func:`rattle_langevin_trajectory_nb` with the same generator continues
the trajectory to round-off, not bit for bit: each call projects its
initial velocities again, which perturbs the last bits of an already
projected state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import integrate
from .device import constant, resolve_device
from .rows import RowPlan, row_plan, scatter_add_planned
from .utils.profiling import phase_scope

# bond k connects sites (I[k], J[k]); water sites ordered O, H1, H2
_BOND_I = (0, 0, 1)
_BOND_J = (1, 2, 2)


def _incidence() -> np.ndarray:
    s = np.zeros((3, 3))   # incidence: s[k, site]
    for k in range(3):
        s[k, _BOND_I[k]] = 1.0
        s[k, _BOND_J[k]] = -1.0
    return s


_S_ROWS = tuple(map(tuple, _incidence().tolist()))


@dataclasses.dataclass(frozen=True)
class RigidWaterParams:
    """Constraint metadata for ``count`` contiguous 3-site molecules
    starting at atom ``offset`` (site order O, H1, H2, matching the water
    model functions)."""

    targets2: torch.Tensor  # [3] squared bond lengths (OH1, OH2, HH), nm^2
    inv_m: torch.Tensor     # [3] 1/mass per site, 1/amu
    offset: int
    count: int

    @classmethod
    def create(cls, count: int, d_oh: float, d_hh: float, m_o: float,
               m_h: float, offset: int = 0, dtype=torch.float64,
               device=None) -> "RigidWaterParams":
        """On the card unless ``device`` says otherwise."""
        dev = resolve_device(device)
        return cls(
            targets2=torch.tensor([d_oh * d_oh, d_oh * d_oh, d_hh * d_hh],
                                  dtype=dtype, device=dev),
            inv_m=torch.tensor([1.0 / m_o, 1.0 / m_h, 1.0 / m_h],
                               dtype=dtype, device=dev),
            offset=offset, count=count)

    @property
    def n_constraints(self) -> int:
        return 3 * self.count


def _mol_view(x, params):
    """[N, 3] -> (head, [count, 3 sites, 3], tail)."""
    o, c = params.offset, params.count
    return x[:o], x[o:o + 3 * c].reshape(c, 3, 3), x[o + 3 * c:]


def _bond_vectors(xm):
    """[M, 3, 3] site positions -> [M, 3 bonds, 3] bond vectors."""
    return torch.stack([xm[:, _BOND_I[k]] - xm[:, _BOND_J[k]]
                        for k in range(3)], dim=1)


def _mass_coupling(inv_m):
    """w[k, l] = sum over sites of incidence_k incidence_l / m_site: the
    mass metric coupling bond k's constraint to bond l's impulse, [3, 3]
    (exact: at most two nonzero terms per entry)."""
    s = constant(_S_ROWS, inv_m.dtype, inv_m.device)
    return torch.sum(s[:, None, :] * s[None, :, :] * inv_m, dim=-1)


# --- structure-of-arrays projection core ------------------------------------


def _soa_view(x, params):
    """[N, 3] -> (head, xs[site][coord] of [M] strided views, tail)."""
    head, xm, tail = _mol_view(x, params)
    return head, tuple(tuple(xm[:, s, d] for d in range(3))
                       for s in range(3)), tail


def _soa_pack(head, xs, tail):
    """Inverse of :func:`_soa_view`."""
    xm = torch.stack([c for row in xs for c in row], dim=1).reshape(-1, 3)
    if head.shape[0] == 0 and tail.shape[0] == 0:
        return xm
    return torch.cat([head, xm, tail], dim=0)


def _bond_soa(xs):
    """xs[site][coord] -> bond vectors d[bond][coord], each [M]."""
    return tuple(tuple(xs[_BOND_I[k]][c] - xs[_BOND_J[k]][c]
                       for c in range(3)) for k in range(3))


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _solve33_soa(a, b):
    """Closed-form adjugate solve on [M] components: a[k][l], b[k] ->
    x[k]."""
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    inv_det = 1.0 / det
    return ((c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det,
            (c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det,
            (c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det)


def _displace_soa(lam, d_ref, im):
    """dx[site][coord] from bond impulses (im[site] per-site 1/m): x_i +=
    2 lam_k d_ref_k / m_i with incidence signs."""
    dx = [[None, None, None] for _ in range(3)]
    for k in range(3):
        for c in range(3):
            imp = 2.0 * lam[k] * d_ref[k][c]
            i, j = _BOND_I[k], _BOND_J[k]
            vi = imp * im[i]
            vj = -imp * im[j]
            dx[i][c] = vi if dx[i][c] is None else dx[i][c] + vi
            dx[j][c] = vj if dx[j][c] is None else dx[j][c] + vj
    return dx


def _poison(bad, like):
    """1 or NaN (``bad``, a device bool) in ``like``'s type."""
    return torch.where(bad, torch.nan, 1.0).to(like.dtype)


# ---------------------------------------------------------------------------
# General distance constraints (parallel SHAKE/RATTLE)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistanceConstraints:
    """Arbitrary pairwise distance constraints (solute X-H bonds, mixed
    systems): ``n_iter`` Jacobi sweeps of SHAKE / RATTLE, a fixed count,
    each a [C]-vector update; non-convergence NaN-poisons.  The impulses
    are summed into the atoms in the fixed order of ``plan`` (made once on
    the host), so the sweeps give the same bits on every run.  Both this
    class and :class:`RigidWaterParams` plug into the ``params`` slot of
    every driver."""

    idx: torch.Tensor        # [C, 2] int64 endpoint atom ids
    targets2: torch.Tensor   # [C] squared target lengths, nm^2
    inv_m: torch.Tensor      # [N] per-atom inverse masses, 1/amu
    plan: RowPlan            # fixed order of the impulses into the atoms
    n_iter: int = 128
    omega: float = 1.0

    @classmethod
    def create(cls, pairs, lengths, masses, n_iter: int = 128,
               omega: float = 1.0, dtype=torch.float64, device=None):
        """On the card unless ``device`` says otherwise."""
        dev = resolve_device(device)
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        lengths = np.asarray(lengths, np.float64).reshape(-1)
        if pairs.shape[0] != lengths.shape[0]:
            raise ValueError("one target length per constrained pair")
        masses = np.asarray(torch.as_tensor(masses).cpu(), np.float64)
        return cls(idx=torch.as_tensor(pairs, device=dev),
                   targets2=torch.as_tensor(lengths * lengths).to(dtype)
                   .to(dev),
                   inv_m=(1.0 / torch.as_tensor(masses).to(dtype)).to(dev),
                   plan=row_plan(pairs.T.reshape(-1), dev),
                   n_iter=n_iter, omega=omega)

    @property
    def n_constraints(self) -> int:
        return int(self.idx.shape[0])


def _apply_impulses(x, corr, p: DistanceConstraints, im_i, im_j):
    """x[i] -= corr / m_i and x[j] += corr / m_j, in the plan's order."""
    vals = torch.cat([-corr * im_i[:, None], corr * im_j[:, None]])
    return scatter_add_planned(x, vals, p.plan)


def _shake_positions(x_old, x_unc, p: DistanceConstraints, tol=None):
    """Parallel-SHAKE position projection along the ``x_old`` bond
    directions with mass weighting (valid constraint impulses)."""
    dtype = x_unc.dtype
    if tol is None:
        tol = 1e-10 if dtype == torch.float64 else 1e-4
    i, j = p.idx[:, 0], p.idx[:, 1]
    im = p.inv_m.to(dtype)
    im_i, im_j = im[i], im[j]
    t2 = p.targets2.to(dtype)
    d_ref = x_old[i] - x_old[j]                        # [C, 3]
    denom = 2.0 * (im_i + im_j)
    x = x_unc
    for _ in range(p.n_iter):
        d = x[i] - x[j]
        c = torch.sum(d * d, dim=-1) - t2
        g = torch.sum(d * d_ref, dim=-1)
        dlam = p.omega * c / (denom * g)
        x = _apply_impulses(x, dlam[:, None] * d_ref, p, im_i, im_j)
    d = x[i] - x[j]
    res = torch.max(torch.abs(torch.sum(d * d, dim=-1) - t2))
    return x * _poison(res > tol, x)


def _shake_velocities(x, v_unc, p: DistanceConstraints, tol=None):
    """Parallel-RATTLE velocity projection (J v = 0 along the current
    bonds); a residual past ``tol`` poisons."""
    dtype = v_unc.dtype
    if tol is None:
        tol = 1e-8 if dtype == torch.float64 else 1e-3
    i, j = p.idx[:, 0], p.idx[:, 1]
    im = p.inv_m.to(dtype)
    im_i, im_j = im[i], im[j]
    d = x[i] - x[j]
    d2 = torch.sum(d * d, dim=-1)
    denom = d2 * (im_i + im_j)
    v = v_unc
    for _ in range(p.n_iter):
        dv = v[i] - v[j]
        c = torch.sum(d * dv, dim=-1)
        dmu = p.omega * c / denom
        v = _apply_impulses(v, dmu[:, None] * d, p, im_i, im_j)
    dv = v[i] - v[j]
    # residual in relative-velocity units (nm/ps) along the unit bond
    res = torch.max(torch.abs(torch.sum(d * dv, dim=-1)) / torch.sqrt(d2))
    return v * _poison(res > tol, v)


#: Rigid-water position projection: "settle" (closed form, the default,
#: as in the JAX package) or "newton" (the iterated 3x3 multiplier solve);
#: both solve the same SHAKE equations and agree to rounding.
RIGID_PROJECTION = "settle"


def _cross_soa(u, v):
    return (u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0])


def _unit_soa(u):
    inv = torch.rsqrt(_dot3(u, u))
    return (u[0] * inv, u[1] * inv, u[2] * inv)


def settle_positions(x_old, x_unc, params: RigidWaterParams):
    """Closed-form SETTLE position projection (Miyamoto & Kollman,
    J. Comput. Chem. 13, 952 (1992)): the analytic solution of the SHAKE
    equations :func:`project_positions`'s Newton path iterates, so each
    molecule's COM and angular momentum are preserved.  Requires the
    isoceles OH1 == OH2 geometry ``RigidWaterParams.create`` makes.  A
    degenerate proposal (no rotation restores the triangle) makes a
    square-root argument negative and NaN-poisons its molecule."""
    head, xo, tail = _soa_view(x_old, params)
    _, xu, _ = _soa_view(x_unc, params)
    dtype = x_unc.dtype
    im = params.inv_m.to(dtype)
    t2 = params.targets2.to(dtype)
    m_o, m_h = 1.0 / im[0], 1.0 / im[1]

    # canonical isoceles geometry (origin at the molecule's COM, O on +y):
    # O = (0, ra), H = (-+rc, -rb) with rc = d_HH / 2 and ra + rb = h
    rc = 0.5 * torch.sqrt(t2[2])
    h = torch.sqrt(t2[0] - 0.25 * t2[2])
    ra = 2.0 * m_h * h / (m_o + 2.0 * m_h)
    rb = h - ra

    # unconstrained COM (constraint impulses cannot move it)
    w_o = m_o / (m_o + 2.0 * m_h)
    w_h = m_h / (m_o + 2.0 * m_h)
    com = tuple(w_o * xu[0][c] + w_h * (xu[1][c] + xu[2][c])
                for c in range(3))
    a1 = tuple(xu[0][c] - com[c] for c in range(3))
    b1 = tuple(xu[1][c] - com[c] for c in range(3))
    c1 = tuple(xu[2][c] - com[c] for c in range(3))
    b0 = tuple(xo[1][c] - xo[0][c] for c in range(3))
    c0 = tuple(xo[2][c] - xo[0][c] for c in range(3))

    # molecule frame: ez normal to the old plane, ex normal to (new O
    # offset, ez), ey completes it
    ez = _unit_soa(_cross_soa(b0, c0))
    ex = _unit_soa(_cross_soa(a1, ez))
    ey = _unit_soa(_cross_soa(ez, ex))

    xb0 = _dot3(b0, ex)
    yb0 = _dot3(b0, ey)
    xc0 = _dot3(c0, ex)
    yc0 = _dot3(c0, ey)
    za1 = _dot3(a1, ez)
    xb1, yb1, zb1 = _dot3(b1, ex), _dot3(b1, ey), _dot3(b1, ez)
    xc1, yc1, zc1 = _dot3(c1, ex), _dot3(c1, ey), _dot3(c1, ez)

    # out-of-plane tilt (phi) and twist (psi) from the z components
    sinphi = za1 / ra
    cosphi = torch.sqrt(1.0 - sinphi * sinphi)
    sinpsi = (zb1 - zc1) / (2.0 * rc * cosphi)
    cospsi = torch.sqrt(1.0 - sinpsi * sinpsi)

    ya2 = ra * cosphi
    xb2 = -rc * cospsi
    t_b = -rb * cosphi
    t_c = rc * sinpsi * sinphi
    yb2 = t_b - t_c
    yc2 = t_b + t_c

    # in-plane rotation (theta) closing the old-geometry projection
    alpha = xb2 * (xb0 - xc0) + yb0 * yb2 + yc0 * yc2
    beta = xb2 * (yc0 - yb0) + xb0 * yb2 + xc0 * yc2
    gamma = xb0 * yb1 - xb1 * yb0 + xc0 * yc1 - xc1 * yc0
    a2b2 = alpha * alpha + beta * beta
    sinth = (alpha * gamma - beta * torch.sqrt(a2b2 - gamma * gamma)) / a2b2
    costh = torch.sqrt(1.0 - sinth * sinth)

    xa3 = -ya2 * sinth
    ya3 = ya2 * costh
    xb3 = xb2 * costh - yb2 * sinth
    yb3 = xb2 * sinth + yb2 * costh
    xc3 = -xb2 * costh - yc2 * sinth
    yc3 = -xb2 * sinth + yc2 * costh

    def back(xd, yd, zd):
        return tuple(com[c] + xd * ex[c] + yd * ey[c] + zd * ez[c]
                     for c in range(3))

    xm = (back(xa3, ya3, za1), back(xb3, yb3, zb1), back(xc3, yc3, zc1))
    return _soa_pack(head, xm, tail)


def project_positions(x_old, x_unc, params, n_iter: int = 4,
                      tol: float = None, method: str | None = None):
    """RATTLE position projection: ``x_unc`` with every constrained bond
    restored to its target length, moved along the mass-weighted
    constraint gradients of ``x_old`` (which must satisfy the
    constraints).  ``method`` (default :data:`RIGID_PROJECTION`) picks the
    rigid-water solver: "settle" (:func:`settle_positions`) or "newton",
    ``n_iter`` iterations of the 3x3 multiplier system, NaN-poisoned if
    the final residual exceeds ``tol`` (default 1e-10 nm^2 in f64, 1e-4
    in f32).  A :class:`DistanceConstraints` takes the parallel-SHAKE
    route."""
    if isinstance(params, DistanceConstraints):
        return _shake_positions(x_old, x_unc, params, tol)
    if (RIGID_PROJECTION if method is None else method) == "settle":
        return settle_positions(x_old, x_unc, params)
    head, xo, tail = _soa_view(x_old, params)
    _, xu, _ = _soa_view(x_unc, params)
    dtype = x_unc.dtype
    if tol is None:
        tol = 1e-10 if dtype == torch.float64 else 1e-4
    inv_m = params.inv_m.to(dtype)
    im = [inv_m[s] for s in range(3)]                 # per-site scalars
    t2 = params.targets2.to(dtype)
    d_old = _bond_soa(xo)
    w = _mass_coupling(inv_m)                         # [3, 3]

    def corrected(lam):
        dx = _displace_soa(lam, d_old, im)
        return tuple(tuple(xu[s][c] + dx[s][c] for c in range(3))
                     for s in range(3))

    zero = torch.zeros((params.count,), dtype=dtype, device=x_unc.device)
    lam = (zero, zero, zero)
    for _ in range(n_iter):
        d = _bond_soa(corrected(lam))
        g = tuple(_dot3(d[k], d[k]) - t2[k] for k in range(3))
        # A[k, l] = dg_k / dlam_l = 4 w[k, l] (d_k . d_old_l)
        a = [[4.0 * w[k, l] * _dot3(d[k], d_old[l]) for l in range(3)]
             for k in range(3)]
        dl = _solve33_soa(a, g)
        lam = tuple(lam[k] - dl[k] for k in range(3))

    xm = corrected(lam)
    d = _bond_soa(xm)
    res = [torch.max(torch.abs(_dot3(d[k], d[k]) - t2[k])) for k in range(3)]
    poison = _poison(torch.maximum(torch.maximum(res[0], res[1]), res[2])
                     > tol, x_unc)
    xm = tuple(tuple(xm[s][c] * poison for c in range(3)) for s in range(3))
    return _soa_pack(head, xm, tail)


def project_velocities(x, v_unc, params):
    """RATTLE velocity projection: ``v_unc`` with the relative velocity
    along every constrained bond removed (J v = 0), by one exact 3x3 solve
    per molecule; each molecule's COM velocity and angular momentum are
    preserved.  A :class:`DistanceConstraints` takes the parallel-RATTLE
    route."""
    if isinstance(params, DistanceConstraints):
        return _shake_velocities(x, v_unc, params)
    head, xm, tail = _soa_view(x, params)
    _, vm, _ = _soa_view(v_unc, params)
    inv_m = params.inv_m.to(v_unc.dtype)
    im = [inv_m[s] for s in range(3)]
    d = _bond_soa(xm)
    dv = _bond_soa(vm)                                        # relative v
    g = tuple(_dot3(d[k], dv[k]) for k in range(3))           # J v / 2
    w = _mass_coupling(inv_m)
    a = [[w[k, l] * _dot3(d[k], d[l]) for l in range(3)] for k in range(3)]
    mu = _solve33_soa(a, tuple(-gk for gk in g))
    dx = _displace_soa(tuple(0.5 * m_ for m_ in mu), d, im)
    vm = tuple(tuple(vm[s][c] + dx[s][c] for c in range(3))
               for s in range(3))
    return _soa_pack(head, vm, tail)


def constraint_residuals(x, params):
    """Squared-length violations, nm^2: [count, 3] for the rigid-water
    template, [C] for general distance constraints."""
    if isinstance(params, DistanceConstraints):
        d = x[params.idx[:, 0]] - x[params.idx[:, 1]]
        return torch.sum(d * d, dim=-1) - params.targets2.to(x.dtype)
    _, xm, _ = _mol_view(x, params)
    d = _bond_vectors(xm)
    return torch.sum(d * d, dim=-1) - params.targets2.to(x.dtype)


# ---------------------------------------------------------------------------
# Constrained integrators
# ---------------------------------------------------------------------------


def _rattle_verlet(force, masses, dt, params):
    """One RATTLE velocity-Verlet step as an ``integrate.Chunk`` step;
    ``force(x, nb) -> (energy, forces)``; its record is the total
    energy."""

    def step(carry, nb):
        inv_m = (1.0 / masses)[:, None]
        x, v, f = carry
        v_half = v + 0.5 * dt * f * inv_m
        x_new = project_positions(x, x + dt * v_half, params)
        v_half = (x_new - x) / dt          # constraint impulse folded into v
        e, f_new = force(x_new, nb)
        v_new = project_velocities(x_new, v_half + 0.5 * dt * f_new * inv_m,
                                   params)
        return (x_new, v_new, f_new), e, e + integrate.kinetic_energy(
            v_new, masses)
    return step


def rattle_verlet_step(x, v, f, energy_fn, masses, dt: float, params):
    """One velocity-Verlet step with RATTLE position and velocity
    projections.  Returns (x, v, f, potential)."""
    step = _rattle_verlet(
        lambda xx, nb: integrate._energy_and_forces(energy_fn, xx), masses,
        dt, params)
    (x, v, f), e, _ = step((x, v, f), None)
    return x, v, f, e


def _rattle_baoab(force, masses, dt, temperature, friction, generator,
                  params):
    """One constrained BAOAB step as an ``integrate.Chunk`` step: each B
    and O stage projects the velocities, each A half-drift the positions
    (folding the impulse into the velocities); its record is the kinetic
    energy."""
    c1, c2 = integrate.baoab_coeffs(dt, friction, temperature)

    def a_half(xx, vv):
        x_new = project_positions(xx, xx + 0.5 * dt * vv, params)
        return x_new, (x_new - xx) / (0.5 * dt)

    def step(carry, nb):
        inv_m = (1.0 / masses)[:, None]
        xx, vv, ff = carry
        vv = project_velocities(xx, vv + 0.5 * dt * ff * inv_m, params)  # B
        xx, vv = a_half(xx, vv)                                          # A
        noise = integrate.normal_noise(vv, generator)
        vv = project_velocities(xx, c1 * vv + c2 * torch.sqrt(inv_m) * noise,
                                params)                                  # O
        xx, vv = a_half(xx, vv)                                          # A
        e, f = force(xx, nb)
        vv = project_velocities(xx, vv + 0.5 * dt * f * inv_m, params)   # B
        return (xx, vv, f), e, integrate.kinetic_energy(vv, masses)
    return step


def _dense_run(x, v, energy_fn, masses, n_steps, graph, key, make_step,
               params, generator=None):
    """The dense RATTLE drivers' loop: chunks of
    ``integrate.STEPS_PER_CHUNK`` (``make_step(masses, generator)`` gives
    a step) from (x, v, F(x)); returns ((x, v, f, potential at the last
    positions), per-step records)."""
    if n_steps <= 0:
        raise ValueError("n_steps must be positive")
    _e0, f0 = integrate._energy_and_forces(energy_fn, x)

    def make(k):
        return integrate.Chunk(make_step, None, k, (x,) * 3, graph, masses,
                               generator, keep=(params,))

    last, out = integrate._run_chunks(
        integrate._chunk_getter(energy_fn, graph, x, masses,
                                key + (id(params),), make), (x, v, f0),
        n_steps, integrate.STEPS_PER_CHUNK, masses, generator)
    with phase_scope("cf.md.final"):
        x_fin = last.x.clone()
        with torch.no_grad():
            e_pot = energy_fn(x_fin)
    return (x_fin, last.v.clone(), last.f.clone(), e_pot), out


def rattle_nve_trajectory(x, v, energy_fn, masses, dt: float, n_steps: int,
                          params, graph: bool = True):
    """``n_steps`` of constrained NVE in chunks of
    ``integrate.STEPS_PER_CHUNK`` (each a CUDA graph replay on the card
    unless ``graph=False``).  The initial velocities are projected onto
    the constraint manifold first.  Returns ((x, v, f, potential),
    per-step total energies)."""
    v = project_velocities(x, v, params)

    def make_step(m, _generator):
        return _rattle_verlet(
            lambda xx, nb: integrate._energy_and_forces(energy_fn, xx), m,
            dt, params)
    return _dense_run(x, v, energy_fn, masses, n_steps, graph,
                      ("rattle_nve", float(dt)), make_step, params)


def rattle_langevin_trajectory(x, v, energy_fn, masses, dt: float,
                               temperature: float, friction: float,
                               generator: torch.Generator, n_steps: int,
                               params, graph: bool = True):
    """Constrained BAOAB (Leimkuhler-Matthews "g-BAOAB" with one
    projection per stage) in chunks of ``integrate.STEPS_PER_CHUNK``.
    Returns ((x, v, f, potential), per-step kinetic energies)."""
    integrate._check_generator(generator, x.device)
    v = project_velocities(x, v, params)

    def make_step(m, g):
        return _rattle_baoab(
            lambda xx, nb: integrate._energy_and_forces(energy_fn, xx), m,
            dt, temperature, friction, g, params)
    key = ("rattle_langevin", float(dt), float(temperature), float(friction))
    return _dense_run(x, v, energy_fn, masses, n_steps, graph, key,
                      make_step, params, generator)


def rattle_langevin_trajectory_nb(state, e_fn, init_nb, masses, dt: float,
                                  temperature: float, friction: float,
                                  generator: torch.Generator, n_steps: int,
                                  params, rebuild_every: int = 10,
                                  graph: bool = True):
    """Constrained BAOAB with neighbor-state reuse — the rigid-water analog
    of ``integrate.langevin_trajectory_nb`` (a chunk per rebuild interval,
    each a CUDA graph replay on the card unless ``graph=False``; a
    remainder runs as one shorter chunk), with RATTLE projections at every
    B, A and O stage.  ``state`` is an ``integrate.MDStateNB``; returns
    (final_state, per-step kinetic energies).  The final state keeps the
    carry forces; resuming with the same generator continues to
    round-off (see the module docstring)."""
    if n_steps <= 0:
        raise ValueError("n_steps must be positive")
    x = state.positions
    integrate._check_generator(generator, x.device)
    v0 = project_velocities(x, state.velocities, params)

    def make(k):
        return integrate.Chunk(lambda m, g: _rattle_baoab(
            lambda xx, nb: e_fn(xx, nb)[:2], m, dt, temperature, friction, g,
            params), init_nb, k, (x,) * 3, graph, masses, generator,
            keep=(params,))

    key = ("rattle_langevin_nb", init_nb, id(params), float(dt),
           float(temperature), float(friction))
    chunk, kes = integrate._run_chunks(
        integrate._chunk_getter(e_fn, graph, x, masses, key, make),
        (x, v0, state.forces), n_steps, rebuild_every, masses, generator)
    return integrate._final_nb(chunk, e_fn, init_nb), kes
