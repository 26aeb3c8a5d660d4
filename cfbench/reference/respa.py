"""Plain reference of impulse r-RESPA on the charge-flux water of
:class:`cfbench.reference.water.Model`: its two force tiers and one outer
step, NVE (Verlet-I) or Langevin with the normals handed in.

Straight PyTorch, written from the published splitting and not from the
program's code: it imports nothing of the program and nothing of JAX.

The tiers.  The slow tier is the direct space, the exclusion correction,
the self term and the reciprocal space, all through the flux charges; the
fast tier is the harmonic water bonds and angles.  Each tier's forces are
minus the autograd gradient of its energy.

One outer step of ``dt`` with ``n`` substeps of ``h = dt / n``
(Tuckerman, Berne and Martyna, J. Chem. Phys. 97, 1990 (1992), the
impulse splitting, Verlet-I)::

    v += dt/2 F_slow / m
    n substeps on F_fast
    F_slow at the new positions
    v += dt/2 F_slow / m

NVE substep (velocity Verlet): ``v += h/2 F_fast / m; x += h v; F_fast;
v += h/2 F_fast / m``.  Langevin substep (BAOAB, Leimkuhler and Matthews,
Appl. Math. Res. Express 2013, 34; the O step at the innermost level, as
OpenMM's ``MTSLangevinIntegrator`` applies it)::

    B  v += h/2 F_fast / m
    A  x += h/2 v
    O  v = c1 v + sqrt((1 - c1^2) kB T / m) R,   c1 = exp(-gamma h)
    A  x += h/2 v
       F_fast at x
    B  v += h/2 F_fast / m

Departures from the published description:

* the normals ``R`` are handed in, one [N, 3] set per substep, and not
  drawn here, so that a test can give the program and the reference the
  same noise;
* the split is fixed, bonds and angles fast and the rest slow, where
  OpenMM assigns force groups to levels (its documented example
  ``[(0, 1), (1, 4)]`` is this schedule with ``n = 4``);
* no constraints and no removal of the centre-of-mass motion;
* every slow evaluation makes its own pair list at its positions, where a
  program may reuse one for several steps (the same pairs while no atom
  has moved half the skin).
"""

from __future__ import annotations

import math

import torch

#: Boltzmann's constant, kJ/mol/K
KB = 0.008314462618


def tiers(model, positions) -> dict:
    """The two tiers at ``positions`` [N, 3] in the model's precision:
    ``e_slow``, ``f_slow``, ``e_fast``, ``f_fast`` and ``scale``, the sum
    of the magnitudes of the energy's terms (the size of the rounding a
    float32 sum of them makes)."""
    x = torch.as_tensor(positions).to(model.device, model.dtype)
    pairs = model.pair_list(x)
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        comps = model.components(x, pairs)
        e_fast = comps["bonded"]
        e_slow = sum(v for k, v in comps.items() if k != "bonded")
        (g_slow,) = torch.autograd.grad(e_slow, x, retain_graph=True)
        (g_fast,) = torch.autograd.grad(e_fast, x)
    scale = sum(abs(float(c.detach())) for c in comps.values())
    return {"e_slow": e_slow.detach(), "f_slow": -g_slow,
            "e_fast": e_fast.detach(), "f_fast": -g_fast, "scale": scale}


def fast_forces(model, x):
    """(energy, forces) of the fast tier alone at ``x``."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        e = model.bonded(model._water_geometry(x))
        (g,) = torch.autograd.grad(e, x)
    return e.detach(), -g


def _outer(model, x, v, f_slow, f_fast, masses, dt, n_inner, substep):
    inv_m = 1.0 / masses[:, None]
    v = v + 0.5 * dt * f_slow * inv_m
    for k in range(n_inner):
        x, v, f_fast = substep(k, x, v, f_fast, inv_m)
    t = tiers(model, x)
    v = v + 0.5 * dt * t["f_slow"] * inv_m
    return x, v, t["f_slow"], f_fast


def verlet_i_step(model, x, v, f_slow, f_fast, masses, dt: float,
                  n_inner: int):
    """One NVE outer step: (x, v, f_slow, f_fast) after it."""
    h = dt / n_inner

    def substep(_k, x, v, f, inv_m):
        v = v + 0.5 * h * f * inv_m
        x = x + h * v
        _e, f = fast_forces(model, x)
        return x, v + 0.5 * h * f * inv_m, f

    return _outer(model, x, v, f_slow, f_fast, masses, dt, n_inner, substep)


def langevin_step(model, x, v, f_slow, f_fast, masses, dt: float,
                  n_inner: int, temperature: float, friction: float,
                  normals):
    """One Langevin outer step with the substeps' normals ``normals``
    [n_inner, N, 3]: (x, v, f_slow, f_fast) after it."""
    h = dt / n_inner
    c1 = math.exp(-friction * h)
    c2 = math.sqrt((1.0 - c1 * c1) * KB * temperature)

    def substep(k, x, v, f, inv_m):
        v = v + 0.5 * h * f * inv_m
        x = x + 0.5 * h * v
        v = c1 * v + c2 * torch.sqrt(inv_m) * normals[k]
        x = x + 0.5 * h * v
        _e, f = fast_forces(model, x)
        return x, v + 0.5 * h * f * inv_m, f

    return _outer(model, x, v, f_slow, f_fast, masses, dt, n_inner, substep)


def kinetic_temperature(ke: float, n_atoms: int) -> float:
    """The kinetic temperature (K) of kinetic energy ``ke`` (kJ/mol) over
    3 N degrees of freedom (no constraints, momentum not conserved)."""
    return 2.0 * ke / (3 * n_atoms * KB)
