"""Plain reference of the charge-flux water energy and forces.

Straight PyTorch, written from the model's equations and not from the
program's code: it imports nothing of the program and nothing of JAX, and
it takes only what the benchmark made (positions, the configuration's
frozen water parameters, the box).  Every derived quantity (the flux
charges, the pair list, alpha, the B-spline moduli, the k-vectors) is
worked out here again.

Molecules are (O, H1, H2) triples in atom order.  The energy is

* flux charges: per water, q_O = q0_O + kb (r1 - b0) + kb (r2 - b0)
  - 2 ka (theta - theta0), q_H1 = q0_H - kb (r1 - b0) + ka (theta - theta0),
  and q_H2 alike with r2; r1, r2 the O-H lengths, theta the H-O-H angle;
* Ewald direct space: k_e q_i q_j erfc(alpha r) / r plus Lennard-Jones
  4 eps_ij [(s_ij / r)^12 - (s_ij / r)^6] (Lorentz-Berthelot, no shift)
  over the minimum-image pairs of different molecules closer than the
  cutoff;
* the exclusion correction -k_e q_i q_j erf(alpha r) / r over each
  water's three intramolecular pairs, and the self term
  -k_e alpha / sqrt(pi) sum q^2;
* reciprocal space: smooth particle-mesh Ewald (Essmann et al. 1995,
  order-p cardinal B-splines on a K^3 mesh, the Euler-spline moduli);
* harmonic water bonds and angles, 0.5 k (r - r0)^2 and
  0.5 k (theta - theta0)^2.

Forces are minus the autograd gradient, through the charges.
``precision`` selects float64 (the reference), float32, or "tf32": float32
with the operands of every product (displacements, charges, spline
weights, Lennard-Jones parameters) rounded to TF32's 10-bit
mantissa, the control that a comparison has to reject.
"""

from __future__ import annotations

import math

import torch

#: Coulomb constant 1 / (4 pi eps0) in kJ mol^-1 nm e^-2 (OpenMM's value)
K_E = 138.935456


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value (10-bit mantissa,
    ties to even), with a straight-through gradient."""
    bits = t.detach().contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    rounded = bits.to(torch.int32).view(torch.float32)
    return t + (rounded - t).detach()


PRECISIONS = {"f64": (torch.float64, None), "f32": (torch.float32, None),
              "tf32": (torch.float32, tf32_round)}


class Model:
    """The water model and the electrostatics settings of a configuration
    (its ``water`` and ``system`` groups), in one precision."""

    def __init__(self, water: dict, system: dict, box, precision: str,
                 device):
        self.dtype, rnd = PRECISIONS[precision]
        self.rnd = rnd if rnd is not None else (lambda t: t)
        self.device = device
        self.w = water
        self.cutoff = float(system["cutoff_nm"])
        self.alpha = math.sqrt(-math.log(2.0 * float(system["ewald_tol"]))
                               ) / self.cutoff
        if system["reciprocal"] != "spme":
            raise ValueError("the reference computes SPME only")
        self.box = torch.as_tensor(box, dtype=self.dtype, device=device)
        self.order = int(system["pme_order"])
        self.mesh = tuple(int(k) for k in system["pme_grid"])
        self.moduli = self._spline_moduli()

        def per_site(key):
            return torch.tensor([water[key + "_O"], water[key + "_H"],
                                 water[key + "_H"]], dtype=self.dtype,
                                device=device)

        self.q0 = per_site("charge")
        self.sigma = per_site("sigma")
        self.eps = per_site("epsilon")

    # -- geometry -----------------------------------------------------------

    def image(self, d):
        return d - self.box * torch.round(d / self.box)

    def _water_geometry(self, x):
        """(r1, r2, theta) of every water of x [n_atoms, 3]."""
        o, h1, h2 = x[0::3], x[1::3], x[2::3]
        d1 = self.rnd(self.image(h1 - o))
        d2 = self.rnd(self.image(h2 - o))
        r1 = torch.sqrt(torch.sum(d1 * d1, dim=-1))
        r2 = torch.sqrt(torch.sum(d2 * d2, dim=-1))
        cos = torch.sum(d1 * d2, dim=-1) / (r1 * r2)
        theta = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        return r1, r2, theta

    def charges(self, geom):
        w = self.w
        r1, r2, theta = geom
        db1 = w["flux_bond_k"] * (r1 - w["flux_bond_b0"])
        db2 = w["flux_bond_k"] * (r2 - w["flux_bond_b0"])
        da = w["flux_angle_k"] * (theta - w["flux_angle_theta0"])
        q = torch.stack([self.q0[0] + db1 + db2 - 2.0 * da,
                         self.q0[1] - db1 + da, self.q0[2] - db2 + da], -1)
        return q.reshape(-1)

    def bonded(self, geom):
        w = self.w
        r1, r2, theta = geom
        return (0.5 * w["bond_k"] * torch.sum((r1 - w["bond_r0"]) ** 2
                                              + (r2 - w["bond_r0"]) ** 2)
                + 0.5 * w["angle_k"] * torch.sum(
                    (theta - w["angle_theta0"]) ** 2))

    # -- Ewald terms --------------------------------------------------------

    @torch.no_grad()
    def pair_list(self, x, block: int = 512):
        """(i, j): the pairs of different molecules closer than the cutoff
        under the minimum image, i < j."""
        n = x.shape[0]
        xd = x.detach().to(torch.float64)
        box = self.box.to(torch.float64)
        cols = torch.arange(n, device=x.device)
        rc2 = self.cutoff * self.cutoff
        out_i, out_j = [], []
        for i0 in range(0, n, block):
            rows = cols[i0:i0 + block]
            d = xd[None, :, :] - xd[rows][:, None, :]
            d = d - box * torch.round(d / box)
            keep = torch.sum(d * d, dim=-1) < rc2
            keep &= rows[:, None] < cols[None, :]
            keep &= (rows[:, None] // 3) != (cols[None, :] // 3)
            ii, jj = torch.nonzero(keep, as_tuple=True)
            out_i.append(rows[ii])
            out_j.append(jj)
        return torch.cat(out_i), torch.cat(out_j)

    def direct(self, x, q, pairs):
        i, j = pairs
        d = self.rnd(self.image(x[j] - x[i]))
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        qq = self.rnd(q[i]) * self.rnd(q[j])
        coul = K_E * qq * torch.erfc(self.alpha * r) / r
        sig = self.sigma.repeat(x.shape[0] // 3)
        eps = self.eps.repeat(x.shape[0] // 3)
        sij = self.rnd(0.5 * (sig[i] + sig[j]))
        eij = self.rnd(torch.sqrt(eps[i] * eps[j]))
        sr6 = (sij / r) ** 6
        return torch.sum(coul + 4.0 * eij * (sr6 * sr6 - sr6))

    def exclusion(self, x, q):
        total = 0.0
        qm = q.reshape(-1, 3)
        xm = x.reshape(-1, 3, 3)
        for a, b in ((0, 1), (0, 2), (1, 2)):
            d = self.rnd(self.image(xm[:, b] - xm[:, a]))
            r = torch.sqrt(torch.sum(d * d, dim=-1))
            qq = self.rnd(qm[:, a]) * self.rnd(qm[:, b])
            total = total - K_E * torch.sum(qq * torch.erf(self.alpha * r)
                                            / r)
        return total

    def self_term(self, q):
        return -K_E * self.alpha / math.sqrt(math.pi) * torch.sum(q * q)

    def _spline(self, t):
        """[M_p(t + j) for j = 0..p-1] for t in [0, 1) (Essmann's
        recursion)."""
        m = [t, 1.0 - t]
        for n in range(3, self.order + 1):
            nxt = []
            for j in range(n):
                left = (t + j) * m[j] if j < n - 1 else 0.0
                right = (n - t - j) * m[j - 1] if j > 0 else 0.0
                nxt.append((left + right) / (n - 1))
            m = nxt
        return torch.stack(m, dim=-1)

    def _spline_moduli(self):
        """B(m) = Bx By Bz, |b(m)|^2 per axis: 1 / |sum_k M_p(k + 1)
        exp(2 pi i m k / K)|^2 over k = 0..p-2."""
        p = self.order
        t0 = torch.zeros((), dtype=torch.float64)
        nodes = self._spline(t0)[1:].to(torch.float64)   # M_p(1..p-1)
        out = []
        for k in self.mesh:
            m = torch.arange(k, dtype=torch.float64)
            j = torch.arange(p - 1, dtype=torch.float64)
            ph = 2.0 * math.pi * m[:, None] * j[None, :] / k
            re = torch.sum(nodes * torch.cos(ph), dim=1)
            im = torch.sum(nodes * torch.sin(ph), dim=1)
            out.append(1.0 / (re * re + im * im))
        bx, by, bz = out
        b = bx[:, None, None] * by[None, :, None] * bz[None, None, :]
        return b.to(self.dtype).to(self.device)

    def spme(self, x, q):
        """Smooth PME: charges spread by M_p onto the mesh, E = 2 pi k_e / V
        sum_{m != 0} exp(-k^2 / 4 alpha^2) / k^2 B(m) |FFT(Q)(m)|^2."""
        p, mesh = self.order, self.mesh
        kdims = torch.tensor(mesh, dtype=self.dtype, device=x.device)
        frac = x / self.box
        u = (frac - torch.floor(frac.detach())) * kdims
        base = torch.floor(u.detach())
        t = u - base
        w = [self.rnd(self._spline(t[:, a])) for a in range(3)]  # [N, p]
        j = torch.arange(p, device=x.device)
        idx = [(base[:, a].long()[:, None] - j[None, :]) % mesh[a]
               for a in range(3)]
        flat = ((idx[0][:, :, None, None] * mesh[1]
                 + idx[1][:, None, :, None]) * mesh[2]
                + idx[2][:, None, None, :]).reshape(-1)
        val = (self.rnd(q)[:, None, None, None] * w[0][:, :, None, None]
               * w[1][:, None, :, None] * w[2][:, None, None, :]).reshape(-1)
        grid = torch.zeros(mesh[0] * mesh[1] * mesh[2], dtype=self.dtype,
                           device=x.device).index_add(0, flat, val)
        f = torch.fft.fftn(grid.reshape(mesh))
        k2 = 0.0
        for a in range(3):
            m = torch.fft.fftfreq(mesh[a], d=1.0 / mesh[a]).to(
                self.dtype).to(x.device)
            ka = 2.0 * math.pi * m / self.box[a]
            shape = [1, 1, 1]
            shape[a] = -1
            k2 = k2 + (ka * ka).reshape(shape)
        k2 = torch.where(k2 > 0, k2, torch.ones_like(k2))
        kern = torch.exp(-k2 / (4.0 * self.alpha ** 2)) / k2
        kern = kern.clone()
        kern[0, 0, 0] = 0.0
        vol = self.box[0] * self.box[1] * self.box[2]
        return (2.0 * math.pi * K_E / vol) * torch.sum(
            kern * self.moduli * (f.real * f.real + f.imag * f.imag))

    # -- the whole ---------------------------------------------------------

    def components(self, x, pairs=None) -> dict:
        """The energy's terms (kJ/mol) at positions [N, 3]."""
        geom = self._water_geometry(x)
        q = self.charges(geom)
        if pairs is None:
            pairs = self.pair_list(x)
        return {"direct": self.direct(x, q, pairs),
                "exclusion": self.exclusion(x, q), "self": self.self_term(q),
                "reciprocal": self.spme(x, q), "bonded": self.bonded(geom)}

    def energy_forces(self, positions):
        """(energy, forces [N, 3], scale) in this precision, from positions
        [N, 3] of any type (moved to this model's device and type); scale
        is the sum of the terms' magnitudes, the size of the rounding a
        float32 sum of them makes."""
        x = torch.as_tensor(positions).to(self.device, self.dtype)
        pairs = self.pair_list(x)
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            comps = self.components(x, pairs)
            e = sum(comps.values())
            (g,) = torch.autograd.grad(e, x)
        scale = sum(abs(float(c.detach())) for c in comps.values())
        return e.detach(), -g.detach(), scale
