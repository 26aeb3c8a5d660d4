"""MD unit system constants (nm, ps, kJ/mol, e, dalton).

Same values as ``chargeflux_tpu.units``; the Coulomb constant matches
OpenMM's ``ONE_4PI_EPS0``.
"""

import math

# Coulomb constant k_e = 1/(4*pi*eps0) in kJ/mol * nm / e^2.
ONE_4PI_EPS0 = 138.935456

# Boltzmann constant in kJ/(mol*K).
BOLTZ = 0.008314462618

# sqrt(pi), used by the Ewald self-energy term.
SQRT_PI = math.sqrt(math.pi)
