"""Physical constants, matched exactly to the reference so that trajectories
are comparable bit-for-tolerance.  Copied unchanged from
``rays_tpu.constants`` (the port must not import the JAX package).

The reference uses *nonstandard* values (reference RAYS_project/RAYS_lib/
constants_m.f90:42-48): clight = 2.997930e8 (not 2.99792458e8), eps0 derived
from mu0*c^2 so that c = 1/sqrt(eps0*mu0) holds exactly, me = 9.1094e-31,
e = 1.6022e-19.  Do not "fix" these: parity with the reference depends on
them.
"""

import math

PI = 3.1415926535897932385
SQRT_PI = math.sqrt(PI)

CLIGHT = 2.997930e8          # speed of light [m/s]  (reference constants_m.f90:42)
MU0 = PI * 4.0e-7            # vacuum permeability
EPS0 = 1.0 / (MU0 * CLIGHT**2)  # chosen so c = 1/sqrt(eps0*mu0)

ME = 9.1094e-31              # electron mass [kg]    (constants_m.f90:46)
MP = 1.6726e-27              # proton mass [kg]
E_CHARGE = 1.6022e-19        # elementary charge [C] (constants_m.f90:48)

# Numerical-range guard for safe division.  The JAX package picked this
# value because TPU float64 emulation has only the float32 exponent range;
# the port keeps the same value so that every guarded denominator rounds
# exactly as in the reference package.
SAFE_TINY = 1.0e-30

# Species lookup table (reference RAYS_project/RAYS_lib/species_m.f90:31-34).
# Charges in units of e, masses in units of me.
SPECIES_TABLE = {
    "electron": (-1.0, 1.0),
    "hydrogen": (1.0, 1836.0),
    "deuterium": (1.0, 3670.0),
    "tritium": (1.0, 5497.0),
    "3He": (2.0, 5496.0),
    "alpha": (2.0, 7294.0),
}
