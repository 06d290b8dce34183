"""The benchmark's frozen Solovev -> G-EQDSK converter: writes the G-EQDSK
that the configuration ``solovev_minus_root_eqdsk`` reads, from the
analytic Solovev equilibrium of RAYS's deck
``solovev_ECH_90GHz_minus_root.in`` (rmaj 1.2, kappa 1.5, bphi0 2.2,
iota0 0.3, outer_bound 1.55), as RAYS's ``solovev_2_eqdsk`` does.

It imports nothing of the program under test.  The formulas are those of
solovev_eq_m.f90 (psi, the boundary radii and height), written here again:

    psi(R, Z) = bp0 / 2 [ (R Z / (rmaj kappa))^2 + (R^2 - rmaj^2)^2 / (4 rmaj^2) ]
    psib      = bp0 / 2 (outer_bound^2 - rmaj^2)^2 / (4 rmaj^2),   bp0 = bphi0 iota0

The sign rule of the converter: the analytic field has Bz = +psi_R / R,
a G-EQDSK reader takes Bz = -psi_R / R (eqdsk_magnetics_spline_interp_m
.f90:238-240), so the file carries -psi, with PSIAXIS 0 and PSIBOUND
-psib: psi falls outward in the file, and psiN = psi / PSIBOUND is the
analytic deck's.  R*Bphi = bphi0 rmaj on every knot; P, TT', P' and Q are
zero (the converter writes no safety factor).  The grid is 129 x 129 over
the plasma's R and Z extent with a margin of 0.08 m on each side; the
boundary is the analytic curve at 101 points, up-down symmetric; the
limiter is the grid's box.

    python3 benchmark/reference/solovev_geqdsk.py [path]

writes the file (by default the committed one, ``benchmark/configs/
solovev_minus_root_eqdsk.geqdsk``); ``benchmark/tests`` holds the
committed file to this converter byte for byte.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

DECK = dict(rmaj=1.2, kappa=1.5, bphi0=2.2, iota0=0.3, outer_bound=1.55)
N_GRID = 129
MARGIN = 0.08
N_BOUNDARY = 101
HEADER = "Solovev minus-root deck, benchmark converter"
PATH = Path(__file__).resolve().parent.parent / "configs" / "solovev_minus_root_eqdsk.geqdsk"


def solovev_psi(R, Z, rmaj, kappa, bphi0, iota0, **_):
    """The analytic Solovev flux (solovev_eq_m.f90), rising outward."""
    bp0 = bphi0 * iota0
    return 0.5 * bp0 * ((R * Z / (rmaj * kappa)) ** 2 + (R**2 - rmaj**2) ** 2 / (4.0 * rmaj**2))


def psi_boundary(rmaj, bphi0, iota0, outer_bound, **_):
    return 0.5 * bphi0 * iota0 * (outer_bound**2 - rmaj**2) ** 2 / (4.0 * rmaj**2)


def boundary_z(R, rmaj, kappa, outer_bound, **_):
    """Height of the last closed surface psi = psib at radius R."""
    zsq = (kappa**2 / (4.0 * R**2)
           * (outer_bound**4 + 2.0 * (R**2 - outer_bound**2) * rmaj**2 - R**4))
    return np.sqrt(np.clip(zsq, 0.0, None))


def extent(rmaj, kappa, outer_bound, **_):
    """(inner radius, top height) of the last closed surface."""
    inner = np.sqrt(2.0 * rmaj**2 - outer_bound**2)
    r_top = (2.0 * outer_bound**2 * rmaj**2 - outer_bound**4) ** 0.25
    return inner, float(boundary_z(r_top, rmaj, kappa, outer_bound))


def _block(values):
    """Values five to a line in 16-character fields (the format 5e16.9)."""
    values = np.asarray(values, dtype=np.float64).ravel()
    return "".join("".join(f"{v:16.9e}" for v in values[k:k + 5]) + "\n"
                   for k in range(0, len(values), 5))


def geqdsk_text(deck=DECK, n=N_GRID, margin=MARGIN, nbound=N_BOUNDARY):
    """The G-EQDSK file's text (eqdsk_utilities_m.f90's layout)."""
    inner, top = extent(**deck)
    rmin, rmax = inner - margin, deck["outer_bound"] + margin
    zmax = top + margin
    R = np.linspace(rmin, rmax, n)
    Z = np.linspace(-zmax, zmax, n)
    psi = -solovev_psi(R[:, None], Z[None, :], **deck)        # psi[i, j] at (R_i, Z_j)
    psib = psi_boundary(**deck)
    rb = np.linspace(inner, deck["outer_bound"], (nbound + 1) // 2)
    zb = boundary_z(rb, **deck)
    rbound = np.concatenate([rb, rb[-2::-1]])
    zbound = np.concatenate([zb, -zb[-2::-1]]) + 0.0     # no -0.0 in the file
    rlim = np.array([rmin, rmax, rmax, rmin, rmin])
    zlim = np.array([-zmax, -zmax, zmax, zmax, -zmax])
    zeros = np.zeros(n)
    rmaj, bphi0 = deck["rmaj"], deck["bphi0"]
    return "".join([
        f"{HEADER:<48s}{0:4d}{n:4d}{n:4d}\n",
        _block([rmax - rmin, 2.0 * zmax, rmaj, rmin, 0.0]),
        _block([rmaj, 0.0, 0.0, -psib, bphi0]),
        _block([0.0, 0.0, 0.0, 0.0, 0.0]),
        _block([0.0, 0.0, 0.0, 0.0, 0.0]),
        _block(np.full(n, bphi0 * rmaj)),                      # T = R Bphi
        _block(zeros), _block(zeros), _block(zeros),           # P, TT', P'
        _block(psi.T),                                         # ((psi(i, j), i), j)
        _block(zeros),                                         # Q
        f"{len(rbound):5d}{len(rlim):5d}\n",
        _block(np.stack([rbound, zbound], -1)),
        _block(np.stack([rlim, zlim], -1)),
    ])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = Path(argv[0]) if argv else PATH
    path.write_text(geqdsk_text())
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
