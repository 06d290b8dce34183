"""Generate a G-EQDSK file from the analytic Solovev field
(``rays_tpu.utils.solovev_2_eqdsk``; reference solovev_2_eqdsk/
solovev_2_eqdsk.f90): the closed-form Solovev psi on a uniform (R, Z) grid,
T = R*Bphi = bphi0*rmaj constant, and the up-down-symmetric analytic
boundary curve.  Host code in numpy float64, the same arithmetic as the JAX
package's generator, so both write the same file.  The companion fidelity
check (compare_analyt_2_interp.f90) is tests/test_torch_axisym.py: the
splined field against the closed form of ``models/solovev.py``.

    python -m rays_tpu_torch.utils.solovev_2_eqdsk solovev.geqdsk --n 129
"""

from __future__ import annotations

import numpy as np

from rays_tpu_torch.utils.eqdsk_io import GEqdsk, write_geqdsk


def solovev_geqdsk(rmaj=1.2, kappa=1.5, bphi0=2.2, iota0=0.3,
                   outer_bound=1.55, nrbox=129, nzbox=129,
                   box_margin=0.08, nbound=101) -> GEqdsk:
    bp0 = bphi0 * iota0
    psib = 0.5 * bp0 * (outer_bound**2 - rmaj**2) ** 2 / rmaj**2 / 4.0
    inner = np.sqrt(2.0 * rmaj**2 - outer_bound**2)
    r_zmax = (2.0 * outer_bound**2 * rmaj**2 - outer_bound**4) ** 0.25
    vert = (kappa / (2.0 * r_zmax)
            * np.sqrt(outer_bound**4
                      + 2.0 * (r_zmax**2 - outer_bound**2) * rmaj**2
                      - r_zmax**4))

    box_rmin = inner - box_margin
    box_rmax = outer_bound + box_margin
    box_zmax = vert + box_margin
    box_zmin = -box_zmax

    r = np.linspace(box_rmin, box_rmax, nrbox)
    z = np.linspace(box_zmin, box_zmax, nzbox)
    R, Z = np.meshgrid(r, z, indexing="ij")
    # psi sign convention: the Solovev analytic field uses Bz = +psi_R/R
    # (solovev_eq_m.f90:308-314) while the EQDSK reader uses Bz = -psi_R/R
    # (eqdsk_magnetics_spline_interp_m.f90:238-240) — a COCOS difference.
    # Write psi with the EQDSK convention so the splined field reproduces
    # the analytic one (psiN is sign-invariant: psi/psibound).
    psi = -0.5 * bp0 * ((R * Z / (rmaj * kappa)) ** 2
                        + ((R**2 - rmaj**2) ** 2) / rmaj**2 / 4.0)

    # analytic boundary (up-down symmetric, odd NBOUND;
    # solovev_2_eqdsk.f90:140-156)
    nb2 = (nbound - 1) // 2
    rb_half = np.linspace(inner, outer_bound, nb2 + 1)
    zsq = (kappa**2 / (4.0 * rb_half**2)
           * (outer_bound**4 + 2.0 * (rb_half**2 - outer_bound**2) * rmaj**2
              - rb_half**4))
    zb_half = np.sqrt(np.clip(zsq, 0.0, None))
    rbound = np.concatenate([rb_half, rb_half[-2::-1]])
    zbound = np.concatenate([zb_half, -zb_half[-2::-1]])

    return GEqdsk(
        header="rays_tpu solovev_2_eqdsk", nrbox=nrbox, nzbox=nzbox,
        rboxlen=box_rmax - box_rmin, zboxlen=box_zmax - box_zmin,
        r0=rmaj, rboxlft=box_rmin, zoff=0.0,
        raxis=rmaj, zaxis=0.0, psiaxis=0.0, psibound=-psib, b0=bphi0,
        current=0.0,
        T=np.full(nrbox, bphi0 * rmaj), P=np.zeros(nrbox),
        TTp=np.zeros(nrbox), Pp=np.zeros(nrbox), Q=np.zeros(nrbox),
        psi=psi, rbound=rbound, zbound=zbound,
        rlim=np.zeros(1), zlim=np.zeros(1),
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="write a Solovev G-EQDSK file")
    ap.add_argument("output")
    ap.add_argument("--rmaj", type=float, default=1.2)
    ap.add_argument("--kappa", type=float, default=1.5)
    ap.add_argument("--bphi0", type=float, default=2.2)
    ap.add_argument("--iota0", type=float, default=0.3)
    ap.add_argument("--outer-bound", type=float, default=1.55)
    ap.add_argument("--n", type=int, default=129)
    args = ap.parse_args(argv)
    eq = solovev_geqdsk(args.rmaj, args.kappa, args.bphi0, args.iota0,
                        args.outer_bound, args.n, args.n)
    write_geqdsk(args.output, eq)
    print(f"wrote {args.output} ({args.n}x{args.n}, psiB={eq.psibound:.6g})")


if __name__ == "__main__":
    main()
