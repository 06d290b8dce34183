"""Analytic Solovev tokamak equilibrium (``rays_tpu.models.solovev``;
reference RAYS_lib/solovev_eq_m.f90), batched over points.

The flux function in (x, y, z), with R = sqrt(x^2 + y^2):

    psi = 0.5*bp0 * [ (R z / (rmaj kappa))^2 + (R^2 - rmaj^2)^2 / (4 rmaj^2) ]

with bp0 = bphi0*iota0 (solovev_eq_m.f90:304-318), B from the closed forms
(solovev_eq_m.f90:170-189) and parabolic-in-psiN profiles.  The JAX package
takes the spatial gradients by forward-mode autodiff of ``fields``; here
the jacobians are written in closed form beside the values
(``fields_and_jac``), from plain differentiable tensor operations, so the
adjoint differentiates through them.  Two guards shape the derivatives:
under the axis guard R = max(R, 1e-12) dR/dx is zero, and outside the
plasma boundary (psiN >= 1) the profiles and their gradients are exact
zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from rays_tpu_torch.models import profiles
from rays_tpu_torch.tracing.stop import StopCode

_AXIS_GUARD = 1e-12


@dataclasses.dataclass(frozen=True)
class SolovevStatic:
    dens_prof_model: str = "parabolic"  # constant | parabolic
    t_prof_model: Tuple[str, ...] = ("zero",)


class SolovevParams(NamedTuple):
    rmaj: Any
    kappa: Any
    bphi0: Any
    iota0: Any
    outer_bound: Any
    # profiles
    alphan1: Any
    alphan2: Any
    alphat1: Any  # (S,)
    alphat2: Any  # (S,)
    # bounding box (R, z)
    box_rmin: Any
    box_rmax: Any
    box_zmin: Any
    box_zmax: Any


def psi_boundary(p: SolovevParams):
    """Flux at the plasma boundary (solovev_eq_m.f90:89-92)."""
    bp0 = p.bphi0 * p.iota0
    return 0.5 * bp0 * (p.outer_bound**2 - p.rmaj**2) ** 2 / p.rmaj**2 / 4.0


def boundaries(p: SolovevParams):
    """(inner_bound, vert_bound, r_zmax), solovev_eq_m.f90:94-100."""
    inner = torch.sqrt(2.0 * p.rmaj**2 - p.outer_bound**2)
    r_zmax = (2.0 * p.outer_bound**2 * p.rmaj**2 - p.outer_bound**4) ** 0.25
    vert = (
        p.kappa / (2.0 * r_zmax)
        * torch.sqrt(
            p.outer_bound**4
            + 2.0 * (r_zmax**2 - p.outer_bound**2) * p.rmaj**2
            - r_zmax**4
        )
    )
    return inner, vert, r_zmax


def _cyl(rvec):
    """x, y, z, the guarded R and (dR/dx, dR/dy), zero under the guard."""
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    r0 = torch.sqrt(x**2 + y**2)
    r = r0.clamp_min(_AXIS_GUARD)
    live = r0 > _AXIS_GUARD
    zero = torch.zeros_like(r)
    return x, y, z, r, torch.where(live, x / r, zero), torch.where(live, y / r, zero)


def _b_cyl(p: SolovevParams, r, z):
    bp0 = p.bphi0 * p.iota0
    br = -bp0 * r * z / (p.rmaj * p.kappa) ** 2
    bz = bp0 * ((z / (p.rmaj * p.kappa)) ** 2 + 0.5 * ((r / p.rmaj) ** 2 - 1.0))
    bphi = p.bphi0 * p.rmaj / r
    return br, bz, bphi


def _psi_value(p: SolovevParams, r, z):
    bp0 = p.bphi0 * p.iota0
    return 0.5 * bp0 * (
        (r * z / (p.rmaj * p.kappa)) ** 2
        + ((r**2 - p.rmaj**2) ** 2) / p.rmaj**2 / 4.0
    )


def b_cylindrical(p: SolovevParams, rvec):
    """(br, bz, bphi) at rvec (..., 3) (solovev_eq_m.f90:170-172)."""
    _, _, z, r, _, _ = _cyl(rvec)
    return _b_cyl(p, r, z)


def psi(p: SolovevParams, rvec):
    """(psi, gradpsi, psiN, gradpsiN) at rvec (..., 3), reference
    solovev_psi (solovev_eq_m.f90:280-322).  gradpsi = (x*bz, y*bz, -R*br)."""
    x, y, z, r, _, _ = _cyl(rvec)
    ps = _psi_value(p, r, z)
    br, bz, _ = _b_cyl(p, r, z)
    gradpsi = torch.stack([x * bz, y * bz, -r * br], dim=-1)
    psib = psi_boundary(p)
    return ps, gradpsi, ps / psib, gradpsi / psib


def magnetics_and_jac(p, rvec):
    """(bvec (B,3), jb (B,3,3), psiN (B,), dpsiN (B,3)) of the Solovev field
    at rvec (B,3); ``p`` is any tuple with rmaj, kappa, bphi0, iota0 and
    outer_bound (``SolovevParams``, or the magnetics parameters of
    ``models/axisym_toroid``).  jb[b, j, i] = dB_j/dx_i."""
    x, y, z, r, drdx, drdy = _cyl(rvec)
    bp0 = p.bphi0 * p.iota0
    a2 = (p.rmaj * p.kappa) ** 2
    br, bz, bphi = _b_cyl(p, r, z)
    dbr_dr, dbr_dz = -bp0 * z / a2, -bp0 * r / a2
    dbz_dr, dbz_dz = bp0 * r / p.rmaj**2, 2.0 * bp0 * z / a2
    dbphi_dr = -bphi / r

    # B in fixed (x, y, z) coordinates (solovev_eq_m.f90:187-189); x and y
    # enter directly and through R
    cx, cy = x / r, y / r
    dcx = (1.0 / r - x / r**2 * drdx, -x / r**2 * drdy)
    dcy = (-y / r**2 * drdx, 1.0 / r - y / r**2 * drdy)
    dr = (drdx, drdy)
    bvec = torch.stack([br * cx - bphi * cy, br * cy + bphi * cx, bz], dim=-1)
    jbx = [dbr_dr * dr[i] * cx + br * dcx[i] - dbphi_dr * dr[i] * cy - bphi * dcy[i]
           for i in range(2)] + [dbr_dz * cx]
    jby = [dbr_dr * dr[i] * cy + br * dcy[i] + dbphi_dr * dr[i] * cx + bphi * dcx[i]
           for i in range(2)] + [dbr_dz * cy]
    jbz = [dbz_dr * drdx, dbz_dr * drdy, dbz_dz]
    jb = torch.stack([torch.stack(row, dim=-1) for row in (jbx, jby, jbz)], dim=-2)

    # psiN and its gradient: d(psi)/dR = R*bz, d(psi)/dz = -R*br
    psib = psi_boundary(p)
    psiN = _psi_value(p, r, z) / psib
    dpsiN = torch.stack([r * bz * drdx, r * bz * drdy, -r * br], dim=-1) / psib
    return bvec, jb, psiN, dpsiN


def fields_and_jac(static: SolovevStatic, p: SolovevParams, species, rvec):
    """Values and jacobians at rvec (B, 3).

    Returns ((bvec (B,3), ns (B,S), ts (B,S)), (jb (B,3,3), jn (B,S,3),
    jt (B,S,3))), where jac[..., i] = d(value)/dx_i as in the JAX package's
    ``value_and_jacfwd`` of ``fields``."""
    bvec, jb, psiN, dpsiN = magnetics_and_jac(p, rvec)
    zero = torch.zeros_like(psiN)

    n0s, t0s = species.n0s, species.t0s
    m = static.dens_prof_model
    if m == "constant":
        ns = n0s + zero[:, None]
        jn = torch.zeros(ns.shape + (3,), dtype=ns.dtype, device=ns.device)
    elif m == "parabolic":
        f, dd = profiles.parabolic_psi(psiN, p.alphan1, p.alphan2)
        ns = n0s * f[:, None]
        jn = n0s[:, None] * (dd[:, None] * dpsiN)[:, None, :]
    else:
        raise ValueError(f"solovev: invalid dens_prof_model {m}")

    ts_list, jt_list = [], []
    zero3 = torch.zeros_like(dpsiN)
    for i, tm in enumerate(static.t_prof_model):
        if tm == "zero":
            ts_list.append(zero)
            jt_list.append(zero3)
        elif tm == "constant":
            ts_list.append(t0s[i] + zero)
            jt_list.append(zero3)
        elif tm == "parabolic":
            f, dd = profiles.parabolic_psi(psiN, p.alphat1[i], p.alphat2[i])
            ts_list.append(t0s[i] * f)
            jt_list.append(t0s[i] * dd[:, None] * dpsiN)
        else:
            raise ValueError(f"solovev: invalid t_prof_model {tm}")
    ts = torch.stack(ts_list, dim=1)
    jt = torch.stack(jt_list, dim=1)
    return (bvec, ns, ts), (jb, jn, jt)


def fields(static: SolovevStatic, p: SolovevParams, species, rvec):
    """B (B,3), n_s (B,S), T_s (B,S) at rvec (B,3)."""
    return fields_and_jac(static, p, species, rvec)[0]


def geom_err(static: SolovevStatic, p: SolovevParams, rvec):
    """R/z box checks (solovev_eq_m.f90:155-156); R before z."""
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    r = torch.sqrt(x**2 + y**2)
    code = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    code = torch.where((z < p.box_zmin) | (z > p.box_zmax),
                       torch.full_like(code, int(StopCode.Z_OUT_OF_BOX)), code)
    code = torch.where((r < p.box_rmin) | (r > p.box_rmax),
                       torch.full_like(code, int(StopCode.R_OUT_OF_BOX)), code)
    return code


def err(static: SolovevStatic, p: SolovevParams, species, rvec):
    """Full standalone validity check (geometry + positivity)."""
    from rays_tpu_torch.models.base import _combine_err

    _, ns, ts = fields(static, p, species, rvec)
    return _combine_err(geom_err(static, p, rvec), ns, ts)
