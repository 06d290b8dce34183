"""Generic axisymmetric toroidal (tokamak) equilibrium
(``rays_tpu.models.axisym_toroid``; reference axisym_toroid_eq_m.f90),
batched over points.

A magnetics backend provides B and the poloidal flux; density and
temperature profiles are functions of normalized flux psiN with scrape-off
floors outside psiN = 1 (axisym_toroid_eq_m.f90:215-363).

Magnetics backends:
  * 'solovev_magnetics': the closed-form field of ``models/solovev.py``
    behind the magnetics interface (solovev_magnetics_m.f90).
  * 'eqdsk_magnetics_spline_interp': a 2-D cubic spline of psi(R, Z) and a
    1-D spline of R*Bphi(R) built from a G-EQDSK file, with
    B = (psi_Z/R, -psi_R/R, RBphi/R) in cylindrical components
    (eqdsk_magnetics_spline_interp_m.f90:206-283).  Psi is shifted to zero
    on axis at load (ibid.:176-179).  Both splines ride in one per-cell
    coefficient table (``psi_cells``): an evaluation fetches one row.
  * 'eqdsk_magnetics_lin_interp': bilinear psi with central differences at
    half-grid offsets, the reference's accuracy A/B for the spline backend.

The JAX package takes the spatial jacobians of ``fields`` by forward-mode
autodiff wherever it has no closed form (the Solovev and bilinear backends,
a missing cell table).  Here every backend writes them in closed form
beside the values, from differentiable tensor operations, so the adjoint
differentiates through them:
  * Solovev: ``solovev.magnetics_and_jac``;
  * spline: psi second derivatives from the same fetched coefficients (or,
    without a cell table, from the four knot tables);
  * bilinear: inside its cell the interpolant's derivative is piecewise
    constant in each direction; what autodiff gives through ``floor`` and
    ``clip`` is that derivative with the cell index held, and the jacobian
    of the five-point difference stencil follows from it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from rays_tpu_torch.models import profiles, solovev as solovev_mod
from rays_tpu_torch.ops import splines
from rays_tpu_torch.tracing.stop import StopCode

_AXIS_GUARD = 1e-12


@dataclasses.dataclass(frozen=True)
class AxisymToroidStatic:
    magnetics_model: str = "solovev_magnetics"
    density_prof_model: str = "parabolic"
    temperature_prof_model: Tuple[str, ...] = ("zero",)


class SolovevMagParams(NamedTuple):
    rmaj: Any
    kappa: Any
    bphi0: Any
    iota0: Any
    outer_bound: Any


class EqdskMagParams(NamedTuple):
    psi_spline: Any    # Spline2D of psi(R, Z), shifted to 0 on axis
    rbphi_spline: Any  # Spline1D of R*Bphi on the R grid
    psib: Any          # PSIBOUND - PSIAXIS
    # flux-coordinate profile splines (reference
    # eqdsk_magnetics_spline_interp_m.f90:183-199): Q and rho = sqrt of
    # normalized toroidal flux on the uniform psiN grid, plus the inverse
    # map psiN(rho) on the matching uniform rho grid
    q_spline: Any = None        # Spline1D of Q(psiN)
    rho_spline: Any = None      # Spline1D of rho(psiN)
    tflux_spline: Any = None    # Spline1D of toroidal flux(psiN), unnormalized
    psin_rho_spline: Any = None  # Spline1D of psiN(rho)
    # per-cell coefficient form of psi and R*Bphi (ops/splines.CellSpline2D),
    # the evaluation path of a run; None evaluates the knot tables
    psi_cells: Any = None


class EqdskLinMagParams(NamedTuple):
    """Linear/finite-difference EQDSK magnetics, the reference's accuracy
    A/B for the spline backend (eqdsk_magnetics_lin_interp_m.f90:2-6):
    bilinear psi interpolation (eqdsk_utilities_m.f90:144-162) with central
    finite differences at half-grid offsets dR = h_R/2, dZ = h_Z/2
    (:190-306, offsets set at lin_interp init :125-126).

    Two deliberate divergences from the reference, kept from the JAX
    package:
      * the B sign convention follows the spline backend (br = psi_z/R,
        bz = -psi_R/R); the reference's lin backend flips both signs
        (eqdsk_magnetics_lin_interp_m.f90:172-173), so its two backends
        disagree on the same file;
      * the B gradient is the derivative of the difference-built B (the
        natural three-point second difference); the reference's
        GetPsiRR/ZZ divide the +-2dR stencil by dR^2 instead of (2dR)^2
        (eqdsk_utilities_m.f90:229-265).
    """

    r0: Any
    dr: Any
    z0: Any
    dz: Any
    psi: Any    # (nr, nz), shifted to 0 on axis
    T: Any      # (nr,) R*Bphi on the R grid
    psib: Any
    rho_spline: Any = None  # the rho machinery belongs to the spline backend


class AxisymToroidParams(NamedTuple):
    mag: Any                 # SolovevMagParams | EqdskMagParams | EqdskLinMagParams
    plasma_psi_limit: Any
    # density
    alphan1: Any
    alphan2: Any
    d_scrape_off: Any
    ne_knots: Any            # (2, K) rows (f, m) of the normalized ne(psiN) spline
    # temperature
    alphat1: Any             # (S,)
    alphat2: Any             # (S,)
    t_scrape_off: Any
    te_knots: Any            # (2, K) normalized Te(psiN)
    ti_knots: Any            # (2, K) normalized Ti(psiN)
    # bounding box
    box_rmin: Any
    box_rmax: Any
    box_zmin: Any
    box_zmax: Any


class _Flux(NamedTuple):
    """psi and what B and its jacobian need of it at (R, Z).  (gr, gz) is
    the gradient of the psi VALUE; (psi_r, psi_z) are the derivatives B is
    built from (the same for the spline, central differences for the
    bilinear backend); second-order entries are None unless asked for."""

    psi: Any
    gr: Any
    gz: Any
    psi_r: Any
    psi_z: Any
    rbphi: Any
    psi_rr: Any = None   # d(psi_r)/dR
    psi_rz: Any = None   # d(psi_r)/dZ
    psi_zr: Any = None   # d(psi_z)/dR
    psi_zz: Any = None   # d(psi_z)/dZ
    rbphi_r: Any = None


def _xyzr(rvec):
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    return x, y, z, torch.sqrt(x**2 + y**2).clamp_min(_AXIS_GUARD)


def _spline_flux(mag: EqdskMagParams, r, z, second):
    if mag.psi_cells is not None:
        # channel 0: psi(R,Z); channel 1: R*Bphi(R) in the same row
        if second:
            fv, fr, fz, frr, frz, fzz = splines.eval_cell_2d_second(mag.psi_cells, r, z)
            return _Flux(fv[..., 0], fr[..., 0], fz[..., 0], fr[..., 0], fz[..., 0],
                         fv[..., 1], frr[..., 0], frz[..., 0], frz[..., 0], fzz[..., 0],
                         fr[..., 1])
        fv, fr, fz = splines.eval_cell_2d(mag.psi_cells, r, z)
        return _Flux(fv[..., 0], fr[..., 0], fz[..., 0], fr[..., 0], fz[..., 0],
                     fv[..., 1])
    if second:
        f, fr, fz, frr, frz, fzz = splines.eval_2d_second(mag.psi_spline, r, z)
        rbphi, rbphi_r = splines.eval_1d_fp(mag.rbphi_spline, r)
        return _Flux(f, fr, fz, fr, fz, rbphi, frr, frz, frz, fzz, rbphi_r)
    f, fr, fz = splines.eval_2d_fp(mag.psi_spline, r, z)
    return _Flux(f, fr, fz, fr, fz, splines.eval_1d(mag.rbphi_spline, r))


def _bilinear_fp(x0, dx, y0, dy, F, x, y):
    """Bilinear interpolation on a uniform grid (eqdsk_utilities_m.f90:
    144-162), cell-clamped outside the box, with its derivatives in the
    held cell: (f, df/dx, df/dy)."""
    nx, ny = F.shape
    i, u = splines._cell(x0, dx, nx, x)
    j, v = splines._cell(y0, dy, ny, y)
    flat = F.reshape(-1)
    lin = i * ny + j
    f00, f01, f10, f11 = (flat.index_select(0, lin + off)
                          for off in (0, 1, ny, ny + 1))
    f = (f00 * (1.0 - u) * (1.0 - v) + f10 * u * (1.0 - v)
         + f01 * (1.0 - u) * v + f11 * u * v)
    fx = ((f10 - f00) * (1.0 - v) + (f11 - f01) * v) / dx
    fy = ((f01 - f00) * (1.0 - u) + (f11 - f10) * u) / dy
    return f, fx, fy


def _linear_1d_fp(x0, dx, f, x):
    """Linear interpolation (GetRBphi, eqdsk_utilities_m.f90:168-184) and
    its slope in the held cell."""
    i, u = splines._cell(x0, dx, f.shape[0], x)
    fi, fi1 = f.index_select(0, i), f.index_select(0, i + 1)
    return fi * (1.0 - u) + fi1 * u, (fi1 - fi) / dx


def _lin_flux(m: EqdskLinMagParams, r, z):
    """The bilinear backend: psi at the point and at the four stencil
    points in one call, then the central differences of the values (for B)
    and of the derivatives (for the jacobian of B)."""
    dR, dZ = m.dr / 2.0, m.dz / 2.0
    n = r.shape[0]
    rr = torch.cat([r, r + dR, r - dR, r, r])
    zz = torch.cat([z, z, z, z + dZ, z - dZ])
    f, fx, fy = (t.view(5, n) for t in _bilinear_fp(m.r0, m.dr, m.z0, m.dz, m.psi, rr, zz))
    rbphi, rbphi_r = _linear_1d_fp(m.r0, m.dr, m.T, r)
    return _Flux(
        psi=f[0], gr=fx[0], gz=fy[0],
        psi_r=(f[1] - f[2]) / (2.0 * dR), psi_z=(f[3] - f[4]) / (2.0 * dZ),
        rbphi=rbphi,
        psi_rr=(fx[1] - fx[2]) / (2.0 * dR), psi_rz=(fy[1] - fy[2]) / (2.0 * dR),
        psi_zr=(fx[3] - fx[4]) / (2.0 * dZ), psi_zz=(fy[3] - fy[4]) / (2.0 * dZ),
        rbphi_r=rbphi_r)


def _eqdsk_flux(static, p, r, z, second):
    if static.magnetics_model == "eqdsk_magnetics_spline_interp":
        return _spline_flux(p.mag, r, z, second)
    if static.magnetics_model == "eqdsk_magnetics_lin_interp":
        return _lin_flux(p.mag, r, z)
    raise ValueError(f"unknown magnetics model {static.magnetics_model}")


def _b_xyz(x, y, r, fl: _Flux):
    br, bz, bphi = fl.psi_z / r, -fl.psi_r / r, fl.rbphi / r
    cx, cy = x / r, y / r
    return torch.stack([br * cx - bphi * cy, br * cy + bphi * cx, bz], dim=-1)


def magnetics(static: AxisymToroidStatic, p: AxisymToroidParams, rvec):
    """(bvec_xyz (B,3), psi (B,), psiN (B,)) at rvec (B,3)."""
    if static.magnetics_model == "solovev_magnetics":
        x, y, z, r = _xyzr(rvec)
        br, bz, bphi = solovev_mod.b_cylindrical(p.mag, rvec)
        psi, _, psiN, _ = solovev_mod.psi(p.mag, rvec)
        bvec = torch.stack([br * x / r - bphi * y / r, br * y / r + bphi * x / r, bz],
                           dim=-1)
        return bvec, psi, psiN
    x, y, z, r = _xyzr(rvec)
    fl = _eqdsk_flux(static, p, r, z, second=False)
    return _b_xyz(x, y, r, fl), fl.psi, fl.psi / p.mag.psib


def _magnetics_and_jac(static, p, rvec):
    """(bvec (B,3), jb (B,3,3), psiN (B,), dpsiN (B,3)), jb[b, j, i] =
    dB_j/dx_i.  For the file backends B = (grad psi x phihat)/R +
    (R Bphi) phihat / R, chained through R = sqrt(x^2 + y^2)."""
    if static.magnetics_model == "solovev_magnetics":
        return solovev_mod.magnetics_and_jac(p.mag, rvec)
    x, y, z, r = _xyzr(rvec)
    fl = _eqdsk_flux(static, p, r, z, second=True)
    cx, cy = x / r, y / r
    br, bz, bphi = fl.psi_z / r, -fl.psi_r / r, fl.rbphi / r
    dbr_dr = fl.psi_zr / r - fl.psi_z / (r * r)
    dbr_dz = fl.psi_zz / r
    dbz_dr = -fl.psi_rr / r + fl.psi_r / (r * r)
    dbz_dz = -fl.psi_rz / r
    dbphi_dr = fl.rbphi_r / r - fl.rbphi / (r * r)

    zero = torch.zeros_like(r)

    def vec(a, b, c):
        return torch.stack([a, b, c], dim=-1)

    drv = vec(cx, cy, zero)                                   # dR/dx_i
    dcx = vec((1.0 - cx * cx) / r, -cx * cy / r, zero)
    dcy = vec(-cx * cy / r, (1.0 - cy * cy) / r, zero)
    dbr = dbr_dr[:, None] * drv + vec(zero, zero, dbr_dz)
    dbz = dbz_dr[:, None] * drv + vec(zero, zero, dbz_dz)
    dbphi = dbphi_dr[:, None] * drv                           # dBphi/dz = 0

    def col(t):
        return t[:, None]

    bvec = vec(br * cx - bphi * cy, br * cy + bphi * cx, bz)
    jb = torch.stack([
        col(br) * dcx + col(cx) * dbr - col(bphi) * dcy - col(cy) * dbphi,
        col(br) * dcy + col(cy) * dbr + col(bphi) * dcx + col(cx) * dbphi,
        dbz,
    ], dim=-2)
    psib = p.mag.psib
    dpsin = (col(fl.gr) * drv + vec(zero, zero, fl.gz)) / psib
    return bvec, jb, fl.psi / psib, dpsin


def psi_and_grad(static, p: AxisymToroidParams, rvec):
    """(psi, gradpsi, psiN, gradpsiN) at rvec (B,3), reference
    axisym_toroid_psi (axisym_toroid_eq_m.f90:366+): the gradient of the
    psi value that ``magnetics`` returns, from the same coefficient fetch
    and the chain rule through R."""
    if static.magnetics_model == "solovev_magnetics":
        return solovev_mod.psi(p.mag, rvec)
    x, y, z, r = _xyzr(rvec)
    fl = _eqdsk_flux(static, p, r, z, second=False)
    gradpsi = torch.stack([fl.gr * x / r, fl.gr * y / r, fl.gz], dim=-1)
    psib = p.mag.psib
    return fl.psi, gradpsi, fl.psi / psib, gradpsi / psib


def q_of_psiN(p: AxisymToroidParams, psiN):
    """(Q, dQ/dpsiN) from the EQDSK Q spline (reference
    eqdsk_magnetics_spline_interp_Q_psiN, eqdsk_magnetics_spline_interp_m
    .f90:355-365)."""
    return splines.eval_1d_fp(p.mag.q_spline, psiN)


def _require_rho(p: AxisymToroidParams):
    if getattr(p.mag, "rho_spline", None) is None:
        raise ValueError(
            "rho coordinate maps unavailable: the EQDSK file carries no "
            "usable Q profile (e.g. Solovev-generated files write Q=0, "
            "matching reference solovev_2_eqdsk.f90:90)")


def rho_of_psiN(p: AxisymToroidParams, psiN):
    """(rho, drho/dpsiN), rho = sqrt(normalized toroidal flux)
    (eqdsk_magnetics_spline_interp_m.f90:368-378)."""
    _require_rho(p)
    return splines.eval_1d_fp(p.mag.rho_spline, psiN)


def psiN_of_rho(p: AxisymToroidParams, rho):
    """(psiN, dpsiN/drho), the inverse coordinate map
    (eqdsk_magnetics_spline_interp_m.f90:380-390)."""
    _require_rho(p)
    return splines.eval_1d_fp(p.mag.psin_rho_spline, rho)


def rho_and_grad(static, p: AxisymToroidParams, rvec):
    """(rho (B,), gradrho (B,3)) at rvec, reference axisym_toroid_rho
    (axisym_toroid_eq_m.f90:399-437).  Only defined for the EQDSK spline
    backend, as in the reference."""
    if p.mag.__class__ is not EqdskMagParams or p.mag.rho_spline is None:
        raise ValueError(
            "axisym_toroid_rho: only available for eqdsk_magnetics_"
            "spline_interp (as in the reference)")
    _, _, psiN, gradpsiN = psi_and_grad(static, p, rvec)
    rho, drho_dpsiN = rho_of_psiN(p, psiN)
    return rho, gradpsiN * drho_dpsiN[:, None]


def spline_profile_fp(knots, rho, floor):
    """(f, df/drho) of a normalized spline profile on a uniform [0, 1] knot
    grid with a constant scrape-off value outside rho > 1
    (density_spline_interp_m.f90:2-15).  ``knots``: (2, K) rows (f, m).
    The derivative is zero where the argument is clipped, which is what
    autodiff gives through the clip and the select."""
    sp = splines.Spline1D(x0=0.0, dx=1.0 / (knots.shape[-1] - 1),
                          f=knots[0], m=knots[1])
    inside = rho <= 1.0
    val, der = splines.eval_1d_fp(sp, rho.clamp(0.0, 1.0))
    return (torch.where(inside, val, floor),
            torch.where((rho >= 0.0) & inside, der, torch.zeros_like(der)))


_DENSITY_MODELS = ("constant", "parabolic", "density_spline_interp")
_TEMPERATURE_MODELS = ("zero", "constant", "parabolic", "temperature_spline_interp")


def _profile_fp(model, knots, psiN, floor, alpha1, alpha2):
    """(f, df/dpsiN) of one profile model (density or one temperature)."""
    if model == "constant":
        return torch.ones_like(psiN), torch.zeros_like(psiN)
    if model == "zero":
        return torch.zeros_like(psiN), torch.zeros_like(psiN)
    if model == "parabolic":
        return profiles.parabolic(psiN, floor, alpha1, alpha2)
    return spline_profile_fp(knots, psiN, floor)


def _profiles_and_jac(static, p, species, psiN, dpsin):
    """((ns, ts), (jn, jt)) of the profile models at psiN with gradient
    dpsin (B,3)."""
    n0s, t0s = species.n0s, species.t0s
    m = static.density_prof_model
    if m not in _DENSITY_MODELS:
        raise ValueError(f"axisym_toroid: invalid density_prof_model {m}")
    f, fp = _profile_fp(m, p.ne_knots, psiN, p.d_scrape_off, p.alphan1, p.alphan2)
    ns = n0s * f[:, None]
    jn = n0s[:, None] * (fp[:, None] * dpsin)[:, None, :]

    ts_list, jt_list = [], []
    for i, tm in enumerate(static.temperature_prof_model):
        if tm not in _TEMPERATURE_MODELS:
            raise ValueError(f"axisym_toroid: invalid temperature_prof_model {tm}")
        ft, ftp = _profile_fp(tm, p.te_knots if i == 0 else p.ti_knots, psiN,
                              p.t_scrape_off, p.alphat1[i], p.alphat2[i])
        ts_list.append(t0s[i] * ft)
        jt_list.append(t0s[i] * ftp[:, None] * dpsin)
    return (ns, torch.stack(ts_list, dim=1)), (jn, torch.stack(jt_list, dim=1))


def _geom_code(p, rvec, psiN):
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    r = torch.sqrt(x**2 + y**2)
    code = torch.zeros(x.shape, dtype=torch.int32, device=x.device)

    def put(cond, stop):
        return torch.where(cond, torch.full_like(code, int(stop)), code)

    code = put(psiN > p.plasma_psi_limit, StopCode.OUT_OF_PLASMA)
    code = put((z < p.box_zmin) | (z > p.box_zmax), StopCode.Z_OUT_OF_BOX)
    code = put((r < p.box_rmin) | (r > p.box_rmax), StopCode.R_OUT_OF_BOX)
    return code


def supports_analytic_jac(static: AxisymToroidStatic, p: AxisymToroidParams) -> bool:
    """True: ``fields_jac_geom`` covers every magnetics backend and profile
    model that ``fields`` accepts (any other name raises there).  The hook
    exists for parity with the JAX package, whose closed form covers only
    the spline backend with a cell table and the analytic profiles
    (rays_tpu/models/axisym_toroid.py:336)."""
    return True


def fields_jac_geom(static: AxisymToroidStatic, p: AxisymToroidParams, species, rvec):
    """``fields_and_jac`` and ``geom_err`` from one evaluation of the
    magnetics: ((bvec, ns, ts), (jb, jn, jt), code)."""
    bvec, jb, psiN, dpsin = _magnetics_and_jac(static, p, rvec)
    (ns, ts), (jn, jt) = _profiles_and_jac(static, p, species, psiN, dpsin)
    return (bvec, ns, ts), (jb, jn, jt), _geom_code(p, rvec, psiN)


def fields_and_jac(static: AxisymToroidStatic, p: AxisymToroidParams, species, rvec):
    """Values and spatial jacobians of (bvec, ns, ts) at rvec (B,3), laid
    out as the JAX package's ``value_and_jacfwd`` of ``fields``:
    jb[b, j, i] = dB_j/dx_i, jn[b, s, i], jt[b, s, i]."""
    return fields_jac_geom(static, p, species, rvec)[:2]


def fields(static: AxisymToroidStatic, p: AxisymToroidParams, species, rvec):
    """B (B,3), n_s (B,S), T_s (B,S) at rvec (B,3)."""
    bvec, _, psiN = magnetics(static, p, rvec)
    (ns, ts), _ = _profiles_and_jac(static, p, species, psiN,
                                    torch.zeros_like(rvec))
    return bvec, ns, ts


def geom_err(static: AxisymToroidStatic, p: AxisymToroidParams, rvec):
    """Box and plasma-boundary checks (axisym_toroid_eq_m.f90:258-270,291)."""
    return _geom_code(p, rvec, magnetics(static, p, rvec)[2])


def err(static: AxisymToroidStatic, p: AxisymToroidParams, species, rvec):
    """Full standalone check (geometry + positivity,
    axisym_toroid_eq_m.f90:360-362)."""
    from rays_tpu_torch.models.base import _combine_err

    bvec, _, psiN = magnetics(static, p, rvec)
    (ns, ts), _ = _profiles_and_jac(static, p, species, psiN, torch.zeros_like(rvec))
    return _combine_err(_geom_code(p, rvec, psiN), ns, ts)


def build_spline_knots(values):
    """Pack a normalized profile knot array as (f, m) rows, (2, K): the
    profile spline is one Params leaf."""
    values = np.asarray(values, dtype=np.float64)
    values = values / values[0]
    sp = splines.build_spline_1d(0.0, 1.0 / (len(values) - 1), values)
    return torch.stack([sp.f, sp.m])


def build_eqdsk_lin_mag_params(path) -> tuple:
    """Load a G-EQDSK file into the bilinear/FD magnetics params
    (eqdsk_magnetics_lin_interp_m.f90:101-133), float64 on the CPU.
    Returns (EqdskLinMagParams, geqdsk)."""
    from rays_tpu_torch.utils import eqdsk_io

    g = eqdsk_io.read_geqdsk(path)
    rg, zg = g.r_grid, g.z_grid

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64))

    return EqdskLinMagParams(
        r0=t(rg[0]), dr=t(rg[1] - rg[0]), z0=t(zg[0]), dz=t(zg[1] - zg[0]),
        psi=t(g.psi - g.psiaxis), T=t(g.T), psib=t(g.psibound - g.psiaxis),
    ), g


def build_eqdsk_mag_params(path) -> tuple:
    """Load a G-EQDSK file into spline magnetics params, on the host in
    float64.  Returns (EqdskMagParams, geqdsk); the file object carries the
    bounds the config layer needs.

    The flux-coordinate splines live on the uniform psiN grid
    (eqdsk_magnetics_spline_interp_m.f90:169-199 and :409-439): toroidal
    flux by cumulative trapezoid of Q over psiN, rho = sqrt(Tflux/Tflux
    total), and the inverse psiN(rho) on the same uniform [0, 1] grid by 40
    bisection passes on the rho spline.  A file without a usable Q profile
    (the Solovev generator writes Q = 0, as reference solovev_2_eqdsk.f90:90)
    gets no rho machinery: ``rho_and_grad`` and ``Ptotal_rho`` refuse."""
    from rays_tpu_torch.utils import eqdsk_io

    g = eqdsk_io.read_geqdsk(path)
    rg, zg = g.r_grid, g.z_grid
    psi = g.psi - g.psiaxis  # shift psi to 0 on axis (reference :176-179)
    psib = g.psibound - g.psiaxis
    psi_spline = splines.build_spline_2d(rg[0], rg[1] - rg[0],
                                         zg[0], zg[1] - zg[0], psi)
    rbphi_spline = splines.build_spline_1d(rg[0], rg[1] - rg[0], g.T)

    n = len(g.Q)
    dpsiN = 1.0 / (n - 1)
    psiN_grid = np.linspace(0.0, 1.0, n)
    q_spline = splines.build_spline_1d(0.0, dpsiN, g.Q)
    tflux = np.concatenate(
        [[0.0], np.cumsum((g.Q[1:] + g.Q[:-1]) * 0.5 * dpsiN)])
    if tflux[-1] > 0.0 and np.all(np.diff(tflux) > 0.0):
        rho = np.sqrt(tflux / tflux[-1])
        rho_spline = splines.build_spline_1d(0.0, dpsiN, rho)
        tflux_spline = splines.build_spline_1d(0.0, dpsiN, tflux)

        def rho_f(pn):
            return splines.eval_1d(rho_spline, torch.as_tensor(pn)).numpy()

        lo, hi = np.zeros(n), np.ones(n)
        for _ in range(40):  # bisection to ~1e-12; the reference stops at 1e-5
            mid = 0.5 * (lo + hi)
            below = rho_f(mid) < psiN_grid  # target rho values = uniform grid
            lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
        psin_on_rho = 0.5 * (lo + hi)
        psin_on_rho[0], psin_on_rho[-1] = 0.0, 1.0
        psin_rho_spline = splines.build_spline_1d(0.0, dpsiN, psin_on_rho)
    else:
        rho_spline = tflux_spline = psin_rho_spline = None

    return EqdskMagParams(
        psi_spline=psi_spline, rbphi_spline=rbphi_spline,
        psib=torch.as_tensor(np.float64(psib)), q_spline=q_spline,
        rho_spline=rho_spline, tflux_spline=tflux_spline,
        psin_rho_spline=psin_rho_spline,
        psi_cells=splines.build_cell_spline_2d([psi_spline],
                                               x_splines=[rbphi_spline])), g
