"""Multiple-mirror (axisymmetric open-field-line) equilibrium
(``rays_tpu.models.multiple_mirror``; reference multiple_mirror_eq_m.f90 +
mirror_magnetics_spline_interp_m.f90), batched over points.

Br, Bz, Aphi(r, z) come from 2-D cubic splines of a field file made by the
coil-field preprocessor (``utils/mirror_magnetics.py``), with the flux
coordinate AphiN = Aphi/Aphi_LUFS (~r^2 near the axis) normalized at the
last uninterrupted flux surface.  Profile shapes add the mirror's
``hyperbolic`` and ``hyperbolic_prof_inside_LUFS`` tanh forms
(multiple_mirror_eq_m.f90:486-536).

B in xyz is (x*br/r, y*br/r, bz); the on-axis limit is handled by the
guard r = max(r, 1e-12), under which the closed-form jacobian reproduces the
reference's explicit axis formulas (mirror_magnetics_spline_interp_m.f90:
165-172) to rounding.  The three fields ride in one per-cell coefficient
table (``field_cells``): an evaluation fetches one row of 48 values and
takes values and first derivatives from it.  Every profile model, the
spline profiles included, has its closed-form derivative, so
``fields_and_jac`` covers every config (the JAX package falls back to
forward-mode autodiff for the spline profiles and a missing cell table).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from rays_tpu_torch.models import profiles
from rays_tpu_torch.models.axisym_toroid import spline_profile_fp
from rays_tpu_torch.ops import splines
from rays_tpu_torch.tracing.stop import StopCode

_AXIS_GUARD = 1e-12


@dataclasses.dataclass(frozen=True)
class MultipleMirrorStatic:
    magnetics_model: str = "mirror_magnetics_spline_interp"
    density_prof_model: str = "parabolic"
    temperature_prof_model: Tuple[str, ...] = ("zero",)


class MultipleMirrorParams(NamedTuple):
    br_spline: Any     # Spline2D of Br(r, z)
    bz_spline: Any     # Spline2D of Bz(r, z)
    aphi_spline: Any   # Spline2D of Aphi(r, z)
    aphi_lufs: Any     # normalization at the LUFS strike point
    plasma_aphin_limit: Any
    # density
    alphan1: Any
    alphan2: Any
    aphin0_d: Any      # hyperbolic inflection point
    delta_d: Any       # hyperbolic gradient scale
    d_scrape_off: Any
    ne_knots: Any
    # temperature
    alphat1: Any       # (S,)
    alphat2: Any       # (S,)
    aphin0_t: Any      # (S,)
    delta_t: Any       # (S,)
    t_scrape_off: Any
    te_knots: Any
    ti_knots: Any
    # box
    box_rmax: Any
    box_zmin: Any
    box_zmax: Any
    # per-cell coefficient table of (Br, Bz, Aphi), the evaluation path of
    # a run (ops/splines.CellSpline2D); None evaluates the knot tables
    field_cells: Any = None


def hyperbolic(rho, f_min, rho0, delta):
    """tanh profile (multiple_mirror_eq_m.f90:486-505).  Returns (f, fp)."""
    th0 = torch.tanh(rho0 / delta)
    f = (torch.tanh((rho + rho0) / delta) - torch.tanh((rho - rho0) / delta)) / 2.0 / th0
    fp = (1.0 / torch.cosh((rho + rho0) / delta) ** 2
          - 1.0 / torch.cosh((rho - rho0) / delta) ** 2) / (2.0 * delta) / th0
    return (1.0 - f_min) * f + f_min, (1.0 - f_min) * fp


def hyperbolic_inside_lufs(rho, f_min, rho0, delta):
    """tanh profile clipped at f_min and outside rho >= 1
    (multiple_mirror_eq_m.f90:509-536)."""
    f_in, fp_in = hyperbolic(rho, 0.0, rho0, delta)
    zero = torch.zeros_like(f_in)
    inside = rho < 1.0
    f = torch.where(inside, f_in, zero)
    fp = torch.where(inside, fp_in, zero)
    clipped = f < f_min
    return torch.where(clipped, f_min, f), torch.where(clipped, zero, fp)


def _xyzr(rvec):
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    return x, y, z, torch.sqrt(x**2 + y**2).clamp_min(_AXIS_GUARD)


def _field_fp(p: MultipleMirrorParams, r, z):
    """(values, d/dr, d/dz) of (Br, Bz, Aphi), each (B, 3)."""
    if p.field_cells is not None:
        return splines.eval_cell_2d(p.field_cells, r, z)
    per_field = [splines.eval_2d_fp(sp, r, z)
                 for sp in (p.br_spline, p.bz_spline, p.aphi_spline)]
    return tuple(torch.stack([pf[d] for pf in per_field], dim=-1) for d in range(3))


def magnetics(p: MultipleMirrorParams, rvec):
    """(bvec_xyz (B,3), aphi (B,), aphiN (B,)) from the field splines."""
    x, y, z, r = _xyzr(rvec)
    fv = _field_fp(p, r, z)[0]
    br, bz, aphi = fv[..., 0], fv[..., 1], fv[..., 2]
    bvec = torch.stack([x * br / r, y * br / r, bz], dim=-1)
    return bvec, aphi, aphi / p.aphi_lufs


def aphi_and_grad(static, p: MultipleMirrorParams, rvec):
    """(Aphi, gradAphi, AphiN, gradAphiN) at rvec (B,3), reference
    multiple_mirror_Aphi (multiple_mirror_eq_m.f90:380+), from the same
    coefficient fetch and the chain rule through r."""
    x, y, z, r = _xyzr(rvec)
    fv, fr, fz = _field_fp(p, r, z)
    aphi, aphi_r, aphi_z = fv[..., 2], fr[..., 2], fz[..., 2]
    grad = torch.stack([aphi_r * x / r, aphi_r * y / r, aphi_z], dim=-1)
    return aphi, grad, aphi / p.aphi_lufs, grad / p.aphi_lufs


_DENSITY_MODELS = ("constant", "parabolic", "hyperbolic", "hyperbolic_prof_inside_LUFS",
                   "density_spline_interp")
_TEMPERATURE_MODELS = ("zero", "constant", "parabolic", "hyperbolic",
                       "hyperbolic_prof_inside_LUFS", "temperature_spline_interp")


def _profile_fp(model, knots, rho, floor, rho0, delta, alpha1, alpha2):
    """(f, df/drho) for one profile model (density or one temperature)."""
    if model == "constant":
        return torch.ones_like(rho), torch.zeros_like(rho)
    if model == "zero":
        return torch.zeros_like(rho), torch.zeros_like(rho)
    if model == "parabolic":
        return profiles.parabolic(rho, floor, alpha1, alpha2)
    if model == "hyperbolic":
        return hyperbolic(rho, floor, rho0, delta)
    if model == "hyperbolic_prof_inside_LUFS":
        return hyperbolic_inside_lufs(rho, floor, rho0, delta)
    return spline_profile_fp(knots, rho, floor)


def _profiles_and_jac(static, p, species, aphin, dan):
    n0s, t0s = species.n0s, species.t0s
    m = static.density_prof_model
    if m not in _DENSITY_MODELS:
        raise ValueError(f"multiple_mirror: invalid density_prof_model {m}")
    f, fp = _profile_fp(m, p.ne_knots, aphin, p.d_scrape_off, p.aphin0_d, p.delta_d,
                        p.alphan1, p.alphan2)
    ns = n0s * f[:, None]
    jn = n0s[:, None] * (fp[:, None] * dan)[:, None, :]

    ts_list, jt_list = [], []
    for i, tm in enumerate(static.temperature_prof_model):
        if tm not in _TEMPERATURE_MODELS:
            raise ValueError(f"multiple_mirror: invalid temperature_prof_model {tm}")
        ft, ftp = _profile_fp(tm, p.te_knots if i == 0 else p.ti_knots, aphin,
                              p.t_scrape_off, p.aphin0_t[i], p.delta_t[i],
                              p.alphat1[i], p.alphat2[i])
        ts_list.append(t0s[i] * ft)
        jt_list.append(t0s[i] * ftp[:, None] * dan)
    return (ns, torch.stack(ts_list, dim=1)), (jn, torch.stack(jt_list, dim=1))


def _geom_code(p, rvec, aphin):
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    r = torch.sqrt(x**2 + y**2)
    code = torch.zeros(x.shape, dtype=torch.int32, device=x.device)

    def put(cond, stop):
        return torch.where(cond, torch.full_like(code, int(stop)), code)

    code = put(aphin > p.plasma_aphin_limit, StopCode.OUT_OF_PLASMA)
    code = put((z < p.box_zmin) | (z > p.box_zmax), StopCode.Z_OUT_OF_BOX)
    code = put(r > p.box_rmax, StopCode.R_OUT_OF_BOX)
    return code


def fields_jac_geom(static: MultipleMirrorStatic, p: MultipleMirrorParams,
                    species, rvec):
    """``fields_and_jac`` and ``geom_err`` from one coefficient fetch:
    ((bvec, ns, ts), (jb, jn, jt), code), by the closed-form chain rule
    through r = sqrt(x^2+y^2)."""
    x, y, z, r = _xyzr(rvec)
    cx, cy = x / r, y / r
    fv, fr, fz = _field_fp(p, r, z)
    br, bz, aphi = fv[..., 0], fv[..., 1], fv[..., 2]
    zero = torch.zeros_like(r)

    def vec(a, b, c):
        return torch.stack([a, b, c], dim=-1)

    def col(t):
        return t[:, None]

    bvec = vec(cx * br, cy * br, bz)
    # d(cx)/dx = (1-cx^2)/r, d(cx)/dy = -cx cy / r, etc.
    dcx = vec((1.0 - cx * cx) / r, -cx * cy / r, zero)
    dcy = vec(-cx * cy / r, (1.0 - cy * cy) / r, zero)
    dr = vec(cx, cy, zero)
    dbr = col(fr[..., 0]) * dr + vec(zero, zero, fz[..., 0])
    dbz = col(fr[..., 1]) * dr + vec(zero, zero, fz[..., 1])
    daphi = col(fr[..., 2]) * dr + vec(zero, zero, fz[..., 2])
    jb = torch.stack([
        col(br) * dcx + col(cx) * dbr,     # dBx/dx_i
        col(br) * dcy + col(cy) * dbr,     # dBy/dx_i
        dbz,                               # dBz/dx_i
    ], dim=-2)

    aphin = aphi / p.aphi_lufs
    (ns, ts), (jn, jt) = _profiles_and_jac(static, p, species, aphin,
                                           daphi / p.aphi_lufs)
    return (bvec, ns, ts), (jb, jn, jt), _geom_code(p, rvec, aphin)


def fields_and_jac(static: MultipleMirrorStatic, p: MultipleMirrorParams,
                   species, rvec):
    """Values and spatial jacobians of (bvec, ns, ts) at rvec (B,3), laid
    out as the JAX package's ``value_and_jacfwd`` of ``fields``:
    jb[b, j, i] = dB_j/dx_i."""
    return fields_jac_geom(static, p, species, rvec)[:2]


def fields(static: MultipleMirrorStatic, p: MultipleMirrorParams, species, rvec):
    """B (B,3), n_s (B,S), T_s (B,S) at rvec (B,3)."""
    bvec, _, aphin = magnetics(p, rvec)
    (ns, ts), _ = _profiles_and_jac(static, p, species, aphin, torch.zeros_like(rvec))
    return bvec, ns, ts


def geom_err(static: MultipleMirrorStatic, p: MultipleMirrorParams, rvec):
    """Box and plasma-boundary checks (multiple_mirror_eq_m.f90:258-275)."""
    return _geom_code(p, rvec, magnetics(p, rvec)[2])


def err(static: MultipleMirrorStatic, p: MultipleMirrorParams, species, rvec):
    from rays_tpu_torch.models.base import _combine_err

    bvec, _, aphin = magnetics(p, rvec)
    (ns, ts), _ = _profiles_and_jac(static, p, species, aphin, torch.zeros_like(rvec))
    return _combine_err(_geom_code(p, rvec, aphin), ns, ts)


def load_field_file(path):
    """Read the Brz netCDF written by the coil-field preprocessor
    (reference mirror_magnetics_m.f90:377; r_grid, z_grid, Br/Bz/Aphi on
    (n_z, n_r) in C order, LUFS scalars), float64 on the CPU.

    Returns (br_spline, bz_spline, aphi_spline, aphi_lufs, box,
    field_cells)."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    try:
        # NetCDF3 data is big-endian; convert to native float64
        rg = np.array(f.variables["r_grid"][:], dtype=np.float64)
        zg = np.array(f.variables["z_grid"][:], dtype=np.float64)
        br = np.array(f.variables["Br"][:], dtype=np.float64).T  # -> (n_r, n_z)
        bz = np.array(f.variables["Bz"][:], dtype=np.float64).T
        aphi = np.array(f.variables["Aphi"][:], dtype=np.float64).T
        r_lufs = float(f.variables["r_LUFS"].getValue())
        z_lufs = float(f.variables["z_LUFS"].getValue())
        r_max = float(f.variables["r_max"].getValue())
        z_min = float(f.variables["z_min"].getValue())
        z_max = float(f.variables["z_max"].getValue())
    finally:
        f.close()

    dr, dz = rg[1] - rg[0], zg[1] - zg[0]
    br_sp = splines.build_spline_2d(rg[0], dr, zg[0], dz, br)
    bz_sp = splines.build_spline_2d(rg[0], dr, zg[0], dz, bz)
    aphi_sp = splines.build_spline_2d(rg[0], dr, zg[0], dz, aphi)
    aphi_lufs = float(splines.eval_2d(
        aphi_sp, torch.tensor(r_lufs, dtype=torch.float64),
        torch.tensor(z_lufs, dtype=torch.float64)))
    cells = splines.build_cell_spline_2d([br_sp, bz_sp, aphi_sp])
    return br_sp, bz_sp, aphi_sp, aphi_lufs, (r_max, z_min, z_max), cells
