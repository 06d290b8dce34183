"""Multiple-mirror post-processor (``rays_tpu.post.mirror_processor``).

Re-design of reference RAYS_project/post_process_lib/mirror_processor_m.f90:

  * ``eq_contours.<label>.nc`` — AphiN / gamma / omega_pN on the (X, Z)
    plane in the reference's exact schema (write_eq_contour_data_NC,
    mirror_processor_m.f90:469-618), read unchanged by
    graphics_RAYS/plot_RAYS_mirror.py:300-349;
  * ``eq_radial_profiles.<label>`` XY-curve netCDF — equilibrium profiles
    on a uniform AphiN grid at z = z_reference, with the R(AphiN) inversion
    by bisection (write_eq_radial_profile_data_NC, :623-834);
  * graphics description file (:184-231);
  * per-ray detailed diagnostics (:235-465) via post.ray_diags;
  * O-X conversion analysis hookup (the do_OX_conv_analysis option).

Each grid is one batched evaluation on the device the parameters live on,
and the inversion bisects every AphiN target at once (ops/bisect).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.io import netcdf_file

from rays_tpu_torch import constants
from rays_tpu_torch.models import base
from rays_tpu_torch.models import multiple_mirror as mm
from rays_tpu_torch.ops import bisect
from rays_tpu_torch.post import grid
from rays_tpu_torch.post.xy_curves import XYCurve, write_xy_curves_nc
from rays_tpu_torch.wave import dispersion


@torch.no_grad()
def write_eq_contours(cfg, params, n_x=51, n_z=101, path=None):
    """AphiN + per-species gamma / normalized plasma frequency on the
    (X, Z) plane (y = 0) -> eq_contours.<label>.nc, reference schema
    (mirror_processor_m.f90:527-618).  Array layouts match what the
    Fortran file looks like from C/python: AphiN (n_X, n_Z),
    gamma_array / omega_pN_array (nspec+1, n_X, n_Z)."""
    rmax = float(params.eq.box_rmax)
    zmin, zmax = float(params.eq.box_zmin), float(params.eq.box_zmax)
    xmin, xmax = -rmax, rmax  # box_xmin = -box_rmax (:564)
    xs = np.linspace(xmin, xmax, n_x)
    zs = np.linspace(zmin, zmax, n_z)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    rvec = grid.plane_points(grid.like(params, X), grid.like(params, Z))
    _, _, aphin = mm.magnetics(params.eq, rvec)
    alpha, gamma, _, _, _, _ = base.eq_point_light(cfg, params, rvec)
    S = cfg.ns
    aphin = grid.to_numpy(aphin).reshape(n_x, n_z)
    gam = np.moveaxis(grid.to_numpy(gamma.abs()).reshape(n_x, n_z, S), -1, 0)
    # omega_pN = omega_p/omega = sqrt(alpha) (:595)
    wpn = grid.to_numpy(torch.sqrt(alpha.clamp_min(0.0)))
    wpn = np.moveaxis(wpn.reshape(n_x, n_z, S), -1, 0)

    fname = path or f"eq_contours.{cfg.run_label}.nc"
    f = netcdf_file(fname, "w")
    try:
        f.createDimension("n_X", n_x)
        f.createDimension("n_Z", n_z)
        f.createDimension("nspec_p1", S)
        f.createDimension("d12", 12)
        for name, val in (("box_xmin", xmin), ("box_xmax", xmax),
                          ("box_zmin", zmin), ("box_zmax", zmax)):
            v = f.createVariable(name, np.float64, ())
            v.data[()] = np.float64(val)
        v = f.createVariable("X", np.float64, ("n_X",))
        v[:] = xs
        v = f.createVariable("Z", np.float64, ("n_Z",))
        v[:] = zs
        v = f.createVariable("AphiN", np.float64, ("n_X", "n_Z"))
        v[:] = aphin
        v = f.createVariable("omega_pN_array", np.float64,
                             ("nspec_p1", "n_X", "n_Z"))
        v[:] = wpn
        v = f.createVariable("gamma_array", np.float64,
                             ("nspec_p1", "n_X", "n_Z"))
        v[:] = gam
        v = f.createVariable("spec_name", "c", ("nspec_p1", "d12"))
        names = np.zeros((S, 12), dtype="S1")
        for i in range(S):
            nm = ("electron" if i == 0 else f"ion_{i}").ljust(12)[:12]
            names[i] = np.frombuffer(nm.encode(), dtype="S1")
        v[:] = names
    finally:
        f.close()
    return fname


@torch.no_grad()
def write_radial_profiles(cfg, params, z_reference, n_points=51,
                          out_prefix=None):
    """Equilibrium profiles on a UNIFORM AphiN grid at z = z_reference,
    R(AphiN) inverted by bisection as in the reference
    (mirror_processor_m.f90:693-700), plus the same profiles vs R."""
    rmax = float(params.eq.box_rmax)
    limit = float(params.eq.plasma_aphin_limit)
    zr = grid.like(params, float(z_reference))
    aphin_grid = torch.linspace(0.0, limit, n_points, dtype=zr.dtype, device=zr.device)

    # R(AphiN) by bisection on [0, box_rmax] (reference: [0, 1.1 r_LUFS])
    rs, _ = bisect.solve_bisection(
        lambda r: mm.magnetics(params.eq, grid.plane_points(r, zr))[2], aphin_grid, 0.0, rmax)
    _, _, _, ns, ts, _ = base.eq_point_light(cfg, params, grid.plane_points(rs, zr))
    ti = ts[:, -1] if cfg.ns > 1 else ts[:, 0] * 0.0
    ne, te, ti = (grid.to_numpy(t) for t in (
        ns[:, 0] * params.species.n_ref, ts[:, 0] / constants.E_CHARGE, ti / constants.E_CHARGE))
    rs, ap = grid.to_numpy(rs), grid.to_numpy(aphin_grid)
    curves = [
        XYCurve("AphiN", "R", ap, rs),
        XYCurve("AphiN", "ne", ap, ne),
        XYCurve("AphiN", "Te_ev", ap, te),
        XYCurve("AphiN", "Ti_ev", ap, ti),
        XYCurve("R", "AphiN", rs, ap),
        XYCurve("R", "ne", rs, ne),
        XYCurve("R", "Te_ev", rs, te),
        XYCurve("R", "Ti_ev", rs, ti),
    ]
    prefix = out_prefix or f"eq_radial_profiles.{cfg.run_label}"
    return write_xy_curves_nc(curves, prefix)


@torch.no_grad()
def r_omode_cutoff(cfg, params, z_reference):
    """Radius of the O-mode cutoff alpha_e = 1 at z = z_reference by
    bisection in r; 0 when no cutoff exists.  Matches the reference's
    bracket [0, r_LUFS at z_reference] (mirror_processor_m.f90:219-222) so
    a non-monotonic alpha_e(r) — e.g. a hollow density profile — selects
    the same root; r_LUFS is itself found by bisecting AphiN = 1, falling
    back to the full box when the LUFS does not cross z_reference."""
    r_box = grid.like(params, [float(params.eq.box_rmax)])
    zr = grid.like(params, float(z_reference))

    def alpha_e(r):
        alpha, _, _, _ = dispersion.alpha_gamma(cfg, params, grid.plane_points(r, zr),
                                                params.rf.omgrf)
        return alpha[:, 0]

    r_lufs, lufs_ok = bisect.solve_bisection(
        lambda r: mm.magnetics(params.eq, grid.plane_points(r, zr))[2], 1.0, 1e-6, r_box)
    r, ok = bisect.solve_bisection(alpha_e, 1.0, 1e-6, torch.where(lufs_ok, r_lufs, r_box))
    return float(r[0]) if bool(ok[0]) else 0.0


def write_graphics_description(cfg, params,
                               path="graphics_description_mirror.dat",
                               num_plot_k_vectors=0, scale_k_vec="True",
                               k_vec_base_length=0.02, set_xy_lim="True",
                               z_reference=None):
    """mirror_processor_m.f90:184-231, emitting exactly the keys
    plot_RAYS_mirror.py reads (box_rmax/box_zmin/box_zmax/z_reference/
    r_Omode_cut_at_z_ref, plot_RAYS_mirror.py:74-101)."""
    zr = z_reference if z_reference is not None else \
        0.5 * (float(params.eq.box_zmin) + float(params.eq.box_zmax))
    with open(path, "w") as f:
        f.write(f" run_description = {cfg.run_description}\n")
        f.write(f" run_label = {cfg.run_label}\n")
        f.write(f" box_rmax = {float(params.eq.box_rmax)}\n")
        f.write(f" box_zmin = {float(params.eq.box_zmin)}\n")
        f.write(f" box_zmax = {float(params.eq.box_zmax)}\n")
        f.write(f" num_plot_k_vectors = {num_plot_k_vectors}\n")
        f.write(f" scale_k_vec = {scale_k_vec}\n")
        f.write(f" k_vec_base_length = {k_vec_base_length}\n")
        f.write(f" set_XY_lim = {set_xy_lim}\n")
        f.write(f" z_reference = {zr}\n")
        f.write(f" r_Omode_cut_at_z_ref = {r_omode_cutoff(cfg, params, zr)}\n")
    return path


def process(cfg, params, results, z_reference=None, do_ox_analysis=True,
            calculate_ray_diag=False, knobs=None):
    """``knobs`` carries the &mirror_processor_list namelist group
    (mirror_processor_m.f90:95-101): XZ-grid sizes N_pointsX_eq/
    N_pointsZ_eq, radial grid n_AphiN, z_reference, the write_* file
    gates, do_OX_conv_analysis, and the plot-vector controls."""
    k = {str(a).lower(): b for a, b in (knobs or {}).items()}
    out = {}
    if bool(k.get("write_contour_data",
                  k.get("write_eq_xz_grid_data", True))):
        out["eq_contours"] = write_eq_contours(
            cfg, params, n_x=int(k.get("n_pointsx_eq", 51)),
            n_z=int(k.get("n_pointsz_eq", 101)))
    if z_reference is None and "z_reference" in k:
        z_reference = float(k["z_reference"])
    zr = z_reference if z_reference is not None else \
        0.5 * (float(params.eq.box_zmin) + float(params.eq.box_zmax))
    if bool(k.get("write_eq_radial_profile_data", True)):
        out["radial_profiles"] = write_radial_profiles(
            cfg, params, zr, n_points=int(k.get("n_aphin", 51)))
    out["graphics_description"] = write_graphics_description(
        cfg, params, z_reference=zr,
        num_plot_k_vectors=int(k.get("num_plot_k_vectors", 0)),
        scale_k_vec=str(k.get("scale_k_vec", "True")),
        k_vec_base_length=float(k.get("k_vec_base_length", 0.02)),
        set_xy_lim=str(k.get("set_xy_lim", "True")))
    if calculate_ray_diag:
        from rays_tpu_torch.post import ray_diags

        out["ray_diags_nc"] = ray_diags.write_ray_diagnostics_nc(
            cfg, params, results)
    if do_ox_analysis and bool(k.get("do_ox_conv_analysis", True)):
        from rays_tpu_torch.post import ox_conversion

        conv = ox_conversion.ox_conv_analysis(cfg, params, results)
        out["ox_conversion"] = ox_conversion.write_ox_conversion_data(
            conv, cfg.run_label)
        out["n_converted"] = len(conv)
    return out
