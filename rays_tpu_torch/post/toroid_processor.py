"""Axisymmetric-toroid (and Solovev) post-processor
(``rays_tpu.post.toroid_processor``).

Re-design of reference RAYS_project/post_process_lib/
axisym_toroid_processor_m.f90 (and the simpler solovev_processor_m.f90):

* plasma-boundary finder: bisection on psiN = 1 along rays from the
  magnetic axis (axisym_toroid_processor_m.f90:131), all rays at once;
* psi(R, Z) contour grid + equilibrium R/Z grids to netCDF (:487,618);
* radial profiles (ne, Te, |B|, alpha, gamma vs psiN) as XY curves (:775);
* graphics description file for the reference plotters.

Each grid is one batched evaluation on the device the parameters live on.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.io import netcdf_file

from rays_tpu_torch.models import base
from rays_tpu_torch.ops import bisect
from rays_tpu_torch.post import grid
from rays_tpu_torch.post.xy_curves import XYCurve, write_xy_curves_nc
from rays_tpu_torch.wave import dispersion


def _psiN_fn(cfg, params):
    """Points (N, 3) -> psiN (N,)."""
    if cfg.equilib_model == "axisym_toroid":
        from rays_tpu_torch.models import axisym_toroid as at

        return lambda r: at.magnetics(cfg.eq_static, params.eq, r)[2]
    if cfg.equilib_model == "solovev":
        from rays_tpu_torch.models import solovev as sv

        return lambda r: sv.psi(params.eq, r)[2]
    raise ValueError(f"toroid processor: unsupported model {cfg.equilib_model}")


def _axis_of(cfg, params):
    if cfg.equilib_model == "axisym_toroid":
        if cfg.eq_static.magnetics_model == "solovev_magnetics":
            return float(params.eq.mag.rmaj), 0.0
        # EQDSK: use the midpoint of the box as a starting axis guess
        sp = params.eq.mag.psi_spline
        return (float(sp.x0) + float(sp.dx) * (sp.f.shape[0] - 1) / 2.0, 0.0)
    return float(params.eq.rmaj), 0.0


def _rz_grid(params, n_r, n_z):
    """The (R, Z) box grid (numpy rs, zs) and its points in (R, Z)
    meshgrid ('ij') order."""
    rs = np.linspace(float(params.eq.box_rmin), float(params.eq.box_rmax), n_r)
    zs = np.linspace(float(params.eq.box_zmin), float(params.eq.box_zmax), n_z)
    R, Z = np.meshgrid(rs, zs, indexing="ij")
    return rs, zs, grid.plane_points(grid.like(params, R), grid.like(params, Z))


@torch.no_grad()
def find_plasma_boundary(cfg, params, n_theta: int = 64, r_max: float = 3.0,
                         eps: float = 1e-6):
    """(R, Z, ok) numpy arrays of the psiN = 1 surface found by bisection
    along n_theta rays from the axis (axisym_toroid_processor_m.f90:131);
    ``eps`` is the namelist ``bisection_eps``."""
    psiN = _psiN_fn(cfg, params)
    r_axis, z_axis = _axis_of(cfg, params)
    thetas = np.linspace(0.0, 2 * np.pi, n_theta, endpoint=False)
    cos, sin = grid.like(params, np.cos(thetas)), grid.like(params, np.sin(thetas))

    def f(t):
        return psiN(grid.plane_points(r_axis + t * cos, z_axis + t * sin))

    t, ok = bisect.solve_bisection(f, 1.0, grid.like(params, np.full(n_theta, eps)), r_max)
    t = grid.to_numpy(t)
    return r_axis + t * np.cos(thetas), z_axis + t * np.sin(thetas), ok.cpu().numpy()


@torch.no_grad()
def write_eq_contour_grids(cfg, params, n_r=65, n_z=65, out_prefix=None):
    """psi/psiN/|B|/ne on an (R, Z) grid -> netCDF for contour plots
    (axisym_toroid_processor_m.f90:487,618)."""
    rs, zs, rvec = _rz_grid(params, n_r, n_z)
    eq = base.equilibrium(cfg, params, rvec)
    pn, bmag, ne = (grid.to_numpy(t).reshape(n_r, n_z) for t in (
        _psiN_fn(cfg, params)(rvec), eq.bmag, eq.ns[:, 0] * params.species.n_ref))

    fname = (out_prefix or f"eq_RZ_grids.{cfg.run_label}") + ".nc"
    f = netcdf_file(fname, "w")
    try:
        f.createDimension("n_R", n_r)
        f.createDimension("n_Z", n_z)
        for name, data in [("R_grid", rs), ("Z_grid", zs)]:
            v = f.createVariable(name, np.float64,
                                 ("n_R",) if name == "R_grid" else ("n_Z",))
            v[:] = data
        for name, data in [("psiN", pn), ("Bmag", bmag), ("ne", ne)]:
            v = f.createVariable(name, np.float64, ("n_R", "n_Z"))
            v[:] = data
    finally:
        f.close()
    return fname


@torch.no_grad()
def write_radial_profiles(cfg, params, n_points=101, out_prefix=None):
    """Midplane radial profiles vs psiN as XY curves
    (axisym_toroid_processor_m.f90:775)."""
    r_axis, z_axis = _axis_of(cfg, params)
    rs = np.linspace(r_axis, float(params.eq.box_rmax), n_points)
    rvec = grid.plane_points(grid.like(params, rs), grid.like(params, z_axis))
    eq = base.equilibrium(cfg, params, rvec)
    alpha, gamma, _, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    pn, ne, te, bmag, ae, ge = (grid.to_numpy(t) for t in (
        _psiN_fn(cfg, params)(rvec), eq.ns[:, 0] * params.species.n_ref, eq.ts[:, 0],
        eq.bmag, alpha[:, 0], gamma[:, 0]))
    curves = [
        XYCurve("R", "psiN", rs, pn),
        XYCurve("psiN", "ne", pn, ne),
        XYCurve("psiN", "Te", pn, te),
        XYCurve("psiN", "Bmag", pn, bmag),
        XYCurve("psiN", "alpha_e", pn, ae),
        XYCurve("psiN", "gamma_e", pn, ge),
    ]
    prefix = out_prefix or f"eq_radial_profiles.{cfg.run_label}"
    return write_xy_curves_nc(curves, prefix)


def write_graphics_description(cfg, params,
                               path="graphics_description_axisym_toroid.dat",
                               num_plot_k_vectors=5, scale_k_vec="True",
                               k_vec_base_length=0.05, set_xy_lim="True",
                               bisection_eps=1e-6):
    """Exactly the keys plot_RAYS_axisym_toroid.py reads (:93-112,364-373)
    — or, for the solovev geometry, plot_RAYS_solovev.py (:76-81,204-211,
    265-291, which additionally wants rmaj/kappa for its own psi contour)."""
    rb, zb, _ = find_plasma_boundary(cfg, params, n_theta=32,
                                     eps=bisection_eps)
    with open(path, "w") as f:
        f.write(f" run_description = {cfg.run_description}\n")
        f.write(f" run_label = {cfg.run_label}\n")
        f.write(f" box_rmin = {float(params.eq.box_rmin)}\n")
        f.write(f" box_rmax = {float(params.eq.box_rmax)}\n")
        f.write(f" box_zmin = {float(params.eq.box_zmin)}\n")
        f.write(f" box_zmax = {float(params.eq.box_zmax)}\n")
        f.write(f" inner_bound = {rb.min()}\n")
        f.write(f" outer_bound = {rb.max()}\n")
        f.write(f" lower_bound = {zb.min()}\n")
        f.write(f" upper_bound = {zb.max()}\n")
        f.write(f" num_plot_k_vectors = {num_plot_k_vectors}\n")
        f.write(f" scale_k_vec = {scale_k_vec}\n")
        f.write(f" k_vec_base_length = {k_vec_base_length}\n")
        f.write(f" set_XY_lim = {set_xy_lim}\n")
        # plasma boundary point lists, whitespace-delimited on one line
        # (dict_variable_to_list_of_floats in the reference's
        # simple_file_editing_functions.py:134; plotted at
        # plot_RAYS_axisym_toroid.py:287-295)
        f.write(" R_boundary = "
                + " ".join(f"{v:.8g}" for v in rb) + "\n")
        f.write(" Z_boundary = "
                + " ".join(f"{v:.8g}" for v in zb) + "\n")
        if cfg.equilib_model == "solovev":
            f.write(f" rmaj = {float(params.eq.rmaj)}\n")
            f.write(f" kappa = {float(params.eq.kappa)}\n")
    return path


@torch.no_grad()
def write_eq_contours(cfg, params, n_r=65, n_z=65, path=None):
    """psiN + per-species |gamma| on the (R, Z) plane ->
    eq_contours.<label>.nc as plot_RAYS_axisym_toroid.py:311-349 reads it:
    R (n_R), Z (n_Z), psiN (n_Z, n_R), gamma_array (nspec+1, n_Z, n_R)."""
    rs, zs, rvec = _rz_grid(params, n_r, n_z)
    _, gamma, _, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    S = cfg.ns
    pn = grid.to_numpy(_psiN_fn(cfg, params)(rvec)).reshape(n_r, n_z).T          # (n_Z, n_R)
    gam = np.transpose(grid.to_numpy(gamma.abs()).reshape(n_r, n_z, S), (2, 1, 0))

    fname = path or f"eq_contours.{cfg.run_label}.nc"
    f = netcdf_file(fname, "w")
    try:
        f.createDimension("n_R", n_r)
        f.createDimension("n_Z", n_z)
        f.createDimension("nspec_p1", S)
        v = f.createVariable("R", np.float64, ("n_R",))
        v[:] = rs
        v = f.createVariable("Z", np.float64, ("n_Z",))
        v[:] = zs
        v = f.createVariable("psiN", np.float64, ("n_Z", "n_R"))
        v[:] = pn
        v = f.createVariable("gamma_array", np.float64,
                             ("nspec_p1", "n_Z", "n_R"))
        v[:] = gam
    finally:
        f.close()
    return fname


@torch.no_grad()
def write_normalized_psi_nc(cfg, params, n_r=65, n_z=65, path=None):
    """normalized_psi.<label>.nc for graphics_RAYS/plot_psi_contours.py:
    box bounds + R(n_R) + Z(n_Z) + psiN indexed [Z, R] (the C-order view
    of the reference's [n_R, n_Z] Fortran layout, which is what
    matplotlib's contour(R, Z, psiN) consumes)."""
    rs, zs, rvec = _rz_grid(params, n_r, n_z)
    pn = grid.to_numpy(_psiN_fn(cfg, params)(rvec)).reshape(n_r, n_z)

    fname = path or f"normalized_psi.{cfg.run_label}.nc"
    f = netcdf_file(fname, "w")
    try:
        f.createDimension("n_R", n_r)
        f.createDimension("n_Z", n_z)
        f.RAYS_run_label = cfg.run_label.encode()
        for name in ("box_rmin", "box_rmax", "box_zmin", "box_zmax"):
            v = f.createVariable(name, np.float64, ())
            # scipy's assignValue does data[:] which trips on 0-d arrays
            v.data[()] = float(getattr(params.eq, name))
        v = f.createVariable("R", np.float64, ("n_R",))
        v[:] = rs
        v = f.createVariable("Z", np.float64, ("n_Z",))
        v[:] = zs
        v = f.createVariable("psiN", np.float64, ("n_Z", "n_R"))
        v[:] = pn.T
    finally:
        f.close()
    return fname


def process(cfg, params, results, knobs=None):
    """``knobs`` carries the &axisym_toroid_processor_list /
    &solovev_processor_list namelist group
    (axisym_toroid_processor_m.f90:59-64, solovev_processor_m.f90:32):
    RZ-grid sizes N_pointsR_eq/N_pointsZ_eq, radial grid n_psiN (n_rho
    accepted as the fallback — the radial writer emits the psiN-grid
    curves), bisection_eps, the write_* file gates, and the plot-vector
    controls."""
    k = {str(a).lower(): b for a, b in (knobs or {}).items()}
    beps = float(k.get("bisection_eps", 1e-6))
    n_r = int(k.get("n_pointsr_eq", 65))
    n_z = int(k.get("n_pointsz_eq", 65))
    out = {}
    rb, zb, ok = find_plasma_boundary(cfg, params, eps=beps)
    out["boundary"] = (rb, zb)
    if bool(k.get("write_contour_data", True)):
        out["contours"] = write_eq_contour_grids(cfg, params, n_r=n_r,
                                                 n_z=n_z)
    if bool(k.get("write_eq_rz_grid_data", True)):
        out["eq_contours"] = write_eq_contours(cfg, params, n_r=n_r, n_z=n_z)
        out["normalized_psi"] = write_normalized_psi_nc(cfg, params, n_r=n_r,
                                                        n_z=n_z)
    if bool(k.get("write_eq_radial_profile_data", True)):
        out["profiles"] = write_radial_profiles(
            cfg, params, n_points=int(k.get("n_psin", k.get("n_rho", 101))))
    gd_path = ("graphics_description_solovev.dat"
               if cfg.equilib_model == "solovev"
               else "graphics_description_axisym_toroid.dat")
    out["graphics_description"] = write_graphics_description(
        cfg, params, path=gd_path,
        num_plot_k_vectors=int(k.get("num_plot_k_vectors", 5)),
        scale_k_vec=str(k.get("scale_k_vec", "True")),
        k_vec_base_length=float(k.get("k_vec_base_length", 0.05)),
        set_xy_lim=str(k.get("set_xy_lim", "True")),
        bisection_eps=beps,
    )
    return out
