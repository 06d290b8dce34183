"""Per-ray detailed diagnostics -> ray_detailed_diagnostics.<label>.nc
(``rays_tpu.post.ray_diags``).

Re-design of the reference's per-geometry ray_detailed_diagnostics
subroutines (axisym_toroid_processor_m.f90:252-465,
slab_processor_m.f90:123-330, mirror_processor_m.f90:235-465): for every
trajectory point, extract or recompute ne, Te, |B|, alpha_e, gamma_e, the
geometry coordinate (psiN / X,Y / AphiN), n_par, n_perp, absorbed power,
n_imag = ki/k0, the electron Z-function arguments for harmonics 0-2
(xi_l = (omega + l*Omega_ce)/(k_par v_th), :407-411), and the dispersion
residual, in the reference's netCDF schema (graphics_RAYS/plot_ray_diags.py
reads the file unchanged).

Every (ray, step) point is evaluated in one batched pass on the device the
results live on, points beyond npoints included, and then masked to the
reference's zero fill, as the JAX package does.  Rays go through in chunks
of at most ``CHUNK_POINTS`` points, so the intermediates of the
equilibrium evaluation stay bounded whatever the batch.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from rays_tpu_torch import constants
from rays_tpu_torch.models import base as model_base
from rays_tpu_torch.wave import damping as damping_mod
from rays_tpu_torch.wave import deriv_cold as deriv_cold_mod

# trajectory points evaluated at once (the equilibrium with its jacobians
# holds some 60 values per point)
CHUNK_POINTS = 1 << 21


def _coordinate_vars(cfg, params, rvec):
    """Geometry-specific coordinate variables of points rvec (N, 3), name
    -> (N,)."""
    x, y, z = rvec[:, 0], rvec[:, 1], rvec[:, 2]
    r_cyl = torch.sqrt(x**2 + y**2)
    if cfg.equilib_model == "slab":
        # slab_processor_m.f90: X, Y, Z
        return {"X": x, "Y": y, "Z": z}
    if cfg.equilib_model == "solovev":
        from rays_tpu_torch.models import solovev as sv

        return {"Psi": sv.psi(params.eq, rvec)[2], "R": r_cyl, "Z": z}
    if cfg.equilib_model == "axisym_toroid":
        from rays_tpu_torch.models import axisym_toroid as at

        return {"Psi": at.magnetics(cfg.eq_static, params.eq, rvec)[2], "R": r_cyl, "Z": z}
    if cfg.equilib_model == "multiple_mirror":
        from rays_tpu_torch.models import multiple_mirror as mm

        return {"Aphi": mm.magnetics(params.eq, rvec)[2], "R": r_cyl, "Z": z}
    raise ValueError(f"ray diagnostics: unknown geometry {cfg.equilib_model}")


def _point_diagnostics(cfg, params, v):
    """The diagnostics of trajectory points v (N, nv), name -> (N,)."""
    rvec, kvec = v[:, 0:3], v[:, 3:6]
    eq = model_base.equilibrium(cfg, params, rvec)
    k0, omgrf = params.rf.k0, params.rf.omgrf
    sp = params.species
    out = {"s": v[:, 6]}
    out.update(_coordinate_vars(cfg, params, rvec))
    out["ne"] = eq.ns[:, 0] * sp.n_ref   # physical density, reference units
    out["Te_kev"] = eq.ts[:, 0] / constants.E_CHARGE / 1000.0
    out["modB"] = eq.bmag
    out["alpha_e"] = eq.alpha[:, 0]
    out["gamma_e"] = eq.gamma[:, 0].abs()

    k3 = (kvec * eq.bunit).sum(-1)
    k1 = torch.sqrt(((kvec - k3[:, None] * eq.bunit) ** 2).sum(-1))
    out["n_par"] = k3 / k0
    out["n_perp"] = k1 / k0

    if cfg.damping_model != "no_damp":
        _, dddk, dddw = deriv_cold_mod.deriv_cold(eq, kvec / k0, omgrf, k0)
        safe_dddw = torch.where(dddw == 0.0, torch.ones_like(dddw), dddw)
        vg = -dddk / safe_dddw[:, None]
        _, ki = damping_mod.damping(cfg, params, eq, v[:, 0:6], vg)
        out["n_imag"] = ki / k0
        out["P_absorbed"] = v[:, 7]
    else:
        out["n_imag"] = torch.zeros_like(k3)
        out["P_absorbed"] = torch.zeros_like(k3)

    # Z-function arguments for harmonics 0..2
    # (axisym_toroid_processor_m.f90:407-411)
    vth = torch.sqrt(2.0 * eq.ts[:, 0].clamp_min(constants.SAFE_TINY) / sp.ms[0])
    safe_k3 = torch.where(k3 == 0.0, torch.ones_like(k3), k3)
    live = (eq.ts[:, 0] > 0.0) & (k3 != 0.0)
    for harmonic in range(3):
        xi = (omgrf + harmonic * eq.omgc[:, 0]) / (safe_k3 * vth)
        out[f"xi_{harmonic}"] = torch.where(live, xi, torch.zeros_like(xi))
    return out


@torch.no_grad()
def compute_ray_diagnostics(cfg, params, results):
    """dict of (B, n_pts) tensors on the results' device, zero beyond
    npoints.  The names are sorted, residual last: the order of the JAX
    package's dict (a pytree sorts its keys), and so of the file."""
    ray_vec = results.ray_vec            # (B, n_pts, nv)
    B, n_pts, nv = ray_vec.shape
    valid = (torch.arange(n_pts, device=ray_vec.device)[None, :]
             < results.npoints[:, None])
    rays = max(1, CHUNK_POINTS // max(n_pts, 1))
    diags = None
    for i in range(0, B, rays):
        part = _point_diagnostics(cfg, params, ray_vec[i:i + rays].reshape(-1, nv))
        if diags is None:
            diags = {k: ray_vec.new_empty((B, n_pts)) for k in sorted(part)}
        ok = valid[i:i + rays]
        for k, val in part.items():
            val = val.reshape(ok.shape)
            # zero fill beyond npoints (the reference's source=0.0 allocation)
            diags[k][i:i + rays] = torch.where(ok, val, torch.zeros_like(val))
    diags["residual"] = torch.where(valid, results.residual,
                                    torch.zeros_like(results.residual))
    return diags


def write_ray_diagnostics_nc(cfg, params, results, path=None):
    """Write the reference-schema netCDF (…processor_m.f90:430-465).
    Returns the filename."""
    from scipy.io import netcdf_file

    diags = compute_ray_diagnostics(cfg, params, results)
    B, n_pts = diags["s"].shape
    suffix = "_slab" if cfg.equilib_model == "slab" else ""
    fn = path or f"ray_detailed_diagnostics{suffix}.{cfg.run_label}.nc"

    f = netcdf_file(fn, "w")
    try:
        f.createDimension("number_of_rays", B)
        f.createDimension("max_number_of_points", n_pts)
        f.createDimension("dim_v_vector", cfg.nv)
        f.createDimension("d8", 8)
        f.RAYS_run_label = cfg.run_label.encode()
        now = datetime.datetime.now()
        dv = f.createVariable("date_vector", np.int32, ("d8",))
        dv[:] = np.array([now.year, now.month, now.day, 0, now.hour,
                          now.minute, now.second, 0], np.int32)
        npv = f.createVariable("npoints", np.int32, ("number_of_rays",))
        npv[:] = results.npoints.cpu().numpy().astype(np.int32)
        for name, arr in diags.items():
            v = f.createVariable(
                name, np.float64, ("number_of_rays", "max_number_of_points"))
            v[:] = arr.cpu().double().numpy()
    finally:
        f.close()
    return fn
