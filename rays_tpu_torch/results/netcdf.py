"""NetCDF results writer/reader, schema-compatible with the reference
(copied from ``rays_tpu.results.netcdf``; it takes the port's RayResults
after ``.cpu()``).

Writes ``run_results.<run_label>.nc`` with the exact dimension and variable
names of the reference writer (reference RAYS_project/RAYS_lib/
ray_results_m.f90:171-249), in NetCDF3-classic format via scipy, so the
reference's committed Python plotters (graphics_RAYS/plot_RAYS_*.py) consume
our output unchanged.  As in the reference, the point axis is trimmed to
max(npoints) on output (ray_results_m.f90:202).
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from rays_tpu_torch.tracing.stop import flag_string


def write_results_nc(cfg, results, total_trace_time=0.0, path=None,
                     ray_trace_time=None):
    nray = int(results.npoints.shape[0])
    npoints = np.asarray(results.npoints)
    actual_max = int(npoints.max())
    nv = int(results.ray_vec.shape[-1])

    fname = path or f"run_results.{cfg.run_label}.nc"
    f = netcdf_file(fname, "w")
    try:
        f.RAYS_run_label = cfg.run_label.encode()
        f.createDimension("number_of_rays", nray)
        f.createDimension("max_number_of_points", actual_max)
        f.createDimension("dim_v_vector", nv)
        f.createDimension("d8", 8)
        f.createDimension("d60", 60)

        def var(name, dtype, dims, data):
            v = f.createVariable(name, dtype, dims)
            v[:] = data
            return v

        import datetime

        now = datetime.datetime.now()
        date_vec = np.array(
            [now.year, now.month, now.day, 0, now.hour, now.minute,
             now.second, now.microsecond // 1000], np.int32)
        var("date_vector", np.int32, ("d8",), date_vec)
        # Fortran writes ray_vec(nv, pts, nray); in C order that is
        # (nray, pts, nv) — exactly our layout.
        var("ray_vec", np.float64,
            ("number_of_rays", "max_number_of_points", "dim_v_vector"),
            np.asarray(results.ray_vec)[:, :actual_max, :])
        var("residual", np.float64,
            ("number_of_rays", "max_number_of_points"),
            np.asarray(results.residual)[:, :actual_max])
        var("npoints", np.int32, ("number_of_rays",), npoints.astype(np.int32))
        var("initial_ray_power", np.float32, ("number_of_rays",),
            np.asarray(results.initial_ray_power, np.float32))
        rtt = (np.zeros(nray, np.float32) if ray_trace_time is None
               else np.asarray(ray_trace_time, np.float32))
        v = var("ray_trace_time", np.float32, ("number_of_rays",), rtt)
        # the reference measures this per ray inside its OpenMP loop
        # (ray_tracing.f90:74-75); rays are traced as one batch here, so
        # this field is an attribution, and the file says so
        v.attribution = (b"batch wall time attributed by each ray's share "
                         b"of accepted steps (rays are traced as one "
                         b"batch); not an independent per-ray timer")
        var("end_residuals", np.float32, ("number_of_rays",),
            np.asarray(results.end_residuals, np.float32))
        var("max_residuals", np.float32, ("number_of_rays",),
            np.asarray(results.max_residuals, np.float32))
        var("end_ray_parameter", np.float32, ("number_of_rays",),
            np.asarray(results.end_ray_parameter, np.float32))
        var("start_ray_vec", np.float32, ("number_of_rays", "dim_v_vector"),
            np.asarray(results.start_ray_vec, np.float32))
        var("end_ray_vec", np.float32, ("number_of_rays", "dim_v_vector"),
            np.asarray(results.end_ray_vec, np.float32))

        flags = np.zeros((nray, 60), dtype="S1")
        for i in range(nray):
            s = flag_string(int(np.asarray(results.stop_flag)[i])).ljust(60)[:60]
            flags[i] = np.frombuffer(s.encode(), dtype="S1")
        v = f.createVariable("ray_stop_flag", "S1", ("number_of_rays", "d60"))
        v[:] = flags

        v = f.createVariable("total_trace_time", np.float32, ())
        # scipy's assignValue is broken for 0-d variables; write the
        # underlying array directly
        v.data[()] = np.float32(total_trace_time)
    finally:
        f.close()
    return fname


def read_results_nc(path):
    """Read a run_results file (ours or the reference's) into a dict."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        out = {k: np.array(v[:]) if v.shape else np.array(v.getValue())
               for k, v in f.variables.items()}
        out["RAYS_run_label"] = getattr(f, "RAYS_run_label", b"").decode()
    finally:
        f.close()
    return out
