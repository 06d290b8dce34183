"""List-directed ASCII results writer/reader (copied from
``rays_tpu.results.ascii``; it takes the port's RayResults after
``.cpu()``, as results/netcdf.py does).

Format-compatible with the reference's write_results_LD / read_results_LD
(reference RAYS_project/RAYS_lib/ray_results_m.f90:365-420): alternating
name line / list-directed value lines, arrays flattened in Fortran column
order (ray_vec written as (nv, pts, nray)).
"""

from __future__ import annotations

import datetime

import numpy as np

from rays_tpu_torch.tracing.stop import flag_string


def _w(f, name, values):
    f.write(f" {name}\n")
    arr = np.atleast_1d(np.asarray(values)).ravel()
    if arr.dtype.kind in "US":
        f.write(" " + " ".join(str(v) for v in arr) + "\n")
    elif arr.dtype.kind in "iu":
        f.write(" " + " ".join(str(int(v)) for v in arr) + "\n")
    else:
        f.write(" " + " ".join(f"{float(v):.17g}" for v in arr) + "\n")


def write_results_ld(cfg, results, total_trace_time=0.0, path=None,
                     ray_trace_time=None):
    nray = int(results.npoints.shape[0])
    npoints = np.asarray(results.npoints)
    nv = int(results.ray_vec.shape[-1])
    actual_max = int(npoints.max())
    fname = path or f"run_results.{cfg.run_label}"
    now = datetime.datetime.now()
    date_vec = [now.year, now.month, now.day, 0, now.hour, now.minute,
                now.second, now.microsecond // 1000]
    with open(fname, "w") as f:
        _w(f, "RAYS_run_label", [cfg.run_label])
        _w(f, "date_vector", date_vec)
        _w(f, "number_of_rays", [nray])
        _w(f, "max_number_of_points", [actual_max])
        _w(f, "dim_v_vector", [nv])
        _w(f, "npoints", npoints)
        _w(f, "total_trace_time", [total_trace_time])
        _w(f, "initial_ray_power", results.initial_ray_power)
        # per-ray trace-time attribution, same field both formats
        # (ray_results_m.f90:50,365-420); callers pass run.ray_trace_times
        _w(f, "ray_trace_time",
           np.zeros(nray) if ray_trace_time is None
           else np.asarray(ray_trace_time, np.float64))
        _w(f, "end_ray_parameter", results.end_ray_parameter)
        _w(f, "end_residuals", results.end_residuals)
        _w(f, "max_residuals", results.max_residuals)
        _w(f, "ray_stop_flag",
           [flag_string(int(s)).strip().replace(" ", "_") or "OK"
            for s in np.asarray(results.stop_flag)])
        # Fortran column-major flatten of the reference's (nv, nray) /
        # (npts, nray) / (nv, npts, nray) arrays (ray_results_m.f90:365+)
        # is element-for-element the C-order ravel of our (nray, nv) /
        # (nray, npts) / (nray, npts, nv) layouts — write them as-is
        # (transposing first, as this writer originally did, produced a
        # ray-fastest order no Fortran reader would accept)
        _w(f, "start_ray_vec", np.asarray(results.start_ray_vec))
        _w(f, "end_ray_vec", np.asarray(results.end_ray_vec))
        _w(f, "residual", np.asarray(results.residual)[:, :actual_max])
        _w(f, "ray_vec", np.asarray(results.ray_vec)[:, :actual_max, :])
    return fname


def read_results_ld(path):
    """Read back into a dict of arrays (shapes restored to C order)."""
    with open(path) as f:
        tokens = f.read().split("\n")
    data = {}
    i = 0
    while i < len(tokens):
        name = tokens[i].strip()
        if not name:
            i += 1
            continue
        vals = tokens[i + 1].split()
        data[name] = vals
        i += 2

    def farr(name):
        return np.asarray([float(v) for v in data[name]])

    out = {
        "RAYS_run_label": data["RAYS_run_label"][0],
        "number_of_rays": int(data["number_of_rays"][0]),
        "max_number_of_points": int(data["max_number_of_points"][0]),
        "dim_v_vector": int(data["dim_v_vector"][0]),
        "npoints": np.asarray([int(v) for v in data["npoints"]]),
        "total_trace_time": float(data["total_trace_time"][0]),
        "ray_trace_time": farr("ray_trace_time"),
        "initial_ray_power": farr("initial_ray_power"),
        "end_ray_parameter": farr("end_ray_parameter"),
        "end_residuals": farr("end_residuals"),
        "max_residuals": farr("max_residuals"),
        "ray_stop_flag": data["ray_stop_flag"],
    }
    nray, pts, nv = (out["number_of_rays"], out["max_number_of_points"],
                     out["dim_v_vector"])
    # the stream is the Fortran column-major order of the reference's
    # (nv, nray) / (npts, nray) / (nv, npts, nray) arrays, which is the
    # C-order layout of our ray-major shapes
    out["start_ray_vec"] = farr("start_ray_vec").reshape(nray, nv)
    out["end_ray_vec"] = farr("end_ray_vec").reshape(nray, nv)
    out["residual"] = farr("residual").reshape(nray, pts)
    out["ray_vec"] = farr("ray_vec").reshape(nray, pts, nv)
    return out


def write_formatted_ray_files(cfg, results, directory=".", run_label=None,
                              ds=None):
    """Per-step formatted ray files: ray_out.<label> + ray_list.<label>.

    The reference streams ``s, v(:)`` after every accepted step
    (check_save.f90:152-154 into the files opened in intialize.f90:79-91)
    and writes the companion description file at the end of trace_rays
    (ray_tracing.f90:280-286); the rationale is crash forensics
    (diagnostics_m.f90:85-91).  The batched trace returns the whole
    trajectory at once, so the equivalent here is written from the saved
    trajectory right after the trace returns: same file names, same
    list-directed layout, so the legacy stream reader (ours below, or
    post_processing_m.f90:292-361) consumes them unchanged.

    Requires cfg.save_trajectory.  ``s`` at point j is j*ds (the outer
    integration grid; both steppers advance exactly ds per outer step).
    """
    label = run_label or cfg.run_label
    npoints = np.asarray(results.npoints)
    ray_vec = np.asarray(results.ray_vec)
    nray = int(npoints.shape[0])
    nv = int(ray_vec.shape[-1])
    if ray_vec.shape[1] < int(npoints.max()):
        raise ValueError(
            "write_formatted_ray_files needs the saved trajectory "
            "(cfg.save_trajectory=True)")
    ds = float(ds) if ds is not None else None

    import os

    out_path = os.path.join(directory, f"ray_out.{label}")
    with open(out_path, "w") as f:
        for ir in range(nray):
            for j in range(int(npoints[ir])):
                s = (j * ds) if ds is not None else float(ray_vec[ir, j, 6])
                f.write(" " + f"{s:.17g} "
                        + " ".join(f"{float(v):.17g}"
                                   for v in ray_vec[ir, j, :]) + "\n")

    list_path = os.path.join(directory, f"ray_list.{label}")
    with open(list_path, "w") as f:
        f.write(f" {nray}\n")
        f.write(f" {nv}\n")
        f.write(" " + " ".join(str(int(n)) for n in npoints) + "\n")
        f.write(" " + " ".join(
            f"{float(v):.17g}" for v in np.asarray(results.end_residuals))
            + "\n")
        f.write(" " + " ".join(
            flag_string(int(s)).strip().replace(" ", "_") or "OK"
            for s in np.asarray(results.stop_flag)) + "\n")
    return out_path, list_path


def read_ray_data(run_label, directory="."):
    """Legacy stream-reader analog (post_processing_m.f90:292-361): read
    ray_list.<label> + ray_out.<label> back into arrays.

    Returns dict with s_vec (nray, npoints_max), v_vec (nray, npoints_max,
    nv), npoints, end_residuals, ray_stop_flag.  Tolerates a truncated
    ray_out (a crashed run): missing points stay zero and the actual count
    is reflected in npoints.
    """
    import os

    with open(os.path.join(directory, f"ray_list.{run_label}")) as f:
        nray = int(f.readline().split()[0])
        nv = int(f.readline().split()[0])
        npoints = np.asarray([int(v) for v in f.readline().split()])
        end_residuals = np.asarray([float(v) for v in f.readline().split()])
        ray_stop = f.readline().split()
    assert npoints.shape[0] == nray

    npoints_max = int(npoints.max()) if nray else 0
    s_vec = np.zeros((nray, npoints_max))
    v_vec = np.zeros((nray, npoints_max, nv))
    got = np.zeros(nray, np.int64)
    with open(os.path.join(directory, f"ray_out.{run_label}")) as f:
        for ir in range(nray):
            for j in range(int(npoints[ir])):
                line = f.readline()
                if not line:  # truncated by a crash: keep what we have
                    break
                vals = [float(v) for v in line.split()]
                s_vec[ir, j] = vals[0]
                v_vec[ir, j, :] = vals[1:1 + nv]
                got[ir] = j + 1
    return {
        "s_vec": s_vec, "v_vec": v_vec,
        "npoints": np.minimum(npoints, got),
        "npoints_declared": npoints,
        "end_residuals": end_residuals, "ray_stop_flag": ray_stop,
    }
