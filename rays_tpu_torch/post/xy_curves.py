"""Named-curve-list netCDF writer (generic profile/diagnostic plots),
``rays_tpu.post.xy_curves``: numpy and scipy only, so the port keeps its
own copy.  Curves are numpy arrays on the host.

Schema-compatible with reference RAYS_project/RAYS_lib/XY_curves_netCDF_m
.f90 (consumed by graphics_RAYS/plot_XY_curves_netCDF.py): dimensions
n_curves / grid_max_len / name lengths; variables curve_name, grid_name,
n_grid, grid(n_curves, grid_max_len), curve(...), zero-padded to the
longest grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.io import netcdf_file


@dataclasses.dataclass
class XYCurve:
    grid_name: str
    curve_name: str
    grid: np.ndarray
    curve: np.ndarray


def write_xy_curves_nc(curves, out_filename):
    """curves: list[XYCurve]; writes <out_filename>.nc."""
    n_curves = len(curves)
    grid_max = max(len(c.grid) for c in curves)
    gname_max = max(len(c.grid_name) for c in curves)
    cname_max = max(len(c.curve_name) for c in curves)

    path = str(out_filename) + ".nc"
    f = netcdf_file(path, "w")
    try:
        f.createDimension("n_curves", n_curves)
        f.createDimension("grid_max_len", grid_max)
        f.createDimension("grid_name_max_len_id", gname_max)
        f.createDimension("curve_name_max_len_id", cname_max)

        def put_str(name, dim, strings, width):
            v = f.createVariable(name, "S1", ("n_curves", dim))
            arr = np.zeros((n_curves, width), dtype="S1")
            for i, s in enumerate(strings):
                arr[i] = np.frombuffer(s.ljust(width)[:width].encode(), dtype="S1")
            v[:] = arr

        put_str("curve_name", "curve_name_max_len_id",
                [c.curve_name for c in curves], cname_max)
        put_str("grid_name", "grid_name_max_len_id",
                [c.grid_name for c in curves], gname_max)

        v = f.createVariable("n_grid", np.int32, ("n_curves",))
        v[:] = np.asarray([len(c.grid) for c in curves], np.int32)

        grid = np.zeros((n_curves, grid_max))
        curve = np.zeros((n_curves, grid_max))
        for i, c in enumerate(curves):
            grid[i, : len(c.grid)] = np.asarray(c.grid)
            curve[i, : len(c.curve)] = np.asarray(c.curve)
        v = f.createVariable("grid", np.float64, ("n_curves", "grid_max_len"))
        v[:] = grid
        v = f.createVariable("curve", np.float64, ("n_curves", "grid_max_len"))
        v[:] = curve
    finally:
        f.close()
    return path


def read_xy_curves_nc(path):
    f = netcdf_file(path, "r", mmap=False)
    try:
        n_grid = np.array(f.variables["n_grid"][:], dtype=np.int64)
        grid = np.array(f.variables["grid"][:], dtype=np.float64)
        curve = np.array(f.variables["curve"][:], dtype=np.float64)
        cn = f.variables["curve_name"][:]
        gn = f.variables["grid_name"][:]
        out = []
        for i in range(len(n_grid)):
            out.append(XYCurve(
                grid_name=b"".join(gn[i]).decode().strip(),
                curve_name=b"".join(cn[i]).decode().strip(),
                grid=grid[i, : n_grid[i]],
                curve=curve[i, : n_grid[i]],
            ))
        return out
    finally:
        f.close()
