"""Ray initialization from a namelist file of launch points and directions
(``rays_tpu.rayinit.file_input``; reference file_input_ray_init_m.f90):
reads ``ray_init_<run_label>.in`` with its /file_input_ray_init_list/
(n_rays_in, rvec_in, rindex_vec_in, ray_pwr_wt_in), then re-solves the
dispersion relation along each given direction as the one-ray initializer
does (file_input_ray_init_m.f90:62-120).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rays_tpu_torch.rayinit.one_ray import solve_along_directions


@dataclasses.dataclass(frozen=True)
class FileInputInit:
    filename: str = ""   # defaults to ray_init_<run_label>.in


def _as_matrix(val, n):
    """Namelist array (flat list or {index: value} dict, Fortran
    column-major 3 x n) -> (n, 3)."""
    flat = np.zeros(3 * n)
    if isinstance(val, dict):
        for i, v in val.items():
            flat[i - 1] = v
    else:
        arr = np.asarray(val, dtype=float).ravel()
        flat[: len(arr)] = arr
    return flat[: 3 * n].reshape(n, 3)


def file_input_ray_init(cfg, params, ri: FileInputInit):
    """Returns (rvec0 (B,3), rindex_vec0 (B,3), pwr_wt (B,)), B the number
    of rays that survive, in the file's order."""
    from rays_tpu_torch.config.namelist import read_namelist_file

    fname = ri.filename or f"ray_init_{cfg.run_label}.in"
    nml = read_namelist_file(fname)
    g = nml["file_input_ray_init_list"]
    n = int(g["n_rays_in"])
    rvecs = _as_matrix(g.get("rvec_in", []), n)
    ndirs = _as_matrix(g.get("rindex_vec_in", []), n)
    pwr_in = np.ones(n)
    if "ray_pwr_wt_in" in g:
        w = g["ray_pwr_wt_in"]
        if isinstance(w, dict):
            for i, v in w.items():
                pwr_in[i - 1] = v
        else:
            arr = np.asarray(w, dtype=float).ravel()
            pwr_in[: len(arr)] = arr

    k0 = params.rf.k0
    rvec = torch.as_tensor(rvecs).to(k0)
    rindex, err, propagating = solve_along_directions(
        cfg, params, rvec, torch.as_tensor(ndirs).to(k0))
    valid = (err == 0) & propagating
    nray = int(valid.sum())
    if nray == 0:
        raise RuntimeError("file_input_ray_init: no successful ray "
                           "initializations")
    # weights kept from the file, normalized by the surviving count (the
    # reference divides the temporary weights by nray)
    pwr = torch.as_tensor(pwr_in).to(k0)[valid] / nray
    return rvec[valid], rindex[valid], pwr
