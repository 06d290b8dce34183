"""Run orchestration: initialize -> trace -> results (``rays_tpu.run``).

The analog of the reference's RAYS main program (RAYS_code/RAYS.f90:
initialize / trace_rays / finalize_run).  ``setup`` resolves config,
params and initial rays; ``run`` traces; ``main`` adds file output.

The CLI runs on ``--device cuda`` unless ``--device cpu`` is given, and
never moves to the CPU by itself.  It writes the run log
``log.RAYS.<run_label>`` unless ``--no-log`` is given, and the netCDF,
list-directed and formatted ray files the namelist asks for.
"""

from __future__ import annotations

import time

import torch

from rays_tpu_torch.config import schema
from rays_tpu_torch.core.types import tree_to
from rays_tpu_torch.rayinit import vector as init_vector
from rays_tpu_torch.tracing import trace as trace_mod


def init_rays(cfg, params):
    """Dispatch ray initialization (reference ray_init_m.f90:101-124)."""
    if cfg.ray_init_model == "simple_slab":
        from rays_tpu_torch.rayinit.slab import simple_slab_ray_init

        return simple_slab_ray_init(cfg, params, cfg.rayinit_static)
    if cfg.ray_init_model == "solovev_ray_init_nphi_ntheta":
        from rays_tpu_torch.rayinit.solovev import solovev_ray_init_nphi_ntheta

        return solovev_ray_init_nphi_ntheta(cfg, params, cfg.rayinit_static)
    if cfg.ray_init_model == "axisym_toroid_ray_init_R_Z_nphi_ntheta":
        from rays_tpu_torch.rayinit.axisym_toroid import axisym_toroid_ray_init

        return axisym_toroid_ray_init(cfg, params, cfg.rayinit_static)
    if cfg.ray_init_model == "one_ray_init_XYZ_k_direction":
        from rays_tpu_torch.rayinit.one_ray import one_ray_init_xyz_k_direction

        return one_ray_init_xyz_k_direction(cfg, params, cfg.rayinit_static)
    if cfg.ray_init_model == "file_input_ray_init":
        from rays_tpu_torch.rayinit.file_input import file_input_ray_init

        return file_input_ray_init(cfg, params, cfg.rayinit_static)
    raise NotImplementedError(f"ray_init_model {cfg.ray_init_model}")


def setup_from(cfg, params, device, dtype):
    """(cfg, CPU float64 params) -> (cfg, params, v0, status0, pwr_wt) on
    ``device`` in ``dtype``: ray init in float64, then cast and moved."""
    rvec0, rindex0, pwr = init_rays(cfg, params)
    v0 = init_vector.initial_ode_vectors(cfg, params, rvec0, rindex0)
    status0 = torch.zeros((v0.shape[0],), dtype=torch.int32, device=device)
    return (cfg, tree_to(params, device, dtype), v0.to(device=device, dtype=dtype),
            status0, pwr.to(device=device, dtype=dtype))


def setup(path, device="cuda", dtype=torch.float64):
    """Namelist file -> (cfg, params, v0, status0, pwr_wt)."""
    cfg, params = schema.from_file(path)
    return setup_from(cfg, params, device, dtype)


def make_diagnostics(path):
    """Run log from the input file's diagnostics_list (reference
    diagnostics_m.f90:48-103): opens the message file, echoes every parsed
    namelist group for config provenance, returns the Diagnostics handle.
    Call ``finalize()`` on it to produce log.RAYS.<run_label>
    (finalize_run.f90:50)."""
    from rays_tpu_torch.config.namelist import read_namelist_file
    from rays_tpu_torch.utils.diagnostics import Diagnostics

    nml = read_namelist_file(path)
    d = nml.get("diagnostics_list", {})

    def _get(grp, key, default):
        for k, v in grp.items():
            if k.lower() == key:
                return v
        return default

    diag = Diagnostics(
        run_label=str(_get(d, "run_label", "run")),
        verbosity=int(_get(d, "verbosity", 0)),
        messages_to_stdout=bool(_get(d, "messages_to_stdout", False)),
    )
    diag.echo_namelists(nml)
    return diag


def ray_trace_times(results, wall):
    """Per-ray trace-time attribution (reference ray_trace_time(iray),
    ray_tracing.f90:74-75,254): the batch wall time attributed by each
    ray's share of accepted steps."""
    npts = results.npoints.to("cpu", torch.float64)
    return wall * npts / max(float(npts.sum()), 1.0)


def run(path, device="cuda", dtype=torch.float64, diag=None):
    """Full run from a rays.in-style file.  Returns (cfg, RayResults on the
    CPU, wall_time_seconds); the wall time covers the trace only."""
    cfg, params, v0, status0, pwr = setup(path, device, dtype)
    if diag is not None:
        diag.message("rays_tpu_torch run", cfg.run_label, threshold=0)
        diag.message("number of rays", int(v0.shape[0]), threshold=0)
        diag.message("nv", cfg.nv, threshold=0)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = trace_mod.trace_rays(cfg, params, v0, status0, pwr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    results = tree_to(results, "cpu")
    if diag is not None:
        from rays_tpu_torch.tracing.stop import flag_string

        diag.message("Wall time ray tracing (s)", round(wall, 4), threshold=0)
        npts = results.npoints.tolist()
        flags = results.stop_flag.tolist()
        times = ray_trace_times(results, wall).tolist()
        for i in range(len(npts)):
            diag.message(f"ray {i + 1}: npoints", npts[i], threshold=1)
            diag.message(f"ray {i + 1}: stop flag", flag_string(flags[i]), threshold=1)
            diag.message(f"ray {i + 1}: trace time (s)", round(times[i], 6),
                         threshold=1)
        diag.message("max dispersion residual", float(results.max_residuals.max()),
                     threshold=0)
    if cfg.write_formatted_ray_files:
        if not cfg.save_trajectory:
            msg = ("write_formatted_ray_files=True requires "
                   "save_trajectory=True; skipping formatted ray files")
            if diag is not None:
                diag.message("WARNING", msg, threshold=0)
            else:
                import warnings

                warnings.warn(msg, stacklevel=2)
        else:
            from rays_tpu_torch.results.ascii import write_formatted_ray_files

            out_p, list_p = write_formatted_ray_files(
                cfg, results, ds=float(params.ode.ds))
            if diag is not None:
                diag.message("wrote formatted ray files", f"{out_p} {list_p}",
                             threshold=0)
    return cfg, results, wall


def finalize_outputs(cfg, results, wall, diag=None, force_netcdf=False):
    """Write the results files the ``&ray_results_list`` namelist asks for
    (reference ray_results_m.f90:98-101 read; finalize_run.f90:21-28 honors
    ``write_results_list_directed`` -> run_results.<label> and
    ``write_results_netCDF`` -> run_results.<label>.nc).  ``force_netcdf``
    is the CLI override on top of the namelist.  Returns the written paths."""
    written = []
    times = ray_trace_times(results, wall)
    if cfg.write_results_list_directed:
        from rays_tpu_torch.results.ascii import write_results_ld

        written.append(write_results_ld(cfg, results, total_trace_time=wall,
                                        ray_trace_time=times))
    if cfg.write_results_netcdf or force_netcdf:
        from rays_tpu_torch.results.netcdf import write_results_nc

        written.append(write_results_nc(cfg, results, total_trace_time=wall,
                                        ray_trace_time=times))
    if diag is not None:
        for fn in written:
            diag.message("wrote results", fn, threshold=0)
    return written


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="rays_tpu_torch ray-tracing run")
    ap.add_argument("input", help="namelist input file (rays.in format)")
    ap.add_argument("--netcdf", action="store_true",
                    help="write run_results.<run_label>.nc even when the "
                         "input's &ray_results_list does not ask for it")
    ap.add_argument("--no-log", action="store_true",
                    help="skip writing log.RAYS.<run_label>")
    ap.add_argument("--device", default="cuda",
                    help="torch device to trace on (default cuda; give "
                         "--device cpu for the plain PyTorch tracer)")
    args = ap.parse_args(argv)

    # a device that is not there fails before any file is opened
    torch.zeros((), device=args.device)
    diag = None if args.no_log else make_diagnostics(args.input)
    cfg, results, wall = run(args.input, device=args.device, diag=diag)
    print(f"run_label: {cfg.run_label}")
    print(f"rays: {results.npoints.shape[0]}  wall: {wall:.3f}s  device: {args.device}")
    print(f"npoints: {results.npoints.tolist()}")
    print(f"max residuals: {results.max_residuals.numpy()}")
    for fn in finalize_outputs(cfg, results, wall, diag=diag, force_netcdf=args.netcdf):
        print(f"wrote {fn}")
    if diag is not None:
        print(f"wrote {diag.finalize()}")


if __name__ == "__main__":
    main()
