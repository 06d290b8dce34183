"""Run orchestration: initialize -> trace -> results (``rays_tpu.run``).

The analog of the reference's RAYS main program (RAYS_code/RAYS.f90:
initialize / trace_rays / finalize_run).  ``setup`` resolves config,
params and initial rays; ``run`` traces; ``main`` adds file output.

The CLI runs on ``--device cuda`` unless ``--device cpu`` is given, and
never moves to the CPU by itself.  Not ported yet: the run log
(``make_diagnostics``) and the list-directed and formatted writers
(ROADMAP A17); the CLI writes no log file.
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
    raise NotImplementedError(
        f"ray_init_model {cfg.ray_init_model!r} is not ported yet")


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


def ray_trace_times(results, wall):
    """Per-ray trace-time attribution (reference ray_trace_time(iray),
    ray_tracing.f90:74-75,254): the batch wall time attributed by each
    ray's share of accepted steps."""
    npts = results.npoints.to("cpu", torch.float64)
    return wall * npts / max(float(npts.sum()), 1.0)


def run(path, device="cuda", dtype=torch.float64):
    """Full run from a rays.in-style file.  Returns (cfg, RayResults on the
    CPU, wall_time_seconds); the wall time covers the trace only."""
    cfg, params, v0, status0, pwr = setup(path, device, dtype)
    if cfg.write_formatted_ray_files:
        raise NotImplementedError(
            "write_formatted_ray_files is not ported yet (ROADMAP A17)")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = trace_mod.trace_rays(cfg, params, v0, status0, pwr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return cfg, tree_to(results, "cpu"), wall


def finalize_outputs(cfg, results, wall, force_netcdf=False):
    """Write the results files the ``&ray_results_list`` namelist asks for
    (reference finalize_run.f90:21-28); ``force_netcdf`` is the CLI
    override.  netCDF only: the list-directed writer is ROADMAP A17.
    Returns the written paths."""
    if cfg.write_results_list_directed:
        raise NotImplementedError(
            "write_results_list_directed is not ported yet (ROADMAP A17)")
    written = []
    if cfg.write_results_netcdf or force_netcdf:
        from rays_tpu_torch.results.netcdf import write_results_nc

        written.append(write_results_nc(
            cfg, results, total_trace_time=wall,
            ray_trace_time=ray_trace_times(results, wall)))
    return written


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="rays_tpu_torch ray-tracing run")
    ap.add_argument("input", help="namelist input file (rays.in format)")
    ap.add_argument("--netcdf", action="store_true",
                    help="write run_results.<run_label>.nc even when the "
                         "input's &ray_results_list does not ask for it")
    ap.add_argument("--device", default="cuda",
                    help="torch device to trace on (default cuda; give "
                         "--device cpu for the plain PyTorch tracer)")
    args = ap.parse_args(argv)

    cfg, results, wall = run(args.input, device=args.device)
    print(f"run_label: {cfg.run_label}")
    print(f"rays: {results.npoints.shape[0]}  wall: {wall:.3f}s  device: {args.device}")
    print(f"npoints: {results.npoints.tolist()}")
    print(f"max residuals: {results.max_residuals.numpy()}")
    for fn in finalize_outputs(cfg, results, wall, force_netcdf=args.netcdf):
        print(f"wrote {fn}")


if __name__ == "__main__":
    main()
