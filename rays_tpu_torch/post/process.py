"""Post-processing orchestration (``rays_tpu.post.process``).

The functional analog of reference RAYS_project/post_process_lib/
post_processing_m.f90 + the standalone post_process_RAYS executable: rebuild
the run configuration from rays.in, load ray results (from memory, the
RAYS_P in-process mode, or back from run_results.<label>.nc, the decoupled
file-based mode, post_processing_m.f90:132-187), select the geometry
processor from post_process_rays.in, and run deposition profiles.

Every processor computes on the device its ``results`` and ``params`` live
on.  The standalone post-processor puts them on ``--device`` (default
cuda) and, like the run CLI, fails before it opens a file where that
device is missing:

    python -m rays_tpu_torch.post.process rays.in --pp post_process_rays.in \\
        [--results FILE] [--device cuda]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rays_tpu_torch.tracing.stop import flag_code
from rays_tpu_torch.tracing.trace import RayResults


def _tensor(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float64)).to(device)


def _codes(strings, device):
    return torch.tensor([flag_code(s) for s in strings], dtype=torch.int32, device=device)


def load_results_nc(path, device="cpu"):
    """run_results.<label>.nc -> RayResults on ``device`` (the reference's
    read_results_instance_NC, ray_results_m.f90:253)."""
    from rays_tpu_torch.results.netcdf import read_results_nc

    d = read_results_nc(path)
    # restore the stop taxonomy from the stored flag strings (the reference
    # round-trips ray_stop_flag through its files, ray_results_m.f90:56,
    # 253-363) so file-based post-processing keyed on stop reason sees the
    # same codes as in-process
    if "ray_stop_flag" in d:
        raw = np.asarray(d["ray_stop_flag"])  # (nray, 60) of S1
        stop_flag = _codes([b"".join(row).decode("ascii", "replace") for row in raw], device)
    else:
        stop_flag = torch.zeros(d["npoints"].shape, dtype=torch.int32, device=device)
    f64 = lambda name: _tensor(d[name], device)   # noqa: E731
    return RayResults(
        ray_vec=f64("ray_vec"),
        residual=f64("residual"),
        npoints=torch.as_tensor(np.array(d["npoints"], dtype=np.int32)).to(device),
        stop_flag=stop_flag,
        initial_ray_power=f64("initial_ray_power"),
        end_residuals=f64("end_residuals"),
        max_residuals=f64("max_residuals"),
        end_ray_parameter=f64("end_ray_parameter"),
        start_ray_vec=f64("start_ray_vec"),
        end_ray_vec=f64("end_ray_vec"),
    )


def load_results_ld(path, device="cpu"):
    """run_results.<label> (list-directed ASCII) -> RayResults on
    ``device`` (the reference's read_results_LD, ray_results_m.f90:424)."""
    from rays_tpu_torch.results.ascii import read_results_ld

    d = read_results_ld(path)
    f64 = lambda name: _tensor(d[name], device)   # noqa: E731
    return RayResults(
        ray_vec=f64("ray_vec"),
        residual=f64("residual"),
        npoints=torch.as_tensor(np.asarray(d["npoints"], np.int32)).to(device),
        stop_flag=_codes(d["ray_stop_flag"], device),
        initial_ray_power=f64("initial_ray_power"),
        end_residuals=f64("end_residuals"),
        max_residuals=f64("max_residuals"),
        end_ray_parameter=f64("end_ray_parameter"),
        start_ray_vec=f64("start_ray_vec"),
        end_ray_vec=f64("end_ray_vec"),
    )


def load_results_ascii(run_label, directory=".", device="cpu"):
    """Legacy per-step stream (ray_out.<label> + ray_list.<label>) ->
    RayResults on ``device`` (the reference's ASCII input mode,
    post_processing_m.f90:292-361).  Per-step residuals are not in this
    stream; summary fields are reconstructed from the trajectory."""
    from rays_tpu_torch.results.ascii import read_ray_data

    d = read_ray_data(run_label, directory)
    v = np.asarray(d["v_vec"], np.float64)
    npts = np.asarray(d["npoints"], np.int32)
    nray = v.shape[0]
    end_vec = v[np.arange(nray), np.maximum(npts - 1, 0)]
    end_res = _tensor(d["end_residuals"], device)
    return RayResults(
        ray_vec=_tensor(v, device),
        residual=torch.zeros(v.shape[:2], dtype=torch.float64, device=device),
        npoints=torch.as_tensor(npts).to(device),
        stop_flag=_codes(d["ray_stop_flag"], device),
        initial_ray_power=torch.full((nray,), 1.0 / max(nray, 1), dtype=torch.float64,
                                     device=device),
        end_residuals=end_res,
        max_residuals=end_res,
        end_ray_parameter=_tensor(end_vec[:, 6], device),
        start_ray_vec=_tensor(v[:, 0, :], device),
        end_ray_vec=_tensor(end_vec, device),
    )


# namelist group feeding each geometry processor (each *_processor_m.f90
# reads its own group from post_process_rays.in)
PROCESSOR_GROUP = {
    "slab": "slab_processor_list",
    "solovev": "solovev_processor_list",
    "axisym_toroid": "axisym_toroid_processor_list",
    "multiple_mirror": "mirror_processor_list",
}


def post_process(cfg, params, results, rindex_vec0=None, pp_config=None):
    """Dispatch the geometry processor (post_processing_m.f90:194-226).

    ``pp_config['processor_knobs']`` carries the processor-specific
    namelist group (slab_processor_m.f90:56-59,
    axisym_toroid_processor_m.f90:59-64, mirror_processor_m.f90:95-101,
    solovev_processor_m.f90:32), read by ``main`` from
    post_process_rays.in; its calculate_dep_profiles /
    write_dep_profiles / calculate_ray_diag gates are honored here."""
    pp_config = pp_config or {}
    processor = pp_config.get("processor", cfg.equilib_model)
    knobs = {str(a).lower(): b
             for a, b in (pp_config.get("processor_knobs") or {}).items()}

    out = {}
    if processor in ("slab",):
        from rays_tpu_torch.post import slab_processor

        if rindex_vec0 is None:
            rindex_vec0 = results.start_ray_vec[:, 3:6] / params.rf.k0
        out.update(slab_processor.process(cfg, params, results, rindex_vec0,
                                          knobs=knobs))
    elif processor in ("solovev", "axisym_toroid"):
        from rays_tpu_torch.post import toroid_processor

        out.update(toroid_processor.process(cfg, params, results, knobs=knobs))
    elif processor in ("multiple_mirror",):
        from rays_tpu_torch.post import mirror_processor

        out.update(mirror_processor.process(
            cfg, params, results,
            z_reference=pp_config.get("z_reference"),
            do_ox_analysis=bool(pp_config.get("do_ox_conv_analysis", True)),
            knobs=knobs))
    else:
        raise ValueError(f"post_process: unknown processor {processor}")

    # per-ray detailed diagnostics netCDF (the reference's
    # calculate_ray_diag flag, slab_processor_m.f90:109 et al.)
    if bool(knobs.get("calculate_ray_diag",
                      pp_config.get("calculate_ray_diag", False))) \
            and "ray_diags_nc" not in out:
        from rays_tpu_torch.post import ray_diags

        out["ray_diags_nc"] = ray_diags.write_ray_diagnostics_nc(
            cfg, params, results)

    # deposition profiles when a damping model ran (namelist gate
    # calculate_dep_profiles, reference default .true.)
    if cfg.damping_slot >= 0 and bool(
            knobs.get("calculate_dep_profiles", True)):
        from rays_tpu_torch.post import deposition

        n_bins = int(pp_config.get("n_bins", 50))
        for name in deposition.profile_names_for_geometry(
                cfg.equilib_model, cfg, params):
            if name == "Ptotal_x":
                xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
            else:
                xmin, xmax = 0.0, 1.0
            out[name] = deposition.calculate_deposition_profile(
                cfg, params, results, name, n_bins=n_bins, xmin=xmin, xmax=xmax)
        # file outputs: netCDF on write_dep_profiles (reference default
        # .true.; the RAYS_P product consumed by P_profiles/plot_profiles),
        # LD on the reference's namelist flag
        # (deposition_profiles_m.f90:83,296)
        if bool(knobs.get("write_dep_profiles", True)):
            out["deposition_nc"] = deposition.write_deposition_profiles_nc(
                cfg, params, results, n_bins=n_bins)
        if pp_config.get("write_results_list_directed"):
            out["deposition_ld"] = deposition.write_deposition_profiles_ld(
                cfg, params, results, n_bins=n_bins)
    return out


def main(argv=None):
    import argparse

    from rays_tpu_torch.config import schema
    from rays_tpu_torch.config.namelist import read_namelist_file
    from rays_tpu_torch.core.types import tree_to

    ap = argparse.ArgumentParser(
        description="standalone post-processor (post_process_RAYS analog)")
    ap.add_argument("rays_in", help="the run's rays.in file")
    ap.add_argument("--pp", default="post_process_rays.in",
                    help="post-process config namelist")
    ap.add_argument("--results", default=None,
                    help="run_results file (default per input mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to post-process on (default cuda; give "
                         "--device cpu for the CPU)")
    args = ap.parse_args(argv)

    # a device that is not there fails before any file is opened
    torch.zeros((), device=args.device)
    cfg, params = schema.from_file(args.rays_in)
    params = tree_to(params, args.device)

    pp_cfg = {}
    if os.path.exists(args.pp):
        nml = read_namelist_file(args.pp)
        pp_cfg.update(nml.get("post_process_list", {}))
        pp_cfg.update(nml.get("deposition_profiles_list", {}))
        # the processor-specific namelist group (each *_processor_m.f90
        # reads its own group); file-driven runs get the reference's
        # .true. defaults for the calculate/write gates
        processor = str(pp_cfg.get("processor", cfg.equilib_model))
        group = PROCESSOR_GROUP.get(processor)
        knobs = {str(a).lower(): b
                 for a, b in nml.get(group, {}).items()} if group else {}
        knobs.setdefault("calculate_dep_profiles", True)
        knobs.setdefault("write_dep_profiles", True)
        knobs.setdefault("calculate_ray_diag", True)
        pp_cfg["processor_knobs"] = knobs
    # ray_data_input_mode = NC | LD | ASCII, filenames constructed from the
    # run label exactly as the reference (post_processing_m.f90:159-187)
    mode = str(pp_cfg.get("ray_data_input_mode", "NC")).strip().upper()
    if mode == "NC":
        results = load_results_nc(
            args.results or f"run_results.{cfg.run_label}.nc", args.device)
    elif mode == "LD":
        results = load_results_ld(
            args.results or f"run_results.{cfg.run_label}", args.device)
    elif mode == "ASCII":
        results = load_results_ascii(cfg.run_label, device=args.device)
    else:
        raise ValueError(
            f"post_process: unimplemented ray_data_input_mode = {mode}")
    out = post_process(cfg, params, results, pp_config=pp_cfg)
    for k, v in out.items():
        print(f"{k}: {v if isinstance(v, str) else type(v).__name__}")
    print(f"rays: {results.npoints.shape[0]}  device: {args.device}")


if __name__ == "__main__":
    main()
