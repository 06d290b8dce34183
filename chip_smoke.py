#!/usr/bin/env python3
"""Chip smoke test of rays_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Drives the port's main path, the slab ECH 90 GHz RK4 case, on the card:
builds the slab RK4 CUDA kernel from rays_tpu_torch/csrc, holds it to its
plain PyTorch twin on the card, times both at 32,768 rays x 500 steps in
float32 and float64, and runs the CLI end to end.  Each phase prints one
line; the first failure raises and the script exits non-zero.

    python3 chip_smoke.py          # from the root of a checkout

The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

N_RAYS = 32768          # the batch of bench.py (rays_tpu), 500 steps each
TRAJ_RTOL = 1e-7        # f64 kernel vs plain twin, of trajectory scale
RESID_MAX_F64 = 1e-6
F32_RTOL = 5e-4         # f32 kernel vs f64 plain (tests/test_fused.py bounds)
RESID_MAX_F32 = 5e-3


def fail(msg):
    raise RuntimeError(msg)


def require(cond, msg):
    if not cond:
        fail(msg)


def scaled_err(got, ref, per_ray_axis):
    """max over rays of |got - ref| / scale, per slot group: positions
    (slots 0-2), wavevector (3-5) and ray parameter (6), each scaled by the
    reference's max magnitude over ``per_ray_axis`` (the trajectory, or
    the endpoint alone) - the measure of tests/test_parity.py."""
    worst = 0.0
    for sl in (slice(0, 3), slice(3, 6), slice(6, 7)):
        r = ref[..., sl].double()
        d = (got[..., sl].double() - r).abs()
        scale = r.abs().amax(dim=per_ray_axis).clamp_min(1e-12)
        worst = max(worst, float((d.amax(dim=per_ray_axis) / scale).max()))
    return worst


def timed(fn):
    """Milliseconds of one call by CUDA events, after synchronizing."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def main():
    # phase 1: the device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rays_tpu_torch import examples, run as runner
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.results.netcdf import read_results_nc
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.tracing.stop import StopCode, flag_string
    from rays_tpu_torch.tracing.trace import trace_rays

    # phase 2: build the kernel library from the sources in the checkout
    t0 = time.perf_counter()
    _, log = fused_slab.load_library()
    build_s = time.perf_counter() - t0
    # -Xptxas -v: registers and spill stores of each instantiation
    ptxas = [f"{'f64' if m[1] == 'd' else 'f32'} S={m[2]} {m[4]} regs {m[3]} B spilled"
             for m in re.finditer(r"slab_rk4_kernelI([fd])Li(\d)E.*?(\d+) bytes spill "
                                  r"stores.*?Used (\d+) registers", log, re.S)]
    require(ptxas, f"no sm_90a ptxas report in the build log:\n{log}")
    print(f"phase 2 build: slab_rk4 for sm_90a in {build_s:.1f} s; ptxas: "
          + ", ".join(ptxas))

    # phase 3: the example, 3 rays x 500 steps, trajectories on
    dev = torch.device("cuda", 0)
    f64, f32 = torch.float64, torch.float32
    cfg, params, v0, st0, pwr = examples.setup_example(
        examples.SLAB_ECH_90GHZ, device=dev, dtype=f64)
    require(cfg.save_trajectory and fused_slab.supported(cfg),
            "the example must ride the kernel with save_trajectory on")
    before = fused_slab.LAUNCHES
    ex_k = trace_rays(cfg, params, v0, st0, pwr)
    torch.cuda.synchronize()
    require(fused_slab.LAUNCHES > before, "trace_rays did not launch the kernel")
    ex_p = fused_slab.trace_batch_fused_reference(cfg, params, v0, st0, pwr)
    require(torch.equal(ex_k.npoints, ex_p.npoints), "example npoints differ")
    require(torch.equal(ex_k.stop_flag, ex_p.stop_flag), "example stop flags differ")
    npts = ex_k.npoints.tolist()
    flags = [flag_string(c) for c in ex_k.stop_flag.tolist()]
    require(npts == [cfg.nstep_max + 1] * 3 and
            all(c == StopCode.NSTEP_MAX for c in ex_k.stop_flag.tolist()),
            f"example expected 501 points and NSTEP_MAX, got {npts} {flags}")
    traj_err = scaled_err(ex_k.ray_vec, ex_p.ray_vec, per_ray_axis=1)
    max_res = float(ex_k.max_residuals.max())
    require(traj_err <= TRAJ_RTOL, f"example trajectory error {traj_err:.3e} > {TRAJ_RTOL}")
    require(max_res < RESID_MAX_F64, f"example max residual {max_res:.3e}")
    print(f"phase 3 example f64: npoints {npts} flags {flags} trajectory err "
          f"{traj_err:.3e} of scale (bound {TRAJ_RTOL}) max residual {max_res:.3e}")

    # phase 4: the main path at 32,768 rays x 500 steps, summaries only
    cfg_b = dataclasses.replace(cfg, save_trajectory=False)
    vb, stb, wb = examples.replicate_rays(v0, st0, pwr, N_RAYS)
    fused_slab.LAUNCHES = 0
    big64 = trace_rays(cfg_b, params, vb, stb, wb)          # the main path
    torch.cuda.synchronize()
    main_launches = fused_slab.LAUNCHES
    require(main_launches >= 1, "the main path did not launch the kernel")
    plain64 = fused_slab.trace_batch_fused_reference(cfg_b, params, vb, stb, wb)
    require(torch.equal(big64.npoints, plain64.npoints), "f64 npoints differ")
    require(torch.equal(big64.stop_flag, plain64.stop_flag), "f64 stop flags differ")
    err64 = scaled_err(big64.end_ray_vec, plain64.end_ray_vec, per_ray_axis=-1)
    abs64 = float((big64.end_ray_vec - plain64.end_ray_vec).abs().max())
    require(err64 <= TRAJ_RTOL, f"f64 endpoint error {err64:.3e} > {TRAJ_RTOL}")
    params32 = tree_to(params, dtype=f32)
    vb32, wb32 = vb.to(f32), wb.to(f32)
    big32 = fused_slab.trace_batch_fused(cfg_b, params32, vb32, stb, wb32)
    torch.cuda.synchronize()
    require(torch.equal(big32.npoints, plain64.npoints), "f32 npoints differ from f64")
    require(torch.equal(big32.stop_flag, plain64.stop_flag), "f32 flags differ from f64")
    err32 = scaled_err(big32.end_ray_vec, plain64.end_ray_vec, per_ray_axis=-1)
    res32 = float(big32.max_residuals.max())
    require(err32 <= F32_RTOL, f"f32 endpoint error {err32:.3e} > {F32_RTOL}")
    require(res32 < RESID_MAX_F32, f"f32 max residual {res32:.3e}")
    print(f"phase 4 {N_RAYS} rays x {cfg.nstep_max} steps: main-path launches "
          f"{main_launches}; f64 kernel vs plain endpoint err {err64:.3e} of scale "
          f"(max abs {abs64:.3e}); f32 kernel vs f64 plain {err32:.3e} of scale, "
          f"max residual {res32:.3e}; npoints {sorted(set(big64.npoints.tolist()))}")

    # phase 5: timing, plain / kernel / kernel / plain, per dtype
    times = {}
    for dt, p_, v_, w_ in ((f32, params32, vb32, wb32), (f64, params, vb, wb)):
        short = dataclasses.replace(cfg_b, nstep_max=5)
        fused_slab.trace_batch_fused_reference(short, p_, v_, stb, w_)   # warm-up
        fused_slab.trace_batch_fused(cfg_b, p_, v_, stb, w_)              # warm-up
        plain = lambda: fused_slab.trace_batch_fused_reference(cfg_b, p_, v_, stb, w_)
        kern = lambda: fused_slab.trace_batch_fused(cfg_b, p_, v_, stb, w_)
        runs = [timed(f)[0] for f in (plain, kern, kern, plain)]
        t_plain, t_kern = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        times[dt] = (t_kern, t_plain)
        name = "f32" if dt == f32 else "f64"
        print(f"phase 5 {name} {N_RAYS} rays x {cfg.nstep_max} steps: kernel "
              f"{t_kern:.3f} ms ({N_RAYS / t_kern * 1e3:.0f} rays/s; runs "
              f"{runs[1]:.3f}, {runs[2]:.3f}), plain {t_plain:.1f} ms "
              f"({N_RAYS / t_plain * 1e3:.0f} rays/s; runs {runs[0]:.1f}, "
              f"{runs[3]:.1f}), speedup {t_plain / t_kern:.1f}x on {card}")

    # phase 6: the CLI end to end, in a temporary directory
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slab_ECH_90GHz_case_1.in")
        with open(path, "w") as f:
            f.write(examples.SLAB_ECH_90GHZ)
        os.chdir(tmp)
        try:
            before = fused_slab.LAUNCHES
            runner.main([path, "--netcdf", "--device", "cuda"])
            require(fused_slab.LAUNCHES > before, "the CLI did not launch the kernel")
            nc = read_results_nc(os.path.join(tmp, f"run_results.{cfg.run_label}.nc"))
        finally:
            os.chdir(cwd)
    nc_flags = [row.tobytes().decode().strip() for row in nc["ray_stop_flag"]]
    require(nc["npoints"].tolist() == npts, f"CLI npoints {nc['npoints']} != {npts}")
    require(nc_flags == [f.strip() for f in flags], f"CLI flags {nc_flags} != {flags}")
    require(nc["ray_vec"].shape == (3, cfg.nstep_max + 1, 7), "CLI ray_vec shape")
    print(f"phase 6 CLI: run_results.{cfg.run_label}.nc read back, npoints "
          f"{nc['npoints'].tolist()} flags {nc_flags}")

    t_kern, t_plain = times[f64]
    print(json.dumps({"kernels": [{
        "name": "slab_rk4",
        "route": "cuda",
        "source": "rays_tpu_torch/csrc/slab_rk4.cu",
        "replaces": "rays_tpu/tracing/fused_slab.py:348",
        "launches": main_launches,
        "max_abs_err": abs64,
        "ms": t_kern,
        "plain_ms": t_plain,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
