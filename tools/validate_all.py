"""End-to-end validation sweep of rays_tpu_torch across geometries and
physics options, the counterpart of scripts/validate_all.py.

    python tools/validate_all.py [stage ...] [--device cpu]

Stages: slab, damped, solovev, axisym, mirror (default: all), on the card
unless --device cpu is given.  Each stage traces an example through
``trace_rays`` (the slab RK4 kernel on the card for slab and damped,
plain PyTorch for the others), prints its wall time, the route, the
kernel launches and PASS or FAIL against the JAX script's bars, then a
summary and, last, one JSON line of every stage.  The JAX script's mpex
stage reads the reference's MPEX example directory; the mirror stage
here runs the port's own four-coil mirror (``examples.MIRROR_ECH_56GHZ``,
its field file written by ``examples.write_mirror_example``) instead.
Exits 1 if a stage fails.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rays_tpu_torch import examples, run as runner  # noqa: E402
from rays_tpu_torch.tracing import fused_slab  # noqa: E402
from rays_tpu_torch.tracing.trace import route, trace_rays  # noqa: E402


def _trace(case):
    """Trace (cfg, params, v0, st, pwr): (cfg, params, results, a report
    of the run)."""
    cfg, params, v0, st, pwr = case
    dev = v0.device
    fused_slab.LAUNCHES = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = trace_rays(cfg, params, v0, st, pwr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    report = {"wall_s": wall, "route": route(cfg, False, dev), "launches": fused_slab.LAUNCHES,
              "nray": int(v0.shape[0]), "npoints": res.npoints.tolist(),
              "max_residual": float(res.max_residuals.max()),
              "flags": sorted(set(res.stop_flag.tolist()))}
    print(f"  [{wall:7.2f}s] nray={report['nray']} nv={cfg.nv} route={report['route']} "
          f"launches={report['launches']} npoints={report['npoints']} "
          f"maxres={report['max_residual']:.3e} flags={report['flags']}", flush=True)
    return cfg, params, res, report


def stage_slab(device="cuda"):
    print("== slab (RK4, time param) ==", flush=True)
    cfg, _, res, rep = _trace(examples.setup_example(examples.SLAB_ECH_90GHZ, device=device))
    rep["ok"] = (all(n == cfg.nstep_max + 1 for n in rep["npoints"])
                 and rep["max_residual"] < 1e-6)
    return rep


def stage_damped(device="cuda"):
    print("== slab damped (fund ECH, multi-spec, deposition) ==", flush=True)
    from rays_tpu_torch.post import deposition

    cfg, params, res, rep = _trace(examples.setup_example(examples.SLAB_ECH_DAMPED, device=device))
    absorbed = res.end_ray_vec[:, 7].double()
    print(f"  total absorption per ray: {absorbed.tolist()}", flush=True)
    prof = deposition.calculate_deposition_profile(
        cfg, params, res, "Ptotal_x", n_bins=40,
        xmin=float(params.eq.xmin), xmax=float(params.eq.xmax)).profile.double()
    total_dep = float(prof.sum())
    expected = float((res.initial_ray_power.double() * absorbed).sum())
    print(f"  deposition sum={total_dep:.6f} expected={expected:.6f} "
          f"peak bin={int(prof.argmax())}", flush=True)
    rep.update(absorbed=absorbed.tolist(), deposition_sum=total_dep, expected=expected)
    rep["ok"] = (float(absorbed.max()) > 0.5
                 and abs(total_dep - expected) < 1e-6 * max(1.0, expected))
    return rep


def stage_solovev(device="cuda"):
    print("== solovev (SG adaptive, arcl) ==", flush=True)
    _, _, _, rep = _trace(examples.setup_example(examples.SOLOVEV_ECH_90GHZ, device=device))
    rep["ok"] = min(rep["npoints"]) > 10 and rep["max_residual"] < 1e-5
    return rep


def _spline_stage(write_example, device, resid_max):
    with tempfile.TemporaryDirectory() as d:
        case = runner.setup(write_example(d), device=device)
    _, _, _, rep = _trace(case)
    rep["ok"] = min(rep["npoints"]) > 5 and rep["max_residual"] < resid_max
    return rep


def stage_axisym(device="cuda"):
    print("== axisym toroid (eqdsk spline magnetics) ==", flush=True)
    return _spline_stage(examples.write_eqdsk_toroid_example, device, 1e-4)


def stage_mirror(device="cuda"):
    print("== multiple mirror (spline fields, four coils; in place of the "
          "reference's MPEX example) ==", flush=True)
    return _spline_stage(examples.write_mirror_example, device, 1e-2)


STAGES = {
    "slab": stage_slab,
    "damped": stage_damped,
    "solovev": stage_solovev,
    "axisym": stage_axisym,
    "mirror": stage_mirror,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stages", nargs="*", help=f"of {', '.join(STAGES)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the plain tracer)")
    args = ap.parse_args(argv)
    if set(args.stages) - set(STAGES):
        ap.error(f"unknown stages {sorted(set(args.stages) - set(STAGES))}")
    torch.zeros((), device=args.device)   # a device that is not there fails first
    results = {}
    for name in args.stages or list(STAGES):
        t0 = time.perf_counter()
        try:
            results[name] = STAGES[name](args.device)
        except Exception as e:  # noqa: BLE001  (a stage that raises is a FAIL)
            import traceback

            traceback.print_exc()
            results[name] = {"ok": False, "error": repr(e)}
        results[name]["stage_s"] = time.perf_counter() - t0
        print("  PASS" if results[name]["ok"] else "  FAIL", flush=True)
    print("\n=== SUMMARY ===", flush=True)
    for name, rep in results.items():
        print(f"  {name}: {'PASS' if rep['ok'] else 'FAIL'} ({rep['stage_s']:.2f} s)", flush=True)
    print(json.dumps({"device": args.device, "stages": results}))
    return 0 if all(r["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
