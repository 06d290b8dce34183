"""What one outer step costs on the H100, path by path: the counterpart of
scripts/step_profile.py.

1. What one step needs.  For the slab RK4 kernel (B1): its operations per
   ray step by kind, counted by the kernel body itself on the example
   rays (``fused_slab.count_ops``), undamped and damped.  For the paths
   without a kernel (the slab under RK4 and under SG, Solovev under SG,
   the EQDSK tokamak and the mirror under RK4): the ``op_census`` of one
   outer step, the aten operations it issues (the host-independent
   kernels per step) and the elements they write per ray, by class.
2. What the device does in one step.  ``torch.profiler`` (CPU and CUDA
   activity) over a short window after a warm-up: a trace of ``--steps``
   outer steps less a trace of none, at ``--rays`` rays.  CUDA kernels per
   outer step beside the census, device time per step, the device's busy
   share of the window, the quantiles of kernel duration, the 8 kernels
   with the most time.  The same for B1 (one launch per call) at 256 rays
   and at ``--rays``.
3. Fixed cost per call against sustained rate: ``trace_rays`` through B1
   at 32,768 and 131,072 rays, f32 and f64, on the host's clock: the best
   of 3 single calls against the best of 3 runs of 5 calls back to back,
   and the fixed cost per call this implies.

Writes build/step_profile.txt; every number beside the card's name and
power limit.  On the CPU (``--device cpu``) sections 1 and 2 run the
plain paths on the host (no device time) and B1 is not run.

    python tools/step_profile.py
    python tools/step_profile.py --device cpu --rays 8 --steps 2
"""

import argparse
import dataclasses
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rays_tpu_torch import examples, run as runner  # noqa: E402
from rays_tpu_torch.core.types import tree_to  # noqa: E402
from rays_tpu_torch.tracing import fused_slab  # noqa: E402
from rays_tpu_torch.tracing.trace import trace_batch, trace_rays  # noqa: E402
from rays_tpu_torch.utils import measure, op_census, op_rates  # noqa: E402

N_RAYS = 32768
STEPS = 16              # outer steps of a profiled window (10-20: the plain slab
                        # issues about 1,200 kernels a step)
CALL_BATCHES = (32768, 131072)
B1_SMALL = 256
DTYPES = {"f32": torch.float32, "f64": torch.float64}
PATHS = ("slab_rk4", "slab_sg", "solovev_sg", "eqdsk_rk4", "mirror_rk4")


def _subdir(directory, name):
    path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)
    return path


def plain_cases(device, n_rays, directory):
    """{path: (cfg, params, v, status, pwr)} of the five paths without a
    kernel at ``n_rays`` rays (examples.replicate_rays), float64, summaries
    only; the EQDSK and mirror input files are written into ``directory``."""
    sg = examples.SLAB_ECH_90GHZ.replace("ode_solver_name='RK4_ODE'", "ode_solver_name='SG_ODE'")
    cases = {
        "slab_rk4": examples.setup_example(device=device),
        "slab_sg": examples.setup_example(sg, device=device),
        "solovev_sg": examples.setup_example(examples.SOLOVEV_ECH_90GHZ, device=device),
        "eqdsk_rk4": runner.setup(examples.write_eqdsk_toroid_example(
            _subdir(directory, "eqdsk")), device=device),
        "mirror_rk4": runner.setup(examples.write_mirror_example(
            _subdir(directory, "mirror")), device=device),
    }
    out = {}
    for name, (cfg, params, v0, st, pwr) in cases.items():
        out[name] = (dataclasses.replace(cfg, save_trajectory=False), params,
                     *examples.replicate_rays(v0, st, pwr, n_rays))
    return out


def _window(case, steps, device):
    """The device trace of ``trace_batch`` over ``steps`` outer steps."""
    cfg, params, v, s, w = case
    c = dataclasses.replace(cfg, nstep_max=steps)
    return measure.profile(lambda: trace_batch(c, params, v, s, w), device)


def step_window(case, steps, device):
    """{kernels, copies, device_us, wall_us, profiled_wall_us per outer
    step; busy share; quantiles; top kernels; profiled}: a window of
    ``steps`` outer steps less one of none, after a warm-up.  The profiler
    slows the host, so the wall per step is also taken without it, on the
    host's clock, and the busy share is the device time over that wall."""
    cfg, params, v, s, w = case

    def trace(n):
        return trace_batch(dataclasses.replace(cfg, nstep_max=n), params, v, s, w)

    trace(2)                                                    # warm-up
    wall = (measure.host_s(lambda: trace(steps), device)[0]
            - measure.host_s(lambda: trace(0), device)[0]) * 1e6 / steps
    none, full = _window(case, 0, device), _window(case, steps, device)
    device_us = (full.busy_us - none.busy_us) / steps
    return {"kernels": (len(full.kernels) - len(none.kernels)) / steps,
            "copies": (len(full.copies) - len(none.copies)) / steps,
            "device_us": device_us, "wall_us": wall,
            "profiled_wall_us": (full.wall_us - none.wall_us) / steps,
            "busy_share": device_us / wall, "quantiles": full.quantiles(),
            "top": [(n, us / steps, c / steps) for n, us, c in full.top(8)],
            "profiled": bool(full.kernels)}


def b1_window(device, n_rays, dtype=torch.float64, reps=5):
    """One B1 call on the slab example at n_rays: {profiled_kernels, the
    kernels torch.profiler saw in one call (the wrapper's own fills, and B1
    where the profiler sees a launch from a ctypes library); profiled_b1,
    whether B1 was among them; call_ms, CUDA events around one call as a
    user makes it; kernel_ms, the device time per call with the wrapper's
    host work hidden; launches of the profiled call}.

    The wrapper reads the run constants from Params (``.cpu()``), which
    waits for the stream; ``kernel_ms`` hands it host copies of them, so
    the calls queue behind ``measure.device_ms``'s spin and the events
    time the launches alone."""
    cfg, params, v0, st, pwr = examples.setup_example(device=device)
    cfg = dataclasses.replace(cfg, save_trajectory=False)
    v, s, w = examples.replicate_rays(v0, st, pwr, n_rays)
    v, w = v.to(dtype), w.to(dtype)
    p, p_host = tree_to(params, dtype=dtype), tree_to(params, "cpu", dtype)
    call = lambda: fused_slab.trace_batch_fused(cfg, p, v, s, w)  # noqa: E731
    call()
    before = fused_slab.LAUNCHES
    tr = measure.profile(call, device)
    launches = fused_slab.LAUNCHES - before
    call_ms = min(measure.time_ms(call, device)[0] for _ in range(3))
    kernel_ms, _ = measure.device_ms(
        lambda: fused_slab.trace_batch_fused(cfg, p_host, v, s, w), device, reps)
    return {"profiled_kernels": len(tr.kernels),
            "profiled_b1": any("slab_rk4" in name for name, _, _ in tr.kernels),
            "call_ms": call_ms, "kernel_ms": kernel_ms, "launches": launches}


def call_cost(device, n_rays, dtype, reps=3, burst=5):
    """(best single call s, best s per call of ``burst`` back to back) of
    ``trace_rays`` on the slab example through B1, host clock."""
    cfg, params, v0, st, pwr = examples.setup_example(device=device)
    cfg = dataclasses.replace(cfg, save_trajectory=False)
    v, s, w = examples.replicate_rays(v0, st, pwr, n_rays)
    p, v, w = tree_to(params, dtype=dtype), v.to(dtype), w.to(dtype)
    call = lambda: trace_rays(cfg, p, v, s, w)  # noqa: E731
    call()
    one = min(measure.host_s(call, device)[0] for _ in range(reps))
    five = min(measure.host_s(lambda: [call() for _ in range(burst)], device)[0]
               for _ in range(reps)) / burst
    return one, five


def run(device="cuda", n_rays=N_RAYS, steps=STEPS, log=print):
    """Every section; returns (report lines, {"b1_ops", "census", "windows",
    "b1", "calls"})."""
    dev = measure.open_device(device)
    cuda = dev.type == "cuda"
    card = measure.card_line(dev)
    lines = []

    def say(msg=""):
        log(msg)
        lines.append(msg)

    # --- 1. what one step needs ---
    say(f"# 1. What one outer step needs ({card})")
    b1_ops = {}
    for name, text in (("slab_rk4", examples.SLAB_ECH_90GHZ),
                       ("slab_rk4_damped", examples.SLAB_ECH_DAMPED)):
        ray_ops, npts = op_rates.example_ray_ops(text)
        per = op_rates.per_ray_step(ray_ops, npts)
        b1_ops[name] = per
        say(f"B1 {name}: operations per ray step (count_ops, example rays of {npts} points): "
            + ", ".join(f"{k} {v:.2f}" for k, v in per.items()) + f"; total {sum(per.values()):.1f}")
    with tempfile.TemporaryDirectory() as tmp:
        cases = plain_cases(dev, n_rays, tmp)
    census = {}
    for name in PATHS:
        c = op_census.step_census(*cases[name])
        census[name] = c
        cls = ", ".join(f"{k} {n} ({e:.0f})" for k, (n, e) in c.by_class().items() if n)
        say(f"{name}: aten ops per outer step {c.n_ops} (views and metadata {c.n_views}, "
            f"host reads {c.host_reads}); elements per ray {sum(c.elements.values()):.1f}; "
            f"by class, ops (elements per ray): {cls}")

    # --- 2. what the device does in one step ---
    say()
    say(f"# 2. torch.profiler, {steps} outer steps less none, {n_rays} rays, f64 ({card})")
    windows = {}
    for name in PATHS:
        wnd = step_window(cases[name], steps, dev)
        windows[name] = wnd
        if not cuda:
            say(f"{name}: host {wnd['wall_us'] / 1e3:.3f} ms per outer step (cpu run: device "
                f"time not measured); census {census[name].n_ops} aten ops per step")
            continue
        if not wnd["profiled"]:
            ms, _ = measure.time_ms(lambda: trace_batch(dataclasses.replace(
                cases[name][0], nstep_max=steps), *cases[name][1:]), dev)
            wnd["events_ms"] = ms / steps
            say(f"{name}: torch.profiler showed no device time; CUDA events: {ms / steps:.3f} "
                f"ms per outer step (kernels per step not measured)")
            continue
        q = wnd["quantiles"]
        say(f"{name}: CUDA kernels per outer step {wnd['kernels']:.1f} (census "
            f"{census[name].n_ops} aten ops; copies {wnd['copies']:.1f}); device "
            f"{wnd['device_us'] / 1e3:.3f} ms of {wnd['wall_us'] / 1e3:.3f} ms per step "
            f"(profiled: {wnd['profiled_wall_us'] / 1e3:.3f} ms), busy share "
            f"{wnd['busy_share']:.4f}; kernel us min {q[0]:.2f} median {q[1]:.2f} p90 "
            f"{q[2]:.2f} max {q[3]:.2f}")
        for kname, us, calls in wnd["top"]:
            say(f"    {us:9.2f} us {calls:6.1f} calls per step  {kname[:90]}")
    del cases
    b1 = {}
    if cuda:
        for n in (B1_SMALL, n_rays):
            b = b1[n] = b1_window(dev, n)
            seen = ("" if b["profiled_b1"] else "; torch.profiler did not see the kernel "
                    "(a ctypes library launches it), so CUDA events time it")
            say(f"B1 slab f64 x 500 steps, {n} rays: kernel {b['kernel_ms']:.3f} ms of device "
                f"time (CUDA events, the wrapper's host work hidden); one call as a user "
                f"makes it {b['call_ms']:.3f} ms (CUDA events){seen}")
    else:
        say("B1: not measured (cpu run; the kernel runs only on the card)")

    # --- 3. fixed cost per call ---
    say()
    say(f"# 3. trace_rays through B1: single call against 5 back to back, best of 3, host "
        f"clock ({card})")
    calls = {}
    if cuda:
        for n in CALL_BATCHES:
            for tag, dt in DTYPES.items():
                one, five = call_cost(dev, n, dt)
                calls[(n, tag)] = (one, five)
                say(f"B={n:7d} {tag}: single {one * 1e3:.3f} ms ({n / one / 1e6:.2f} M rays/s); "
                    f"5 back to back {five * 1e3:.3f} ms per call ({n / five / 1e6:.2f} M rays/s "
                    f"sustained); implied fixed cost per call {(one - five) * 1e3:.3f} ms")
    else:
        say("not measured (cpu run; B1 runs only on the card)")
    return lines, {"b1_ops": b1_ops, "census": census, "windows": windows, "b1": b1,
                   "calls": calls}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the plain paths only)")
    ap.add_argument("--rays", type=int, default=N_RAYS, help="rays of the profiled windows")
    ap.add_argument("--steps", type=int, default=STEPS, help="outer steps of a window")
    ap.add_argument("--out", default=os.path.join("build", "step_profile.txt"))
    args = ap.parse_args(argv)
    lines, _ = run(args.device, args.rays, args.steps)
    print(f"wrote {measure.write_report(lines, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
