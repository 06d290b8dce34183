"""What one outer step costs on the H100, path by path: the counterpart of
scripts/step_profile.py, for the eager tracer and the graphed one.

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
   with the most time.  Each path that the graph route takes (the slab
   under RK4 with the equilibrium-gradient slots, since B1 takes the plain
   slab, and the four others) also through ``trace_rays``'s graphed tracer
   (tracing/graphed.py): the same window of replays, its host reads and
   substep passes per step, and the one-off capture time of the
   configuration.  The same for B1 (one launch per call) at 256 rays and at
   ``--rays``.
3. Fixed cost per call against sustained rate: ``trace_rays`` through B1
   at 32,768 and 131,072 rays, f32 and f64, on the host's clock: the best
   of 3 single calls against the best of 3 runs of 5 calls back to back,
   and the fixed cost per call this implies.
4. One outer step's backward pass (its VJP) in the adjoints of the
   training step, the SG training step and the EQDSK adjoint (VJP_PATHS):
   the backward of ``2 --steps`` outer steps less that of ``--steps``,
   eager (autograd through ``trace_batch``) and through ``trace_rays``'s
   graphed adjoint (tracing/graphed_adjoint.py), with the same figures as
   section 2.  Then one outer step with forward-mode tangents through the
   tangent graph (tracing/graphed_tangent.py) on the inverse demo's
   configuration (Solovev, RK4; TANGENT_PATHS): with the closed-form
   jacobians and with Solovev registered without them (JACFWD_MODEL,
   forward over reverse), its census and its window.
5. The least time one outer step could take on each compiled route at
   ``--rays`` rays, f64 (``step_bound``): the census's elements per ray
   (the graph route's step, the adjoint's VJP piece, the tangent graph's
   JVP piece) as operations at the published f64 peak, against the bytes
   the step must move (carry in and out; the tangent's carry tangents;
   the adjoint's stack row and cotangents) at the published memory rate;
   the larger of the two, and its share of the device time per step that
   sections 2 and 4 measured.

Writes build/step_profile.txt; every number beside the card's name and
power limit.  On the CPU (``--device cpu``) sections 1 and 2 run the
plain paths on the host (no device time); B1 and the graphs are not run.

    python tools/step_profile.py
    python tools/step_profile.py --device cpu --rays 8 --steps 2
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rays_tpu_torch import examples, run as runner  # noqa: E402
from rays_tpu_torch.models import base, solovev  # noqa: E402
from rays_tpu_torch.core.types import tree_leaves, tree_map, tree_to  # noqa: E402
from rays_tpu_torch.tracing import fused_slab, graphed, rk45  # noqa: E402
from rays_tpu_torch.tracing.trace import initial_carry, route, trace_batch, trace_rays  # noqa: E402
from rays_tpu_torch.utils import measure, op_census, op_rates  # noqa: E402

N_RAYS = 32768
STEPS = 16              # outer steps of a profiled window (10-20: the plain slab
                        # issues about 1,200 kernels a step)
CALL_BATCHES = (32768, 131072)
B1_SMALL = 256
DTYPES = {"f32": torch.float32, "f64": torch.float64}
PATHS = ("slab_rk4", "slab_rk4_eq_gradients", "slab_sg", "solovev_sg", "eqdsk_rk4",
         "mirror_rk4")
GRAPHED = PATHS[1:]     # the paths that trace_rays sends to the graphed tracer


def _subdir(directory, name):
    path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)
    return path


def plain_cases(device, n_rays, directory):
    """{path: (cfg, params, v, status, pwr)} of the five paths without a
    kernel at ``n_rays`` rays (examples.replicate_rays), float64, summaries
    only; the EQDSK and mirror input files are written into ``directory``."""
    sg = examples.SLAB_ECH_90GHZ.replace("ode_solver_name='RK4_ODE'", "ode_solver_name='SG_ODE'")
    eq_grad = examples.SLAB_ECH_90GHZ.replace("integrate_eq_gradients=.false.",
                                              "integrate_eq_gradients=.true.")
    cases = {
        "slab_rk4": examples.setup_example(device=device),
        "slab_rk4_eq_gradients": examples.setup_example(eq_grad, device=device),
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


# every path that trace_rays sends to the graphed tracer: (case of
# plain_cases or "slab_f32", Config changes)
GRAPH_CASES = {
    "slab_rk4_eq_gradients": ("slab_rk4_eq_gradients", {}),
    "slab_rk4_autodiff": ("slab_rk4", dict(ray_deriv_name="autodiff")),
    "slab_sg_fixed_budget": ("slab_sg", dict(sg_scan_substeps=2)),
    "slab_sg_loop": ("slab_sg", {}),
    "solovev_sg": ("solovev_sg", {}),
    "solovev_rk4": ("solovev_sg", dict(ode_solver_name="RK4_ODE")),
    "eqdsk_rk4": ("eqdsk_rk4", {}),
    "mirror_damped_rk4": ("mirror_damped_rk4", {}),
    "slab_compensated_f32": ("slab_f32", dict(compensated_sum=True)),
}
# every path whose reverse mode trace_rays sends to the graphed adjoint
# (tracing/graphed_adjoint.py), in the form of GRAPH_CASES: RK4 on every
# geometry, B1's two configs among them, SG with a fixed substep budget
ADJOINT_CASES = {
    "slab_rk4": ("slab_rk4", {}),
    "slab_rk4_damped": ("slab_damped", {}),
    **{name: GRAPH_CASES[name] for name in ("slab_rk4_eq_gradients", "slab_sg_fixed_budget",
                                            "solovev_rk4", "eqdsk_rk4", "mirror_damped_rk4",
                                            "slab_compensated_f32")},
    "solovev_sg_fixed_budget": ("solovev_sg", dict(sg_scan_substeps=3)),
}
# Solovev registered with its fields, geometry and validity checks alone:
# its jacobians come by forward mode (models/base.equilibrium), forward
# over reverse inside a caller's forward-AD level
JACFWD_MODEL = "solovev_jacfwd"
# section 4's tangent steps: the inverse demo's configuration (Solovev,
# RK4) with the closed-form jacobians and through JACFWD_MODEL
TANGENT_PATHS = ("solovev_rk4", "solovev_rk4_jacfwd")
# the adjoints of chip_smoke.py's phases 9, 13 and 16, whose VJP per
# outer step section 4 profiles
VJP_PATHS = ("slab_rk4_damped", "slab_sg_fixed_budget", "eqdsk_rk4")
MIRROR_DAMPED = examples.MIRROR_ECH_56GHZ.replace("damping_model='no_damp'",
                                                  "damping_model='damp_fund_ECH'")


def _cases(device, n_rays, directory, table):
    """{name: (cfg, params, v, status, pwr)} of ``table`` ({name: (case of
    plain_cases, "slab_f32", "mirror_damped_rk4" or "slab_damped", Config
    changes)}) at ``n_rays`` rays, trajectories on; the spline files are
    written into ``directory``."""
    base = plain_cases(device, n_rays, directory)
    cfg, params, v0, st, pwr = examples.setup_example(device=device, dtype=torch.float32)
    base["slab_f32"] = (cfg, params, *examples.replicate_rays(v0, st, pwr, n_rays))
    cfg, params, v0, st, pwr = runner.setup(examples.write_mirror_example(
        _subdir(directory, "mirror_damped"), text=MIRROR_DAMPED), device=device)
    base["mirror_damped_rk4"] = (cfg, params, *examples.replicate_rays(v0, st, pwr, n_rays))
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_DAMPED, device=device)
    base["slab_damped"] = (cfg, params, *examples.replicate_rays(v0, st, pwr, n_rays))
    out = {}
    for name, (which, changes) in table.items():
        cfg, *rest = base[which]
        out[name] = (dataclasses.replace(cfg, save_trajectory=True, **changes), *rest)
    return out


def graph_cases(device, n_rays, directory):
    """The cases of GRAPH_CASES (``_cases``)."""
    return _cases(device, n_rays, directory, GRAPH_CASES)


def adjoint_cases(device, n_rays, directory):
    """The cases of ADJOINT_CASES (``_cases``)."""
    return _cases(device, n_rays, directory, ADJOINT_CASES)


def register_jacfwd_model():
    """Register JACFWD_MODEL (``base.register_eq_model``); returns its name."""
    import types

    base.register_eq_model(JACFWD_MODEL, types.SimpleNamespace(
        fields=solovev.fields, geom_err=solovev.geom_err, err=solovev.err))
    return JACFWD_MODEL


def tangent_cases(device, n_rays):
    """The cases of TANGENT_PATHS at ``n_rays`` rays, summaries only
    (JACFWD_MODEL registered)."""
    cfg, params, v0, st, pwr = examples.setup_example(examples.SOLOVEV_ECH_90GHZ, device=device)
    cfg = dataclasses.replace(cfg, ode_solver_name="RK4_ODE", save_trajectory=False)
    rest = (params, *examples.replicate_rays(v0, st, pwr, n_rays))
    return {"solovev_rk4": (cfg, *rest),
            "solovev_rk4_jacfwd": (dataclasses.replace(
                cfg, equilib_model=register_jacfwd_model()), *rest)}


def direction(params, v, w, seed):
    """A tangent for every floating Params leaf, v0 and pwr_wt: each
    tensor times N(0, 1) entries from a numpy seed, on its device."""
    rng = np.random.default_rng(seed)

    def draw(t):
        return t * torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=t.dtype,
                                   device=t.device)

    return (tree_map(lambda t: draw(t) if t.is_floating_point() else None, params),
            draw(v), draw(w))


def _duals(params, v, w, tangents):
    """(Params, v0, pwr_wt) as dual tensors along ``tangents`` (of
    ``direction``) at the current level."""
    dp, dv, dw = tangents
    return (tree_map(lambda t, d: t if d is None else fwAD.make_dual(t, d), params, dp),
            fwAD.make_dual(v, dv), fwAD.make_dual(w, dw))


def along(tracer, tangents):
    """``tracer`` with forward-mode tangents along ``tangents``, inside a
    dual level of its own, without gradients."""
    def traced(cfg, params, v, s, w):
        with fwAD.dual_level(), torch.no_grad():
            p, vv, ww = _duals(params, v, w, tangents)
            return tracer(cfg, p, vv, s, ww)

    return traced


def tangent_census(case, tangents):
    """``op_census.step_census`` of ``case`` with forward-mode tangents."""
    cfg, params, v, s, w = case
    with fwAD.dual_level():
        p, vv, ww = _duals(params, v, w, tangents)
        return op_census.step_census(cfg, p, vv, s, ww)


def _vjp_loss_and_leaves(case, n, tracer=trace_batch):
    """(loss, floating Params leaves) of ``vjp_window``'s loss over n outer
    steps of ``tracer``."""
    cfg, params, v, s, w = case
    p = tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)
    res = tracer(dataclasses.replace(cfg, nstep_max=n), p, v, s, w)
    loss = (res.end_ray_vec[:, 0:3] ** 2 * res.initial_ray_power[:, None]).sum()
    return loss, [t for t in tree_leaves(p) if t.requires_grad]


def vjp_census(case, k=1):
    """The census of one outer step's VJP as the adjoint graph's "vjp"
    piece issues it (the step recomputed under autograd, then its
    backward): the forward and backward of ``vjp_window``'s loss over
    k + 1 outer steps less those of k, eagerly through trace_batch."""
    def run(n):
        def fn():
            loss, leaves = _vjp_loss_and_leaves(case, n)
            torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return op_census.census(fn, case[2].shape[0])

    return run(k + 1) - run(k)


def _ray_bytes(tensors, n_rays):
    """Bytes per ray of the tensors whose first axis is the ray batch."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and t.dim() and t.shape[0] == n_rays) / n_rays


def step_bound(census, case, kind):
    """{ops, bytes, ms_ops, ms_bytes, bound_ms, bound_by} of one outer step
    of ``case`` on the compiled route ``kind`` ("graph", "tangent" or
    "adjoint"), at the case's rays, f64.  Operations: every element per ray
    that the census's classes but ``copy`` write, each one operation, at
    the published f64 peak (op_rates.PEAK_FLOPS).  Bytes, each counted once,
    at the published memory rate (op_rates.HBM_BYTES_PER_S): the carry read
    and written and the trajectory row written; the tangent graph also the
    floating carry's tangents read and written and the row's tangent; the
    adjoint's VJP its stack row read (the carry before the step), the
    floating carry's cotangent read and written and the row's cotangent
    read."""
    cfg, params, v, s, w = case
    n_rays = v.shape[0]
    with torch.no_grad():
        carry = initial_carry(cfg, params, v, s)
    whole = _ray_bytes(carry, n_rays)
    floating = _ray_bytes([t for t in carry if t.is_floating_point()], n_rays)
    row = (v.shape[1] + 1) * v.element_size() if cfg.save_trajectory else 0
    per_ray = {"graph": 2 * whole + row,
               "tangent": 2 * (whole + floating) + 2 * row,
               "adjoint": whole + 2 * floating + row}[kind]
    ops = n_rays * sum(e for cls, (_, e) in census.by_class().items() if cls != "copy")
    n_bytes = n_rays * per_ray
    ms_ops = ops / op_rates.PEAK_FLOPS[torch.float64] * 1e3
    ms_bytes = n_bytes / op_rates.HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": n_bytes, "ms_ops": ms_ops, "ms_bytes": ms_bytes,
            "bound_ms": max(ms_ops, ms_bytes),
            "bound_by": "bytes" if ms_bytes > ms_ops else "operations"}


def step_window(case, steps, device, tracer=trace_batch):
    """{kernels, copies, device_us, wall_us, profiled_wall_us per outer
    step; busy share; quantiles; top kernels; profiled; first_s and
    again_s, the host seconds of the first and a later call of ``steps``
    steps}: a window of ``steps`` outer steps of ``tracer`` less one of
    none, after a warm-up of both (for the graphed tracer, their capture).
    The profiler slows the host, so the wall per step is also taken without
    it, on the host's clock, and the busy share is the device time over
    that wall."""
    cfg, params, v, s, w = case

    def trace(n):
        c = dataclasses.replace(cfg, nstep_max=n)
        return lambda: tracer(c, params, v, s, w)

    first = measure.host_s(trace(steps), device)[0]            # warm-up
    trace(0)()
    again = measure.host_s(trace(steps), device)[0]
    wall = (again - measure.host_s(trace(0), device)[0]) * 1e6 / steps
    none, full = measure.profile(trace(0), device), measure.profile(trace(steps), device)
    device_us = (full.busy_us - none.busy_us) / steps
    return {"kernels": (len(full.kernels) - len(none.kernels)) / steps,
            "copies": (len(full.copies) - len(none.copies)) / steps,
            "device_us": device_us, "wall_us": wall,
            "profiled_wall_us": (full.wall_us - none.wall_us) / steps,
            "busy_share": device_us / wall, "quantiles": full.quantiles(),
            "top": [(n, us / steps, c / steps) for n, us, c in full.top(8)],
            "profiled": bool(full.kernels), "first_s": first, "again_s": again}


def vjp_window(case, steps, device, tracer=trace_batch):
    """One outer step's backward pass: the backward of a run of
    ``2 steps`` outer steps less that of ``steps`` (the loss of
    ``bench.py``'s adjoint rows, every floating Params leaf), after a
    warm-up of both (for the graphed adjoint, their captures): {kernels,
    copies, device_us, wall_us, profiled_wall_us per outer step, busy
    share, quantiles, top kernels, profiled}.  Each backward's forward runs
    before its window, outside it."""
    def backward(n):
        loss, leaves = _vjp_loss_and_leaves(case, n, tracer)
        return lambda: torch.autograd.grad(loss, leaves, allow_unused=True,
                                           materialize_grads=True)

    for n in (steps, 2 * steps):
        backward(n)()
    wall = ((measure.host_s(backward(2 * steps), device)[0]
             - measure.host_s(backward(steps), device)[0]) * 1e6 / steps)
    short = measure.profile(backward(steps), device)
    full = measure.profile(backward(2 * steps), device)
    device_us = (full.busy_us - short.busy_us) / steps
    return {"kernels": (len(full.kernels) - len(short.kernels)) / steps,
            "copies": (len(full.copies) - len(short.copies)) / steps,
            "device_us": device_us, "wall_us": wall,
            "profiled_wall_us": (full.wall_us - short.wall_us) / steps,
            "busy_share": device_us / wall, "quantiles": full.quantiles(),
            "top": [(n, us / steps, c / steps) for n, us, c in full.top(8)],
            "profiled": bool(full.kernels)}


def graph_window(case, steps, device):
    """``step_window`` through ``trace_rays``'s graphed tracer (on a card:
    the graphs exist only there), plus {capture_ms: the first call less a
    later one (the one-off capture of the configuration), launch_us: the
    host time of one replay call of each graph, reads and passes: host
    reads and lockstep substep passes per outer step
    (``rk45.SubstepStats``, in a run of its own)}."""
    cfg, params, v, s, w = case
    wnd = step_window(case, steps, device, trace_rays)
    c = dataclasses.replace(cfg, nstep_max=steps)
    launch_us = {}
    for name, g in graphed._CACHE[("graph", *graphed.cache_key(c, params, v))].graphs.items():
        # the host's part of one replay: the graph launch, with the stream
        # idle before it (the next call loads its inputs again)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        g.replay()
        launch_us[name] = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize(device)
    rk45.stats = rk45.SubstepStats()
    try:
        trace_rays(c, params, v, s, w)
        loops, reads, _, _ = rk45.stats.totals()
    finally:
        rk45.stats = None
    return {**wnd, "capture_ms": (wnd["first_s"] - wnd["again_s"]) * 1e3,
            "launch_us": launch_us, "reads": reads / steps, "passes": loops / steps}


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


def _window_line(wnd, census, tracer, case, steps, dev):
    """One line of a profiled window on the card; where the profiler saw no
    device time, CUDA events time ``steps`` outer steps of ``tracer``
    instead."""
    if not wnd["profiled"]:
        cfg, params, v, s, w = case
        ms, _ = measure.time_ms(lambda: tracer(dataclasses.replace(cfg, nstep_max=steps),
                                               params, v, s, w), dev)
        wnd["events_ms"] = ms / steps
        return (f"torch.profiler showed no device time; CUDA events: {ms / steps:.3f} ms per "
                f"outer step (kernels per step not measured)")
    q = wnd["quantiles"]
    top = "".join(f"\n    {us:9.2f} us {calls:6.1f} calls per step  {kname[:90]}"
                  for kname, us, calls in wnd["top"])
    return (f"CUDA kernels per outer step {wnd['kernels']:.1f} (census {census.n_ops} aten ops; "
            f"copies {wnd['copies']:.1f}); device {wnd['device_us'] / 1e3:.3f} ms of "
            f"{wnd['wall_us'] / 1e3:.3f} ms per step (profiled: "
            f"{wnd['profiled_wall_us'] / 1e3:.3f} ms), busy share {wnd['busy_share']:.4f}; "
            f"kernel us min {q[0]:.2f} median {q[1]:.2f} p90 {q[2]:.2f} max {q[3]:.2f}{top}")


def run(device="cuda", n_rays=N_RAYS, steps=STEPS, log=print, vjp_paths=VJP_PATHS):
    """Every section, section 4 on ``vjp_paths``; returns (report lines,
    {"b1_ops", "census", "windows", "graphs", "b1", "calls", "vjp", "tangents",
    "tangent_census", "bounds"}); "bounds" is {(route, path): step_bound with
    device_ms, the device time per step measured, or None}."""
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
        say(f"{name} eager: " + _window_line(wnd, census[name], trace_batch, cases[name], steps,
                                             dev))
    graphs = {}
    for name in GRAPHED:
        if not cuda:
            say(f"{name} graphed: not measured (cpu run; the graphs exist only on a card)")
            continue
        wnd = graphs[name] = graph_window(cases[name], steps, dev)
        say(f"{name} graphed: " + _window_line(wnd, census[name], trace_rays, cases[name], steps,
                                               dev)
            + f"; host reads {wnd['reads']:.3f} and substep passes {wnd['passes']:.3f} per "
            f"outer step; capture {wnd['capture_ms']:.1f} ms (once per configuration); host "
            f"time of one replay call: " + ", ".join(
                f"{k} {us:.1f} us" for k, us in wnd["launch_us"].items()))
    plain = {name: cases[name] for name in GRAPHED}
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

    # --- 4. one outer step's VJP ---
    say()
    say(f"# 4. One outer step's backward pass, the backward of {2 * steps} outer steps less "
        f"that of {steps}, {n_rays} rays, f64, trajectories on ({card})")
    vjp = {}
    with tempfile.TemporaryDirectory() as tmp:
        cases = adjoint_cases(dev, n_rays, tmp)
    for name in vjp_paths:
        tracers = {"eager": trace_batch, "graphed": trace_rays} if cuda else {
            "eager": trace_batch}
        for tag, tracer in tracers.items():
            wnd = vjp[(name, tag)] = vjp_window(cases[name], steps, dev, tracer)
            if not cuda:
                say(f"{name} {tag}: host {wnd['wall_us'] / 1e3:.3f} ms per outer step's "
                    f"backward (cpu run: device time not measured)")
                continue
            if not wnd["profiled"]:
                say(f"{name} {tag}: torch.profiler showed no device time; wall "
                    f"{wnd['wall_us'] / 1e3:.3f} ms per outer step's backward")
                continue
            q = wnd["quantiles"]
            say(f"{name} {tag} (route {route(cases[name][0], True, dev)}): CUDA kernels per "
                f"outer step's backward {wnd['kernels']:.1f} (copies {wnd['copies']:.1f}); device "
                f"{wnd['device_us'] / 1e3:.3f} ms of {wnd['wall_us'] / 1e3:.3f} ms (profiled: "
                f"{wnd['profiled_wall_us'] / 1e3:.3f} ms), busy share {wnd['busy_share']:.4f}; "
                f"kernel us min {q[0]:.2f} median {q[1]:.2f} p90 {q[2]:.2f} max {q[3]:.2f}"
                + "".join(f"\n    {us:9.2f} us {c:6.1f} calls per step  {k[:90]}"
                          for k, us, c in wnd["top"]))
        if not cuda:
            say(f"{name} graphed: not measured (cpu run; the graphs exist only on a card)")
    vjp_census_of = {name: vjp_census(cases[name]) for name in vjp_paths}
    vjp_cases = {name: cases[name] for name in vjp_paths}
    del cases

    say()
    say(f"# 4b. One outer step with forward-mode tangents (a direction on every floating "
        f"leaf, v0 and pwr_wt), {n_rays} rays, f64, summaries only ({card})")
    tcases = tangent_cases(dev, n_rays)
    tangents, tangent_census_of = {}, {}
    try:
        for name, case in tcases.items():
            along_dir = direction(case[1], case[2], case[4], seed=25)
            c = tangent_census_of[name] = tangent_census(case, along_dir)
            cls = ", ".join(f"{k} {n} ({e:.0f})" for k, (n, e) in c.by_class().items() if n)
            say(f"{name} census with tangents: aten ops per outer step {c.n_ops} (host reads "
                f"{c.host_reads}); elements per ray {sum(c.elements.values()):.1f}; by class, ops "
                f"(elements per ray): {cls}")
            tracer = trace_rays if cuda else trace_batch
            wnd = tangents[name] = step_window(case, steps, dev, along(tracer, along_dir))
            if not cuda:
                say(f"{name} eager with tangents: host {wnd['wall_us'] / 1e3:.3f} ms per outer "
                    f"step (cpu run: device time not measured; the tangent graph exists only "
                    f"on a card)")
                continue
            say(f"{name} tangent graph (route {route(case[0], False, dev, tangents=True)}): "
                + _window_line(wnd, c, along(trace_rays, along_dir), case, steps, dev)
                + f"; capture {(wnd['first_s'] - wnd['again_s']) * 1e3:.1f} ms")
        rows = ([("graph", name, census[name], plain[name], graphs.get(name))
                 for name in GRAPHED]
                + [("adjoint", name, vjp_census_of[name], case, vjp.get((name, "graphed")))
                   for name, case in vjp_cases.items()]
                + [("tangent", name, tangent_census_of[name], case,
                    tangents[name] if cuda else None) for name, case in tcases.items()])
        bounds = route_bounds(say, rows, n_rays, card)
    finally:
        base.EQ_MODELS.pop(JACFWD_MODEL, None)
    del tcases
    return lines, {"b1_ops": b1_ops, "census": census, "windows": windows, "graphs": graphs,
                   "b1": b1, "calls": calls, "vjp": vjp, "tangents": tangents,
                   "tangent_census": tangent_census_of, "bounds": bounds}


def route_bounds(say, rows, n_rays, card):
    """Section 5: ``step_bound`` of each of ``rows``, (route, path, census
    of one outer step, case, its window or None): the graph route's step
    on GRAPHED, the adjoint's VJP on the VJP paths, the tangent graph's
    JVP on TANGENT_PATHS, each beside the device time per step of its
    window; {(route, path): bound, device_ms the window's or None}."""
    say()
    say(f"# 5. The least time of one outer step, {n_rays} rays, f64: the census's elements "
        f"per ray (all classes but copy) at {op_rates.PEAK_FLOPS[torch.float64] / 1e12:.0f} "
        f"TFLOP/s against the bytes the step moves at "
        f"{op_rates.HBM_BYTES_PER_S / 1e12:.2f} TB/s ({card})")
    bounds = {}
    for kind, name, c, case, wnd in rows:
        b = bounds[(kind, name)] = step_bound(c, case, kind)
        measured = wnd is not None and wnd.get("profiled")
        b["device_ms"] = wnd["device_us"] / 1e3 if measured else None
        share = (f"share {b['bound_ms'] / b['device_ms']:.5g} of the {b['device_ms']:.3f} ms "
                 f"of device time per step measured above" if measured else
                 "device time not measured")
        say(f"{kind} {name}: {c.n_ops} aten ops, {b['ops'] / n_rays:.1f} operations and "
            f"{b['bytes'] / n_rays:.1f} bytes per ray; operations {b['ms_ops']:.5g} ms, bytes "
            f"{b['ms_bytes']:.5g} ms; bound {b['bound_ms']:.5g} ms by {b['bound_by']}; {share}")
    return bounds


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
