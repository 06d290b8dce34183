#!/usr/bin/env python3
"""Chip smoke test of rays_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Drives the port's paths on the card: builds the slab RK4 CUDA kernel
libraries from rays_tpu_torch/csrc (undamped and the two damped variants,
side by side), holds the kernel to its plain PyTorch twin on the card,
times both, runs the CLI, runs the training steps, the paths without a
kernel and post-processing.  Each phase prints one line; the first failure
raises and the script exits non-zero.

    python3 chip_smoke.py                 # every group, from the root of a checkout
    python3 chip_smoke.py --group adjoint # one group alone, at its full depth

The phases come in eight groups (phase 1, the device and the build of
every kernel library, runs in every call):

* kernel, phases 2-8: the build; the undamped slab ECH 90 GHz main path
  (32,768 rays x 500 steps, f64 and f32, timed against the plain twin and
  its bound, the card filled at 524,288 rays, the CLI); the damped example
  through the kernel and the damped batch (32,768 rays x 400 steps).
* graph, phases 29, 31, 32, 34 and 35.  29: every path that trace_rays sends
  to the graphed tracer (tracing/graphed.py: the slab under RK4 with the
  equilibrium-gradient slots, with the autodiff derivatives, under SG
  with a fixed substep budget and with its loop; Solovev under SG and
  RK4; the EQDSK tokamak; the damped mirror; the compensated float32
  carry) at GRAPH_RAYS rays x GRAPH_STEPS steps with trajectories, against
  its eager trace_batch bit for bit on every field, twice (the second
  call replays the first call's capture with the inputs copied in
  again), with the captures and replays counted and the one-off capture
  timed.  31: the same configs with forward-mode tangents through the
  tangent graph (tracing/graphed_tangent.py; the autodiff derivatives
  stay plain) against eager forward AD: the primal bit for bit, the
  tangents within TANGENT_RTOL of scale.  32: the inverse demo's two
  forward-mode columns at N_RAYS rays x INVERSE_STEPS steps, graphed
  against eager, with ms and peak GiB.  34: the slab module registered
  under a new name through the graph route, the adjoint graph and the
  tangent graph, each against its eager twin, and under "slab" through
  the graph route, not B1; a toy with fields alone (its jacobians
  forward over reverse inside the tangents' level) through the tangent
  graph against eager forward AD; a model that reads the host refused
  by name before any capture.  35: phase 32's columns with Solovev
  registered without its closed forms (jacobians forward over reverse),
  through the tangent graph at the same size, held to phase 32's
  closed-form columns, with ms, peak GiB and the census of one outer
  step of both.
* adjoint, phases 36, 37, 38, 30, 33, 9, 13 and 16, every one through the
  graphed adjoint (tracing/graphed_adjoint.py: each outer step and its VJP
  captured once as CUDA graphs, the backward replaying the VJP last step
  first).  36: the slab VJP kernel (tracing/slab_vjp.py), the VJP piece of
  B1's configs without damping, at the benchmark cell's shapes against
  the generic piece captured alike, with ms per step, launches and its
  bound.  37: the slab step kernel (tracing/slab_vjp.py), their step
  piece, alike against the generic step piece and against B1.  38: the
  EQDSK step kernel (tracing/eqdsk_step.py), the step piece of the spline
  toroid with a cell table, on the benchmark cell solovev_eqdsk.grad's
  deck and fan (seed 0) against the generic pieces, with a float32
  control and its bound from a host count of its operations.  30: every
  configuration of that route (RK4 on the slab, damped slab, slab with
  the equilibrium-gradient slots, Solovev, EQDSK and damped mirror; SG
  with a fixed substep budget on the slab and on Solovev; the
  compensated float32 carry) at ADJOINT_RAYS rays x ADJOINT_STEPS steps
  with trajectories, the loss and every gradient held to eager autograd
  through trace_batch (ADJOINT_RTOL of each leaf's scale), the forward
  bit for bit (the slab kernels' config at rounding level; EQDSK with the
  generic pieces, whose step kernel phase 38 holds); the default
  call cuts Solovev SG to ADJOINT_CUT_DEFAULT and says so.  33: backwards whose cache
  entry was evicted before they ran
  (one loss over five step counts; a forward, four other captures, then
  the backward), each entry captured again by its backward, the
  gradients held to eager autograd.  9: the training step of
  __graft_entry__.py (32,768 damped rays x 400 steps, trajectories on,
  forward, backward and a finite-difference check through the kernel);
  13: the adaptive training step (100 outer steps x 2 masked substeps);
  16: the EQDSK adjoint (100 RK4 steps, the psi cell table among the
  leaves).  Each prints its route and is timed at its second call, the
  first capturing it.
* plain, phases 10-12: the Solovev tokamak fan under the adaptive stepper
  (the example against the same code on the CPU, the CLI, 32,768 rays x
  200 outer steps, RK4 at f64 and f32) and the slab under the adaptive
  stepper (32,768 rays x 500 outer steps, f64 and f32).  No hand-written
  kernel: the graph route, trace_batch's step captured as a CUDA graph
  and replayed, as the JAX package runs them as one compiled program (the
  group keeps its older name).
* spline, phases 14-16: the EQDSK tokamak (a 129 x 129 G-EQDSK written by
  the port's solovev_2_eqdsk) and the multiple mirror (a 51 x 201 field
  file from the port's coil-field generator): launch rays against the CPU,
  the CLI, 32,768 rays x 500 RK4 steps at f64 and f32, through the graph
  route; then the EQDSK adjoint.  ``--only-spline`` is an alias of ``--group spline``.
* post, phases 17-19: post-processing on the card.  17: the damped batch
  traced by the kernel with trajectories (32,768 x 401 points), then the
  ray diagnostics, the resonance and cutoff scan, the kx roots and the
  deposition profile, each timed with its peak memory, the diagnostics
  beside their bytes floor, and the first 64 rays held to the CPU.  18:
  the EQDSK and mirror batches (32,768 rays x SPLINE_EXAMPLE_STEPS with
  trajectories), their diagnostics, the toroid and mirror processors with
  the O-X analysis, held to the CPU on 64 rays.  19: the run CLI and then
  the post-processor CLI on the damped slab, Solovev, EQDSK and mirror
  examples, every expected file read back.
* tools, phases 20-24: 20 the batch scan (tools/run_batch_scan.py, B1 at
  f32 and f64 over 256 ... 524,288 rays, rays/s at each size, the largest
  batch held to phase 5's result) and the ds scan (tools/run_ds_scan.py,
  RK4 through B1 with its convergence order; the adaptive ladder in a
  process of its own); 21 tools/validate_all.py, every stage PASS; 22 the
  erays pipeline on the damped slab through B1, its netCDF file read back
  through the port's netCDF4 shim, and the docs; 23 the rays split across
  processes: a world of 1 over NCCL (the damped 32,768-ray trace and its
  all_reduced profile against the unsplit run) and
  entry.dryrun_multiprocess(2), two processes on the one card over gloo;
  24 the compensated carry (f32, 32,768 rays x 100 steps, graph route) and
  the inverse demo at its start, card against CPU, its time split into
  the loss (graph route), the gradient (adjoint graph) and each
  forward-mode column (tangent graph) (INVERSE_STEPS RK4 steps; the
  default call cuts them to INVERSE_STEPS_DEFAULT and says so).
  The batch and RK4 ds scans run alone on the card; the SG ladder,
  validate_all and the dry run then run as processes of their own beside
  phases 22-24.
* profile, phases 25-28: the measurement tools.  25 tools/step_profile.py
  (B1's operations per ray step; the op census of one outer step of the
  slab RK4 (plain and with the equilibrium-gradient slots), slab SG,
  Solovev SG, EQDSK and mirror paths beside the CUDA kernels, device time
  and busy share that torch.profiler sees, eager and graphed, with the
  graphed paths' host reads and capture time; B1's
  device time at 256 and 32,768 rays; trace_rays' fixed cost per call);
  the backward pass of one outer step in the three adjoints of phases 9,
  13 and 16, eager and graphed; one outer step with tangents through the
  tangent graph on the inverse demo's config, closed form and forward
  mode; the bound of one outer step on each compiled route and its share
  of the device time per step;
  26 tools/op_roofline.py (the op-rate kernels of csrc/op_rates.cu, each
  held to its plain chain at the full depth and one iteration short, and
  B1 priced at their rates beside the published-peak bound); 27
  tools/precision_probe.py (where the f32 end error comes from, the plain
  tracer and B1, on the example and on 32,768 rays); 28
  tools/profile_mirror.py (the mirror's evaluation split into its pieces,
  host against device, and each piece in a loop).  Each writes its
  report under build/.  The default call cuts the profiled windows to
  PROFILE_STEPS_DEFAULT steps, the probe to PROBE_STEPS_DEFAULT steps and
  the mirror to
  MIRROR_STEPS_DEFAULT steps and MIRROR_LOOP_ITERS_DEFAULT iterations, and
  says so in their lines.

The last lines are the total wall time, a JSON line of the times of the
paths without a kernel (each trace with its route), a JSON summary of the kernels (B1's two entries
when the kernel group ran, the op-rate kernels' when the profile group
ran) and {"ok": true, "device": {...}}.  Without a CUDA device it
exits non-zero and prints no result.

Beside each kernel time stands its bound, the least time the card could
take for the same work: the larger of the bytes the kernel must move over
the memory rate and the floating-point operations it must do over the
peak rate of their type.  The operations are counted, not estimated: the
kernel body runs the example's rays once on the CPU on a type that counts
its arithmetic (fused_slab.count_ops), so a ray that stops early or an
evaluation without a live Dawson sum counts what it needed.  Phase 2
prints the registers, spills and the occupancy the runtime grants; phases
5 and 8 also time the kernel with the card filled (524,288 rays).
"""

import argparse
import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_RAYS = 32768          # the batch of bench.py (rays_tpu)
TRAJ_RTOL = 1e-7        # f64 kernel vs plain twin, of trajectory scale
ABSORB_ATOL = 1e-9      # f64 kernel vs plain twin, absorption slots
RESID_MAX_F64 = 1e-6
F32_RTOL = 5e-4         # f32 kernel vs f64 plain (tests/test_fused.py bounds)
F32_ABSORB_ATOL = 2e-4  # (tests/test_precision.py:104-112)
RESID_MAX_F32 = 5e-3
LOSS_RTOL = 1e-10       # training loss: kernel forward vs autograd forward
FD_RTOL = 2e-4          # directional derivative vs central difference
FD_EPS = 1e-7           # relative step of the finite difference
N_BINS = 32
N_FILL = 524288         # rays that fill the card (16 x N_RAYS), kernel only
HOST_RTOL = 1e-7        # plain tracer on the card vs on the CPU, of trajectory scale
SOLOVEV_MIN_POINTS = 10     # the bars of scripts/validate_all.py for this example
SOLOVEV_RESID_MAX = 1e-5
# f32 against f64 at the endpoints, (positions, wavevector), of scale:
# tests/test_precision.py for the slab, and for the Solovev fan (fixed step:
# the example's tolerance of 1e-7 is below what float32 can resolve)
SG_F32_RTOL_SLAB = (1e-3, 5e-4)
F32_RTOL_SOLOVEV = (1e-3, 2e-2)
# the spline geometries: f32 against f64 at the endpoints of the rays that
# stop at the same point in both, (positions, wavevector) of scale, and the
# share of rays that may stop a step apart (a ray that leaves the plasma
# crosses psiN = 1 or AphiN = 1 within float32 rounding of a step's end)
F32_RTOL_SPLINE = (1e-3, 2e-2)
F32_NPOINTS_SHARE = 0.02
SPLINE_RESID_MAX = 1e-4     # tests/test_axisym.py
SPLINE_EXAMPLE_STEPS = 120  # RK4 steps of the launch rays and the CLI (the batch runs 500)
SPLINE_BATCH_STEPS = 500    # bench.py's
EQDSK_ADJOINT_STEPS = 100   # RK4 steps of the EQDSK adjoint (bench.py runs 500)
EQDSK_FD_STEPS = 20         # RK4 steps of its finite-difference check
TRAIN_STEPS = 400           # RK4 steps of the damped training step (the example's)
SG_ADJOINT_STEPS = 100      # outer steps of the adaptive training step
SG_FD_STEPS = 20        # outer steps of its finite-difference check
GROUPS = ("kernel", "graph", "adjoint", "plain", "spline", "post", "tools", "profile")
GRAPH_RAYS = 4096       # phase 29: each graphed path against its eager twin
GRAPH_STEPS = 50
ADJOINT_RAYS = 4096     # phase 30: each graphed adjoint against eager autograd
ADJOINT_STEPS = 50
ADJOINT_RTOL = 1e-10    # of each leaf's largest eager gradient, f64
# phase 30 in the default call: Solovev SG with a fixed budget at fewer rays
# and steps (its eager twin took 44-61 s at ADJOINT_RAYS x ADJOINT_STEPS on
# an H100 80GB HBM3, 700 W)
ADJOINT_CUT_DEFAULT = {"solovev_sg_fixed_budget": (1024, 10)}
ADJOINT_RTOL_F32 = 2e-6     # ... f32: 16 ulp (the steps summed in another order)
SLAB_VJP_RAYS = 32768   # phase 36: the slab VJP at the benchmark cell's shapes
SLAB_VJP_STEPS = 500
SLAB_VJP_RTOL = 1e-11   # of each gradient's scale (tests/test_torch_slab_vjp.py)
SLAB_RTOL = 1e-9        # B1 against its plain twin, of scale (tests/test_torch_kernel_host.py)
# phase 38: gradients of the EQDSK step's run against the generic pieces'
# on the cell's deck, of each gradient's scale.  Its forward is at rounding
# level, not bit for bit: on an H100 the sound runs read 5.5e-14, the
# float32 control's live gradients are not finite, and the cell's float32
# reference reads 3.4e-4 (PERF.md sections 2 and 6); the cell's grad_gap
# limit lies between
EQDSK_STEP_GRAD_RTOL = 1e-8
TANGENT_RTOL = 1e-10    # phases 31, 32, 34: tangents of their eager scale, f64
TANGENT_RTOL_F32 = 2e-6     # ... f32
# phase 31 in the default call: the SG loop form on Solovev at fewer steps
# (its eager forward-AD twin took 93.1 s at GRAPH_STEPS on an H100 80GB HBM3, 700 W)
TANGENT_STEPS_DEFAULT = {"solovev_sg": 20}
TOY_SHIFT = 2.0e-3      # phase 34: the toy model's shift of the slab's profiles in x, m
EVICT_RAYS = 1024       # phase 33: the programs whose backward outlives its cache entry
EVICT_STEPS = 20
# post-processing (phases 17-19): the rays the CPU recomputes, and the
# tolerances of tests/test_torch_post_*.py for the card against the CPU
N_HOST_CHECK = 64
POST_TOL = 1e-12            # of each variable's scale
N_IMAG_TOL = 1e-10          # n_imag: the Z function and the group velocity
N_DEP_BINS = 50             # post_process's default
# the card's published rates (memory, FP64 and FP32 outside the tensor
# cores) and the kernel's bound are in rays_tpu_torch/utils/op_rates.py


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


def group_err(got, ref):
    """(positions, wavevector) max over rays of |got - ref| over the
    reference's scale per ray, at the endpoints."""
    out = []
    for sl in (slice(0, 3), slice(3, 6)):
        r = ref[:, sl].double()
        scale = r.abs().amax(dim=-1).clamp_min(1e-12)
        out.append(float(((got[:, sl].double() - r).abs().amax(dim=-1) / scale).max()))
    return tuple(out)


def absorb_err(got, ref):
    """max |got - ref| over the absorption slots (7 and up)."""
    return float((got[..., 7:].double() - ref[..., 7:].double()).abs().max())


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


def ops_per_example_ray(text):
    """[{kind: operations}] and [npoints] for each of the example's launch
    rays, counted on the CPU by the kernel body itself."""
    from rays_tpu_torch.utils import op_rates

    return op_rates.example_ray_ops(text)


def kernel_bound(ray_ops, n_rays, nv, dtype):
    """(bound ms, 'bytes' or 'operations', detail) of one launch on n_rays
    rays that tile the example's launch rays (examples.replicate_rays):
    ``op_rates.published_bound``, every operation at the published peak of
    its type."""
    from rays_tpu_torch.utils import op_rates

    return op_rates.published_bound(op_rates.replicated_totals(ray_ops, n_rays), n_rays,
                                    nv, dtype)


def time_kernel(fused_slab, cfg, params, v, st, w, reps=3):
    """Least of ``reps`` kernel times in ms, after a warm-up."""
    kern = lambda: fused_slab.trace_batch_fused(cfg, params, v, st, w)
    kern()
    return min(timed(kern)[0] for _ in range(reps))


def time_plain_and_kernel(fused_slab, cfg, params, v, st, w):
    """(kernel ms, plain ms, the three runs) in the order kernel, plain,
    kernel, after a warm-up of each.  The plain twin runs once: it takes
    thousands of kernel times, and its spread is the host's."""
    short = dataclasses.replace(cfg, nstep_max=5)
    fused_slab.trace_batch_fused_reference(short, params, v, st, w)   # warm-up
    fused_slab.trace_batch_fused(cfg, params, v, st, w)               # warm-up
    plain = lambda: fused_slab.trace_batch_fused_reference(cfg, params, v, st, w)
    kern = lambda: fused_slab.trace_batch_fused(cfg, params, v, st, w)
    runs = [timed(f)[0] for f in (kern, plain, kern)]
    return (runs[0] + runs[2]) / 2, runs[1], runs


def graph_run(cfg_, params_, v_, st_, w_):
    """trace_rays on a config that takes the graph route on the card:
    (results, ms by CUDA events, (loops, host reads, attempts, rejected) of
    the substep loop, peak bytes).  No kernel launch; the first call of a
    configuration includes its capture."""
    from rays_tpu_torch.tracing import fused_slab, graphed, rk45
    from rays_tpu_torch.tracing.trace import route, trace_rays

    require(route(cfg_, False, v_.device) == "graph", "expected the graph route")
    before, replays = fused_slab.LAUNCHES, graphed.REPLAYS
    rk45.stats = rk45.SubstepStats()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms, res = timed(lambda: trace_rays(cfg_, params_, v_, st_, w_))
    totals = rk45.stats.totals()
    rk45.stats = None
    require(fused_slab.LAUNCHES == before, "the graph route launched the kernel")
    require(graphed.REPLAYS - replays >= cfg_.nstep_max, "the graph route replayed no step")
    require(all(t.is_cuda for t in res if t is not None), "results left the card")
    return res, ms, totals, torch.cuda.max_memory_allocated()


def flag_counts(res):
    from rays_tpu_torch.tracing.stop import flag_string

    codes, counts = torch.unique(res.stop_flag, return_counts=True)
    return {flag_string(c).strip(): n for c, n in zip(codes.tolist(), counts.tolist())}


def run_module(module, args, cwd):
    """``python -m module args`` as a user calls it, in ``cwd``, with the
    checkout on the path; returns its standard output."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"python -m {module} {' '.join(args)} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def run_cli(path, cwd):
    """The run CLI (the default device) on the namelist ``path`` with
    --netcdf; returns its standard output."""
    out = run_module("rays_tpu_torch.run", [path, "--netcdf"], cwd)
    require("device: cuda" in out, f"the CLI did not run on the card:\n{out}")
    return out


def timed_peak(fn):
    """(ms by CUDA events, result, peak bytes allocated during the call,
    what was allocated before it included)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, out = timed(fn)
    return ms, out, torch.cuda.max_memory_allocated()


def first_rays(res, n):
    """The first n rays of a RayResults."""
    return type(res)(*(None if t is None else t[:n] for t in res))


def require_same_diagnostics(card, host, what):
    """The diagnostics of the card's first rays against the CPU's, each
    variable within POST_TOL (n_imag N_IMAG_TOL) of the CPU's scale.
    Returns the largest scaled error."""
    require(list(card) == list(host), f"{what}: variables {list(card)} != {list(host)}")
    worst = 0.0
    for name, h in host.items():
        c = card[name][:h.shape[0]].cpu()
        err = float((c - h).abs().max()) / max(float(h.abs().max()), 1e-300)
        require(err <= (N_IMAG_TOL if name == "n_imag" else POST_TOL),
                f"{what}: {name} card vs CPU {err:.3e} of scale")
        worst = max(worst, err)
    return worst


def _read_outputs(path):
    """{name: array} of a netCDF file, or the numbers of a text file."""
    from scipy.io import netcdf_file

    if path.endswith(".nc"):
        f = netcdf_file(path, "r", mmap=False)
        try:
            return {k: np.array(v.data) for k, v in f.variables.items() if k != "date_vector"}
        finally:
            f.close()
    with open(path) as f:
        words = f.read().split()
    nums = []
    for w in words:
        try:
            nums.append(float(w))
        except ValueError:
            pass
    return {"numbers": np.array(nums), "words": len(words)}


def require_same_files(card_dir, host_dir, skip=()):
    """Every file the card wrote against the CPU's, variable by variable:
    floats within POST_TOL of each variable's scale (the numbers of a text
    file within 1e-8 of their size), everything else equal.  Returns the
    names compared."""
    names = sorted(n for n in os.listdir(card_dir) if not n.startswith(skip))
    require(names == sorted(n for n in os.listdir(host_dir) if not n.startswith(skip)),
            f"card wrote {names}, the CPU {sorted(os.listdir(host_dir))}")
    for name in names:
        c = _read_outputs(os.path.join(card_dir, name))
        h = _read_outputs(os.path.join(host_dir, name))
        require(list(c) == list(h), f"{name}: variables differ")
        for k in h:
            a, b = np.asarray(c[k]), np.asarray(h[k])
            require(a.shape == b.shape, f"{name}:{k} shape {a.shape} != {b.shape}")
            if b.dtype.kind != "f" or not b.size:
                require(np.array_equal(a, b), f"{name}:{k} differs")
            elif k == "numbers":
                require(np.all(np.abs(a - b) <= 1e-8 * np.maximum(np.abs(a), np.abs(b))),
                        f"{name}: numbers differ")
            else:
                err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)
                require(err <= POST_TOL, f"{name}:{k} card vs CPU {err:.3e} of scale")
    return names


def spline_geometry_phase(phase, name, write_example, card, dev, paths, extra_check):
    """Phases 14 and 15: one spline geometry from its files to the batch.
    (a) the example's launch rays on the card against the same code on the
    CPU and (b) the CLI with its netCDF file read back, both at
    SPLINE_EXAMPLE_STEPS steps (an evaluation costs the host the same for 2
    rays as for 32,768, so the depth is cut here and not in the batch);
    (c) 32,768 rays x 500 RK4 steps, summaries only, f64 and f32.  Returns
    (cfg, params, v0, st0, pwr) of the example on the card."""
    from rays_tpu_torch import examples, run as runner
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.results.netcdf import read_results_nc
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.tracing.stop import flag_string
    from rays_tpu_torch.tracing.trace import trace_rays
    from rays_tpu_torch.utils import op_rates

    f64, f32 = torch.float64, torch.float32
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path, (cfg, params, v0, st0, pwr) = spline_example(write_example, tmp, dev)
        t_setup = time.perf_counter() - t0
        host_case = runner.setup(path, device="cpu", dtype=f64)
        # (b) the CLI, in the directory of its input files
        run_cli(path, tmp)
        nc = read_results_nc(os.path.join(tmp, f"run_results.{cfg.run_label}.nc"))
    require(cfg.ode_solver_name == "RK4_ODE" and cfg.nstep_max == SPLINE_EXAMPLE_STEPS
            and cfg.save_trajectory, f"the {name} example changed")
    require(not fused_slab.supported(cfg), f"the gate must refuse the {name} example")
    require(all(t.is_cuda for t in (v0, st0, pwr)), "the launch rays are not on the card")

    # (a) the launch rays, trajectories on, against the same code on the CPU
    ex, ex_ms, _, _ = graph_run(cfg, params, v0, st0, pwr)
    host = trace_rays(*host_case)
    require(torch.equal(ex.npoints.cpu(), host.npoints), f"{name} npoints: card != CPU")
    require(torch.equal(ex.stop_flag.cpu(), host.stop_flag), f"{name} flags: card != CPU")
    err = scaled_err(ex.ray_vec.cpu(), host.ray_vec, per_ray_axis=1)
    res_max = float(ex.max_residuals.max())
    npts = ex.npoints.tolist()
    flags = [flag_string(c).strip() for c in ex.stop_flag.tolist()]
    require(err <= HOST_RTOL, f"{name} card vs CPU {err:.3e} > {HOST_RTOL}")
    require(min(npts) > 5 and res_max < SPLINE_RESID_MAX,
            f"{name} npoints {npts} max residual {res_max:.3e}")
    print(f"phase {phase} {name} example f64, RK4 x {cfg.nstep_max} steps, route graph: files and "
          f"setup {t_setup:.2f} s; {len(npts)} rays, npoints {npts} flags {flags} max residual "
          f"{res_max:.3e}; card vs CPU trajectory err {err:.3e} of scale (bound {HOST_RTOL}); "
          f"{ex_ms:.1f} ms; {extra_check(cfg, params)}")
    require(nc["npoints"].tolist() == npts, f"{name} CLI npoints {nc['npoints']} != {npts}")
    require(nc["ray_vec"].shape == (len(npts), max(npts), 7), f"{name} CLI ray_vec shape")
    require(float(np.abs(nc["ray_vec"][:, :min(npts)] - ex.ray_vec.cpu().numpy()[:, :min(npts)])
                  .max()) <= 1e-6 * float(ex.ray_vec.abs().max()),
            f"{name} CLI trajectories differ from the library's")
    print(f"phase {phase} {name} CLI: run_results.{cfg.run_label}.nc read back, npoints "
          f"{nc['npoints'].tolist()}")

    # (c) the batch
    cfg_b = dataclasses.replace(cfg, save_trajectory=False, nstep_max=SPLINE_BATCH_STEPS)
    vb, stb, wb = examples.replicate_rays(v0, st0, pwr, N_RAYS)
    params32 = tree_to(params, dtype=f32)
    graph_run(dataclasses.replace(cfg_b, nstep_max=3), params, vb, stb, wb)        # warm-up
    n_eval = 4 * cfg_b.nstep_max + 1
    table = params.eq.mag.psi_cells.cells if name == "EQDSK" else params.eq.field_cells.cells
    out = {}
    for dt, p_, v_, w_ in ((f64, params, vb, wb), (f32, params32, vb.to(f32), wb.to(f32))):
        tag = "f32" if dt == f32 else "f64"
        res, ms, _, peak = graph_run(cfg_b, p_, v_, stb, w_)
        out[dt] = res
        size = torch.finfo(dt).bits // 8
        row = table.shape[2] * 16 * size
        print(f"phase {phase} {name} RK4 {tag} {N_RAYS} rays x {cfg_b.nstep_max} steps: {ms:.1f} ms "
              f"({N_RAYS / ms * 1e3:.0f} rays/s), {ms / n_eval:.3f} ms per evaluation "
              f"({n_eval} evaluations; one row of {row} B per ray and evaluation = "
              f"{N_RAYS * row / op_rates.HBM_BYTES_PER_S * 1e3:.5f} ms at the memory rate); peak memory "
              f"{peak / 2**30:.3f} GiB; npoints {sorted(set(res.npoints.tolist()))[:6]} flags "
              f"{flag_counts(res)} max residual {float(res.max_residuals.max()):.3e} on {card}")
        paths.append({"name": f"{name.lower()}_rk4_{tag}", "route": "graph", "ms": ms,
                      "ms_per_evaluation": ms / n_eval, "rays_per_s": N_RAYS / ms * 1e3})
    # the batch's first rays are the example's: those the example's depth
    # did not cut stop at the same point with the same flag
    for i, n in enumerate(npts):
        if n <= SPLINE_EXAMPLE_STEPS:
            same_ray = (int(out[f64].npoints[i]) == n
                        and int(out[f64].stop_flag[i]) == int(ex.stop_flag[i]))
        else:
            same_ray = int(out[f64].npoints[i]) > SPLINE_EXAMPLE_STEPS
        require(same_ray, f"{name}: ray {i} of the batch stops elsewhere than the example's")
    same = out[f32].npoints == out[f64].npoints
    share = 1.0 - float(same.double().mean())
    ex_, ek_ = group_err(out[f32].end_ray_vec[same], out[f64].end_ray_vec[same])
    require(share <= F32_NPOINTS_SHARE, f"{name} f32: {share:.4f} of the rays stop elsewhere")
    require(ex_ <= F32_RTOL_SPLINE[0] and ek_ <= F32_RTOL_SPLINE[1],
            f"{name} f32 vs f64: positions {ex_:.3e}, k {ek_:.3e}")
    print(f"phase {phase} {name} f32 vs f64: {share:.5f} of the rays stop a step apart (bound "
          f"{F32_NPOINTS_SHARE}); on the others endpoints {ex_:.3e} (positions), {ek_:.3e} (k) "
          f"of scale (bounds {F32_RTOL_SPLINE})")
    return cfg, params, v0, st0, pwr


def spline_phases(run):
    """Phases 14-16: the spline geometries, plain PyTorch on the card."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.models import base, solovev
    from rays_tpu_torch.tracing import fused_slab

    card, dev, paths = run.card, run.dev, run.paths
    f64 = torch.float64
    launches_before = fused_slab.LAUNCHES

    def eqdsk_field_check(cfg, params):
        """B and grad B from the splined 129 x 129 file against the
        closed-form Solovev field, at the points and bars of
        tests/test_axisym.py."""
        pts = torch.tensor([[1.45, 0.0, 0.1], [1.2, 0.3, -0.2], [0.9, 0.2, 0.4],
                            [1.5, 0.0, 0.0]], dtype=f64, device=dev)
        closed = examples.setup_example(examples.SOLOVEV_ECH_90GHZ, device=dev, dtype=f64)[1].eq
        b_ref, jb_ref, _, _ = solovev.magnetics_and_jac(closed, pts)
        eq = base.equilibrium(cfg, params, pts)
        require(torch.allclose(eq.bvec, b_ref, rtol=1e-5, atol=1e-6), "splined B != closed form")
        require(torch.allclose(eq.gradb, jb_ref.transpose(1, 2), rtol=2e-3, atol=1e-3),
                "splined grad B != closed form")
        return (f"splined B vs closed-form Solovev at 4 points: max abs "
                f"{float((eq.bvec - b_ref).abs().max()):.2e} T (rtol 1e-5, atol 1e-6), grad B "
                f"{float((eq.gradb - jb_ref.transpose(1, 2)).abs().max()):.2e} T/m "
                f"(rtol 2e-3, atol 1e-3)")

    def mirror_field_check(cfg, params):
        """div B = 0 on the launch region, to the spline's accuracy."""
        pts = torch.tensor([[0.01, 0.0, 1.7], [0.0, 0.02, 1.8], [-0.02, 0.01, 1.9],
                            [0.03, 0.0, 2.0], [0.0, 0.0, 1.6]], dtype=f64, device=dev)
        eq = base.equilibrium(cfg, params, pts)
        div = eq.gradb.diagonal(dim1=1, dim2=2).sum(-1).abs().max()
        scale = eq.gradb.abs().max()
        require(float(div) <= 1e-3 * float(scale), f"div B {float(div):.3e} of {float(scale):.3e}")
        return (f"|B| at the launch points {[round(b, 4) for b in eq.bmag.tolist()]} T, "
                f"div B {float(div):.2e} T/m of a gradient of {float(scale):.2e} T/m")

    # phase 14: the EQDSK tokamak
    cfg_e, params_e, v0_e, st0_e, pwr_e = spline_geometry_phase(
        14, "EQDSK", examples.write_eqdsk_toroid_example, card, dev, paths, eqdsk_field_check)
    # phase 15: the multiple mirror
    spline_geometry_phase(15, "mirror", examples.write_mirror_example, card, dev, paths,
                          mirror_field_check)
    eqdsk_adjoint_phase(run, (cfg_e, params_e, v0_e, st0_e, pwr_e))
    require(fused_slab.LAUNCHES == launches_before,
            "phases 14-16 launched the slab kernel")
    print("phases 14-16: route graph in 14-15, adjoint in 16; no kernel launch counted")


def spline_example(write_example, directory, dev):
    """A spline example written into ``directory`` by the port's tools, its
    launch rays and the CLI cut to SPLINE_EXAMPLE_STEPS: (path of rays.in,
    (cfg, params, v0, status0, pwr) on ``dev``)."""
    from rays_tpu_torch import run as runner

    path = spline_example_files(write_example, directory)
    return path, runner.setup(path, device=dev, dtype=torch.float64)


def eqdsk_adjoint_phase(run, case=None):
    """Phase 16: the EQDSK adjoint (the loss of bench.py's EQDSK row):
    gradients with respect to the psi cell table and every other leaf, and
    the directional derivative.  ``case`` is the EQDSK example on the card
    (phase 14's, or made here)."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.tracing import graphed_adjoint
    from rays_tpu_torch.tracing.trace import route, trace_rays

    card, dev, paths = run.card, run.dev, run.paths
    f64 = torch.float64
    if case is None:
        with tempfile.TemporaryDirectory() as tmp:
            case = spline_example(examples.write_eqdsk_toroid_example, tmp, dev)[1]
    cfg_e, params_e, v0_e, st0_e, pwr_e = case

    def loss_of(res):
        return (res.end_ray_vec[:, 0:3] ** 2 * res.initial_ray_power[:, None]).sum()

    def adjoint_step(cfg_, v, st, w):
        pg = tree_map(lambda t: t.detach().clone().requires_grad_(True), params_e)
        require(route(cfg_, True, v.device) == "adjoint", "the adjoint takes the adjoint graph")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = loss_of(trace_rays(cfg_, pg, v, st, w))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, tree_leaves(pg), allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (loss.detach(), pg, grads, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                torch.cuda.max_memory_allocated())

    cfg_a = dataclasses.replace(cfg_e, save_trajectory=False, nstep_max=EQDSK_ADJOINT_STEPS)
    vb, stb, wb = examples.replicate_rays(v0_e, st0_e, pwr_e, N_RAYS)
    c0 = graphed_adjoint.CAPTURES
    first_ms = sum(adjoint_step(cfg_a, vb, stb, wb)[3:5])     # with the capture
    loss_a, pg, grads_a, fwd, bwd, peak = adjoint_step(cfg_a, vb, stb, wb)
    require(graphed_adjoint.CAPTURES - c0 == 1, "the EQDSK adjoint was not captured once")
    bad = [i for i, g in enumerate(grads_a) if not bool(torch.isfinite(g).all())]
    require(not bad, f"non-finite EQDSK gradients in leaves {bad}")
    g_cells = next(g for g, t in zip(grads_a, tree_leaves(pg)) if t is pg.eq.mag.psi_cells.cells)
    g_alphan = next(g for g, t in zip(grads_a, tree_leaves(pg)) if t is pg.eq.alphan1)
    require(float(g_cells.abs().max()) > 0 and float(g_alphan.abs()) > 0,
            "the psi cell table or alphan1 got no gradient")
    print(f"phase 16 EQDSK adjoint {N_RAYS} rays x {EQDSK_ADJOINT_STEPS} RK4 steps f64 "
          f"(summaries only), route adjoint: loss {float(loss_a):.12e}, forward {fwd:.1f} ms, "
          f"backward {bwd:.1f} ms (first call, with the capture, {first_ms:.1f} ms in all), peak "
          f"memory {peak / 2**30:.2f} GiB; {len(grads_a)} leaf gradients all "
          f"finite, the psi cell table's {tuple(g_cells.shape)} with "
          f"{int((g_cells != 0).sum())} nonzero entries, max {float(g_cells.abs().max()):.3e} "
          f"on {card}")
    paths.append({"name": "eqdsk_adjoint_f64", "route": "adjoint", "ms": fwd + bwd,
                  "forward_ms": fwd, "backward_ms": bwd, "first_ms": first_ms,
                  "peak_gib": peak / 2**30, "steps": EQDSK_ADJOINT_STEPS,
                  "rays_per_s": N_RAYS / (fwd + bwd) * 1e3})
    del grads_a, pg, vb, stb, wb

    # The launch rays start at Z = 0, on a knot line of the grid, and one of
    # them stays on it by symmetry.  A direction that moves every cell
    # coefficient on its own makes psi discontinuous across that line, and
    # the +eps and -eps runs then read different cells: the loss has no
    # derivative there.  The check moves the rays a third of a cell off the
    # line, where it has one.
    cfg_f = dataclasses.replace(cfg_a, nstep_max=EQDSK_FD_STEPS)
    v0_f = v0_e.clone()
    v0_f[:, 2] += params_e.eq.mag.psi_cells.dy / 3.0
    loss_f, _, grads_f, _, _, _ = adjoint_step(cfg_f, v0_f, st0_e, pwr_e)
    rng = np.random.default_rng(5)
    dirs = type(params_e)(*(tree_map(
        (lambda t: t.abs() * torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=f64,
                                             device=dev))
        if name in ("species", "rf", "eq") else torch.zeros_like, sub)
        for name, sub in zip(params_e._fields, params_e)))
    dd = sum(float((g * d).sum()) for g, d in zip(grads_f, tree_leaves(dirs)))
    fd_runs = {}
    for sgn in (1.0, -1.0):
        p_ = tree_map(lambda p, d: p + sgn * FD_EPS * d, params_e, dirs)
        with torch.no_grad():
            r_ = trace_rays(cfg_f, p_, v0_f, st0_e, pwr_e)
        fd_runs[sgn] = (float(loss_of(r_)), r_.npoints.tolist())
    require(fd_runs[1.0][1] == fd_runs[-1.0][1] == [EQDSK_FD_STEPS + 1] * v0_e.shape[0],
            f"npoints at +-eps {fd_runs[1.0][1]} {fd_runs[-1.0][1]}")
    fd = (fd_runs[1.0][0] - fd_runs[-1.0][0]) / (2 * FD_EPS)
    fd_rel = abs(dd - fd) / abs(fd)
    require(fd_rel <= FD_RTOL, f"EQDSK directional derivative {dd!r} vs FD {fd!r}: {fd_rel:.3e}")
    print(f"phase 16 EQDSK gradient check, {v0_e.shape[0]} rays x {EQDSK_FD_STEPS} steps: loss "
          f"{float(loss_f):.12e}, directional derivative {dd:.10e} vs central difference "
          f"{fd:.10e} (eps {FD_EPS} of each leaf), rel diff {fd_rel:.3e} (bound {FD_RTOL})")


def substep_report(totals, n_rays, n_outer):
    loops, reads, attempts, rejected = totals
    return (f"substeps per outer step {loops / n_outer:.3f} lockstep passes, "
            f"{attempts / n_rays / n_outer:.3f} taken and "
            f"{rejected / n_rays / n_outer:.4f} rejected per ray; host reads per "
            f"outer step {reads / n_outer:.3f}")


def slab_sg_case(dev):
    """The slab example under SG_ODE (bench.py's bench_sg_adaptive) on the
    card: the example (cfg, params, v0, status0, pwr) and, summaries only,
    (cfg, v, status, pwr) of its 32,768-ray batch."""
    from rays_tpu_torch import examples

    case = examples.setup_example(
        examples.SLAB_ECH_90GHZ.replace("ode_solver_name='RK4_ODE'", "ode_solver_name='SG_ODE'"),
        device=dev, dtype=torch.float64)
    cfg_g = case[0]
    require(cfg_g.ode_solver_name == "SG_ODE" and cfg_g.nstep_max == 500, "slab SG case")
    return case, (dataclasses.replace(cfg_g, save_trajectory=False),
                  *examples.replicate_rays(*case[2:], N_RAYS))


def kernel_phases(run):
    """Phases 2-8: the kernels, built from the sources in the checkout,
    on the undamped and the damped main paths.  Returns what the kernels
    line reports."""
    from rays_tpu_torch import examples, native, run as runner
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.results.netcdf import read_results_nc
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.tracing.stop import StopCode, flag_string
    from rays_tpu_torch.tracing.trace import trace_rays
    from rays_tpu_torch.utils import op_rates

    card = run.card

    # phase 2: the kernel libraries, built from the sources in the checkout
    # at phase 1
    libs = fused_slab.load_libraries()
    # -Xptxas -v: registers and spill stores of each instantiation
    reports = []
    for variant, (_, log) in libs.items():
        ptxas = [f"{'f64' if m[1] == 'd' else 'f32'} S={m[2]} {m[5]} regs {m[4]} B spilled"
                 for m in re.finditer(r"slab_rk4_kernelI([fd])Li(\d)ELi(\d)E.*?(\d+) bytes "
                                      r"spill stores.*?Used (\d+) registers", log, re.S)]
        require(ptxas, f"no sm_90a ptxas report in the build log of variant {variant}:\n{log}")
        reports.append(f"variant {variant}: " + ", ".join(ptxas))
    print(f"phase 2 build: slab_rk4 variants {sorted(libs)} for sm_90a in {run.build_s:.1f} s "
          f"(built side by side with op_rates); ptxas: " + "; ".join(reports))
    regs = [(int(m.group(2)), int(m.group(1))) for m in re.finditer(
        r"(\d+) bytes spill stores.*?Used (\d+) registers", op_rates.load_library()[1], re.S)]
    require(regs, "no sm_90a ptxas report in the op_rates build log")
    print(f"phase 2 build: op_rates, {len(regs)} kernel instantiations, at most "
          f"{max(r for r, _ in regs)} registers, {max(b for _, b in regs)} B spilled")
    # what the runtime grants the instantiations that the phases below launch
    occupancy = {}
    for variant in (0, 2):
        for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
            occ = native.occupancy(libs[variant][0].rays_slab_occupancy,
                                   int(dt == torch.float64), 2)
            require(occ["blocks_per_sm"] >= 1, f"variant {variant} {name} cannot launch: {occ}")
            occupancy[variant, dt] = occ
            print(f"phase 2 occupancy: variant {variant} {name} S=2: {occ['registers']} "
                  f"registers, {occ['local_bytes']} B local, {occ['blocks_per_sm']} blocks "
                  f"x {occ['threads']} threads = {occ['warps_per_sm']} warps per SM")
    # the operations the two batches need, counted by the host build
    t0 = time.perf_counter()
    ops_u, npts_u = ops_per_example_ray(examples.SLAB_ECH_90GHZ)
    ops_d, npts_d = ops_per_example_ray(examples.SLAB_ECH_DAMPED)
    for name, ops, npts in (("slab_rk4", ops_u, npts_u), ("slab_rk4_damped", ops_d, npts_d)):
        steps = sum(npts) - len(npts)
        per_step = {k: round(sum(o[k] for o in ops) / steps, 2) for k in ops[0]}
        print(f"phase 2 operations, {name}: example rays of {npts} points, per ray step "
              f"{per_step} (sum {sum(per_step.values()):.1f})")
    print(f"phase 2 operation count (g++ build and run on the CPU): "
          f"{time.perf_counter() - t0:.1f} s")

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
    require(big64.npoints[:3].tolist() == npts_u, "counted rays stop elsewhere than the batch's")
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

    # phase 5: timing, kernel / plain / kernel, per dtype
    def report_bound(phase, name, ray_ops, n_rays, nv, dt, t_kern):
        bound, by, d = kernel_bound(ray_ops, n_rays, nv, dt)
        expanded = (f"; with exp at {op_rates.EXP_F64_INSTRUCTIONS} operations "
                    f"{d['ms_ops_exp_expanded']:.4f} ms, share "
                    f"{d['ms_ops_exp_expanded'] / t_kern:.4f}"
                    if d.get("exp") and dt == f64 else "")
        print(f"{phase} {name} {n_rays} rays: kernel {t_kern:.3f} ms, bound {bound:.4f} ms by "
              f"{by} ({d['flops']:.4e} operations: {d['div']:.3e} div, {d['sqrt']:.3e} sqrt, "
              f"{d['exp']:.3e} exp; {d['bytes']:.3e} bytes = {d['ms_bytes']:.5f} ms), share of "
              f"bound {bound / t_kern:.4f}{expanded} on {card}")
        return bound, by

    times, bounds, fill = {}, {}, {}
    vf, stf, wf = examples.replicate_rays(v0, st0, pwr, N_FILL)
    for dt, p_, v_, w_ in ((f32, params32, vb32, wb32), (f64, params, vb, wb)):
        t_kern, t_plain, runs = time_plain_and_kernel(fused_slab, cfg_b, p_, v_, stb, w_)
        times[dt] = (t_kern, t_plain)
        name = "f32" if dt == f32 else "f64"
        print(f"phase 5 {name} {N_RAYS} rays x {cfg.nstep_max} steps: kernel "
              f"{t_kern:.3f} ms ({N_RAYS / t_kern * 1e3:.0f} rays/s; runs "
              f"{runs[0]:.3f}, {runs[2]:.3f}), plain {t_plain:.1f} ms "
              f"({N_RAYS / t_plain * 1e3:.0f} rays/s; one run between the kernel's), "
              f"speedup {t_plain / t_kern:.1f}x on {card}")
        bounds[dt] = report_bound("phase 5", name, ops_u, N_RAYS, cfg.nv, dt, t_kern)
        t_fill = time_kernel(fused_slab, cfg_b, p_, vf.to(dt), stf, wf.to(dt))
        print(f"phase 5 {name} {N_FILL} rays x {cfg.nstep_max} steps (card filled): kernel "
              f"{t_fill:.3f} ms ({N_FILL / t_fill * 1e3:.0f} rays/s)")
        report_bound("phase 5", name, ops_u, N_FILL, cfg.nv, dt, t_fill)
        # the filled card's result, which phase 20's largest batch is held to
        res_fill = fused_slab.trace_batch_fused(cfg_b, p_, vf.to(dt), stf, wf.to(dt))
        fill[dt] = (res_fill.end_ray_vec, res_fill.npoints)
    del vf, stf, wf

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

    # phase 7: the damped example through the kernel, 3 rays x 400 steps
    cfg_d, params_d, v0_d, st0_d, pwr_d = examples.setup_example(
        examples.SLAB_ECH_DAMPED, device=dev, dtype=f64)
    require(cfg_d.save_trajectory and fused_slab.supported(cfg_d),
            "the damped example must ride the kernel with save_trajectory on")
    before = fused_slab.LAUNCHES
    dk = trace_rays(cfg_d, params_d, v0_d, st0_d, pwr_d)
    torch.cuda.synchronize()
    require(fused_slab.LAUNCHES > before, "trace_rays did not launch the damped kernel")
    dp = fused_slab.trace_batch_fused_reference(cfg_d, params_d, v0_d, st0_d, pwr_d)
    require(torch.equal(dk.npoints, dp.npoints), "damped npoints differ")
    require(torch.equal(dk.stop_flag, dp.stop_flag), "damped stop flags differ")
    d_err = scaled_err(dk.ray_vec, dp.ray_vec, per_ray_axis=1)
    d_abs = absorb_err(dk.ray_vec, dp.ray_vec)
    absorbed = dk.end_ray_vec[:, 7].tolist()
    require(d_err <= TRAJ_RTOL, f"damped trajectory error {d_err:.3e} > {TRAJ_RTOL}")
    require(d_abs <= ABSORB_ATOL, f"damped absorption error {d_abs:.3e} > {ABSORB_ATOL}")
    require(max(absorbed) > 1e-3, f"no ray absorbed more than 1e-3: {absorbed}")
    print(f"phase 7 damped example f64 (nv {cfg_d.nv}): npoints {dk.npoints.tolist()} "
          f"flags {[flag_string(c) for c in dk.stop_flag.tolist()]} absorbed "
          f"{[f'{a:.6f}' for a in absorbed]}; kernel vs plain trajectory err "
          f"{d_err:.3e} of scale, absorption err {d_abs:.3e}")

    # phase 8: the damped batch, 32,768 rays x 400 steps, summaries only
    cfg_db = dataclasses.replace(cfg_d, save_trajectory=False)
    vd, std, wd = examples.replicate_rays(v0_d, st0_d, pwr_d, N_RAYS)
    fused_slab.LAUNCHES = 0
    db64 = trace_rays(cfg_db, params_d, vd, std, wd)
    torch.cuda.synchronize()
    damped_launches = fused_slab.LAUNCHES
    require(damped_launches >= 1, "the damped batch did not launch the kernel")
    dplain = fused_slab.trace_batch_fused_reference(cfg_db, params_d, vd, std, wd)
    require(torch.equal(db64.npoints, dplain.npoints), "damped f64 npoints differ")
    require(torch.equal(db64.stop_flag, dplain.stop_flag), "damped f64 flags differ")
    db_err = scaled_err(db64.end_ray_vec, dplain.end_ray_vec, per_ray_axis=-1)
    db_abs = absorb_err(db64.end_ray_vec, dplain.end_ray_vec)
    db_max_abs = float((db64.end_ray_vec - dplain.end_ray_vec).abs().max())
    require(db_err <= TRAJ_RTOL, f"damped f64 endpoint error {db_err:.3e} > {TRAJ_RTOL}")
    require(db_abs <= ABSORB_ATOL, f"damped f64 absorption error {db_abs:.3e}")
    params_d32 = tree_to(params_d, dtype=f32)
    vd32, wd32 = vd.to(f32), wd.to(f32)
    db32 = fused_slab.trace_batch_fused(cfg_db, params_d32, vd32, std, wd32)
    torch.cuda.synchronize()
    require(torch.equal(db32.npoints, dplain.npoints), "damped f32 npoints differ from f64")
    require(torch.equal(db32.stop_flag, dplain.stop_flag), "damped f32 flags differ from f64")
    db32_err = scaled_err(db32.end_ray_vec, dplain.end_ray_vec, per_ray_axis=-1)
    db32_abs = float((db32.end_ray_vec[:, 7].double() - dplain.end_ray_vec[:, 7]).abs().max())
    require(db32_err <= F32_RTOL, f"damped f32 endpoint error {db32_err:.3e} > {F32_RTOL}")
    require(db32_abs <= F32_ABSORB_ATOL,
            f"damped f32 absorption error {db32_abs:.3e} > {F32_ABSORB_ATOL}")
    print(f"phase 8 damped {N_RAYS} rays x {cfg_d.nstep_max} steps: launches "
          f"{damped_launches}; f64 kernel vs plain endpoint err {db_err:.3e} of scale, "
          f"absorption err {db_abs:.3e}; f32 kernel vs f64 plain {db32_err:.3e} of "
          f"scale, absorption err {db32_abs:.3e}; npoints "
          f"{sorted(set(db64.npoints.tolist()))}")
    require(db64.npoints[:3].tolist() == npts_d,
            "counted damped rays stop elsewhere than the batch's")
    damped_times, damped_bounds = {}, {}
    vf, stf, wf = examples.replicate_rays(v0_d, st0_d, pwr_d, N_FILL)
    for dt, p_, v_, w_ in ((f32, params_d32, vd32, wd32), (f64, params_d, vd, wd)):
        t_kern, t_plain, runs = time_plain_and_kernel(fused_slab, cfg_db, p_, v_, std, w_)
        damped_times[dt] = (t_kern, t_plain)
        name = "f32" if dt == f32 else "f64"
        print(f"phase 8 damped {name} {N_RAYS} rays x {cfg_d.nstep_max} steps: kernel "
              f"{t_kern:.3f} ms ({N_RAYS / t_kern * 1e3:.0f} rays/s; runs "
              f"{runs[0]:.3f}, {runs[2]:.3f}), plain {t_plain:.1f} ms "
              f"({N_RAYS / t_plain * 1e3:.0f} rays/s; one run between the kernel's), "
              f"speedup {t_plain / t_kern:.1f}x on {card}")
        damped_bounds[dt] = report_bound("phase 8 damped", name, ops_d, N_RAYS, cfg_d.nv, dt,
                                         t_kern)
        t_fill = time_kernel(fused_slab, cfg_db, p_, vf.to(dt), stf, wf.to(dt))
        print(f"phase 8 damped {name} {N_FILL} rays x {cfg_d.nstep_max} steps (card filled): "
              f"kernel {t_fill:.3f} ms ({N_FILL / t_fill * 1e3:.0f} rays/s)")
        report_bound("phase 8 damped", name, ops_d, N_FILL, cfg_d.nv, dt, t_fill)
    del vf, stf, wf
    return {"slab_rk4": (main_launches, abs64, times[f64], bounds[f64]),
            "slab_rk4_damped": (damped_launches, db_max_abs, damped_times[f64],
                                damped_bounds[f64]),
            "big64_end": big64.end_ray_vec, "fill": fill}


def training_phase(run, steps=TRAIN_STEPS):
    """Phase 9: the training step of __graft_entry__.py on one GPU at
    ``steps`` steps through the graphed adjoint, timed at its second call
    (the first captures it), and its directional derivative."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.post.deposition import calculate_deposition_profile
    from rays_tpu_torch.tracing import fused_slab, graphed_adjoint
    from rays_tpu_torch.tracing.stop import StopCode
    from rays_tpu_torch.tracing.trace import route, trace_rays

    dev, f64 = run.dev, torch.float64
    cfg_d, params_d, v0_d, st0_d, pwr_d = examples.setup_example(
        examples.SLAB_ECH_DAMPED, device=dev, dtype=f64)
    vd, std, wd = examples.replicate_rays(v0_d, st0_d, pwr_d, N_RAYS)
    # the rays are absorbed at 293-329 points: a run cut below that ends on
    # the step budget, and no ray reaches TOTAL_ABSORPTION
    require(cfg_d.nstep_max == TRAIN_STEPS, "the damped example changed")
    cfg_t = dataclasses.replace(cfg_d, nstep_max=steps)
    xmin, xmax = float(params_d.eq.xmin), float(params_d.eq.xmax)

    def loss_of(res, p):
        prof = calculate_deposition_profile(cfg_t, p, res, "Ptotal_x", n_bins=N_BINS,
                                            xmin=xmin, xmax=xmax)
        return ((res.end_ray_vec[:, 0:3] ** 2 * res.initial_ray_power[:, None]).sum()
                + (prof.profile ** 2).sum())

    def with_grad(p):
        return tree_map(lambda t: t.detach().clone().requires_grad_(True), p)

    def train_step(v, st, w):
        """(loss, grads, forward ms, backward ms, peak bytes, stop flags)
        through trace_rays with gradients."""
        pg = with_grad(params_d)
        leaves = tree_leaves(pg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = trace_rays(cfg_t, pg, v, st, w)
        loss = loss_of(res, pg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (loss.detach(), grads, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                torch.cuda.max_memory_allocated(), res.stop_flag)

    def kernel_loss(p, v, st, w):
        before = fused_slab.LAUNCHES
        with torch.no_grad():
            res = trace_rays(cfg_t, p, v, st, w)
            out = loss_of(res, p)
        require(fused_slab.LAUNCHES > before, "the kernel forward did not launch the kernel")
        return out, res

    which = route(cfg_t, True, dev)
    require(which == "adjoint", f"the training step takes route {which}, not the adjoint graph")
    c0 = graphed_adjoint.CAPTURES
    first_ms = sum(train_step(vd, std, wd)[2:4])     # with the capture
    loss9, grads9, fwd_ms, bwd_ms, peak, flags9 = train_step(vd, std, wd)
    require(graphed_adjoint.CAPTURES - c0 == 1, "the training step was not captured once")
    n_leaves = len(grads9)
    bad = [i for i, g in enumerate(grads9) if not bool(torch.isfinite(g).all())]
    require(not bad, f"non-finite gradients in leaves {bad}")
    absorbed = int((flags9 == StopCode.TOTAL_ABSORPTION).sum())
    require(absorbed > 0 or steps < TRAIN_STEPS, "no ray reached TOTAL_ABSORPTION")
    lossk, _ = kernel_loss(params_d, vd, std, wd)
    loss_rel = abs(float(lossk) - float(loss9)) / abs(float(loss9))
    require(loss_rel <= LOSS_RTOL,
            f"kernel-forward loss {float(lossk)!r} vs autograd {float(loss9)!r}: {loss_rel:.3e}")
    print(f"phase 9 training step {N_RAYS} rays x {steps} steps f64 (trajectories on, {N_BINS} "
          f"bins), route {which}: loss {float(loss9):.12e}, forward {fwd_ms:.1f} ms, backward "
          f"{bwd_ms:.1f} ms (first call, with the capture, {first_ms:.1f} ms in all), peak "
          f"memory {peak / 2**30:.2f} GiB; {absorbed} rays end with TOTAL_ABSORPTION; "
          f"{n_leaves} leaf gradients all finite; kernel-forward loss rel diff {loss_rel:.3e} "
          f"(bound {LOSS_RTOL}) on {run.card}")
    run.paths.append({"name": "training_step_f64", "route": which, "ms": fwd_ms + bwd_ms,
                      "forward_ms": fwd_ms, "backward_ms": bwd_ms, "first_ms": first_ms,
                      "steps": steps, "peak_gib": peak / 2**30})
    del grads9

    # the directional derivative on the 3 example rays against a central
    # difference through the kernel; ode and limits are held fixed
    loss3, grads3, _, _, _, _ = train_step(v0_d, st0_d, pwr_d)
    rng = np.random.default_rng(2)

    def direction(sub, physics):
        """N(0, 1) times each element's magnitude; zero off the physics."""
        if not physics:
            return tree_map(torch.zeros_like, sub)
        return tree_map(lambda t: t.abs() * torch.as_tensor(
            rng.standard_normal(tuple(t.shape)), dtype=f64, device=dev), sub)

    dirs = type(params_d)(*(direction(sub, name in ("species", "rf", "eq"))
                            for name, sub in zip(params_d._fields, params_d)))
    dd_ad = sum(float((g * d).sum()) for g, d in zip(grads3, tree_leaves(dirs)))
    shifted = {sgn: kernel_loss(tree_map(lambda p, d: p + sgn * FD_EPS * d, params_d, dirs),
                                v0_d, st0_d, pwr_d)
               for sgn in (1.0, -1.0)}
    (lp, rp), (lm, rm) = shifted[1.0], shifted[-1.0]
    require(torch.equal(rp.npoints, rm.npoints) and torch.equal(rp.stop_flag, rm.stop_flag),
            "npoints or flags differ between the +eps and -eps runs")
    fd = (float(lp) - float(lm)) / (2 * FD_EPS)
    fd_rel = abs(dd_ad - fd) / abs(fd)
    require(fd_rel <= FD_RTOL, f"directional derivative {dd_ad!r} vs FD {fd!r}: {fd_rel:.3e}")
    print(f"phase 9 gradient check, 3 rays x {cfg_t.nstep_max} steps: loss "
          f"{float(loss3):.12e}, directional derivative {dd_ad:.10e} vs central "
          f"difference {fd:.10e} (eps {FD_EPS} of each leaf), rel diff {fd_rel:.3e} "
          f"(bound {FD_RTOL}); npoints at +-eps {rp.npoints.tolist()}")


def plain_phases(run, big64_end=None):
    """Phases 10-12: the Solovev example, its CLI, the Solovev fan and the
    slab under the adaptive stepper, plain PyTorch on the card.
    ``big64_end`` is the RK4 kernel's f64 batch of phase 4, when it ran."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.results.netcdf import read_results_nc
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.tracing.stop import flag_string
    from rays_tpu_torch.tracing.trace import trace_rays

    from rays_tpu_torch.results.ascii import read_results_ld

    card, dev, paths = run.card, run.dev, run.paths
    f64, f32 = torch.float64, torch.float32

    # phase 10: the Solovev example, 5 rays x 200 outer steps, SG_ODE, f64
    cfg_s, params_s, v0_s, st0_s, pwr_s = examples.setup_example(
        examples.SOLOVEV_ECH_90GHZ, device=dev, dtype=f64)
    require(cfg_s.ode_solver_name == "SG_ODE" and cfg_s.save_trajectory
            and cfg_s.nstep_max == 200, "the Solovev example changed")
    require(not fused_slab.supported(cfg_s), "the gate must refuse the Solovev example")
    sol, sol_ms, sol_tot, _ = graph_run(cfg_s, params_s, v0_s, st0_s, pwr_s)
    host = trace_rays(*examples.setup_example(examples.SOLOVEV_ECH_90GHZ, device="cpu",
                                              dtype=f64))
    require(torch.equal(sol.npoints.cpu(), host.npoints), "Solovev npoints: card != CPU")
    require(torch.equal(sol.stop_flag.cpu(), host.stop_flag), "Solovev flags: card != CPU")
    sol_err = scaled_err(sol.ray_vec.cpu(), host.ray_vec, per_ray_axis=1)
    sol_res = float(sol.max_residuals.max())
    sol_npts = sol.npoints.tolist()
    sol_flags = [flag_string(c) for c in sol.stop_flag.tolist()]
    require(min(sol_npts) > SOLOVEV_MIN_POINTS, f"Solovev npoints {sol_npts}")
    require(sol_res < SOLOVEV_RESID_MAX, f"Solovev max residual {sol_res:.3e}")
    require(sol_err <= HOST_RTOL, f"Solovev card vs CPU {sol_err:.3e} > {HOST_RTOL}")
    print(f"phase 10 Solovev example f64, SG_ODE, route graph: npoints {sol_npts} flags "
          f"{sol_flags} max residual {sol_res:.3e}; card vs CPU trajectory err "
          f"{sol_err:.3e} of scale (bound {HOST_RTOL}); {sol_ms:.1f} ms; "
          f"{substep_report(sol_tot, len(sol_npts), cfg_s.nstep_max)}")

    # phase 11: the CLI as a user calls it (python -m, the default device) on
    # the Solovev namelist, in a temporary directory
    label = cfg_s.run_label
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "solovev_ECH_90GHz.in")
        with open(path, "w") as f:
            f.write(examples.SOLOVEV_ECH_90GHZ
                    + "&ray_results_list\n write_results_list_directed=.true.\n/\n")
        run_cli(path, tmp)
        nc = read_results_nc(os.path.join(tmp, f"run_results.{label}.nc"))
        ld = read_results_ld(os.path.join(tmp, f"run_results.{label}"))
        with open(os.path.join(tmp, f"log.RAYS.{label}")) as f:
            log = f.read()
    require(nc["npoints"].tolist() == sol_npts, f"CLI netCDF npoints {nc['npoints']}")
    require(ld["npoints"].tolist() == sol_npts, f"CLI list-directed npoints {ld['npoints']}")
    require(nc["ray_vec"].shape == ld["ray_vec"].shape == (len(sol_npts), max(sol_npts), 7),
            "CLI ray_vec shape")
    require(float(np.abs(ld["ray_vec"] - sol.ray_vec.cpu().numpy()).max()) <= 1e-6
            * float(sol.ray_vec.abs().max()), "CLI trajectories differ from phase 10's")
    require("number of rays = 5" in log and "Wall time total" in log, "the run log is short")
    print(f"phase 11 Solovev CLI: run_results.{label}.nc, run_results.{label} and "
          f"log.RAYS.{label} ({len(log.splitlines())} lines) read back, npoints "
          f"{nc['npoints'].tolist()}")

    # phase 12 (a): the Solovev fan at 32,768 rays x 200 outer steps, f64
    cfg_sb = dataclasses.replace(cfg_s, save_trajectory=False)
    vs, sts, ws = examples.replicate_rays(v0_s, st0_s, pwr_s, N_RAYS)
    graph_run(dataclasses.replace(cfg_sb, nstep_max=3), params_s, vs, sts, ws)   # warm-up
    sb, sb_ms, sb_tot, sb_peak = graph_run(cfg_sb, params_s, vs, sts, ws)
    n5 = len(sol_npts)
    require(sb.npoints[:n5].tolist() == sol_npts
            and sb.stop_flag[:n5].tolist() == sol.stop_flag.tolist(),
            "the batch's first rays stop elsewhere than the example's")
    # the jitter in y turns the launch frame by up to 3e-6 without solving
    # for k again, and the residual starts that far from its floor
    require(float(sb.max_residuals.max()) < 10 * SOLOVEV_RESID_MAX, "Solovev batch residual")
    print(f"phase 12 Solovev SG f64 {N_RAYS} rays x {cfg_s.nstep_max} outer steps: "
          f"{sb_ms:.1f} ms ({N_RAYS / sb_ms * 1e3:.0f} rays/s), "
          f"{substep_report(sb_tot, N_RAYS, cfg_s.nstep_max)}; peak memory "
          f"{sb_peak / 2**30:.3f} GiB; npoints {sorted(set(sb.npoints.tolist()))} flags "
          f"{flag_counts(sb)} max residual {float(sb.max_residuals.max()):.3e} on {card}")
    paths.append({"name": "solovev_sg_f64", "route": "graph", "ms": sb_ms,
                  "rays_per_s": N_RAYS / sb_ms * 1e3})
    # float32 on the fan: under fixed-step RK4, as tests/test_precision.py
    # holds it (the example's tolerance 1e-7 is below float32's resolution)
    cfg_sr = dataclasses.replace(cfg_sb, ode_solver_name="RK4_ODE")
    params_s32 = tree_to(params_s, dtype=f32)
    sr64, sr64_ms, _, _ = graph_run(cfg_sr, params_s, vs, sts, ws)
    sr32, sr32_ms, _, _ = graph_run(cfg_sr, params_s32, vs.to(f32), sts, ws.to(f32))
    require(torch.equal(sr32.npoints, sr64.npoints) and torch.equal(sr32.stop_flag, sr64.stop_flag),
            "Solovev RK4 f32 npoints or flags differ from f64")
    ex, ek = group_err(sr32.end_ray_vec, sr64.end_ray_vec)
    require(ex <= F32_RTOL_SOLOVEV[0] and ek <= F32_RTOL_SOLOVEV[1],
            f"Solovev RK4 f32 vs f64: positions {ex:.3e}, k {ek:.3e}")
    # the adaptive against the fixed-step result, on the rays both traced to the end
    whole = (sb.npoints == cfg_s.nstep_max + 1) & (sr64.npoints == cfg_s.nstep_max + 1)
    sg_rk = group_err(sb.end_ray_vec[whole], sr64.end_ray_vec[whole])
    print(f"phase 12 Solovev RK4 {N_RAYS} rays x {cfg_s.nstep_max} steps: f64 {sr64_ms:.1f} ms, "
          f"f32 {sr32_ms:.1f} ms; f32 vs f64 endpoints {ex:.3e} (positions), {ek:.3e} (k) of "
          f"scale (bounds {F32_RTOL_SOLOVEV}); SG f64 vs RK4 f64 on the {int(whole.sum())} rays both "
          f"trace to the end {sg_rk[0]:.3e}, {sg_rk[1]:.3e}")
    paths.append({"name": "solovev_rk4_f64", "route": "graph", "ms": sr64_ms,
                  "rays_per_s": N_RAYS / sr64_ms * 1e3})
    paths.append({"name": "solovev_rk4_f32", "route": "graph", "ms": sr32_ms,
                  "rays_per_s": N_RAYS / sr32_ms * 1e3})
    del sb, sr64, sr32, vs, sts, ws

    # phase 12 (b): the slab under SG_ODE, 32,768 rays x 500 outer steps
    # (bench.py's bench_sg_adaptive), f64 and f32
    (cfg_g, params_g, v0_g, st0_g, pwr_g), (cfg_gb, vg, stg, wg) = slab_sg_case(dev)
    ex_g, _, _, _ = graph_run(cfg_g, params_g, v0_g, st0_g, pwr_g)
    params_g32 = tree_to(params_g, dtype=f32)
    slab_sg = {}
    for dt, p_, v_, w_ in ((f64, params_g, vg, wg), (f32, params_g32, vg.to(f32), wg.to(f32))):
        name = "f32" if dt == f32 else "f64"
        res, ms, tot, peak = graph_run(cfg_gb, p_, v_, stg, w_)
        slab_sg[dt] = res
        require(res.npoints[:3].tolist() == ex_g.npoints.tolist()
                and res.stop_flag[:3].tolist() == ex_g.stop_flag.tolist(),
                f"slab SG {name}: the batch's first rays stop elsewhere than the example's")
        print(f"phase 12 slab SG {name} {N_RAYS} rays x {cfg_g.nstep_max} outer steps: "
              f"{ms:.1f} ms ({N_RAYS / ms * 1e3:.0f} rays/s), "
              f"{substep_report(tot, N_RAYS, cfg_g.nstep_max)}; peak memory "
              f"{peak / 2**30:.3f} GiB; npoints {sorted(set(res.npoints.tolist()))} max "
              f"residual {float(res.max_residuals.max()):.3e} on {card}")
        paths.append({"name": f"slab_sg_{name}", "route": "graph", "ms": ms,
                      "rays_per_s": N_RAYS / ms * 1e3})
    require(torch.equal(slab_sg[f32].npoints, slab_sg[f64].npoints), "slab SG f32 npoints")
    ex, ek = group_err(slab_sg[f32].end_ray_vec, slab_sg[f64].end_ray_vec)
    require(ex <= SG_F32_RTOL_SLAB[0] and ek <= SG_F32_RTOL_SLAB[1],
            f"slab SG f32 vs f64: positions {ex:.3e}, k {ek:.3e}")
    vs_rk4 = "not run (no kernel group in this call)"
    if big64_end is not None:
        sg_k = group_err(slab_sg[f64].end_ray_vec, big64_end)
        vs_rk4 = f"{sg_k[0]:.3e}, {sg_k[1]:.3e} (tolerance 1e-4 requested)"
    print(f"phase 12 slab SG f32 vs f64 endpoints {ex:.3e} (positions), {ek:.3e} (k) of scale "
          f"(bounds {SG_F32_RTOL_SLAB}); SG f64 vs the RK4 kernel's f64 {vs_rk4}")
    del slab_sg


def sg_training_phase(run, steps=SG_ADJOINT_STEPS):
    """Phase 13: the adaptive training step (bench.py's SG adjoint) at
    ``steps`` outer steps through the graphed adjoint, timed at its second
    call (the first captures it), and its directional derivative."""
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.tracing import graphed_adjoint
    from rays_tpu_torch.tracing.trace import route, trace_rays

    card, dev, paths = run.card, run.dev, run.paths
    f64 = torch.float64
    (cfg_g, params_g, v0_g, st0_g, pwr_g), (cfg_gb, vg, stg, wg) = slab_sg_case(dev)
    # the fixed budget of 2 masked substeps, forward and backward, f64
    cfg_a = dataclasses.replace(cfg_gb, sg_scan_substeps=2, nstep_max=steps)

    def sg_loss(res):
        return (res.end_ray_vec[:, 0:3] ** 2 * res.initial_ray_power[:, None]).sum()

    def sg_train_step(cfg_, v, st, w):
        pg = tree_map(lambda t: t.detach().clone().requires_grad_(True), params_g)
        require(route(cfg_, True, v.device) == "adjoint", "the adjoint takes the adjoint graph")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = trace_rays(cfg_, pg, v, st, w)
        loss = sg_loss(res)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, tree_leaves(pg), allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (loss.detach(), res, grads, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                torch.cuda.max_memory_allocated())

    c0 = graphed_adjoint.CAPTURES
    first_ms = sum(sg_train_step(cfg_a, vg, stg, wg)[3:5])     # with the capture
    loss_a, res_a, grads_a, fwd_a, bwd_a, peak_a = sg_train_step(cfg_a, vg, stg, wg)
    require(graphed_adjoint.CAPTURES - c0 == 1, "the SG training step was not captured once")
    require(int(res_a.npoints.min()) == steps + 1 == int(res_a.npoints.max()),
            "the budget of 2 substeps did not suffice")
    bad = [i for i, g in enumerate(grads_a) if not bool(torch.isfinite(g).all())]
    require(not bad, f"non-finite SG gradients in leaves {bad}")
    print(f"phase 13 SG training step {N_RAYS} rays x {steps} outer steps f64 (sg_scan_substeps "
          f"2, summaries only), route adjoint: loss {float(loss_a):.12e}, forward {fwd_a:.1f} "
          f"ms, backward {bwd_a:.1f} ms (first call, with the capture, {first_ms:.1f} ms in "
          f"all), peak memory {peak_a / 2**30:.2f} GiB; {len(grads_a)} leaf gradients all "
          f"finite on {card}")
    paths.append({"name": "slab_sg_training_step_f64", "route": "adjoint", "ms": fwd_a + bwd_a,
                  "forward_ms": fwd_a, "backward_ms": bwd_a, "first_ms": first_ms,
                  "peak_gib": peak_a / 2**30, "outer_steps": steps,
                  "rays_per_s": N_RAYS / (fwd_a + bwd_a) * 1e3})
    del res_a, grads_a

    cfg_f = dataclasses.replace(cfg_a, nstep_max=SG_FD_STEPS)
    loss_f, _, grads_f, _, _, _ = sg_train_step(cfg_f, v0_g, st0_g, pwr_g)
    rng = np.random.default_rng(3)
    dirs_g = type(params_g)(*(tree_map(
        (lambda t: t.abs() * torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=f64,
                                             device=dev))
        if name in ("species", "rf", "eq") else torch.zeros_like, sub)
        for name, sub in zip(params_g._fields, params_g)))
    dd_sg = sum(float((g * d).sum()) for g, d in zip(grads_f, tree_leaves(dirs_g)))
    fd_runs = {}
    for sgn in (1.0, -1.0):
        p_ = tree_map(lambda p, d: p + sgn * FD_EPS * d, params_g, dirs_g)
        with torch.no_grad():
            r_ = trace_rays(cfg_f, p_, v0_g, st0_g, pwr_g)
        fd_runs[sgn] = (float(sg_loss(r_)), r_.npoints.tolist())
    require(fd_runs[1.0][1] == fd_runs[-1.0][1] == [SG_FD_STEPS + 1] * 3,
            f"npoints at +-eps {fd_runs[1.0][1]} {fd_runs[-1.0][1]}")
    fd_sg = (fd_runs[1.0][0] - fd_runs[-1.0][0]) / (2 * FD_EPS)
    fd_sg_rel = abs(dd_sg - fd_sg) / abs(fd_sg)
    require(fd_sg_rel <= FD_RTOL,
            f"SG directional derivative {dd_sg!r} vs FD {fd_sg!r}: {fd_sg_rel:.3e}")
    print(f"phase 13 SG gradient check, 3 rays x {SG_FD_STEPS} outer steps: loss "
          f"{float(loss_f):.12e}, directional derivative {dd_sg:.10e} vs central difference "
          f"{fd_sg:.10e} (eps {FD_EPS} of each leaf), rel diff {fd_sg_rel:.3e} (bound {FD_RTOL})")


def graph_phase(run):
    """Phase 29: every path of the graph route against its eager twin on
    the card, at GRAPH_RAYS rays x GRAPH_STEPS steps with trajectories:
    trace_rays (captured at the first call, replayed at the second, the
    inputs copied in each time) bit for bit equal to trace_batch on every
    RayResults field; captures and replays counted, the capture timed."""
    from rays_tpu_torch.tracing import fused_slab, graphed, rk45
    from rays_tpu_torch.tracing.trace import RayResults, route, trace_batch, trace_rays

    card, dev = run.card, run.dev
    sp = _tool("step_profile")
    with tempfile.TemporaryDirectory() as tmp:
        cases = sp.graph_cases(dev, GRAPH_RAYS, tmp)
    t_phase = time.perf_counter()
    for name, (cfg, params, v, st, w) in cases.items():
        cfg = dataclasses.replace(cfg, nstep_max=GRAPH_STEPS)
        require(route(cfg, False, dev) == "graph" and not fused_slab.supported(cfg),
                f"{name}: expected the graph route")
        with torch.no_grad():
            trace_batch(dataclasses.replace(cfg, nstep_max=2), params, v, st, w)  # warm-up
            eager_ms, ref = timed(lambda: trace_batch(cfg, params, v, st, w))
            c0, r0, l0 = graphed.CAPTURES, graphed.REPLAYS, fused_slab.LAUNCHES
            first_ms, first = timed(lambda: trace_rays(cfg, params, v, st, w))
            c1, r1 = graphed.CAPTURES, graphed.REPLAYS
            second_ms, second = timed(lambda: trace_rays(cfg, params, v, st, w))
        require(c1 - c0 == 1 and graphed.CAPTURES == c1,
                f"{name}: {graphed.CAPTURES - c0} captures in two calls")
        require(fused_slab.LAUNCHES == l0, f"{name}: the graph route launched B1")
        loop_form = cfg.ode_solver_name == "SG_ODE" and cfg.sg_scan_substeps == 0
        per_call = (r1 - r0, graphed.REPLAYS - r1)
        require(per_call[0] == per_call[1] and (
            per_call[0] >= 2 * GRAPH_STEPS if loop_form else per_call[0] == GRAPH_STEPS),
            f"{name}: replays per call {per_call}")
        for tag, got in (("first", first), ("second", second)):
            bad = [f for f, g, r in zip(RayResults._fields, got, ref)
                   if (g is None) != (r is None) or (r is not None and not torch.equal(g, r))]
            require(not bad, f"{name} {tag} call: fields {bad} differ from trace_batch's")
        print(f"phase 29 {name} {GRAPH_RAYS} rays x {GRAPH_STEPS} steps "
              f"{str(v.dtype).replace('torch.', '')}: graphed equal to trace_batch bit for bit on "
              f"every field, both calls; 1 capture, {per_call[0]} replays a call; eager "
              f"{eager_ms:.1f} ms, graphed {second_ms:.1f} ms (x{eager_ms / second_ms:.2f}), first "
              f"call {first_ms:.1f} ms (capture {first_ms - second_ms:.1f} ms); npoints "
              f"{sorted(set(ref.npoints.tolist()))[:4]}")
        run.paths.append({"name": f"graph_{name}", "route": "graph", "ms": second_ms,
                          "eager_ms": eager_ms, "capture_ms": first_ms - second_ms,
                          "replays": per_call[0]})
    require(rk45.stats is None, "the substep counts were left on")
    print(f"phase 29 {len(cases)} graphed paths bit-equal to their eager twins in "
          f"{time.perf_counter() - t_phase:.1f} s; graphed.CAPTURES {graphed.CAPTURES}, "
          f"graphed.REPLAYS {graphed.REPLAYS} in this process; cache of "
          f"{graphed.CACHE_SIZE}, {graphed.CHUNK} substep pass per read on {card}")


def adjoint_phase(run, full):
    """Phase 30: every configuration of the graphed adjoint against eager
    autograd through trace_batch on the card, at ADJOINT_RAYS rays x
    ADJOINT_STEPS steps with trajectories: a loss that reads every floating
    RayResults field (weights from a numpy seed) through trace_rays
    (captured at the first call, replayed at the second) and through
    trace_batch; the forward bit for bit, the loss bit for bit, every
    gradient (floating Params leaves, v0, pwr_wt) within ADJOINT_RTOL
    (ADJOINT_RTOL_F32 in float32) of the leaf's largest eager gradient.
    The slab kernels' configs (slab_vjp.takes) run B1's arithmetic forward:
    their counts and stops equal, the rest within SLAB_RTOL, the loss within
    LOSS_RTOL and the gradients within ADJOINT_RTOL as every other config's.
    The EQDSK spline toroid's (eqdsk_step.takes) runs here with the generic
    pieces (GenericAdjoint), bit for bit; phase 38 holds its step kernel to
    them.  ``full``: every config at that size, else those of
    ADJOINT_CUT_DEFAULT at their cut rays and steps (the line says so)."""
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.tracing import eqdsk_step, fused_slab, graphed_adjoint, slab_vjp
    from rays_tpu_torch.tracing.trace import RayResults, route, trace_batch, trace_rays

    card, dev = run.card, run.dev
    sp = _tool("step_profile")
    with tempfile.TemporaryDirectory() as tmp:
        cases = sp.adjoint_cases(dev, ADJOINT_RAYS, tmp)

    def loss_and_grads(tracer, cfg, params, v, st, w):
        """(loss, results, gradients, ms, peak bytes) on the host clock."""
        p = tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)
        v, w = v.clone().requires_grad_(True), w.clone().requires_grad_(True)
        leaves = [t for t in tree_leaves(p) if t.is_floating_point()] + [v, w]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = tracer(cfg, p, v, st, w)
        rng = np.random.default_rng(30)
        loss = sum((t * torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=t.dtype,
                                        device=dev)).sum()
                   for t in res if t is not None and t.is_floating_point())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()
        return (loss.detach(), res, grads, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated())

    t_phase = time.perf_counter()
    for name, (cfg, params, v, st, w) in cases.items():
        rays, steps, cut = ADJOINT_RAYS, ADJOINT_STEPS, ""
        if name in ADJOINT_CUT_DEFAULT:
            cut_rays, cut_steps = ADJOINT_CUT_DEFAULT[name]
            rays, rays_cut = _cut(full, ADJOINT_RAYS, cut_rays, "rays", "adjoint")
            steps, steps_cut = _cut(full, ADJOINT_STEPS, cut_steps, "steps", "adjoint")
            cut = rays_cut + steps_cut
            v, st, w = v[:rays], st[:rays], w[:rays]
        cfg = dataclasses.replace(cfg, nstep_max=steps)
        which = route(cfg, True, dev)
        require(which == "adjoint", f"{name}: route {which}, not the adjoint graph")
        loss_and_grads(trace_batch, dataclasses.replace(cfg, nstep_max=2), params, v, st, w)
        ref_loss, ref, ref_grads, eager_ms, eager_peak = loss_and_grads(
            trace_batch, cfg, params, v, st, w)
        eqdsk = eqdsk_step.takes(cfg, params, dev)
        tracer = GenericAdjoint() if eqdsk else trace_rays

        def captures():
            return graphed_adjoint.CAPTURES + getattr(tracer, "captures", 0)

        c0, r0, l0 = captures(), graphed_adjoint.REPLAYS, fused_slab.LAUNCHES
        first_ms = loss_and_grads(tracer, cfg, params, v, st, w)[3]
        c1, r1 = captures(), graphed_adjoint.REPLAYS
        loss, got, grads, graphed_ms, peak = loss_and_grads(tracer, cfg, params, v, st, w)
        if eqdsk:
            tracer.release()
        per_call = (r1 - r0, graphed_adjoint.REPLAYS - r1)
        require(c1 - c0 == 1 and captures() == c1,
                f"{name}: {captures() - c0} captures in two calls")
        require(per_call == (2 * steps,) * 2, f"{name}: replays per call {per_call}")
        require(fused_slab.LAUNCHES == l0, f"{name}: the adjoint launched B1")
        # the slab kernels' configs: the forward is B1's arithmetic, equal
        # counts and stops, the rest at rounding level (SLAB_RTOL of each
        # field's scale, the residuals as tests/test_torch_kernel_host.py)
        kernels = slab_vjp.takes(cfg, dev)

        def same_field(f, g, r):
            if not kernels or not r.is_floating_point():
                return torch.equal(g, r)
            if f in ("residual", "end_residuals", "max_residuals"):
                return torch.allclose(g, r, rtol=1e-6, atol=1e-12)
            return float((g - r).abs().max()) <= SLAB_RTOL * float(r.abs().max())

        bad = [f for f, g, r in zip(RayResults._fields, got, ref)
               if (g is None) != (r is None) or (r is not None and not same_field(f, g, r))]
        require(not bad, f"{name}: forward fields {bad} differ from trace_batch's")
        require(torch.equal(loss, ref_loss) or (
            kernels and abs(float(loss - ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))),
            f"{name}: loss {float(loss)!r} vs {float(ref_loss)!r}")
        worst, same = 0.0, 0
        rtol = ADJOINT_RTOL if v.dtype == torch.float64 else ADJOINT_RTOL_F32
        for i, (g, r) in enumerate(zip(grads, ref_grads)):
            scale = float(r.abs().max()) if r.numel() else 0.0
            err = float((g - r).abs().max()) if r.numel() else 0.0
            require(bool(torch.isfinite(g).all()) and err <= rtol * scale,
                    f"{name}: gradient {i} differs by {err:.3e} of scale {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
            same += bool(torch.equal(g, r))
        how = ("at rounding level (the slab kernels)" if kernels else
               "bit for bit (the generic pieces; the step kernel: phase 38)" if eqdsk else
               "bit for bit")
        print(f"phase 30 {name} {rays} rays x {steps} steps{cut} "
              f"{str(v.dtype).replace('torch.', '')}, route {which}: forward and loss equal to "
              f"trace_batch's {how}; {len(grads)} gradients within {worst:.3e} of scale "
              f"(bound {rtol}), {same} bit-equal; 1 capture, {per_call[0]} replays a "
              f"call; eager {eager_ms:.1f} ms, graphed {graphed_ms:.1f} ms "
              f"(x{eager_ms / graphed_ms:.2f}), first call {first_ms:.1f} ms; peak "
              f"{peak / 2**30:.2f} GiB graphed, {eager_peak / 2**30:.2f} GiB eager")
        run.paths.append({"name": f"adjoint_{name}", "route": which, "rays": rays,
                          "steps": steps, "ms": graphed_ms,
                          "eager_ms": eager_ms, "first_ms": first_ms, "peak_gib": peak / 2**30,
                          "eager_peak_gib": eager_peak / 2**30, "worst_grad_rel": worst,
                          "bit_equal_grads": same, "grads": len(grads)})
    print(f"phase 30 {len(cases)} graphed adjoints held to eager autograd in "
          f"{time.perf_counter() - t_phase:.1f} s; graphed_adjoint.CAPTURES "
          f"{graphed_adjoint.CAPTURES}, REPLAYS {graphed_adjoint.REPLAYS} in this process on "
          f"{card}")


def slab_vjp_phase(run, rays=None, steps=None):
    """Phase 36: the hand-written VJP of the slab step (tracing/slab_vjp.py,
    csrc/slab_rk4_vjp.cu) as the adjoint graph's backward piece, at the
    benchmark cell's shapes (SLAB_VJP_RAYS rays x SLAB_VJP_STEPS steps of
    the deck's slab, float64, summaries only): the endpoint loss of the
    cell and its gradient in every floating Params leaf through trace_rays
    (the kernel's piece, by the gate) against the same adjoint graph with
    the generic piece (a StaticAdjoint whose kernel side is taken off,
    captured and replayed alike), every gradient within SLAB_VJP_RTOL of
    its scale (the CPU tests' bound); the device ms per step of both sweeps
    from the spans' CUDA events, the kernel's launches (those captured into
    the VJP graph, at each replay), its registers and its bound: the
    operations a live ray step needs (one forward step and its reverse:
    what the body does, counted by the host build on the counting type,
    less what it repeats), at the published FP64 peak, beside the body's
    own count.  Returns the kernels line's row."""
    import functools

    from rays_tpu_torch import examples, native
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.tracing import graphed, graphed_adjoint as ga, slab_vjp, trace
    from rays_tpu_torch.utils import op_rates, spans

    card, dev = run.card, run.dev
    rays, steps = rays or SLAB_VJP_RAYS, steps or SLAB_VJP_STEPS
    t0 = time.perf_counter()
    lib, log = slab_vjp.load_library(torch.float64, 2)
    ptxas = re.search(r"slab_rk4_vjp_kernel.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                      log, re.S)
    require(ptxas, f"no sm_90a ptxas report in the slab VJP's build log:\n{log}")
    occ = native.occupancy(lib.rays_slab_vjp_occupancy)
    require(occ["blocks_per_sm"] >= 1, f"the slab VJP cannot launch: {occ}")
    print(f"phase 36 build: slab_rk4_vjp f64 S=2 loaded in {time.perf_counter() - t0:.1f} s "
          f"(built in phase 1); ptxas {ptxas[2]} registers, {ptxas[1]} B spilled; granted "
          f"{occ['blocks_per_sm']} blocks x {occ['threads']} threads = {occ['warps_per_sm']} "
          f"warps per SM, {occ['local_bytes']} B local")

    cfg, params, v0, st0, pwr0 = examples.setup_example(examples.SLAB_ECH_90GHZ, device=dev)
    cfg = dataclasses.replace(cfg, nstep_max=steps, save_trajectory=False)
    v, st, w = examples.replicate_rays(v0, st0, pwr0, rays)
    require(slab_vjp.takes(cfg, dev) and trace.route(cfg, True, dev) == "adjoint",
            "the cell's config takes the adjoint graph with the slab VJP")
    p = tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()]

    def derivative_step(tracer):
        """(gradients, forward ms, backward ms) of the cell's loss: the
        device ms of the replay loops' spans, over the outer steps."""
        spans.clear()
        with spans.recording():
            res = tracer(cfg, p, v, st, w)
            loss = (res.end_ray_vec[:, 0:3] ** 2 * w[:, None]).sum()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            torch.cuda.synchronize()
        ms = {r.name: r.device_ms for r in spans.records()}
        spans.clear()
        return (grads, res, ms["rays.adjoint.forward"] / steps,
                ms["rays.adjoint.backward"] / steps)

    # the kernel's piece, as trace_rays takes it (the first call captures)
    t1 = time.perf_counter()
    derivative_step(trace.trace_rays)
    first_s = time.perf_counter() - t1
    key = ("adjoint", *graphed.cache_key(cfg, p, v))
    slab = graphed._CACHE[key].loop.kernels
    require(slab is not None and slab.captured["vjp"] == 1,
            "trace_rays took the generic piece, or its VJP graph holds no one slab VJP launch")
    l0 = slab_vjp.LAUNCHES
    runs = [derivative_step(trace.trace_rays) for _ in range(3)]
    launches = (slab_vjp.LAUNCHES - l0) // len(runs)
    require(launches == steps, f"{launches} launches of the slab VJP a backward")
    # the same count as the card's trace sees it: the kernel's device
    # launches in one more derivative step under torch.profiler
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        derivative_step(trace.trace_rays)
    traced = sum(e.count for e in prof.key_averages() if "slab_rk4_vjp_kernel" in e.key)
    require(traced == steps, f"the profiler saw {traced} slab VJP kernels in a backward")
    grads, res = runs[0][0], runs[0][1]

    # the generic piece, captured alike on the same shapes
    held = (tree_map(torch.Tensor.detach, p), v, st)
    class GenericVJP(ga.StaticAdjoint):
        def functions(self):
            # the generic VJP piece in place of the gate's kernel, beside its step
            return {"step": self.kernels.step, "vjp": self.vjp}

    loop = GenericVJP(cfg, *held)
    with torch.no_grad():
        carry = trace.initial_carry(cfg, *held)
        entry = graphed.Captured(loop, lambda: loop.load_inputs(
            carry, [t for t in tree_leaves(held[0]) if t.is_floating_point()]), ga.WARMUP)
    generic = lambda cfg_, p_, v_, st_, w_: ga.trace_adjoint(  # noqa: E731
        cfg_, p_, v_, st_, w_, lambda: (loop, functools.partial(ga._replay, entry)))
    gen_runs = [derivative_step(generic) for _ in range(2)]
    ref = gen_runs[0][0]
    entry.release()
    del loop, entry

    worst = 0.0
    for i, (g, r) in enumerate(zip(grads, ref)):
        scale = float(r.abs().max()) if r.numel() else 0.0
        err = float((g - r).abs().max()) if r.numel() else 0.0
        require(bool(torch.isfinite(g).all()) and err <= SLAB_VJP_RTOL * scale,
                f"phase 36: gradient {i} differs by {err:.3e} of scale {scale:.3e}")
        require(scale > 0.0 or not bool(g.any()), f"phase 36: gradient {i} is not zero")
        worst = max(worst, err / scale if scale else 0.0)

    # the bound: operations of a live ray step on the counting type (the
    # host build on 48 of the rays, 10 steps), at the published FP64 peak:
    # what the VJP needs (the body's count less what it repeats), and the
    # body's own count beside it
    hcfg = dataclasses.replace(cfg, nstep_max=10)
    hp = tree_map(lambda t: t.detach().cpu(), params)
    hv, hst = v[:48].cpu(), st[:48].cpu()
    hloop = ga.StaticAdjoint(hcfg, hp, hv, hst)
    hloop.kernels = slab_vjp.SlabVJP(slab_vjp.load_host_library(), hloop)
    hloop.forward(trace.initial_carry(hcfg, hp, hv, hst),
                  [t for t in tree_leaves(hp) if t.is_floating_point()])
    ops, again, live = {}, {}, 0
    for k in range(hcfg.nstep_max - 1, -1, -1):
        hloop.k.fill_(k)
        o, a, n = slab_vjp.count_ops(hloop)
        ops = {key_: ops.get(key_, 0) + o[key_] for key_ in o}
        again = {key_: again.get(key_, 0) + a[key_] for key_ in a}
        live += n
    per_step = {k: c / live for k, c in ops.items()}
    needed = {k: (c - again[k]) / live for k, c in ops.items()}
    live_steps = float((res.npoints.double() - 1).sum())
    ms_per_op = live_steps / op_rates.PEAK_FLOPS[torch.float64] * 1e3
    bound_ms = sum(needed.values()) * ms_per_op
    own_bound_ms = sum(per_step.values()) * ms_per_op
    fwd = sorted(r[2] for r in runs)
    bwd = sorted(r[3] for r in runs)
    gen_bwd = sorted(r[3] for r in gen_runs)
    print(f"phase 36 slab VJP {rays} rays x {steps} steps f64: {len(grads)} gradients within "
          f"{worst:.3e} of scale of the generic piece's (bound {SLAB_VJP_RTOL}); {launches} "
          f"launches a backward ({traced} in the profiler's trace); backward {bwd[0]:.5f}-{bwd[-1]:.5f} ms per outer step (generic "
          f"{gen_bwd[0]:.4f}-{gen_bwd[-1]:.4f}, x{gen_bwd[0] / bwd[-1]:.1f}); forward "
          f"{fwd[0]:.4f}-{fwd[-1]:.4f} ms per step; first call {first_s:.2f} s with the "
          f"capture; a live ray step needs {sum(needed.values()):.1f} operations ("
          + ", ".join(f"{k} {c:.1f}" for k, c in needed.items() if c)
          + f"), the body does {sum(per_step.values()):.1f}; {live_steps:.0f} live ray steps: "
          f"bound {bound_ms / steps:.6f} ms per step (the body's count: "
          f"{own_bound_ms / steps:.6f}), share {bound_ms / steps / bwd[0]:.4f} (of the body's "
          f"count: {own_bound_ms / steps / bwd[0]:.4f}) on {card}")
    run.paths.append({"name": "slab_vjp_training_step_f64", "route": "adjoint", "rays": rays,
                      "steps": steps, "backward_ms_per_step": bwd,
                      "generic_backward_ms_per_step": gen_bwd, "forward_ms_per_step": fwd,
                      "worst_grad_rel": worst, "ops_per_live_step": needed,
                      "body_ops_per_live_step": per_step, "body_bound_ms": own_bound_ms})
    return {"name": "slab_rk4_vjp", "route": "cuda", "source": "rays_tpu_torch/csrc/slab_rk4_vjp.cu",
            "replaces": "the graphed adjoint's generic VJP piece (tracing/graphed_adjoint.py)",
            "launches": launches, "max_abs_err": worst, "ms": bwd[0] * steps,
            "plain_ms": gen_bwd[0] * steps, "bound_ms": bound_ms, "bound_by": "operations",
            "body_bound_ms": own_bound_ms,
            "library_ms": None}


def slab_step_phase(run, rays=None, steps=None):
    """Phase 37: the slab step kernel (tracing/slab_vjp.py,
    csrc/slab_rk4_step.cuh in the slab VJP's library) as the adjoint
    graph's forward piece, at phase 36's shapes: the cell's endpoint loss
    and its gradient in every floating Params leaf through trace_rays (both
    kernel pieces, by the gate) against the same adjoint graph whose
    forward is the generic step piece (a StaticAdjoint whose pieces are
    the generic step and the slab VJP kernel, captured and replayed alike),
    every gradient within ADJOINT_RTOL of its scale, npoints and stops
    equal and the end states within SLAB_RTOL of scale; the forward against
    B1 on the same inputs (trace_rays without gradients): npoints and stops
    equal, the end states within SLAB_RTOL of scale; the device ms per step of both forwards from the spans' CUDA
    events and the kernel's own from the profiler; its launches (those
    captured into the step graph, at each replay; the profiler's count);
    its registers and spills beside the VJP's, and its bound: live ray
    steps at B1's frozen count (benchmark/counts/slab_rk4_time.json) at
    the published FP64 peak, against the carry read and written and the
    stack row written at the memory rate.  Returns the kernels line's
    row."""
    import functools

    from rays_tpu_torch import examples, native
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.tracing import graphed, graphed_adjoint as ga, slab_vjp, trace
    from rays_tpu_torch.utils import op_rates, spans

    card, dev = run.card, run.dev
    rays, steps = rays or SLAB_VJP_RAYS, steps or SLAB_VJP_STEPS
    lib, log = slab_vjp.load_library(torch.float64, 2)
    reports = {}
    for kernel in ("slab_rk4_step_kernel", "slab_rk4_vjp_kernel"):
        m = re.search(kernel + r".*?(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
        require(m, f"no sm_90a ptxas report of {kernel} in the library's build log:\n{log}")
        reports[kernel] = (int(m[2]), int(m[1]))
    occ = native.occupancy(lib.rays_slab_step_occupancy)
    require(occ["blocks_per_sm"] >= 1, f"the slab step cannot launch: {occ}")
    (regs, spill), (vjp_regs, vjp_spill) = reports.values()
    print(f"phase 37 build: slab_rk4_step_kernel f64 S=2: ptxas {regs} registers, {spill} B "
          f"spilled (the VJP beside it: {vjp_regs} registers, {vjp_spill} B); granted "
          f"{occ['blocks_per_sm']} blocks x {occ['threads']} threads = {occ['warps_per_sm']} "
          f"warps per SM, {occ['local_bytes']} B local")

    cfg, params, v0, st0, pwr0 = examples.setup_example(examples.SLAB_ECH_90GHZ, device=dev)
    cfg = dataclasses.replace(cfg, nstep_max=steps, save_trajectory=False)
    v, st, w = examples.replicate_rays(v0, st0, pwr0, rays)
    require(slab_vjp.takes(cfg, dev) and trace.route(cfg, True, dev) == "adjoint",
            "the cell's config takes the adjoint graph with the slab kernels")
    p = tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()]

    def derivative_step(tracer):
        """(gradients, results, forward ms, backward ms per outer step)."""
        spans.clear()
        with spans.recording():
            res = tracer(cfg, p, v, st, w)
            loss = (res.end_ray_vec[:, 0:3] ** 2 * w[:, None]).sum()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            torch.cuda.synchronize()
        ms = {r.name: r.device_ms for r in spans.records()}
        spans.clear()
        return (grads, res, ms["rays.adjoint.forward"] / steps,
                ms["rays.adjoint.backward"] / steps)

    derivative_step(trace.trace_rays)      # the capture, if phase 36 has not made it
    entry = graphed._CACHE[("adjoint", *graphed.cache_key(cfg, p, v))]
    side = entry.loop.kernels
    require(side is not None and side.captured["step"] == 1,
            "trace_rays took the generic step piece, or its graph holds no one slab step launch")
    l0 = slab_vjp.STEP_LAUNCHES
    runs = [derivative_step(trace.trace_rays) for _ in range(3)]
    launches = (slab_vjp.STEP_LAUNCHES - l0) // len(runs)
    require(launches == steps, f"{launches} launches of the slab step a forward")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        derivative_step(trace.trace_rays)
    found = [e for e in prof.key_averages() if "slab_rk4_step_kernel" in e.key]
    traced = sum(e.count for e in found)
    require(traced == steps, f"the profiler saw {traced} slab step kernels in a forward")
    dev_us = sum(getattr(e, "device_time_total", 0) or e.cuda_time_total for e in found)
    kernel_ms = dev_us / 1e3 / traced
    grads, res = runs[0][0], runs[0][1]

    # B1 on the same inputs, without gradients
    with torch.no_grad():
        b1 = trace.trace_rays(cfg, tree_map(torch.Tensor.detach, p), v, st, w)
    require(torch.equal(res.npoints, b1.npoints) and torch.equal(res.stop_flag, b1.stop_flag),
            "phase 37: npoints or stops differ from B1's")
    scale = res.end_ray_vec.detach().abs().amax(0).clamp_min(1e-12)

    def end_gap_to(other):
        return float(((res.end_ray_vec.detach() - other.end_ray_vec.detach()).abs()
                      / scale).max())

    end_gap = end_gap_to(b1)
    require(end_gap <= SLAB_RTOL, f"phase 37: end states {end_gap:.3e} of scale from B1's")

    # the generic step piece under the same VJP kernel, captured alike
    held = (tree_map(torch.Tensor.detach, p), v, st)
    class GenericStep(ga.StaticAdjoint):
        def functions(self):
            # the generic step piece in place of the gate's kernel, beside its VJP
            return {"step": self.step, "vjp": self.kernels.vjp}

    loop = GenericStep(cfg, *held)
    with torch.no_grad():
        carry = trace.initial_carry(cfg, *held)
        gentry = graphed.Captured(loop, lambda: loop.load_inputs(
            carry, [t for t in tree_leaves(held[0]) if t.is_floating_point()]), ga.WARMUP)
    generic = lambda cfg_, p_, v_, st_, w_: ga.trace_adjoint(  # noqa: E731
        cfg_, p_, v_, st_, w_, lambda: (loop, functools.partial(ga._replay, gentry)))
    gen_runs = [derivative_step(generic) for _ in range(2)]
    ref, gen_res = gen_runs[0][0], gen_runs[0][1]
    gentry.release()
    del loop, gentry
    require(torch.equal(gen_res.npoints, res.npoints)
            and torch.equal(gen_res.stop_flag, res.stop_flag),
            "phase 37: npoints or stops differ from the generic step's")
    gen_gap = end_gap_to(gen_res)
    require(gen_gap <= SLAB_RTOL,
            f"phase 37: end states {gen_gap:.3e} of scale from the generic step's")
    worst = 0.0
    for i, (g, r) in enumerate(zip(grads, ref)):
        scale_ = float(r.abs().max()) if r.numel() else 0.0
        err = float((g - r).abs().max()) if r.numel() else 0.0
        require(bool(torch.isfinite(g).all()) and err <= ADJOINT_RTOL * scale_,
                f"phase 37: gradient {i} differs by {err:.3e} of scale {scale_:.3e}")
        worst = max(worst, err / scale_ if scale_ else 0.0)

    # the bound: B1's frozen count a live ray step at the FP64 peak, against
    # the bytes of a step: the carry read and written, its stack row written
    with open(Path(__file__).resolve().parent / "benchmark" / "counts"
              / "slab_rk4_time.json") as f:
        per_live = json.load(f)["ops_per_live_step"]
    live_steps = float((res.npoints.double() - 1).sum())
    ops_ms = live_steps * per_live / op_rates.PEAK_FLOPS[torch.float64] * 1e3 / steps
    row = sum(t.element_size() * t[0].numel() for t in entry.loop.carry)
    bytes_ms = 3 * row * rays / op_rates.HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    fwd = sorted(r[2] for r in runs)
    bwd = sorted(r[3] for r in runs)
    gen_fwd = sorted(r[2] for r in gen_runs)
    print(f"phase 37 slab step {rays} rays x {steps} steps f64: {len(grads)} gradients within "
          f"{worst:.3e} of scale of the generic step's under the same VJP (bound "
          f"{ADJOINT_RTOL}); npoints and stops equal to B1's and the generic step's, end "
          f"states within {end_gap:.3e} of B1's and {gen_gap:.3e} of the generic step's "
          f"(bound {SLAB_RTOL}); {launches} launches a forward ({traced} in the "
          f"profiler's trace); forward {fwd[0]:.5f}-{fwd[-1]:.5f} ms per outer step (generic "
          f"{gen_fwd[0]:.4f}-{gen_fwd[-1]:.4f}, x{gen_fwd[0] / fwd[-1]:.1f}), the kernel alone "
          f"{kernel_ms:.5f} ms; backward {bwd[0]:.5f}-{bwd[-1]:.5f}; bound {bound_ms:.6f} ms per "
          f"step (operations {ops_ms:.6f}: {live_steps:.0f} live ray steps x {per_live}; bytes "
          f"{bytes_ms:.6f}: 3 x {row} B a ray), share {bound_ms / kernel_ms:.4f} on {card}")
    run.paths.append({"name": "slab_step_training_step_f64", "route": "adjoint", "rays": rays,
                      "steps": steps, "forward_ms_per_step": fwd,
                      "generic_forward_ms_per_step": gen_fwd, "backward_ms_per_step": bwd,
                      "kernel_ms_per_step": kernel_ms, "worst_grad_rel": worst,
                      "end_gap_b1": end_gap, "end_gap_generic": gen_gap, "registers": regs, "spill_bytes": spill,
                      "vjp_registers": vjp_regs, "vjp_spill_bytes": vjp_spill})
    return {"name": "slab_rk4_step", "route": "cuda",
            "source": "rays_tpu_torch/csrc/slab_rk4_step.cuh",
            "replaces": "the graphed adjoint's generic step piece (tracing/graphed_adjoint.py)",
            "launches": launches, "max_abs_err": worst, "ms": kernel_ms * steps,
            "plain_ms": gen_fwd[0] * steps, "bound_ms": bound_ms * steps,
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations", "library_ms": None}


class GenericAdjoint:
    """trace_rays' adjoint graph with the generic pieces whatever the
    kernels' gates say: a StaticAdjoint without its kernel side, captured at
    the first call as graphed_adjoint.capture captures (WARMUP warm-up
    iterations) and replayed through graphed_adjoint._replay.  Called as
    trace_rays is; ``captures`` counts its captures, ``release`` gives its
    graphs' pool back to the card."""

    def __init__(self):
        self.entry, self.captures = None, 0

    def __call__(self, cfg, p, v, st, w):
        import functools

        from rays_tpu_torch.core.types import tree_leaves, tree_map
        from rays_tpu_torch.tracing import graphed, graphed_adjoint as ga, trace

        if self.entry is None:
            held = (tree_map(torch.Tensor.detach, p), v.detach(), st)
            loop = ga.StaticAdjoint(cfg, *held)
            loop.kernels = None
            with torch.no_grad():
                carry = trace.initial_carry(cfg, *held)
                leaves = [t for t in tree_leaves(held[0]) if t.is_floating_point()]
                self.entry = graphed.Captured(loop, lambda: loop.load_inputs(carry, leaves),
                                              ga.WARMUP)
            self.captures += 1
        entry = self.entry
        return ga.trace_adjoint(cfg, p, v, st, w,
                                lambda: (entry.loop, functools.partial(ga._replay, entry)))

    def release(self):
        if self.entry is not None:
            self.entry.release()
            self.entry = None


def eqdsk_step_phase(run):
    """Phase 38: the EQDSK step kernel (tracing/eqdsk_step.py,
    csrc/eqdsk_rk4.cu) as the adjoint graph's forward piece on the benchmark
    cell solovev_eqdsk.grad's deck and fan (seed 0: 32,768 rays x 500 RK4
    steps, float64, summaries only): the cell's endpoint loss and its
    gradient in every floating Params leaf through trace_rays (the kernel's
    step piece, by the gate, and the generic VJP) against the same adjoint
    graph with the generic pieces (GenericAdjoint): npoints and stops
    equal, the end states within SLAB_RTOL of scale, every gradient within
    EQDSK_STEP_GRAD_RTOL of its scale; the control: the kernel's run on the
    deck in float32 against the same float64 answer, which must read above
    that limit; the device ms per step of both forwards from the spans' CUDA
    events and the kernel's own from the profiler, against its bound: the
    operations of a live ray step, counted on the host build (64 rays spread
    over the fan, every step; eqdsk_step.count_ops), times the run's live ray
    steps at the published FP64 peak, against the carry read and written and
    the stack row written at the memory rate; its launches (those captured
    into the step graph, at each replay: ``eqdsk_step.STEP_LAUNCHES``; the
    profiler's count); its registers and spills in both precisions.
    Returns the kernels line's row."""
    import contextlib

    from benchmark.lib import common, inputs
    from rays_tpu_torch import native
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.tracing import eqdsk_step, graphed, graphed_adjoint as ga, trace
    from rays_tpu_torch.utils import op_rates, spans

    card, dev = run.card, run.dev
    reports = {}
    for dtype in (torch.float64, torch.float32):
        lib, log = eqdsk_step.load_library(dtype, 2)
        m = re.search(r"eqdsk_rk4_step_kernel.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                      log, re.S)
        require(m, f"no sm_90a ptxas report of eqdsk_rk4_step_kernel in the build log:\n{log}")
        reports[dtype] = (int(m[2]), int(m[1]), next(
            (line.strip() for line in log.splitlines() if "Used" in line and "registers" in line),
            ""))
        if dtype == torch.float64:
            occ = native.occupancy(lib.rays_eqdsk_step_occupancy)
    require(occ["blocks_per_sm"] >= 1, f"the EQDSK step cannot launch: {occ}")
    regs, spill, ptxas = reports[torch.float64]
    regs32, spill32, ptxas32 = reports[torch.float32]
    print(f"phase 38 build: eqdsk_rk4_step_kernel f64 S=2: ptxas {regs} registers, {spill} B "
          f"spilled ({ptxas}); granted {occ['blocks_per_sm']} blocks x {occ['threads']} threads "
          f"= {occ['warps_per_sm']} warps per SM, {occ['local_bytes']} B local; f32 S=2: "
          f"{regs32} registers, {spill32} B spilled ({ptxas32})")

    cell = common.Cell("solovev_eqdsk.grad")
    cfg, params, _, v, st, w = inputs.program(cell, 0, dev, lambda name: contextlib.nullcontext())
    steps, rays = cfg.nstep_max, v.shape[0]
    require(eqdsk_step.takes(cfg, params, dev) and trace.route(cfg, True, dev) == "adjoint",
            "the cell's config takes the adjoint graph with the EQDSK step")

    def derivative_step(tracer, p, v, w):
        """(gradients, results, forward ms, backward ms per outer step)."""
        leaves = [t for t in tree_leaves(p) if t.is_floating_point()]
        spans.clear()
        with spans.recording():
            res = tracer(cfg, p, v, st, w)
            loss = (res.end_ray_vec[:, 0:3] ** 2 * w[:, None]).sum()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            torch.cuda.synchronize()
        ms = {r.name: r.device_ms for r in spans.records()}
        spans.clear()
        return (grads, res, ms["rays.adjoint.forward"] / steps,
                ms["rays.adjoint.backward"] / steps)

    def with_grad(dtype):
        return tree_map(lambda t: (t.detach().to(dtype, copy=True).requires_grad_(True)
                                   if t.is_floating_point() else t), params)

    p = with_grad(torch.float64)
    derivative_step(trace.trace_rays, p, v, w)      # the capture
    key = ("adjoint", *graphed.cache_key(cfg, p, v))
    entry = graphed._CACHE[key]
    side = entry.loop.kernels
    require(isinstance(side, eqdsk_step.EqdskStep) and side.captured["step"] == 1,
            "trace_rays took the generic step piece, or its graph holds no one EQDSK step launch")
    l0 = eqdsk_step.STEP_LAUNCHES
    runs = [derivative_step(trace.trace_rays, p, v, w) for _ in range(2)]
    launches = (eqdsk_step.STEP_LAUNCHES - l0) // len(runs)
    require(launches == steps, f"{launches} launches of the EQDSK step a forward")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        derivative_step(trace.trace_rays, p, v, w)
    found = [e for e in prof.key_averages() if "eqdsk_rk4_step_kernel" in e.key]
    traced = sum(e.count for e in found)
    require(traced == steps, f"the profiler saw {traced} EQDSK step kernels in a forward")
    dev_us = sum(getattr(e, "device_time_total", 0) or e.cuda_time_total for e in found)
    kernel_ms = dev_us / 1e3 / traced
    grads, res = runs[0][0], runs[0][1]
    row = sum(t.element_size() * t[0].numel() for t in entry.loop.carry)
    graphed._CACHE.pop(key).release()     # its stack and pool back to the card
    del entry, side

    # the generic pieces, captured alike
    generic = GenericAdjoint()
    gen_runs = [derivative_step(generic, p, v, w) for _ in range(2)]
    generic.release()
    ref, gen_res = gen_runs[0][0], gen_runs[0][1]
    require(torch.equal(gen_res.npoints, res.npoints)
            and torch.equal(gen_res.stop_flag, res.stop_flag),
            "phase 38: npoints or stops differ from the generic step's")
    scale = gen_res.end_ray_vec.detach().abs().amax(0).clamp_min(1e-12)

    def end_gap(r):
        return float(((r.end_ray_vec.detach().double() - gen_res.end_ray_vec.detach()).abs()
                      / scale).max())

    def grad_gap(gs):
        """(the worst leaf's gap over its scale, of the finite leaves whose
        scale is not zero; the leaves that are not finite or not zero where
        the answer's gradient is)."""
        worst, bad = 0.0, 0
        for g, r in zip(gs, ref):
            s_ = float(r.abs().max()) if r.numel() else 0.0
            err = float((g.double() - r).abs().max()) if r.numel() else 0.0
            if not bool(torch.isfinite(g).all()) or (not s_ and err):
                bad += 1
            elif s_:
                worst = max(worst, err / s_)
        return worst, bad

    gap = end_gap(res)
    require(gap <= SLAB_RTOL, f"phase 38: end states {gap:.3e} of scale from the generic step's")
    worst, bad = grad_gap(grads)
    require(worst <= EQDSK_STEP_GRAD_RTOL and not bad,
            f"phase 38: gradients {worst:.3e} of scale from the generic step run's, {bad} leaves "
            "not finite or not zero")

    # the control: the kernel's run in float32 (its own library) against
    # the same float64 answer must read above the limit
    p32 = with_grad(torch.float32)
    ctl_grads, ctl_res = derivative_step(trace.trace_rays, p32, v.float(), w.float())[:2]
    graphed._CACHE.pop(("adjoint", *graphed.cache_key(cfg, p32, v.float()))).release()
    control, ctl_bad = grad_gap(ctl_grads)
    ctl_moved = int((ctl_res.npoints != gen_res.npoints).sum())
    require(control > EQDSK_STEP_GRAD_RTOL or ctl_bad,
            f"phase 38: the float32 control reads {control:.3e}, within the limit")

    # the bound: the operations of a live ray step on the counting type
    hcfg, idx = cfg, torch.linspace(0, rays - 1, 64, device=dev).long()
    hp = tree_map(lambda t: t.detach().cpu(), params)
    hv, hst = v[idx].cpu(), st[idx].cpu()
    hloop = ga.StaticAdjoint(hcfg, hp, hv, hst)
    hloop.kernels = eqdsk_step.EqdskStep(eqdsk_step.load_host_library(), hloop)
    hloop.load_inputs(trace.initial_carry(hcfg, hp, hv, hst),
                      [t for t in tree_leaves(hp) if t.is_floating_point()])
    ops, live = {}, 0
    for k in range(steps):
        hloop.k.fill_(k)
        o, n = eqdsk_step.count_ops(hloop)
        ops = {key_: ops.get(key_, 0) + o[key_] for key_ in o}
        live += n
    require(live > 0, "phase 38: no live ray step in the host count")
    per_live = {k: c / live for k, c in ops.items()}
    live_steps = float((res.npoints.double() - 1).sum())
    ops_ms = sum(per_live.values()) * live_steps / op_rates.PEAK_FLOPS[torch.float64] * 1e3
    ops_ms /= steps
    bytes_ms = 3 * row * rays / op_rates.HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)

    fwd = sorted(r[2] for r in runs)
    bwd = sorted(r[3] for r in runs)
    gen_fwd = sorted(r[2] for r in gen_runs)
    gen_bwd = sorted(r[3] for r in gen_runs)
    print(f"phase 38 EQDSK step, cell solovev_eqdsk.grad seed 0, {rays} rays x {steps} steps "
          f"f64: npoints and stops equal to the generic step's ({live_steps:.0f} live ray "
          f"steps), end states within {gap:.3e} of scale (bound {SLAB_RTOL}); {len(grads)} "
          f"gradients through the generic VJP within {worst:.3e} of scale of the generic "
          f"pieces' (bound {EQDSK_STEP_GRAD_RTOL}; the float32 control reads {control:.3e} on "
          f"{len(ctl_grads) - ctl_bad} leaves, {ctl_bad} not finite or not zero where the answer "
          f"is, its end states {end_gap(ctl_res):.3e}, {ctl_moved} rays' npoints moved); "
          f"{launches} launches a forward ({traced} in the profiler's trace); forward "
          f"{fwd[0]:.5f}-{fwd[-1]:.5f} ms per outer step (generic {gen_fwd[0]:.4f}-"
          f"{gen_fwd[-1]:.4f}, x{gen_fwd[0] / fwd[-1]:.1f}), the kernel alone {kernel_ms:.5f} ms; "
          f"a live ray step does {sum(per_live.values()):.1f} operations ("
          + ", ".join(f"{k} {c:.1f}" for k, c in per_live.items() if c)
          + f"; host count, {live} live steps of 64 rays): bound {ops_ms:.6f} ms a step by "
          f"operations, {bytes_ms:.6f} by bytes ({3 * row} B a ray), share "
          f"{bound_ms / kernel_ms:.4f}; backward {bwd[0]:.4f}-{bwd[-1]:.4f} (generic pieces "
          f"{gen_bwd[0]:.4f}-{gen_bwd[-1]:.4f}) on {card}")
    run.paths.append({"name": "eqdsk_step_training_step_f64", "route": "adjoint", "rays": rays,
                      "steps": steps, "forward_ms_per_step": fwd,
                      "generic_forward_ms_per_step": gen_fwd, "backward_ms_per_step": bwd,
                      "generic_backward_ms_per_step": gen_bwd, "kernel_ms_per_step": kernel_ms,
                      "worst_grad_rel": worst, "control_grad_rel": control,
                      "control_bad_leaves": ctl_bad,
                      "end_gap_generic": gap, "registers": regs, "spill_bytes": spill,
                      "registers_f32": regs32, "spill_bytes_f32": spill32,
                      "launches": launches, "ops_per_live_step": per_live,
                      "bound_ms_per_step": bound_ms})
    return {"name": "eqdsk_rk4_step", "route": "cuda",
            "source": "rays_tpu_torch/csrc/eqdsk_rk4.cuh",
            "replaces": "the graphed adjoint's generic step piece (tracing/graphed_adjoint.py)",
            "launches": launches, "max_abs_err": worst, "ms": kernel_ms * steps,
            "plain_ms": gen_fwd[0] * steps, "bound_ms": bound_ms * steps,
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations", "library_ms": None}


def tangent_direction(params, v, w, seed):
    """A tangent for every floating Params leaf, v0 and pwr_wt: each
    tensor times N(0, 1) entries from a numpy seed, on its device."""
    from rays_tpu_torch.core.types import tree_map

    rng = np.random.default_rng(seed)

    def draw(t):
        return t * torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=t.dtype,
                                   device=t.device)

    return (tree_map(lambda t: draw(t) if t.is_floating_point() else None, params),
            draw(v), draw(w))


def traced_tangents(tracer, cfg, params, v, st, w, direction):
    """{field: (primal, tangent or None)} of ``tracer`` on dual inputs
    along ``direction``, without gradients."""
    import torch.autograd.forward_ad as fwAD

    from rays_tpu_torch.core.types import tree_map
    from rays_tpu_torch.tracing.trace import RayResults

    dp, dv, dw = direction
    with fwAD.dual_level(), torch.no_grad():
        p = tree_map(lambda t, d: t if d is None else fwAD.make_dual(t, d), params, dp)
        res = tracer(cfg, p, fwAD.make_dual(v, dv), st, fwAD.make_dual(w, dw))
        return {f: tuple(fwAD.unpack_dual(t)) for f, t in zip(RayResults._fields, res)
                if t is not None}


def tangent_errors(got, ref, what):
    """Require every primal bit for bit equal to ``ref``'s and return the
    worst tangent difference over its field's scale (an absent tangent is
    zero)."""
    worst = 0.0
    for f, (p, t) in ref.items():
        gp, gt = got[f]
        require(torch.equal(gp, p), f"{what}: the primal of {f} differs")
        if not p.is_floating_point():
            continue
        r = torch.zeros_like(p) if t is None else t
        g = torch.zeros_like(gp) if gt is None else gt
        scale = float(r.abs().max()) if r.numel() else 0.0
        err = float((g - r).abs().max()) if r.numel() else 0.0
        require(bool(torch.isfinite(g).all()), f"{what}: non-finite tangent of {f}")
        worst = max(worst, err / scale if scale else err)
    return worst


def tangent_phase(run, full):
    """Phase 31: every config of the graph route that the tangent graph
    takes, against eager forward AD through trace_batch on the card, at
    GRAPH_RAYS rays x GRAPH_STEPS steps with trajectories, along a tangent
    on every floating Params leaf, v0 and pwr_wt: trace_rays (captured at
    the first call, replayed at the second) with the primal of every field
    bit for bit and the tangents within TANGENT_RTOL of scale.  ``full``:
    every config at GRAPH_STEPS, else those of TANGENT_STEPS_DEFAULT at
    their cut depth (the line says so)."""
    from rays_tpu_torch.tracing import fused_slab, graphed_tangent
    from rays_tpu_torch.tracing.trace import route, trace_batch, trace_rays

    card, dev = run.card, run.dev
    sp = _tool("step_profile")
    with tempfile.TemporaryDirectory() as tmp:
        cases = sp.graph_cases(dev, GRAPH_RAYS, tmp)
    t_phase = time.perf_counter()
    for name, (cfg, params, v, st, w) in cases.items():
        steps, cut = GRAPH_STEPS, ""
        if not full and name in TANGENT_STEPS_DEFAULT:
            steps = TANGENT_STEPS_DEFAULT[name]
            cut = (f" (cut from {GRAPH_STEPS} to {steps} steps in the default call; "
                   f"--group graph runs all)")
        cfg = dataclasses.replace(cfg, nstep_max=steps)
        which = route(cfg, False, dev, tangents=True)
        why = graphed_tangent.refusal(cfg)
        if why is not None:
            require(which == "plain", f"{name}: route {which} for a refused config")
            print(f"phase 31 {name}: route {which} ({why})")
            continue
        require(which == "tangent", f"{name}: route {which}, not the tangent graph")
        direction = tangent_direction(params, v, w, seed=31)
        traced_tangents(trace_batch, dataclasses.replace(cfg, nstep_max=2), params, v, st, w,
                        direction)  # warm-up
        eager_ms, ref = timed(lambda: traced_tangents(trace_batch, cfg, params, v, st, w,
                                                      direction))
        c0, r0, l0 = graphed_tangent.CAPTURES, graphed_tangent.REPLAYS, fused_slab.LAUNCHES
        first_ms, first = timed(lambda: traced_tangents(trace_rays, cfg, params, v, st, w,
                                                        direction))
        c1, r1 = graphed_tangent.CAPTURES, graphed_tangent.REPLAYS
        second_ms, second = timed(lambda: traced_tangents(trace_rays, cfg, params, v, st, w,
                                                          direction))
        require(c1 - c0 == 1 and graphed_tangent.CAPTURES == c1,
                f"{name}: {graphed_tangent.CAPTURES - c0} captures in two calls")
        require(fused_slab.LAUNCHES == l0, f"{name}: the tangent graph launched B1")
        loop_form = cfg.ode_solver_name == "SG_ODE" and cfg.sg_scan_substeps == 0
        per_call = (r1 - r0, graphed_tangent.REPLAYS - r1)
        require(per_call[0] == per_call[1] and (
            per_call[0] >= 2 * steps if loop_form else per_call[0] == steps),
            f"{name}: replays per call {per_call}")
        rtol = TANGENT_RTOL if v.dtype == torch.float64 else TANGENT_RTOL_F32
        worst = max(tangent_errors(got, ref, f"{name} {tag} call")
                    for tag, got in (("first", first), ("second", second)))
        require(worst <= rtol, f"{name}: tangents differ by {worst:.3e} of scale (bound {rtol})")
        require(float(ref["end_ray_vec"][1].abs().max()) > 0, f"{name}: zero tangents")
        print(f"phase 31 {name} {GRAPH_RAYS} rays x {steps} steps{cut} "
              f"{str(v.dtype).replace('torch.', '')}, route {which}: primal equal to eager "
              f"forward AD bit for bit on every field, tangents within {worst:.3e} of scale "
              f"(bound {rtol}), both calls; 1 capture, {per_call[0]} replays a call; eager "
              f"{eager_ms:.1f} ms, graphed {second_ms:.1f} ms (x{eager_ms / second_ms:.2f}), "
              f"first call {first_ms:.1f} ms (capture {first_ms - second_ms:.1f} ms)")
        run.paths.append({"name": f"tangent_{name}", "route": which, "steps": steps,
                          "ms": second_ms,
                          "eager_ms": eager_ms, "capture_ms": first_ms - second_ms,
                          "replays": per_call[0], "worst_tangent_rel": worst})
    print(f"phase 31 tangent graphs held to eager forward AD in "
          f"{time.perf_counter() - t_phase:.1f} s; graphed_tangent.CAPTURES "
          f"{graphed_tangent.CAPTURES}, REPLAYS {graphed_tangent.REPLAYS} in this process on "
          f"{card}")


def inverse_columns_phase(run):
    """Phase 32: the inverse demo's two forward-mode columns at full width:
    its config (Solovev, RK4, trajectories, INVERSE_STEPS steps) on its
    fan replicated to N_RAYS rays, each column through the tangent graph
    (trace_rays; the first column's call captures) and eagerly
    (trace_batch), timed by CUDA events with the peak memory of each
    call; the primal bit for bit, the tangents within TANGENT_RTOL.
    Returns the graphed columns, {i: (trajectories, their tangents)}."""
    import torch.autograd.forward_ad as fwAD

    from rays_tpu_torch import examples
    from rays_tpu_torch.tracing import graphed_tangent
    from rays_tpu_torch.tracing.trace import route, trace_batch, trace_rays

    card, dev = run.card, run.dev
    inv = _tool("inverse_demo")
    prob = inv.InverseProblem(INVERSE_STEPS, str(dev))
    cfg = prob.cfg
    v, st, w = examples.replicate_rays(prob.v0, prob.st, prob.pwr, N_RAYS)
    require(route(cfg, False, dev, tangents=True) == "tangent", "the columns' route")

    def column(tracer, i):
        tangent = torch.zeros_like(prob.start)
        tangent[i] = 1.0
        with fwAD.dual_level(), torch.no_grad():
            th = fwAD.make_dual(prob.start, tangent)
            p = prob.params._replace(eq=prob.params.eq._replace(kappa=th[0], iota0=th[1]))
            r, t = fwAD.unpack_dual(tracer(cfg, p, v, st, w).ray_vec[:, :, 0:3])
        return r, t

    t_phase = time.perf_counter()
    c0 = graphed_tangent.CAPTURES
    rows, columns = {}, {}
    for i in (0, 1):
        eager_ms, ref, eager_peak = timed_peak(lambda: column(trace_batch, i))
        graphed_ms, got, peak = timed_peak(lambda: column(trace_rays, i))
        columns[i] = got
        require(torch.equal(got[0], ref[0]), f"column {i}: the trajectories differ")
        scale = float(ref[1].abs().max())
        err = float((got[1] - ref[1]).abs().max())
        require(scale > 0 and err <= TANGENT_RTOL * scale,
                f"column {i}: tangents differ by {err:.3e} of scale {scale:.3e}")
        rows[i] = (eager_ms, eager_peak, graphed_ms, peak, err / scale)
    again_ms, _, _ = timed_peak(lambda: column(trace_rays, 0))
    require(graphed_tangent.CAPTURES - c0 == 1,
            f"{graphed_tangent.CAPTURES - c0} captures for the two columns")
    for i, (eager_ms, eager_peak, graphed_ms, peak, rel) in rows.items():
        first = " (first call, with the capture)" if i == 0 else ""
        print(f"phase 32 inverse demo column {i}, {N_RAYS} rays x {INVERSE_STEPS} RK4 steps f64 "
              f"with trajectories: graphed {graphed_ms:.1f} ms{first}, {peak / 2**30:.2f} GiB; "
              f"eager {eager_ms:.1f} ms, {eager_peak / 2**30:.2f} GiB; trajectories bit for bit, "
              f"tangents within {rel:.3e} of scale (bound {TANGENT_RTOL})")
    print(f"phase 32 column 0 again {again_ms:.1f} ms (replayed; x{rows[0][0] / again_ms:.2f} "
          f"the eager column); in {time.perf_counter() - t_phase:.1f} s on {card}")
    run.paths.append({"name": "inverse_columns", "route": "tangent", "rays": N_RAYS,
                      "steps": INVERSE_STEPS, "ms": [rows[0][2], rows[1][2], again_ms],
                      "eager_ms": [rows[0][0], rows[1][0]],
                      "peak_gib": [rows[0][3] / 2**30, rows[1][3] / 2**30],
                      "eager_peak_gib": [rows[0][1] / 2**30, rows[1][1] / 2**30]})
    return columns


def jacfwd_columns_phase(run, closed):
    """Phase 35: phase 32's columns through a model whose jacobians come by
    forward mode: Solovev registered with its fields, geometry and
    validity checks alone (tools/step_profile.py's JACFWD_MODEL), so that
    inside the column's dual level ``base.equilibrium`` takes them forward
    over reverse.  The same inputs at N_RAYS rays x INVERSE_STEPS steps
    through trace_rays (the tangent graph; the first column's call
    captures), timed by CUDA events with the peak memory of each call;
    primal and tangents within TANGENT_RTOL of scale of phase 32's
    closed-form columns ``closed``.  Then the census of one outer step
    with the column's tangent, closed form against forward mode."""
    import torch.autograd.forward_ad as fwAD

    from rays_tpu_torch import examples
    from rays_tpu_torch.models import base
    from rays_tpu_torch.tracing import graphed_tangent
    from rays_tpu_torch.tracing.trace import route, trace_rays
    from rays_tpu_torch.utils import op_census

    card, dev = run.card, run.dev
    inv, sp = _tool("inverse_demo"), _tool("step_profile")
    prob = inv.InverseProblem(INVERSE_STEPS, str(dev))
    v, st, w = examples.replicate_rays(prob.v0, prob.st, prob.pwr, N_RAYS)
    cfg = dataclasses.replace(prob.cfg, equilib_model=sp.register_jacfwd_model())

    def dual_params(i):
        tangent = torch.zeros_like(prob.start)
        tangent[i] = 1.0
        th = fwAD.make_dual(prob.start, tangent)
        return prob.params._replace(eq=prob.params.eq._replace(kappa=th[0], iota0=th[1]))

    def column(c, i):
        with fwAD.dual_level(), torch.no_grad():
            res = trace_rays(c, dual_params(i), v, st, w)
            r, t = fwAD.unpack_dual(res.ray_vec[:, :, 0:3])
        require(not r.requires_grad and not t.requires_grad, "the column kept autograd history")
        return r, t

    def census(c):
        with fwAD.dual_level():
            return op_census.step_census(c, dual_params(0), v, st, w)

    t_phase = time.perf_counter()
    try:
        require(route(cfg, False, dev, tangents=True) == "tangent", "the columns' route")
        c0, r0 = graphed_tangent.CAPTURES, graphed_tangent.REPLAYS
        rows = {}
        for i in (0, 1):
            ms, (r, t), peak = timed_peak(lambda: column(cfg, i))
            ref_r, ref_t = closed[i]
            worst = []
            for got, ref in ((r, ref_r), (t, ref_t)):
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                require(bool(torch.isfinite(got).all()) and scale > 0
                        and err <= TANGENT_RTOL * scale,
                        f"column {i}: differs from the closed form's by {err:.3e} of scale "
                        f"{scale:.3e}")
                worst.append(err / scale)
            rows[i] = (ms, peak, worst)
        again_ms, _, _ = timed_peak(lambda: column(cfg, 0))
        require(graphed_tangent.CAPTURES - c0 == 1,
                f"{graphed_tangent.CAPTURES - c0} captures for the two columns")
        require(graphed_tangent.REPLAYS - r0 == 3 * INVERSE_STEPS,
                f"{graphed_tangent.REPLAYS - r0} replays for three columns")
        closed_census, jacfwd_census = census(prob.cfg), census(cfg)
    finally:
        base.EQ_MODELS.pop(sp.JACFWD_MODEL, None)
    for i, (ms, peak, (r_rel, t_rel)) in rows.items():
        first = " (first call, with the capture)" if i == 0 else ""
        print(f"phase 35 inverse demo column {i} by forward-mode jacobians ({sp.JACFWD_MODEL}), "
              f"{N_RAYS} rays x {INVERSE_STEPS} RK4 steps f64 with trajectories, route tangent: "
              f"{ms:.1f} ms{first}, {peak / 2**30:.2f} GiB; against phase 32's closed-form "
              f"column: trajectories within {r_rel:.3e}, tangents within {t_rel:.3e} of scale "
              f"(bound {TANGENT_RTOL})")
    parts = []
    for tag, c in (("closed form", closed_census), ("forward mode", jacfwd_census)):
        cls = ", ".join(f"{k} {n} ({e:.0f})" for k, (n, e) in c.by_class().items() if n)
        parts.append(f"{tag} {c.n_ops} aten ops, {sum(c.elements.values()):.1f} elements per "
                     f"ray, {c.host_reads} host reads (by class, ops (elements per ray): {cls})")
    print(f"phase 35 one outer step with the column's tangent, census at {N_RAYS} rays: "
          + "; ".join(parts))
    print(f"phase 35 column 0 again {again_ms:.1f} ms (replayed); 1 capture, "
          f"{INVERSE_STEPS} replays a column; in {time.perf_counter() - t_phase:.1f} s on {card}")
    run.paths.append({"name": "inverse_columns_jacfwd", "route": "tangent", "rays": N_RAYS,
                      "steps": INVERSE_STEPS, "ms": [rows[0][0], rows[1][0], again_ms],
                      "peak_gib": [rows[0][1] / 2**30, rows[1][1] / 2**30],
                      "worst_rel": [max(rows[i][2]) for i in (0, 1)],
                      "census_ops": [closed_census.n_ops, jacfwd_census.n_ops],
                      "census_elements_per_ray": [sum(closed_census.elements.values()),
                                                  sum(jacfwd_census.elements.values())]})


def eviction_phase(run):
    """Phase 33: a backward whose adjoint graph was evicted from the cache
    before it ran (ROADMAP C10, repaired by capturing it again).  (a) One
    loss summed over five step counts of the damped slab (five cache keys
    for graphed.CACHE_SIZE places); (b) a forward with gradients, then
    four no-grad runs of other configs through the graph route, then the
    backward.  At EVICT_RAYS rays; the loss bit for bit and every gradient
    within ADJOINT_RTOL of eager autograd's through trace_batch."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.tracing import graphed, graphed_adjoint
    from rays_tpu_torch.tracing.trace import route, trace_batch, trace_rays

    card, dev = run.card, run.dev
    cfg, params, v, st, w = examples.setup_example(examples.SLAB_ECH_DAMPED, device=dev)
    v, st, w = examples.replicate_rays(v, st, w, EVICT_RAYS)
    cfg = dataclasses.replace(cfg, save_trajectory=True)
    require(graphed.CACHE_SIZE < 5, f"a cache of {graphed.CACHE_SIZE} holds five entries")

    def with_grad():
        return tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()),
                        params)

    def loss_of(res):
        return (res.end_ray_vec[:, :6] ** 2).sum() + res.ray_vec.sum() + res.max_residuals.sum()

    def grads(loss, p):
        return torch.autograd.grad(loss, [t for t in tree_leaves(p) if t.is_floating_point()],
                                   allow_unused=True, materialize_grads=True)

    def worst_of(got, ref, what):
        worst = 0.0
        for i, (g, r) in enumerate(zip(got, ref)):
            scale = float(r.abs().max()) if r.numel() else 0.0
            err = float((g - r).abs().max()) if r.numel() else 0.0
            require(bool(torch.isfinite(g).all()) and err <= ADJOINT_RTOL * scale,
                    f"{what}: gradient {i} differs by {err:.3e} of scale {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
        return worst

    steps = [EVICT_STEPS + i for i in range(6)]
    cfgs = [dataclasses.replace(cfg, nstep_max=n) for n in steps[:5]]
    require(all(route(c, True, dev) == "adjoint" for c in cfgs), "expected the adjoint graph")
    t0 = time.perf_counter()
    c0 = graphed_adjoint.CAPTURES
    p = with_grad()
    loss = sum(loss_of(trace_rays(c, p, v, st, w)) for c in cfgs)
    forward_captures = graphed_adjoint.CAPTURES - c0
    got = grads(loss, p)
    backward_captures = graphed_adjoint.CAPTURES - c0 - forward_captures
    q = with_grad()
    ref = sum(loss_of(trace_batch(c, q, v, st, w)) for c in cfgs)
    require(torch.equal(loss.detach(), ref.detach()), "the summed loss differs from eager")
    require(forward_captures == 5 and backward_captures == 1,
            f"captures: {forward_captures} forward, {backward_captures} backward")
    worst = worst_of(got, grads(ref, q), "five configs")
    print(f"phase 33 one loss over five step counts {steps[:5]} (damped slab, {EVICT_RAYS} rays, "
          f"cache of {graphed.CACHE_SIZE}): 5 captures forward, 1 in the backward (the first "
          f"config's, evicted by the fifth); loss equal to eager's bit for bit, {len(got)} "
          f"gradients within {worst:.3e} of scale (bound {ADJOINT_RTOL}); "
          f"{time.perf_counter() - t0:.1f} s")

    # (b) on a sixth step count, whose entry no call has made yet
    t0 = time.perf_counter()
    c0 = graphed_adjoint.CAPTURES
    last = dataclasses.replace(cfg, nstep_max=steps[5])
    p = with_grad()
    loss = loss_of(trace_rays(last, p, v, st, w))
    sg = dataclasses.replace(cfg, ode_solver_name="SG_ODE", sg_scan_substeps=0)
    g0 = graphed.CAPTURES
    with torch.no_grad():
        for n in steps[1:5]:
            c = dataclasses.replace(sg, nstep_max=n)
            require(route(c, False, dev) == "graph", "expected the graph route")
            trace_rays(c, params, v, st, w)
    require(graphed.CAPTURES - g0 == 4, f"{graphed.CAPTURES - g0} graph captures, not 4")
    key = ("adjoint", *graphed.cache_key(last, p, v))
    require(key not in graphed._CACHE, "the forward's entry was not evicted")
    got = grads(loss, p)
    require(graphed_adjoint.CAPTURES - c0 == 2, f"{graphed_adjoint.CAPTURES - c0} captures")
    q = with_grad()
    ref = loss_of(trace_batch(last, q, v, st, w))
    require(torch.equal(loss.detach(), ref.detach()), "the loss differs from eager")
    worst = worst_of(got, grads(ref, q), "backward after four graph captures")
    print(f"phase 33 a forward with gradients, four no-grad SG runs through the graph route, "
          f"then the backward: its entry evicted and captured again in the backward; "
          f"{len(got)} gradients within {worst:.3e} of scale (bound {ADJOINT_RTOL}); "
          f"{time.perf_counter() - t0:.1f} s on {card}")


def registered_model_phase(run):
    """Phase 34: a model of the caller's own on the card.  The built-in
    slab module registered under a new name takes the graph route, the
    adjoint graph and the tangent graph, each held to its eager twin at
    GRAPH_RAYS rays x GRAPH_STEPS steps; registered under "slab" it takes
    the graph route, not B1; a toy with ``fields`` alone (the slab's
    fields shifted in x, whose jacobians come forward over reverse inside
    the tangents' level) takes its tangents through the tangent graph,
    held to eager forward AD through trace_batch at the same size; a
    model that reads the host is refused with a ValueError naming it
    before anything is captured."""
    import types

    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_leaves, tree_map
    from rays_tpu_torch.models import base, slab
    from rays_tpu_torch.tracing import fused_slab, graphed, graphed_adjoint, graphed_tangent
    from rays_tpu_torch.tracing.trace import RayResults, route, trace_batch, trace_rays

    card, dev = run.card, run.dev
    cfg, params, v, st, w = examples.setup_example(device=dev)
    v, st, w = examples.replicate_rays(v, st, w, GRAPH_RAYS)
    cfg = dataclasses.replace(cfg, nstep_max=GRAPH_STEPS, save_trajectory=True)
    t0 = time.perf_counter()
    l0 = fused_slab.LAUNCHES
    lines = []
    for name in ("slab_registered", "slab"):
        c = dataclasses.replace(cfg, equilib_model=name)
        base.register_eq_model(name, slab)
        try:
            require(not fused_slab.supported(c), f"B1 takes the registered {name!r}")
            which = [route(c, False, dev), route(c, True, dev), route(c, False, dev, tangents=True)]
            require(which == ["graph", "adjoint", "tangent"], f"{name!r}: routes {which}")
            with torch.no_grad():
                ref = trace_batch(c, params, v, st, w)
                got = trace_rays(c, params, v, st, w)
            bad = [f for f, g, r in zip(RayResults._fields, got, ref)
                   if (g is None) != (r is None) or (r is not None and not torch.equal(g, r))]
            require(not bad, f"{name!r}: graphed fields {bad} differ from trace_batch's")
            if name != "slab_registered":
                lines.append(f"under {name!r}: graph route bit for bit")
                continue
            p, q = (tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()),
                             params) for _ in range(2))
            losses, grads = [], []
            for tracer, pp in ((trace_rays, p), (trace_batch, q)):
                loss = (tracer(c, pp, v, st, w).end_ray_vec[:, :6] ** 2).sum()
                losses.append(loss.detach())
                grads.append(torch.autograd.grad(
                    loss, [t for t in tree_leaves(pp) if t.is_floating_point()],
                    allow_unused=True, materialize_grads=True))
            require(torch.equal(*losses), f"{name!r}: the adjoint graph's loss differs")
            worst = 0.0
            for g, r in zip(*grads):
                scale, err = float(r.abs().max()), float((g - r).abs().max())
                require(err <= ADJOINT_RTOL * scale, f"{name!r}: gradient differs by {err:.3e}")
                worst = max(worst, err / scale if scale else 0.0)
            direction = tangent_direction(params, v, w, seed=34)
            tworst = tangent_errors(
                traced_tangents(trace_rays, c, params, v, st, w, direction),
                traced_tangents(trace_batch, c, params, v, st, w, direction), name)
            require(tworst <= TANGENT_RTOL, f"{name!r}: tangents differ by {tworst:.3e}")
            lines.append(f"under {name!r}: graph route bit for bit, adjoint gradients within "
                         f"{worst:.3e} of scale, tangents within {tworst:.3e}")
        finally:
            base.EQ_MODELS.pop(name)
    # the toy: fields only, so base.equilibrium takes its jacobians by
    # forward mode, forward over reverse inside the tangents' dual level
    def shifted(rvec):
        return rvec - TOY_SHIFT * torch.eye(3, dtype=rvec.dtype, device=rvec.device)[0]

    toy = types.SimpleNamespace(
        fields=lambda static, p, species, rvec: slab.fields(static, p, species, shifted(rvec)),
        geom_err=slab.geom_err,
        err=lambda static, p, species, rvec: slab.err(static, p, species, shifted(rvec)))
    c = dataclasses.replace(cfg, equilib_model="shifted_slab")
    moved = v.clone()
    moved[:, 0] += TOY_SHIFT
    base.register_eq_model("shifted_slab", toy)
    try:
        which = route(c, False, dev, tangents=True)
        require(which == "tangent", f"the toy's tangents took route {which}")
        direction = tangent_direction(params, moved, w, seed=36)
        t_toy = time.perf_counter()
        ref = traced_tangents(trace_batch, c, params, moved, st, w, direction)
        eager_s = time.perf_counter() - t_toy
        c0, r0 = graphed_tangent.CAPTURES, graphed_tangent.REPLAYS
        got = traced_tangents(trace_rays, c, params, moved, st, w, direction)
        require(graphed_tangent.CAPTURES - c0 == 1 and graphed_tangent.REPLAYS - r0 == GRAPH_STEPS,
                f"the toy's tangent graph: {graphed_tangent.CAPTURES - c0} captures, "
                f"{graphed_tangent.REPLAYS - r0} replays")
        tworst = tangent_errors(got, ref, "the toy")
        require(tworst <= TANGENT_RTOL, f"the toy's tangents differ by {tworst:.3e}")
        require(float(ref["end_ray_vec"][1].abs().max()) > 0, "the toy's tangents are zero")
        require(int(ref["npoints"][0].max()) > GRAPH_STEPS // 2, "the toy's rays stopped early")
        lines.append(f"the toy with fields alone ('shifted_slab', jacobians forward over "
                     f"reverse): tangent graph primal bit for bit, tangents within "
                     f"{tworst:.3e} of eager forward AD ({eager_s:.1f} s eager)")
    finally:
        base.EQ_MODELS.pop("shifted_slab")
    require(fused_slab.LAUNCHES == l0, "a registered model launched B1")

    def fields_and_jac(static, p, species, rvec):
        if rvec[:, 0].max().item() > 1e9:     # a host read
            fail("unreachable")
        return slab.fields_and_jac(static, p, species, rvec)

    reader = types.SimpleNamespace(fields=slab.fields, geom_err=slab.geom_err, err=slab.err,
                                   fields_and_jac=fields_and_jac)
    c = dataclasses.replace(cfg, equilib_model="host_reader")
    base.register_eq_model("host_reader", reader)
    refused = []
    try:
        counts = lambda: (graphed.CAPTURES, graphed_adjoint.CAPTURES,   # noqa: E731
                          graphed_tangent.CAPTURES)
        before = counts()
        for kind in ("graph", "adjoint", "tangent"):
            try:
                if kind == "graph":
                    with torch.no_grad():
                        trace_rays(c, params, v, st, w)
                elif kind == "adjoint":
                    p = tree_map(lambda t: t.detach().clone().requires_grad_(
                        t.is_floating_point()), params)
                    trace_rays(c, p, v, st, w)
                else:
                    traced_tangents(trace_rays, c, params, v, st, w,
                                    tangent_direction(params, v, w, seed=35))
            except ValueError as e:
                require("'host_reader'" in str(e) and "_local_scalar_dense" in str(e),
                        f"{kind}: refused without the model's name: {e}")
                refused.append(kind)
            else:
                fail(f"the host-reading model was not refused on the {kind} route")
        require(counts() == before, f"captures {before} -> {counts()} for a refused model")
        require(not any(k[1] == c for k in graphed._CACHE), "a refused model has an entry")
    finally:
        base.EQ_MODELS.pop("host_reader")
    print(f"phase 34 registered models, {GRAPH_RAYS} rays x {GRAPH_STEPS} steps f64: the slab "
          f"module " + "; ".join(lines) + f"; B1 not launched; a host-reading model refused "
          f"before any capture on the {', '.join(refused)} routes, its name in the ValueError; "
          f"{time.perf_counter() - t0:.1f} s on {card}")



def post_main_path_phase(run):
    """Phase 17: the main path's post-processing at full width.  Kernel B1
    (damped, f64) traces the damped example's 32,768 rays x 400 steps with
    trajectories; then, on the card, the ray diagnostics of every (ray,
    step) point, the resonance and cutoff scan of every ray, the kx roots
    of every ray and every deposition profile, each timed with its peak
    memory, and the first N_HOST_CHECK rays recomputed on the CPU."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.post import deposition, ray_diags, slab_processor
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.tracing.stop import StopCode
    from rays_tpu_torch.tracing.trace import trace_rays
    from rays_tpu_torch.utils import op_rates

    card, dev, paths, f64 = run.card, run.dev, run.paths, torch.float64
    cfg, params, v0, st0, pwr = examples.setup_example(
        examples.SLAB_ECH_DAMPED, device=dev, dtype=f64)
    require(cfg.save_trajectory and fused_slab.supported(cfg),
            "the damped example must ride the kernel with trajectories on")
    vb, stb, wb = examples.replicate_rays(v0, st0, pwr, N_RAYS)
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
    names = deposition.profile_names_for_geometry(cfg.equilib_model, cfg, params)
    require(names == ("Ptotal_x",), f"slab profiles {names}")

    def steps(res):
        rindex = res.start_ray_vec[:, 3:6] / params.rf.k0
        return {
            "ray_diagnostics": lambda: ray_diags.compute_ray_diagnostics(cfg, params, res),
            "res_and_cuts": lambda: slab_processor.find_res_and_cuts(cfg, params, rindex,
                                                                     write_file=False),
            "kx_roots": lambda: slab_processor.kx_profiles(cfg, params, rindex)[1],
            "Ptotal_x": lambda: deposition.calculate_deposition_profile(
                cfg, params, res, "Ptotal_x", n_bins=N_DEP_BINS, xmin=xmin, xmax=xmax).profile,
        }

    trace_rays(dataclasses.replace(cfg, nstep_max=3), params, vb, stb, wb)   # build, warm-up
    # the main path, counted: the kernel's trace, then post-processing
    fused_slab.LAUNCHES = 0
    t_trace, res = timed(lambda: trace_rays(cfg, params, vb, stb, wb))
    launches = fused_slab.LAUNCHES
    require(launches >= 1, "phase 17's trace did not launch the damped kernel")
    for fn in steps(first_rays(res, N_HOST_CHECK)).values():    # warm-up of each step
        fn()
    out, line = {}, []
    for name, fn in steps(res).items():
        ms, out[name], peak = timed_peak(fn)
        line.append(f"{name} {ms:.1f} ms (peak {peak / 2**30:.2f} GiB)")
        paths.append({"name": f"post_slab_{name}", "ms": ms, "peak_gib": peak / 2**30})
    require(fused_slab.LAUNCHES == launches, "post-processing launched the kernel")
    B, n_pts, nv = res.ray_vec.shape
    absorbed = int((res.stop_flag == StopCode.TOTAL_ABSORPTION).sum())
    diags = out["ray_diagnostics"]
    # the bytes the diagnostics must move: the trajectories, residuals and
    # npoints read once, every variable written once
    n_read = (res.ray_vec.numel() + res.residual.numel()) * 8 + res.npoints.numel() * 4
    n_written = sum(v.numel() * v.element_size() for v in diags.values())
    floor = (n_read + n_written) / op_rates.HBM_BYTES_PER_S * 1e3
    paths[-4]["bound_ms"] = floor
    print(f"phase 17 damped B1 f64 {B} rays x {n_pts} points (trajectories on): trace "
          f"{t_trace:.1f} ms, {launches} launch; {absorbed} rays end with TOTAL_ABSORPTION; "
          f"post-processing on the card: " + ", ".join(line) + f"; diagnostics: "
          f"{len(diags)} variables, {n_read / 1e9:.3f} GB read + {n_written / 1e9:.3f} GB "
          f"written = bytes floor {floor:.3f} ms, {floor / paths[-4]['ms']:.4f} of it on {card}")
    require(absorbed > 0, "no ray of phase 17 was absorbed")
    require(all(bool(torch.isfinite(v).all()) for v in diags.values()), "non-finite diagnostics")

    # the first rays again on the CPU
    n = N_HOST_CHECK
    host_params = tree_to(params, "cpu")
    host_res = tree_to(first_rays(res, n), "cpu")
    host_rindex = host_res.start_ray_vec[:, 3:6] / host_params.rf.k0
    diag_err = require_same_diagnostics(
        diags, ray_diags.compute_ray_diagnostics(cfg, host_params, host_res), "phase 17")
    host_cuts = slab_processor.find_res_and_cuts(cfg, host_params, host_rindex, write_file=False)
    width = xmax - xmin
    for i, (c, h) in enumerate(zip(out["res_and_cuts"][:n], host_cuts)):
        require([len(v) for v in c.values()] == [len(v) for v in h.values()],
                f"ray {i}: crossing counts card {[len(v) for v in c.values()]} != CPU")
        for k in h:
            require(np.all(np.abs(c[k] - h[k]) <= POST_TOL * width), f"ray {i} {k} crossings")
    n_cross = sum(len(v) for e in out["res_and_cuts"] for v in e.values())
    host_kx = slab_processor.kx_profiles(cfg, host_params, host_rindex)[1]
    kx_err = float((out["kx_roots"][:n].cpu() - host_kx).abs().max() / host_kx.abs().max())
    require(kx_err <= POST_TOL, f"kx roots card vs CPU {kx_err:.3e}")
    dep_card = steps(first_rays(res, n))["Ptotal_x"]().cpu()
    dep_host = deposition.calculate_deposition_profile(
        cfg, host_params, host_res, "Ptotal_x", n_bins=N_DEP_BINS, xmin=xmin, xmax=xmax).profile
    dep_err = float((dep_card - dep_host).abs().max() / dep_host.abs().max())
    require(dep_err <= POST_TOL, f"deposition card vs CPU {dep_err:.3e}")
    print(f"phase 17 card vs CPU on the first {n} rays: diagnostics {diag_err:.3e} of scale "
          f"(bounds {POST_TOL}, n_imag {N_IMAG_TOL}); crossings equal in count, locations "
          f"within {POST_TOL} of the box ({n_cross} crossings over all rays); kx roots "
          f"{kx_err:.3e}; Ptotal_x {dep_err:.3e} (total absorbed "
          f"{float(out['Ptotal_x'].sum()):.6f} of 1)")


def post_spline_phase(run):
    """Phase 18: the EQDSK and mirror batches with trajectories, their ray
    diagnostics and the toroid and mirror processors (the latter with the
    O-X analysis) on the card, timed, and the first N_HOST_CHECK rays and
    the geometry files held to the CPU."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.post import mirror_processor, ox_conversion, ray_diags
    from rays_tpu_torch.post import toroid_processor

    card, dev, paths = run.card, run.dev, run.paths
    cwd = os.getcwd()
    for name, write, processor in (
            ("EQDSK", examples.write_eqdsk_toroid_example, toroid_processor),
            ("mirror", examples.write_mirror_example, mirror_processor)):
        with tempfile.TemporaryDirectory() as tmp:
            _, (cfg, params, v0, st0, pwr) = spline_example(write, tmp, dev)
            vb, stb, wb = examples.replicate_rays(v0, st0, pwr, N_RAYS)
            res, t_trace, _, _ = graph_run(cfg, params, vb, stb, wb)
            ray_diags.compute_ray_diagnostics(cfg, params, first_rays(res, N_HOST_CHECK))
            t_diag, diags, peak_diag = timed_peak(
                lambda: ray_diags.compute_ray_diagnostics(cfg, params, res))
            dirs = {k: os.path.join(tmp, k) for k in ("card", "cpu")}
            for d in dirs.values():
                os.mkdir(d)
            os.chdir(dirs["card"])
            try:
                t_proc, proc_out, peak_proc = timed_peak(
                    lambda: processor.process(cfg, params, res))
                host_params = tree_to(params, "cpu")
                host_res = tree_to(first_rays(res, N_HOST_CHECK), "cpu")
                os.chdir(dirs["cpu"])
                processor.process(cfg, host_params, host_res)
            finally:
                os.chdir(cwd)
            diag_err = require_same_diagnostics(
                diags, ray_diags.compute_ray_diagnostics(cfg, host_params, host_res),
                f"phase 18 {name}")
            files = require_same_files(dirs["card"], dirs["cpu"], skip=("OX_conversion",))
            ox = ""
            if processor is mirror_processor:
                card_ox = ox_conversion.ox_conv_analysis(cfg, params,
                                                         first_rays(res, N_HOST_CHECK))
                host_ox = ox_conversion.ox_conv_analysis(cfg, host_params, host_res)
                require([(c.ray_number, c.step_number) for c in card_ox]
                        == [(c.ray_number, c.step_number) for c in host_ox],
                        "O-X records card != CPU")
                for c, h in zip(card_ox, host_ox):
                    require(abs(c.conv_coeff - h.conv_coeff) <= N_IMAG_TOL * abs(h.conv_coeff)
                            and np.allclose(c.x_cut, h.x_cut, rtol=0, atol=POST_TOL),
                            "O-X coefficient or cutoff point card != CPU")
                n_cand = int(ox_conversion.candidates(cfg, params, res)[0].numel())
                ox = (f"; O-X: {n_cand} rays with an interior maximum of alpha below the "
                      f"cutoff, {proc_out['n_converted']} of {N_RAYS} convert, "
                      f"{len(host_ox)} of the first {N_HOST_CHECK} on both")
        tag = name.lower()
        paths.append({"name": f"post_{tag}_ray_diagnostics", "ms": t_diag,
                      "peak_gib": peak_diag / 2**30})
        paths.append({"name": f"post_{tag}_process", "ms": t_proc, "peak_gib": peak_proc / 2**30})
        print(f"phase 18 {name} {N_RAYS} rays x {cfg.nstep_max} RK4 steps with trajectories: "
              f"trace {t_trace:.1f} ms; ray diagnostics {t_diag:.1f} ms (peak "
              f"{peak_diag / 2**30:.2f} GiB), {processor.__name__.split('.')[-1]}.process "
              f"{t_proc:.1f} ms (peak {peak_proc / 2**30:.2f} GiB){ox}; card vs CPU on the "
              f"first {N_HOST_CHECK} rays: diagnostics {diag_err:.3e} of scale, files {files} "
              f"equal within {POST_TOL} on {card}")


# the files the post-processor CLI writes for each example, by run label
POST_FILES = {
    "slab": ["res_and_cut.{L}", "eq_X_profiles.{L}.nc", "kx_profiles_slab.{L}.nc",
             "kx_profiles_slab.{L}", "graphics_description_slab.dat",
             "ray_detailed_diagnostics_slab.{L}.nc", "deposition_profiles.{L}.nc"],
    "solovev": ["eq_RZ_grids.{L}.nc", "eq_contours.{L}.nc", "normalized_psi.{L}.nc",
                "eq_radial_profiles.{L}.nc", "graphics_description_solovev.dat",
                "ray_detailed_diagnostics.{L}.nc"],
    "axisym_toroid": ["eq_RZ_grids.{L}.nc", "eq_contours.{L}.nc", "normalized_psi.{L}.nc",
                      "eq_radial_profiles.{L}.nc", "graphics_description_axisym_toroid.dat",
                      "ray_detailed_diagnostics.{L}.nc"],
    "multiple_mirror": ["eq_contours.{L}.nc", "eq_radial_profiles.{L}.nc",
                        "graphics_description_mirror.dat", "ray_detailed_diagnostics.{L}.nc",
                        "OX_conversion.{L}"],
}


def post_cli_phase(run):
    """Phase 19: ``python -m rays_tpu_torch.run`` and then ``python -m
    rays_tpu_torch.post.process`` as a user calls them (the default device)
    on the damped slab, Solovev, EQDSK and mirror examples, each in a
    directory of its own and the four side by side; every expected file
    read back."""
    from scipy.io import netcdf_file

    from rays_tpu_torch import examples
    from rays_tpu_torch.config import schema
    from rays_tpu_torch.post.xy_curves import read_xy_curves_nc

    def write_text(text):
        return lambda d: _write(os.path.join(d, "rays.in"), text)

    cases = {
        "damped slab": write_text(examples.SLAB_ECH_DAMPED),
        "Solovev": write_text(examples.SOLOVEV_ECH_90GHZ),
        "EQDSK": lambda d: spline_example_files(examples.write_eqdsk_toroid_example, d),
        "mirror": lambda d: spline_example_files(examples.write_mirror_example, d),
    }

    def pipeline(name, tmp):
        t0 = time.perf_counter()
        path = cases[name](tmp)
        cfg, _ = schema.from_file(path)
        run_cli(path, tmp)
        _write(os.path.join(tmp, "post_process_rays.in"), "&post_process_list\n/\n")
        out = run_module("rays_tpu_torch.post.process", [path], tmp)
        require("device: cuda" in out, f"the post-processor did not run on the card:\n{out}")
        label = cfg.run_label
        npoints = np.array(netcdf_file(os.path.join(tmp, f"run_results.{label}.nc"), "r",
                                       mmap=False).variables["npoints"][:])
        for fname in (f.format(L=label) for f in POST_FILES[cfg.equilib_model]):
            full = os.path.join(tmp, fname)
            require(os.path.exists(full), f"{name}: the post-processor wrote no {fname}")
            if fname.endswith(".nc") and fname.startswith(("eq_X", "kx_", "eq_radial")):
                curves = read_xy_curves_nc(full)
                require(curves and all(np.isfinite(c.curve).all() for c in curves),
                        f"{name}: {fname}")
            elif fname.endswith(".nc"):
                data = _read_outputs(full)
                require(all(np.isfinite(v).all() for v in data.values() if v.dtype.kind == "f"),
                        f"{name}: {fname} has non-finite values")
                if fname.startswith("ray_detailed"):
                    require(np.array_equal(data["npoints"], npoints), f"{name}: {fname} npoints")
            else:
                require(os.path.getsize(full) > 0, f"{name}: {fname} is empty")
        return len(POST_FILES[cfg.equilib_model]), time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as root:
        with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
            futures = {}
            for name in cases:
                d = os.path.join(root, name.replace(" ", "_"))
                os.mkdir(d)
                futures[name] = pool.submit(pipeline, name, d)
            done = {name: f.result() for name, f in futures.items()}
    for name, (n, sec) in done.items():
        run.paths.append({"name": f"post_cli_{name.replace(' ', '_').lower()}",
                          "ms": sec * 1e3, "files": n})
    print("phase 19 run CLI then post-processor CLI, four examples side by side on "
          f"{run.card}: " + "; ".join(f"{name}: {n} files read back, {s:.1f} s"
                                      for name, (n, s) in done.items()))


# --------------------------------------------------------------------------
# the tools group: phases 20-24
# --------------------------------------------------------------------------

SCAN_SIZES = (256, 1024, 4096, 16384, 65536, 262144, 524288)   # tools/run_batch_scan.py
RK4_ORDER_TOL = 0.5         # measured RK4 order of the ds scan's first rungs, against 4
SPLIT_RTOL, SPLIT_ATOL = 1e-10, 1e-14   # __graft_entry__.py: profile and ray_vec
COMP_STEPS = 100            # the compensated carry: f32 slab x 100 steps
COMP_ULP = 1.2e-7           # tests/test_precision.py: the carry under 100 ulp of scale
INVERSE_STEPS = 80          # scripts/inverse_demo.py's depth
INVERSE_STEPS_DEFAULT = 40  # ... in the default call, which runs every group
INVERSE_RTOL = 1e-10        # card vs CPU at the starting point, of scale
INVERSE_ITERS = 2           # Adam iterations timed (the demo runs 50, then Gauss-Newton)
TOOL_TIMEOUT = 600          # seconds for each process of the group


def _tool(name):
    """A module of tools/ imported by its path."""
    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(f"tool_{name}",
                                                  os.path.join(root, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start_tool(name, args, out_path):
    """``python tools/<name>.py args`` in the background, its output to
    ``out_path``."""
    root = os.path.dirname(os.path.abspath(__file__))
    log = open(out_path, "w")
    proc = subprocess.Popen([sys.executable, os.path.join(root, "tools", f"{name}.py"), *args],
                            cwd=root, stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, log


def _finish_tool(proc, log, what):
    """Wait for a background tool (TOOL_TIMEOUT), require exit 0 and
    return its output and its last line as JSON."""
    try:
        proc.wait(timeout=TOOL_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    with open(log.name) as f:
        out = f.read()
    require(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{out[-4000:]}")
    return out, json.loads(out.strip().splitlines()[-1])


def tools_phases(run, fill, inverse_steps):
    """Phases 20-24: the scans, validate_all, the erays pipeline and the
    docs, rays split across processes, the compensated carry and the
    inverse demo.  The batch scan runs first and alone on the card; then
    three tools start as processes of their own (the ds scan's adaptive
    ladder, validate_all, the two-process dry run) and run side by side
    with phases 22-24, whose times include that sharing; their lines come
    when they end.  ``fill``: phase 5's result at the filled card, or None
    when the kernel group did not run; ``inverse_steps``: the RK4 steps of
    the inverse demo's traces."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.tracing.trace import trace_rays

    card, dev, paths = run.card, run.dev, run.paths
    f32, f64 = torch.float32, torch.float64
    fused_slab.load_libraries()     # built once, before any process of the group starts

    # phase 20: the batch scan, B1 at f32 and f64 over 256 ... 524,288 rays
    batch_tool = _tool("run_batch_scan")
    require(tuple(batch_tool.SIZES) == SCAN_SIZES, f"batch sizes {batch_tool.SIZES}")
    fused_slab.LAUNCHES = 0
    rows = batch_tool.run(dev.type, SCAN_SIZES)
    launches = fused_slab.LAUNCHES
    # a warm-up and a timed trace per size and precision
    require(launches == 2 * 2 * len(SCAN_SIZES), f"the batch scan launched B1 {launches} times")
    for name, rs in rows.items():
        print(f"phase 20 batch scan {name}, slab x 500 steps through B1 ({launches} launches "
              f"in all): " + ", ".join(f"{r['batch']}: {r['rays_per_s']:.0f} rays/s "
                                       f"({r['wall_s'] * 1e3:.3f} ms)" for r in rs)
              + f" on {card}")
        paths.append({"name": f"batch_scan_{name}", "launches": launches // 2,
                      "ms": [r["wall_s"] * 1e3 for r in rs],
                      "rays_per_s": [r["rays_per_s"] for r in rs], "batch": list(SCAN_SIZES)})
    # the largest batch again, held to phase 5's kernel result for the same rays
    cfg, params, v0, st0, pwr = examples.setup_example(device=dev)
    cfg = dataclasses.replace(cfg, save_trajectory=False)
    vf, stf, wf = examples.replicate_rays(v0, st0, pwr, SCAN_SIZES[-1])
    if fill is None:   # the kernel group did not run: phase 5's launch, here
        fill = {dt: (lambda r: (r.end_ray_vec, r.npoints))(fused_slab.trace_batch_fused(
            cfg, tree_to(params, dtype=dt), vf.to(dt), stf, wf.to(dt))) for dt in (f32, f64)}
    big = trace_rays(cfg, params, vf, stf, wf)
    require(torch.equal(big.end_ray_vec, fill[f64][0]) and torch.equal(big.npoints, fill[f64][1]),
            "the largest f64 batch differs from phase 5's")
    big32 = trace_rays(cfg, tree_to(params, dtype=f32), vf.to(f32), stf, wf.to(f32))
    require(torch.equal(big32.end_ray_vec, fill[f32][0]) and torch.equal(big32.npoints, fill[f32][1]),
            "the largest f32 batch differs from phase 5's")
    err32 = scaled_err(big32.end_ray_vec, fill[f64][0], per_ray_axis=-1)
    require(err32 <= F32_RTOL, f"the largest f32 batch's endpoints {err32:.3e} off the f64")
    print(f"phase 20 largest batch ({SCAN_SIZES[-1]} rays): f64 and f32 bit-equal to phase "
          f"5's B1 results for the same rays, f32 within {err32:.3e} of scale of the f64")
    del vf, stf, wf, big, big32

    # phase 20: the ds scan, RK4 through B1 here, the adaptive ladder in
    # a process of its own
    ds_tool = _tool("run_ds_scan")
    ds_rows, orders, ds_launches = ds_tool.run(dev.type, ("RK4_ODE",), log=lambda m: None)
    rk4 = orders["RK4_ODE"]
    require(ds_launches["RK4_ODE"] == ds_tool.N_RUNGS,
            f"the RK4 ds scan launched B1 {ds_launches['RK4_ODE']} times")
    require(abs(rk4[0] - 4.0) < RK4_ORDER_TOL, f"RK4 convergence order {rk4}")
    print(f"phase 20 ds scan RK4, {ds_tool.N_RUNGS} rungs (ds0/2^i, {ds_tool.N0}*2^i steps) "
          f"through B1 ({ds_launches['RK4_ODE']} launches): errors vs the finest "
          f"{[r['err_vs_finest'] for r in ds_rows]}, measured orders {rk4}; wall "
          f"{[round(r['wall_s'] * 1e3, 3) for r in ds_rows]} ms")
    paths.append({"name": "ds_scan_rk4", "ms": sum(r["wall_s"] for r in ds_rows) * 1e3,
                  "launches": ds_launches["RK4_ODE"], "orders": rk4})

    import concurrent.futures

    from rays_tpu_torch import entry

    tmp = tempfile.TemporaryDirectory()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    started = time.perf_counter()
    bg = {"ds_sg": _start_tool("run_ds_scan", [
              "--device", dev.type, "--solvers", "SG_ODE",
              "--out", os.path.join(tmp.name, "ds_sg.txt")], os.path.join(tmp.name, "ds_sg.log")),
          "validate": _start_tool("validate_all", ["--device", dev.type],
                                  os.path.join(tmp.name, "validate.log"))}
    dryrun = pool.submit(entry.dryrun_multiprocess, 2, dev.type, None, None,
                         entry.DRYRUN_STEPS, TOOL_TIMEOUT)
    try:
        erays_phase(run)
        split_phase(run)
        compensated_phase(run)
        inverse_phase(run, inverse_steps)

        out, sg = _finish_tool(*bg.pop("ds_sg"), "tools/run_ds_scan.py --solvers SG_ODE")
        sg_rows = sg["rows"]
        require(sg["launches"] == {"SG_ODE": 0}, f"the SG ladder launched B1: {sg['launches']}")
        require([r["min_npoints"] for r in sg_rows] == [r["nstep"] + 1 for r in sg_rows],
                f"SG ladder npoints {[r['min_npoints'] for r in sg_rows]}")
        print(f"phase 20 ds scan SG (plain, a process of its own): errors vs the finest "
              f"{[r['err_vs_finest'] for r in sg_rows]}, orders {sg['orders']['SG_ODE']}; "
              f"wall {[round(r['wall_s'], 3) for r in sg_rows]} s")
        paths.append({"name": "ds_scan_sg", "ms": sum(r["wall_s"] for r in sg_rows) * 1e3})

        out, val = _finish_tool(*bg.pop("validate"), "tools/validate_all.py")
        stages = val["stages"]
        require(list(stages) == ["slab", "damped", "solovev", "axisym", "mirror"]
                and all(r["ok"] for r in stages.values()), f"validate_all: {stages}")
        for name in ("slab", "damped"):
            require(stages[name]["route"] == "kernel" and stages[name]["launches"] >= 1,
                    f"validate_all {name} did not run B1: {stages[name]}")
        for name in ("solovev", "axisym", "mirror"):
            require(stages[name]["route"] == "graph" and stages[name]["launches"] == 0,
                    f"validate_all {name}: {stages[name]}")
        print("phase 21 tools/validate_all.py on the card: " + "; ".join(
            f"{n} PASS, {r['route']} ({r['launches']} launches), trace {r['wall_s']:.3f} s, "
            f"stage {r['stage_s']:.2f} s, npoints {r['npoints']}, max residual "
            f"{r['max_residual']:.3e}" for n, r in stages.items())
            + "; mirror: the port's four-coil mirror in place of the reference's MPEX example")
        paths.append({"name": "validate_all", "ms": sum(r["stage_s"] for r in stages.values())
                      * 1e3, "stages_s": {n: r["stage_s"] for n, r in stages.items()}})

        reports = dryrun.result(timeout=TOOL_TIMEOUT)
        require([r["backend"] for r in reports] == ["gloo", "gloo"]
                and [r["device"] for r in reports] == [str(dev)] * 2,
                f"dry run processes: {reports}")
        r0 = reports[0]
        require(all(r[k] == r0[k] for r in reports for k in ("loss", "grad_l1")),
                "the two processes' losses or gradients differ")
        print(f"phase 23 entry.dryrun_multiprocess(2): two processes on the one card over gloo "
              f"(NCCL refuses two ranks on one device), damped slab {r0['rays'][2]} rays x "
              f"{r0['nstep']} steps with trajectories, route {r0['route']} (the training step's "
              f"gradients), rays {[r['rays'][:2] for r in reports]}: "
              f"split == whole at __graft_entry__.py's tolerances on each; loss "
              f"{r0['loss']:.12e}, gradient l1 {r0['grad_l1']:.6e} over {r0['leaves']} leaves, "
              f"deposition {r0['deposition_sum']:.6e}; split step "
              f"{[round(r['split_s'], 2) for r in reports]} s, whole step "
              f"{[round(r['whole_s'], 2) for r in reports]} s; no scaling is claimed (one card)")
        paths.append({"name": "dryrun_multiprocess_2", "ms": max(r["split_s"] for r in reports)
                      * 1e3, "whole_ms": max(r["whole_s"] for r in reports) * 1e3})
    finally:
        for proc, log in bg.values():
            proc.kill()
            proc.wait()
            log.close()
        pool.shutdown(wait=True, cancel_futures=True)
        tmp.cleanup()
    print(f"phases 20-24: {time.perf_counter() - started:.1f} s from the start of the "
          f"side-by-side processes")


def erays_phase(run):
    """Phase 22: the erays pipeline on the damped slab through B1, its
    netCDF file read back through the port's netCDF4 shim, and the docs."""
    from scipy.io import netcdf_file

    from rays_tpu_torch import examples
    from rays_tpu_torch.compat import netCDF4 as shim
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.utils import doc_modules, erays

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        _write(os.path.join(tmp, "rays.in"), examples.SLAB_ECH_DAMPED)
        os.chdir(tmp)
        try:
            fused_slab.LAUNCHES = 0
            t0 = time.perf_counter()
            out = erays.run_pipeline("rays.in", device=str(run.dev))
            wall = time.perf_counter() - t0
            launches = fused_slab.LAUNCHES
        finally:
            os.chdir(cwd)
        require(launches >= 1, "the erays pipeline did not launch B1")
        files = sorted(os.listdir(tmp))
        nc = os.path.join(tmp, out["nc"])
        ds, ref = shim.Dataset(nc), netcdf_file(nc, "r", mmap=False)
        try:
            for name, var in ref.variables.items():
                want = np.asarray(var[:] if var.shape else var.getValue())
                require(np.array_equal(np.asarray(ds.variables[name]), want),
                        f"the shim reads {name} otherwise than scipy")
            n_vars = len(ref.variables)
        finally:
            ds.close()
            ref.close()
        mod, nml = doc_modules.write_docs(os.path.join(tmp, "docs"))
        with open(mod) as f:
            text = f.read()
        require("\n## rays_tpu_torch/entry.py\n" in text and os.path.getsize(nml) > 0,
                "write_docs wrote no module section or no namelist file")
    res = out["results"]
    print(f"phase 22 erays pipeline, damped slab on {run.dev} ({launches} B1 launch): "
          f"{wall:.2f} s (trace {out['wall'] * 1e3:.1f} ms), npoints {res.npoints.tolist()}, "
          f"post-processing {sorted(out['post'])}; {len(files)} files {files}; "
          f"{out['nc']} read back through the netCDF4 shim equal to scipy ({n_vars} "
          f"variables); write_docs wrote {os.path.basename(mod)} and {os.path.basename(nml)}")
    run.paths.append({"name": "erays_pipeline", "ms": wall * 1e3, "launches": launches})


def split_phase(run):
    """Phase 23: a world of one process over NCCL on the card: the split
    trace of the damped batch and its all_reduced deposition profile
    against trace_rays and calculate_deposition_profile."""
    import torch.distributed as dist

    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.parallel import multihost, sharded
    from rays_tpu_torch.post import deposition
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.tracing.trace import trace_rays

    dev = run.dev
    cfg, params, v0, st0, pwr = examples.setup_example(examples.SLAB_ECH_DAMPED, device="cpu")
    vg, sg, wg = examples.replicate_rays(v0, st0, pwr, N_RAYS)    # the launch grid, on the host
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
    params = tree_to(params, dev)
    with tempfile.TemporaryDirectory() as tmp:
        rank, world = multihost.initialize(init_method="file://" + os.path.join(tmp, "rdv"),
                                           num_processes=1, process_id=0, device=dev.type)
        try:
            backend = dist.get_backend()
            require((rank, world) == (0, 1) and backend == ("nccl" if dev.type == "cuda"
                                                            else "gloo"),
                    f"world {(rank, world)} over {backend}")
            mesh = multihost.global_ray_mesh()
            lo, hi = multihost.local_ray_slice(N_RAYS)
            lv, ls, lw = multihost.distribute_rays(mesh, vg[lo:hi], sg[lo:hi], wg[lo:hi],
                                                   device=dev.type)
            tracer = multihost.make_multihost_tracer(cfg, mesh)
            fused_slab.LAUNCHES = 0
            t_trace, res = timed(lambda: tracer(params, lv, ls, lw))
            launches = fused_slab.LAUNCHES
            require(launches >= 1, "the split trace did not launch B1")
            t_prof, prof = timed(lambda: deposition.calculate_deposition_profile(
                cfg, params, res, "Ptotal_x", n_bins=N_BINS, xmin=xmin, xmax=xmax).profile)
            t_red, prof_g = timed(lambda: sharded.all_reduce_sum(prof.clone(), mesh))
        finally:
            dist.destroy_process_group()
    whole = trace_rays(cfg, params, vg.to(dev), sg.to(dev), wg.to(dev))
    prof0 = deposition.calculate_deposition_profile(cfg, params, whole, "Ptotal_x",
                                                    n_bins=N_BINS, xmin=xmin, xmax=xmax).profile
    for got, ref, what in ((res.ray_vec, whole.ray_vec[lo:hi], "ray_vec"),
                           (prof_g, prof0, "profile")):
        err = float((got - ref).abs().max())
        require(bool(torch.allclose(got, ref, rtol=SPLIT_RTOL, atol=SPLIT_ATOL)),
                f"split {what} differs from the whole run's by {err:.3e}")
    require(torch.equal(res.npoints, whole.npoints[lo:hi]), "split npoints differ")
    print(f"phase 23 world of 1 over {backend} on {dev}: rays {lo}:{hi} of {N_RAYS} damped, "
          f"trace with trajectories {t_trace:.1f} ms ({launches} B1 launch), Ptotal_x "
          f"{t_prof:.1f} ms, all_reduce {t_red:.3f} ms; ray_vec and the reduced profile equal "
          f"trace_rays + calculate_deposition_profile (rtol {SPLIT_RTOL}, atol {SPLIT_ATOL}; "
          f"max diff {float((prof_g - prof0).abs().max()):.3e}), deposition "
          f"{float(prof_g.sum()):.6f}")
    run.paths.append({"name": "split_world_1", "ms": t_trace + t_prof + t_red,
                      "launches": launches})


def compensated_phase(run):
    """Phase 24: the compensated carry, f32 slab at N_RAYS x COMP_STEPS
    through the graph route, against the same run without the carry."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.tracing.trace import route, trace_batch, trace_rays

    dev = run.dev
    cfg, params, v0, st0, pwr = examples.setup_example(device=dev, dtype=torch.float32)
    plain_cfg = dataclasses.replace(cfg, nstep_max=COMP_STEPS, save_trajectory=False)
    comp_cfg = dataclasses.replace(plain_cfg, compensated_sum=True)
    require(route(comp_cfg, False, dev) == "graph" and not fused_slab.supported(comp_cfg),
            "a compensated run must take the graph route")
    vb, sb, wb = examples.replicate_rays(v0, st0, pwr, N_RAYS)
    before = fused_slab.LAUNCHES
    # warm-up of both; the carry's with its capture
    trace_batch(dataclasses.replace(plain_cfg, nstep_max=3), params, vb, sb, wb)
    trace_rays(comp_cfg, params, vb, sb, wb)
    t_plain, plain = timed(lambda: trace_batch(plain_cfg, params, vb, sb, wb))
    t_comp, comp = timed(lambda: trace_rays(comp_cfg, params, vb, sb, wb))
    require(fused_slab.LAUNCHES == before, "the compensated run launched B1")
    require(torch.equal(comp.end_ray_vec, plain.end_ray_vec)
            and torch.equal(comp.npoints, plain.npoints),
            "the compensated state is not bit-equal to the plain run's")
    c = comp.end_ray_comp.double()
    scale = comp.end_ray_vec.double().abs().amax(dim=0) + 1e-300
    ratio = float((c.abs().amax(dim=0) / scale).max())
    require(bool(torch.isfinite(c).all()) and float(c.abs().max()) > 0
            and ratio < COMP_STEPS * COMP_ULP, f"carry: ratio {ratio:.3e}")
    print(f"phase 24 compensated carry, f32 slab {N_RAYS} rays x {COMP_STEPS} steps on {dev} "
          f"(graph route): state and npoints bit-equal to the run without it; carry finite, "
          f"nonzero, at most {ratio:.3e} of scale (bound {COMP_STEPS * COMP_ULP:.1e}); "
          f"{t_comp:.1f} ms with the carry (graphed), {t_plain:.1f} ms without (eager)")
    run.paths.append({"name": "compensated_f32", "route": "graph", "ms": t_comp,
                      "plain_ms": t_plain})


def inverse_phase(run, steps):
    """Phase 24: the inverse demo at its starting point on the card
    against the CPU, the start's time split into the loss, its gradient
    and each forward-mode column (each route's first call, with its
    capture), and a few of its iterations timed, at ``steps`` of its
    INVERSE_STEPS RK4 steps."""
    inv = _tool("inverse_demo")
    dev = run.dev
    t0 = time.perf_counter()
    card = inv.start_point(nstep_max=steps, device=str(dev))
    t_start = time.perf_counter() - t0
    routes = card["routes"]
    require(routes == {"loss": "graph", "gradient": "adjoint", "columns": "tangent"},
            f"inverse demo routes {routes}")
    host = inv.InverseProblem(steps, "cpu")
    loss_h, grad_h = host.value_and_grad(host.start)
    _, j0_h, j1_h = host.jvp_columns(host.start)
    loss_err = abs(float(card["loss"]) - float(loss_h)) / abs(float(loss_h))
    grad_err = float((card["grad"].cpu() - grad_h).abs().max() / grad_h.abs().max())
    col_err = max(float((card[k].cpu() - h).abs().max() / h.abs().max())
                  for k, h in (("j0", j0_h), ("j1", j1_h)))
    require(loss_err <= INVERSE_RTOL and grad_err <= INVERSE_RTOL and col_err <= INVERSE_RTOL,
            f"inverse demo start, card vs CPU: loss {loss_err:.3e}, gradient {grad_err:.3e}, "
            f"columns {col_err:.3e}")
    require(bool(torch.isfinite(card["j0"]).all() and torch.isfinite(card["j1"]).all()),
            "non-finite Jacobian columns")
    lines = []
    t0 = time.perf_counter()
    out = inv.run_demo(n_iters=INVERSE_ITERS, nstep_max=steps, n_newton=0,
                       log=lines.append, device=str(dev))
    t_demo = time.perf_counter() - t0
    require(all(np.isfinite(h[0]) for h in out["history"]), "non-finite demo loss")
    cut = (f" (cut from {INVERSE_STEPS} to fit the default run; --group tools runs all)"
           if steps < INVERSE_STEPS else "")
    split = ", ".join(f"{k} {v:.2f} s" for k, v in card["seconds"].items())
    print(f"phase 24 inverse demo ({card['target'].shape[0]} rays x {steps} RK4 steps{cut}) "
          f"at its start on {dev}: loss {float(card['loss']):.12e}, gradient "
          f"{card['grad'].tolist()} (routes: loss {routes['loss']}, gradient "
          f"{routes['gradient']}, columns {routes['columns']}), equal to the CPU's within "
          f"{loss_err:.3e}, {grad_err:.3e} and {col_err:.3e} (columns) of scale (bound "
          f"{INVERSE_RTOL}); the start {t_start:.2f} s: {split} (each the route's first call, "
          f"its capture included); {INVERSE_ITERS} Adam iterations {t_demo:.2f} s (losses "
          f"{[f'{h[0]:.3e}' for h in out['history']]})")
    run.paths.append({"name": "inverse_demo", "ms": t_demo * 1e3, "start_ms": t_start * 1e3,
                      "start_split_ms": {k: v * 1e3 for k, v in card["seconds"].items()},
                      "steps": steps, "iterations": INVERSE_ITERS})


# --- phases 25-28: the JAX repo's measurement scripts as tools on the card ---

PROFILE_STEPS = 16              # outer steps of a profiled window (tools/step_profile.py)
PROFILE_STEPS_DEFAULT = 4       # ... in the default call, which runs every group
PROBE_STEPS_DEFAULT = 100       # RK4 steps of the precision probe (its depth: 500)
MIRROR_STEPS = 500              # scripts/profile_mirror.py's depth
MIRROR_STEPS_DEFAULT = 100
MIRROR_LOOP_ITERS = 500         # the loops of scripts/profile_mirror2.py
MIRROR_LOOP_ITERS_DEFAULT = 100
# what each op-rate kernel stands for in scripts/vpu_roofline.py
VPU_ROOFLINE_CHAINS = "scripts/vpu_roofline.py:41"      # _chain, scanned by measure (:50)
VPU_ROOFLINE_MATVEC = "scripts/vpu_roofline.py:104"     # dot_body, the tiny dot_general


def _cut(full, depth, default, what, group="profile"):
    """(depth, the text that states the cut) of a phase of ``group``."""
    if full:
        return depth, ""
    return default, (f" ({what} cut from {depth} to {default} in the default call; "
                     f"--group {group} runs all)")


def profile_phases(run, full):
    """Phases 25-28: tools/step_profile.py, op_roofline.py,
    precision_probe.py and profile_mirror.py on the card.  Each writes its report under build/; the lines here condense
    them.  ``full``: the depths of the tools (--group profile), else the
    cut ones.  Returns the op-rate kernels' rows for the kernels line."""
    from rays_tpu_torch.tracing import fused_slab
    from rays_tpu_torch.utils import measure, op_rates

    card, dev = run.card, run.dev
    quiet = lambda msg: None  # noqa: E731

    # phase 25: the step profile
    steps, cut = _cut(full, PROFILE_STEPS, PROFILE_STEPS_DEFAULT, "profiled outer steps")
    t0 = time.perf_counter()
    fused_slab.LAUNCHES = 0
    sp = _tool("step_profile")
    # the default call profiles the training step's backward alone
    vjp_paths = sp.VJP_PATHS if full else sp.VJP_PATHS[:1]
    vjp_cut = "" if full else (f" (paths cut from {len(sp.VJP_PATHS)} to 1 in the default call; "
                               f"--group profile runs all)")
    lines, rep = sp.run(dev.type, N_RAYS, steps, log=quiet, vjp_paths=vjp_paths)
    b1_launches = fused_slab.LAUNCHES
    path = measure.write_report(lines, os.path.join("build", "step_profile.txt"))
    for name, per in rep["b1_ops"].items():
        print(f"phase 25 B1 {name}: {sum(per.values()):.1f} operations per ray step "
              f"({', '.join(f'{k} {v:.2f}' for k, v in per.items() if v)})")
    def window(w):
        if w["profiled"]:
            return (f"{w['kernels']:.1f} CUDA kernels and {w['copies']:.1f} copies per outer "
                    f"step, device {w['device_us'] / 1e3:.3f} of {w['wall_us'] / 1e3:.3f} ms per "
                    f"step ({w['profiled_wall_us'] / 1e3:.3f} profiled), busy share "
                    f"{w['busy_share']:.4f}, kernel median {w['quantiles'][1]:.2f} us; top: "
                    + "; ".join(f"{n[:48]} {us:.1f} us x {c:.0f}" for n, us, c in w["top"][:2]))
        return (f"torch.profiler showed no device time; CUDA events "
                f"{w.get('events_ms', float('nan')):.3f} ms per outer step")

    for name, c in rep["census"].items():
        require(c.n_ops > 0, f"{name}: an empty census")
        print(f"phase 25 {name} {N_RAYS} rays f64 eager: census {c.n_ops} aten ops per outer "
              f"step ({c.host_reads} host reads); {window(rep['windows'][name])}{cut}")
        g = rep["graphs"].get(name)
        if g is not None:
            print(f"phase 25 {name} {N_RAYS} rays f64 graphed: {window(g)}; host reads "
                  f"{g['reads']:.3f} and substep passes {g['passes']:.3f} per outer step; "
                  f"capture {g['capture_ms']:.1f} ms; one replay call on the host "
                  + ", ".join(f"{k} {us:.1f} us" for k, us in g["launch_us"].items())
                  + cut)
    require(set(rep["graphs"]) == set(sp.GRAPHED), f"graphed windows {sorted(rep['graphs'])}")
    for n, b in rep["b1"].items():
        require(b["launches"] == 1, f"B1 at {n} rays: {b}")
        print(f"phase 25 B1 slab f64 x 500, {n} rays: kernel {b['kernel_ms']:.3f} ms of device "
              f"time (CUDA events, wrapper hidden), {b['call_ms']:.3f} ms a call; the profiler "
              f"saw {b['profiled_kernels']} kernels in the call, B1 "
              f"{'among them' if b['profiled_b1'] else 'not among them'}")
    for (n, tag), (one, five) in rep["calls"].items():
        print(f"phase 25 trace_rays through B1, {n} rays {tag}: single call {one * 1e3:.3f} ms, "
              f"5 back to back {five * 1e3:.3f} ms per call, fixed cost per call "
              f"{(one - five) * 1e3:.3f} ms (host clock, best of 3)")
    require(set(rep["vjp"]) == {(n, t) for n in vjp_paths for t in ("eager", "graphed")},
            f"VJP windows {sorted(rep['vjp'])}")
    for (name, tag), w in rep["vjp"].items():
        print(f"phase 25 {name} {N_RAYS} rays f64 with trajectories, one outer step's backward "
              f"pass, {tag}: {window(w)}{cut}{vjp_cut}")
    require(set(rep["tangents"]) == set(sp.TANGENT_PATHS), f"tangent windows {rep['tangents']}")
    for name, w in rep["tangents"].items():
        c = rep["tangent_census"][name]
        print(f"phase 25 {name} {N_RAYS} rays f64 with tangents, tangent graph: census "
              f"{c.n_ops} aten ops and {sum(c.elements.values()):.1f} elements per ray per "
              f"outer step; {window(w)}{cut}")
    for (kind, name), b in rep["bounds"].items():
        share = ("device time not measured" if b["device_ms"] is None else
                 f"share {b['bound_ms'] / b['device_ms']:.5g} of {b['device_ms']:.3f} ms of "
                 f"device time per step")
        print(f"phase 25 bound of one outer step, {kind} route, {name}, {N_RAYS} rays f64: "
              f"{b['ops'] / N_RAYS:.1f} operations and {b['bytes'] / N_RAYS:.1f} bytes per ray; "
              f"operations {b['ms_ops']:.5g} ms, bytes {b['ms_bytes']:.5g} ms; bound "
              f"{b['bound_ms']:.5g} ms by {b['bound_by']}; {share}")
    # B1 at two sizes (warm-up, profiled call, 3 timed calls, 5 hidden
    # behind the spin) and trace_rays at four (warm-up, 3 single calls, 3
    # bursts of 5)
    require(b1_launches == 2 * 10 + 4 * 19, f"the step profile launched B1 {b1_launches} times")
    print(f"phase 25 step profile in {time.perf_counter() - t0:.1f} s ({b1_launches} B1 "
          f"launches); wrote {path} on {card}")
    run.paths.append({"name": "step_profile", "steps": steps, "b1_launches": b1_launches,
                      "aten_ops_per_step": {k: c.n_ops for k, c in rep["census"].items()},
                      "kernels_per_step": {k: w["kernels"] for k, w in rep["windows"].items()},
                      "busy_share": {k: w["busy_share"] for k, w in rep["windows"].items()},
                      "graphed_kernels_per_step": {k: g.get("kernels")
                                                   for k, g in rep["graphs"].items()},
                      "graphed_busy_share": {k: g.get("busy_share")
                                             for k, g in rep["graphs"].items()},
                      "graphed_capture_ms": {k: g["capture_ms"]
                                             for k, g in rep["graphs"].items()},
                      "vjp": {f"{k}_{t}": {"kernels": w["kernels"], "device_ms": w["device_us"] / 1e3,
                                           "wall_ms": w["wall_us"] / 1e3,
                                           "busy_share": w["busy_share"]}
                              for (k, t), w in rep["vjp"].items()},
                      "tangent": {k: {"kernels": w["kernels"], "device_ms": w["device_us"] / 1e3,
                                      "wall_ms": w["wall_us"] / 1e3,
                                      "busy_share": w["busy_share"]}
                                  for k, w in rep["tangents"].items()},
                      "bounds": {f"{kind}_{k}": {"bound_ms": b["bound_ms"],
                                                 "bound_by": b["bound_by"],
                                                 "device_ms": b["device_ms"]}
                                 for (kind, k), b in rep["bounds"].items()}})

    # phase 26: the op-class rates and B1 priced with them
    t0 = time.perf_counter()
    op_rates.LAUNCHES.clear()
    opr = _tool("op_roofline")
    lines, rep = opr.run(dev.type, log=quiet)
    launches = dict(op_rates.LAUNCHES)
    path = measure.write_report(lines, os.path.join("build", "op_roofline.txt"))
    rows = rep["kernels"]
    for r in rows:
        require(launches.get(r["name"], 0) >= 1, f"{r['name']} was not launched")
    for dt, rates in rep["rates"].items():
        tag = "f32" if dt == torch.float32 else "f64"
        print(f"phase 26 op-class rates {tag}, G ops/s: "
              + ", ".join(f"{k} {v / 1e9:.1f}" for k, v in rates.items())
              + "; ILP sweep of fma (W, K): " + ", ".join(
                  f"({r['w']}, {r['k']}) {r['rate'] / 1e9:.1f}" for r in rows
                  if r["dtype"] == dt and r["op"] == "fma"))
    worst = max(rows, key=lambda r: r["max_rel_err"] / opr.REL_TOL[r["dtype"]])
    coarse = min(rows, key=lambda r: r["resolution"] / max(r["max_rel_err"], 1e-300))
    print(f"phase 26 {len(rows)} op-rate kernels equal their plain chains at the full depth "
          f"and one iteration short (f64 within 1e-12, f32 within 1e-5 relative, each below "
          f"its chain's resolution; worst {worst['name']} {worst['max_rel_err']:.2e}; "
          f"closest to its resolution {coarse['name']} {coarse['max_rel_err']:.2e} of "
          f"{coarse['resolution']:.2e})")
    for r in rep["b1"]:
        tag = "f32" if r["dtype"] == torch.float32 else "f64"
        print(f"phase 26 B1 {r['name']} {tag} {r['rays']} rays: kernel {r['ms']:.3f} ms; "
              f"op-priced estimate {r['op_ms']:.4f} ms (share {r['op_ms'] / r['ms']:.4f}); "
              f"published-peak bound {r['published_ms']:.4f} ms (share "
              f"{r['published_ms'] / r['ms']:.4f})")
    c = rep["census"]
    print(f"phase 26 plain slab RK4 step: {c['aten_ops']} aten ops, op-priced estimate "
          f"{c['ns_per_ray_step']:.3f} ns per ray step at the f64 rates")
    print(f"phase 26 op roofline in {time.perf_counter() - t0:.1f} s; wrote {path} on {card}")
    kernels = [{
        "name": r["name"], "route": "cuda", "source": "rays_tpu_torch/csrc/op_rates.cu",
        "replaces": VPU_ROOFLINE_MATVEC if r["op"] == "matvec" else VPU_ROOFLINE_CHAINS,
        "launches": launches.get(r["name"], 0), "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        # no single PyTorch call computes a dependent chain
        "library_ms": None} for r in rows]

    # phase 27: the precision probe
    t0 = time.perf_counter()
    probe = _tool("precision_probe")
    psteps, cut = _cut(full, probe.N_STEPS, PROBE_STEPS_DEFAULT, "RK4 steps")
    fused_slab.LAUNCHES = 0
    lines, rep = probe.run(dev.type, steps=psteps, log=quiet)
    require(fused_slab.LAUNCHES == 2, f"the probe launched B1 {fused_slab.LAUNCHES} times")
    path = measure.write_report(lines, os.path.join("build", "precision_probe.txt"))
    for key, what in (("example", f"slab example 3 rays x {psteps}"),
                      ("replicated", f"{N_RAYS} rays x {psteps}")):
        r = rep[key]
        require(all(np.isfinite(v) for v in r.values()), f"probe {key}: {r}")
        require(r["f32"] <= F32_RTOL and r["b1_f32"] <= F32_RTOL,
                f"probe {key}: f32 end errors {r['f32']:.3e}, B1 {r['b1_f32']:.3e}")
        print(f"phase 27 precision probe, {what} steps: amplification "
              f"{r['amplification']:.2f}x; f32 end error plain {r['f32']:.3e}, compensated "
              f"{r['f32_compensated']:.3e} (resolved {r['f32_compensated_resolved']:.3e}), "
              f"deriv_cold in f64 {r['f32_deriv_cold_f64']:.3e}, equilibrium in f64 "
              f"{r['f32_equilibrium_f64']:.3e}, both {r['f32_both_f64']:.3e}; B1 f32 "
              f"{r['b1_f32']:.3e}{cut}")
    print(f"phase 27 precision probe in {time.perf_counter() - t0:.1f} s; wrote {path} on {card}")

    # phase 28: the mirror profile
    t0 = time.perf_counter()
    msteps, cut = _cut(full, MIRROR_STEPS, MIRROR_STEPS_DEFAULT, "steps")
    iters, icut = _cut(full, MIRROR_LOOP_ITERS, MIRROR_LOOP_ITERS_DEFAULT, "iterations")
    lines, rep, loops = _tool("profile_mirror").run(dev.type, steps=msteps, iters=iters,
                                                    log=quiet)
    path = measure.write_report(lines, os.path.join("build", "profile_mirror.txt"))
    for tag, res in rep.items():
        evals = 4 * msteps + 1
        parts = ", ".join(f"{k} {m['ms']:.3f} ms (host {m['host_us'] / 1e3:.3f}, device "
                          f"{m['device_us'] / 1e3:.3f}, {m['kernels']} kernels)"
                          for k, m in res.items() if not k.startswith("trace"))
        print(f"phase 28 mirror {tag} 8192 rays x {msteps} steps{cut}: trace "
              f"{res['trace']['ms']:.1f} ms ({res['trace']['ms'] / evals:.3f} ms per "
              f"evaluation), without damping {res['trace_no_damp']['ms']:.1f} ms; one of each "
              f"on the batch: {parts}")
    print(f"phase 28 mirror loops f32, {iters} iterations{icut}, ms per iteration net of the "
          f"null loop: " + ", ".join(f"{k} {net:.4f}" for k, (_, net) in loops.items()))
    print(f"phase 28 mirror profile in {time.perf_counter() - t0:.1f} s; wrote {path} on "
          f"{card}")
    run.paths.append({"name": "mirror_profile", "steps": msteps,
                      "ms_per_eval": {t: r["trace"]["ms"] / (4 * msteps + 1)
                                      for t, r in rep.items()},
                      "eqn_ray_ms": {t: r["eqn_ray"]["ms"] for t, r in rep.items()},
                      "eval_cell_2d_ms": {t: r["eval_cell_2d"]["ms"] for t, r in rep.items()}})
    return kernels


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


def spline_example_files(write_example, directory):
    """The spline example's files cut to SPLINE_EXAMPLE_STEPS; the path of
    rays.in."""
    path = write_example(directory)
    with open(path) as f:
        text = f.read()
    require(f"nstep_max={SPLINE_BATCH_STEPS}" in text, "a spline example changed")
    return _write(path, text.replace(f"nstep_max={SPLINE_BATCH_STEPS}",
                                     f"nstep_max={SPLINE_EXAMPLE_STEPS}"))


def build_kernels():
    """Build (unless built) every kernel library of the checkout: the three
    slab RK4 variants, the slab VJP and step, the EQDSK step (f64 and f32)
    and the op-rate kernels, each source by its own nvcc, all started
    together.  Returns the seconds it took."""
    from rays_tpu_torch.tracing import eqdsk_step, fused_slab, slab_vjp
    from rays_tpu_torch.utils import op_rates

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        for f in [pool.submit(fused_slab.load_libraries), pool.submit(op_rates.load_library),
                  pool.submit(slab_vjp.load_library, torch.float64, 2),
                  pool.submit(eqdsk_step.load_library, torch.float64, 2),
                  pool.submit(eqdsk_step.load_library, torch.float32, 2)]:
            f.result()
    return time.perf_counter() - t0


class Run:
    """What every phase reads: the card's nvidia-smi line, the device, and
    the paths line being filled."""

    def __init__(self, card, dev):
        self.card, self.dev, self.paths = card, dev, []
        self.build_s = None


def main(argv=None):
    ap = argparse.ArgumentParser(description="chip smoke test of rays_tpu_torch")
    ap.add_argument("--group", choices=GROUPS,
                    help="run one group alone, at its full depth (default: every group)")
    ap.add_argument("--only-spline", action="store_true", help="the same as --group spline")
    args = ap.parse_args(argv)
    if args.only_spline:
        if args.group not in (None, "spline"):
            ap.error("--only-spline is --group spline")
        args.group = "spline"

    t_start = time.perf_counter()
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
    groups = GROUPS if args.group is None else (args.group,)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"count {torch.cuda.device_count()}; groups {', '.join(groups)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(card, torch.device("cuda", 0))
    every = args.group is None
    # every kernel library of the checkout, one nvcc per source, side by side
    run.build_s = build_kernels()
    print(f"phase 1 build: slab_rk4 (3 variants), slab_rk4_vjp (f64, S=2), eqdsk_rk4 (f64 and "
          f"f32, S=2) and op_rates for sm_90a in {run.build_s:.1f} s (side by side)")

    kernels = kernel_phases(run) if "kernel" in groups else None
    if "graph" in groups:
        graph_phase(run)
        tangent_phase(run, not every)
        closed_columns = inverse_columns_phase(run)
        registered_model_phase(run)
        jacfwd_columns_phase(run, closed_columns)
        del closed_columns
    vjp_kernel = step_kernel = eqdsk_kernel = None
    if "adjoint" in groups:
        vjp_kernel = slab_vjp_phase(run)
        step_kernel = slab_step_phase(run)
        eqdsk_kernel = eqdsk_step_phase(run)
        adjoint_phase(run, not every)
        eviction_phase(run)
        training_phase(run)
    if "plain" in groups:
        plain_phases(run, kernels["big64_end"] if kernels else None)
    if "adjoint" in groups:
        sg_training_phase(run)
    if "spline" in groups:
        spline_phases(run)
    elif "adjoint" in groups:
        eqdsk_adjoint_phase(run)
    if "post" in groups:
        post_main_path_phase(run)
        post_spline_phase(run)
        post_cli_phase(run)
    if "tools" in groups:
        tools_phases(run, kernels["fill"] if kernels else None,
                     INVERSE_STEPS_DEFAULT if every else INVERSE_STEPS)
    op_kernels = profile_phases(run, not every) if "profile" in groups else []

    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"paths": run.paths}))
    b1 = []
    if kernels is not None:
        b1 = [{
            "name": name,
            "route": "cuda",
            "source": "rays_tpu_torch/csrc/slab_rk4.cu",
            "replaces": "rays_tpu/tracing/fused_slab.py:348",
            "launches": launches,
            "max_abs_err": err,
            "ms": t_kern,
            "plain_ms": t_plain,
            "bound_ms": bound,
            "bound_by": bound_by,
            # no single PyTorch call computes an RK4 trajectory
            "library_ms": None,
        } for name, (launches, err, (t_kern, t_plain), (bound, bound_by))
            in ((k, kernels[k]) for k in ("slab_rk4", "slab_rk4_damped"))]
    b1 += [k for k in (vjp_kernel, step_kernel, eqdsk_kernel) if k is not None]
    if b1 or op_kernels:
        print(json.dumps({"kernels": b1 + op_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
