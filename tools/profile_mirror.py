"""Where the mirror's spline trace spends its time on the H100: the
counterpart of scripts/profile_mirror.py and scripts/profile_mirror2.py.

The JAX script read the reference's MPEX example directory, which is not
in this repository; this tool runs the port's own four-coil mirror
(``examples.MIRROR_ECH_56GHZ``, its 51 x 201 field file and ray file
written by ``examples.write_mirror_example``) with the MPEX case's
fundamental-ECH damping switched on (``damp_fund_ECH``; the example itself
has none), its rays grown to 8,192 (``examples.replicate_rays``), 500 RK4
steps, in float32 and float64.  It times

* the full trace, and the trace without damping (nv = 7);
* per evaluation, on the batch: the bare right-hand side (``rhs.eqn_ray``,
  with and without damping), the bare ``check_save``, the bare cell fetch
  of ``ops/splines.py`` (``eval_cell_2d`` and ``eval_cell_2d_second``),
  the equilibrium alone, with damping, and ``eq_point_light``.

Each is timed with CUDA events (after a warm-up) and traced once with
``torch.profiler`` (a trace over a window of 4 outer steps): the host's
time (the wall over the profiled call) and the device's busy time stand
side by side, with the kernels each launches.

Then, as scripts/profile_mirror2.py did, each piece runs ``--iters``
(500) times in a loop of eager PyTorch whose carry feeds the next
iteration, against a null loop that only adds to the carry; the net time
per iteration is the loop's time less the null loop's, over the
iterations (float32).  Beside the pieces above: ten cell fetches, the raw
fetch of a (B, K, 4, 4) cell block by two indices and by one flat index
(``index_select``), and 50 fused multiply-adds on the (B, nv) state.

Writes build/profile_mirror.txt with the card's name and power limit.

    python tools/profile_mirror.py
    python tools/profile_mirror.py --device cpu --rays 16 --steps 5 --iters 3
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
from rays_tpu_torch.models import base  # noqa: E402
from rays_tpu_torch.ops import splines  # noqa: E402
from rays_tpu_torch.tracing import rhs  # noqa: E402
from rays_tpu_torch.tracing.trace import trace_batch  # noqa: E402
from rays_tpu_torch.utils import measure  # noqa: E402
from rays_tpu_torch.wave import damping  # noqa: E402

N_RAYS = 8192
N_STEPS = 500
REPS = 5
PROFILED_STEPS = 4
N_ITERS = 500
DTYPES = {"f32": torch.float32, "f64": torch.float64}
DAMPED = examples.MIRROR_ECH_56GHZ.replace("damping_model='no_damp'",
                                           "damping_model='damp_fund_ECH'")


def mirror_case(directory, device, n_rays=N_RAYS, steps=N_STEPS):
    """(cfg damped, cfg without damping, params, v (n_rays, 8), status,
    pwr) of the damped four-coil mirror, float64, summaries only; its input
    files are written into ``directory``."""
    cfg, params, v0, st, pwr = runner.setup(
        examples.write_mirror_example(directory, text=DAMPED), device=device)
    cfg = dataclasses.replace(cfg, nstep_max=steps, save_trajectory=False)
    nodamp = dataclasses.replace(cfg, damping_model="no_damp", multi_spec_damping=False,
                                 integrate_eq_gradients=False)
    return (cfg, nodamp, params, *examples.replicate_rays(v0, st, pwr, n_rays))


def components(cfg, nodamp, params, v):
    """{name: callable} of the pieces of one evaluation on the batch v
    (B, nv), each returning what the trace computes at those points."""
    s0 = torch.zeros((), dtype=v.dtype, device=v.device)
    cells = params.eq.field_cells
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    r = torch.sqrt(x * x + y * y)

    def eq_and_damping():
        eq = base.equilibrium(cfg, params, v[:, :3])
        return damping.damping(cfg, params, eq, v[:, :6], v[:, 3:6])

    return {
        "eqn_ray": lambda: rhs.eqn_ray(cfg, params, s0, v),
        "eqn_ray_no_damp": lambda: rhs.eqn_ray(nodamp, params, s0, v[:, :nodamp.nv]),
        "check_save": lambda: rhs.check_save(cfg, params, v),
        "eval_cell_2d": lambda: splines.eval_cell_2d(cells, r, z),
        "eval_cell_2d_second": lambda: splines.eval_cell_2d_second(cells, r, z),
        "equilibrium": lambda: base.equilibrium(cfg, params, v[:, :3]),
        "equilibrium_damping": eq_and_damping,
        "eq_point_light": lambda: base.eq_point_light(cfg, params, v[:, :3]),
    }


def _profiled(m, cuda):
    """The profiled call's host time beside the device's busy time."""
    if not cuda:
        return f"profiled: host {m['host_us'] / 1e3:.3f} ms (cpu run: no device time)"
    return (f"profiled: host {m['host_us'] / 1e3:.3f} ms, device busy "
            f"{m['device_us'] / 1e3:.3f} ms ({m['kernels']} kernels)")


def _measure(fn, device, reps=REPS):
    """{ms by CUDA events (host clock on the CPU), host_us and device_us of
    one profiled call, kernels}."""
    fn()
    ms, _ = measure.time_ms(fn, device, reps)
    tr = measure.profile(fn, device)
    return {"ms": ms, "host_us": tr.wall_us, "device_us": tr.busy_us,
            "kernels": len(tr.kernels)}


def _measure_trace(cfg, params, v, st, w, device):
    """The trace: ms of one whole run after a short warm-up, and host_us,
    device_us and kernels per outer step from a profiled window of
    PROFILED_STEPS steps less one of none (a whole trace is too many
    events to parse)."""
    def trace(n):
        return trace_batch(dataclasses.replace(cfg, nstep_max=n), params, v, st, w)

    trace(2)
    ms, _ = measure.time_ms(lambda: trace(cfg.nstep_max), device)
    none = measure.profile(lambda: trace(0), device)
    some = measure.profile(lambda: trace(PROFILED_STEPS), device)
    return {"ms": ms, "host_us": (some.wall_us - none.wall_us) / PROFILED_STEPS,
            "device_us": (some.busy_us - none.busy_us) / PROFILED_STEPS,
            "kernels": (len(some.kernels) - len(none.kernels)) // PROFILED_STEPS}


def _cell_index(cells, v):
    """(i, j) of each ray's cell in the (nxm, nym, K, 4, 4) table."""
    r = torch.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2)
    i = ((r - cells.x0) / cells.dx).to(torch.int64).clamp(0, cells.cells.shape[0] - 1)
    j = ((v[:, 2] - cells.y0) / cells.dy).to(torch.int64).clamp(0, cells.cells.shape[1] - 1)
    return i, j


def loop_bodies(cfg, params):
    """{name: carry -> carry} of the pieces, each feeding its result back
    into the (B, nv) carry with a weight of 1e-12."""
    cells = params.eq.field_cells
    s0 = torch.zeros((), dtype=cells.cells.dtype, device=cells.cells.device)
    nxm, nym = cells.cells.shape[:2]
    flat = cells.cells.reshape(nxm * nym, -1)

    def fetch(v, shift=0.0):
        r = torch.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2) + shift
        f, fx, fy = splines.eval_cell_2d(cells, r, v[:, 2])
        return f.sum(-1) + fx.sum(-1) + fy.sum(-1)

    def fma50(v):
        for _ in range(50):
            v = v * 1.0000001 + 1e-9
        return v

    return {
        "null (+1e-12)": lambda v: v + 1e-12,
        "1x eval_cell_2d": lambda v: v + 1e-12 * fetch(v)[:, None],
        "10x eval_cell_2d": lambda v: v + 1e-12 * sum(fetch(v, i * 1e-9)
                                                      for i in range(10))[:, None],
        "1x eqn_ray": lambda v: v + 1e-12 * rhs.eqn_ray(cfg, params, s0, v)[0],
        "1x check_save": lambda v: v + 1e-12 * rhs.check_save(cfg, params, v)[0][:, None],
        "raw 2d-index gather (B,K,4,4)": lambda v: v + 1e-12 * cells.cells[
            _cell_index(cells, v)].sum((1, 2, 3))[:, None],
        "flat 1d-index gather (B,K*16)": lambda v: v + 1e-12 * flat.index_select(
            0, (lambda ij: ij[0] * nym + ij[1])(_cell_index(cells, v))).sum(-1)[:, None],
        "50 fma on (B,nv)": fma50,
    }


def run_loops(cfg, params, v0, device, iters=N_ITERS, say=print):
    """Every loop of ``loop_bodies`` on v0; {name: (loop ms, net ms per
    iteration)}."""
    out, null = {}, 0.0
    for name, body in loop_bodies(cfg, params).items():
        def loop():
            v = v0
            for _ in range(iters):
                v = body(v)  # noqa: B023
            return v

        body(v0)                                   # warm-up
        ms, _ = measure.time_ms(loop, device)
        if not out:
            null = ms
        out[name] = (ms, (ms - null) / iters)
        say(f"{name:32s} {ms:10.1f} ms  ({out[name][1]:8.4f} ms per iteration net)")
    return out


def run(device="cuda", n_rays=N_RAYS, steps=N_STEPS, iters=N_ITERS, log=print):
    """Every measurement at both precisions, then the loops in float32.
    Returns (report lines, {precision: {name: measurement}}, {loop name:
    (loop ms, net ms per iteration)})."""
    dev = measure.open_device(device)
    cuda = dev.type == "cuda"
    card = measure.card_line(dev)
    lines = []

    def say(msg=""):
        log(msg)
        lines.append(msg)

    with tempfile.TemporaryDirectory() as tmp:
        cfg, nodamp, params, v0, st, pwr = mirror_case(tmp, dev, n_rays, steps)
    cells = params.eq.field_cells.cells
    say(f"# mirror ({cfg.damping_model}, nv {cfg.nv}) {n_rays} rays x {steps} RK4 steps on "
        f"{card}; field cells {tuple(cells.shape)}, {cells.numel() * 4} B in f32")
    clock = "CUDA events" if cuda else "host clock"
    out = {}
    for tag, dt in DTYPES.items():
        p, v, w = tree_to(params, dtype=dt), v0.to(dt), pwr.to(dt)
        res = {"trace": _measure_trace(cfg, p, v, st, w, dev),
               "trace_no_damp": _measure_trace(nodamp, p, v[:, :nodamp.nv], st, w, dev)}
        evals = 4 * steps + 1
        for name in ("trace", "trace_no_damp"):
            m = res[name]
            say(f"{tag} {name:22s} {m['ms']:10.1f} ms ({clock}), {n_rays / m['ms'] * 1e3:10.0f} "
                f"rays/s, {m['ms'] / evals:.3f} ms per evaluation ({evals}); per outer step "
                + _profiled(m, cuda))
        for name, fn in components(cfg, nodamp, p, v).items():
            m = res[name] = _measure(fn, dev)
            say(f"{tag} one {name:20s} {m['ms']:9.3f} ms ({clock}); " + _profiled(m, cuda))
        e = res["eqn_ray"]["ms"]
        say(f"{tag} per trace evaluation {res['trace']['ms'] / evals:.3f} ms against one bare "
            f"eqn_ray {e:.3f} ms and one cell fetch {res['eval_cell_2d']['ms']:.3f} ms "
            f"({e / max(res['eval_cell_2d']['ms'], 1e-9):.0f}x)")
        out[tag] = res
    say()
    say(f"# {iters}-iteration eager loops, f32, net of the null loop ({clock}), on {card}")
    loops = run_loops(cfg, tree_to(params, dtype=torch.float32), v0.to(torch.float32), dev,
                      iters, say)
    return lines, out, loops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu on the host's clock)")
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--iters", type=int, default=N_ITERS, help="iterations of each loop")
    ap.add_argument("--out", default=os.path.join("build", "profile_mirror.txt"))
    args = ap.parse_args(argv)
    lines, _, _ = run(args.device, args.rays, args.steps, args.iters)
    print(f"wrote {measure.write_report(lines, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
