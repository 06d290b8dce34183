"""Entry points, the counterparts of the JAX package's
``__graft_entry__.py``.

``entry()`` is one batched RK4 ray step on the slab ECH example.

``dryrun_multiprocess(n)`` runs one full training step split over ``n``
processes (``torch.distributed``): each process traces its own slice of
the damped slab's rays with trajectories, bins its deposition profile,
and the step's loss

    sum over rays of |x_end|^2 P  +  sum over bins of profile^2

is differentiated with respect to every Params leaf.  The profile term is
not linear in the rays, so the gradient is not a sum of per-process
gradients of per-process losses: each process first sums the profile
over the processes (``all_reduce``), then sends ``2 * profile_global``
back through its own profile, and the Params' gradients are summed over
the processes.  Every process holds the split step to the same step on
the whole batch at ``__graft_entry__.py``'s tolerances.

    python -m rays_tpu_torch.entry                 # entry() on the card
    python -m rays_tpu_torch.entry --dryrun 2      # two processes
    python -m rays_tpu_torch.entry --dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from rays_tpu_torch import examples
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.parallel import multihost, sharded
from rays_tpu_torch.post import deposition
from rays_tpu_torch.tracing import rk4, trace

N_BINS = 32
DRYRUN_STEPS = 120
# __graft_entry__.py's tolerances, split against whole
LOSS_RTOL = 1e-12
PROFILE_RTOL, PROFILE_ATOL = 1e-10, 1e-14
GRAD_RTOL, GRAD_ATOL = 1e-8, 1e-12


def entry(device="cuda"):
    """(fn, example_args): one batched RK4 ray step, fn(params, v0) ->
    (v1, status)."""
    cfg, params, v0, _, _ = examples.setup_example(device=device)

    def step(params, v0):
        s = torch.zeros((), dtype=v0.dtype, device=v0.device)
        return rk4.rk4_step(cfg, params, s, v0)

    return step, (params, v0)


def _loss_parts(cfg, params, v0, status0, pwr, tracer, xmin, xmax):
    """(results, the endpoint term, the Ptotal_x profile) of these rays."""
    res = tracer(params, v0, status0, pwr)
    prof = deposition.calculate_deposition_profile(
        cfg, params, res, "Ptotal_x", n_bins=N_BINS, xmin=xmin, xmax=xmax).profile
    return res, (res.end_ray_vec[:, 0:3] ** 2 * pwr[:, None]).sum(), prof


def with_grad(params):
    """A copy of the Params whose floating leaves require grad."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()),
                    params)


def training_step(cfg, params, v0, status0, pwr, mesh=None, xmin=None, xmax=None):
    """One training step on this process's rays: (loss, results, the
    profile summed over the processes, the gradient of every floating
    Params leaf summed over the processes).  ``params`` must come from
    ``with_grad``.  With one process (``mesh`` None or of size 1) this is
    the step on the whole batch."""
    mesh = mesh or sharded.make_ray_mesh()
    xmin = float(params.eq.xmin.detach()) if xmin is None else xmin
    xmax = float(params.eq.xmax.detach()) if xmax is None else xmax
    leaves = [t for t in tree_leaves(params) if t.requires_grad]
    tracer = sharded.make_sharded_tracer(cfg, mesh)
    res, end, prof = _loss_parts(cfg, params, v0, status0, pwr, tracer, xmin, xmax)
    # one collective for the two sums over rays
    total = sharded.all_reduce_sum(torch.cat([end.detach().reshape(1), prof.detach()]), mesh)
    end_g, prof_g = total[0], total[1:]
    loss = end_g + (prof_g ** 2).sum()
    grads = torch.autograd.grad([end, prof], leaves,
                                grad_outputs=[torch.ones_like(end), 2.0 * prof_g],
                                allow_unused=True, materialize_grads=True)
    flat = sharded.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
    return loss, res, prof_g, grads


def whole_step(cfg, params, v0, status0, pwr, xmin, xmax):
    """The same step on the whole batch in one process, the plain way:
    autograd of the loss itself.  (loss, results, profile, grads)."""
    leaves = [t for t in tree_leaves(params) if t.requires_grad]
    res, end, prof = _loss_parts(cfg, params, v0, status0, pwr,
                                 sharded.make_sharded_tracer(cfg, None), xmin, xmax)
    loss = end + (prof ** 2).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss, res, prof, list(grads)


def _require_close(got, ref, rtol, atol, what):
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")


def dryrun_worker(device="cuda", nstep_max=DRYRUN_STEPS):
    """One process's part of ``dryrun_multiprocess``, after ``initialize``:
    the split step on its own rays, the step on the whole batch, and the
    comparison.  Returns what it measured."""
    mesh = multihost.global_ray_mesh()
    dev = multihost.process_device(device)
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_DAMPED, device="cpu")
    # 120 steps: deep enough for the stop, deposition and adjoint machinery
    cfg = dataclasses.replace(cfg, nstep_max=nstep_max, save_trajectory=True)
    # the launch grid, small and the same on every process; each process
    # traces only its slice of it
    n_rays = max(2 * mesh.size, v0.shape[0])
    v0, st, pwr = examples.replicate_rays(v0, st, pwr, n_rays)
    v0, st, pwr, _ = sharded.pad_rays(v0, st, pwr, mesh.size)
    lo, hi = multihost.local_ray_slice(v0.shape[0])
    lv, ls, lw = multihost.distribute_rays(mesh, v0[lo:hi], st[lo:hi], pwr[lo:hi], device=dev)
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
    params = with_grad(tree_map(lambda t: t.to(dev), params))

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, out

    t_split, (loss, res, prof, grads) = timed(
        lambda: training_step(cfg, params, lv, ls, lw, mesh, xmin, xmax))
    # the reference: the whole batch on this process's device
    t_whole, (loss0, res0, prof0, grads0) = timed(
        lambda: whole_step(cfg, params, v0.to(dev), st.to(dev), pwr.to(dev), xmin, xmax))
    _require_close(loss, loss0.detach(), LOSS_RTOL, 0.0, "loss")
    _require_close(prof, prof0.detach(), PROFILE_RTOL, PROFILE_ATOL, "profile")
    _require_close(res.ray_vec.detach(), res0.ray_vec[lo:hi].detach(), PROFILE_RTOL,
                   PROFILE_ATOL, "ray_vec")
    for i, (g, g0) in enumerate(zip(grads, grads0)):
        _require_close(g, g0, GRAD_RTOL, GRAD_ATOL, f"gradient of leaf {i}")
    return {
        "rank": mesh.rank, "processes": mesh.size, "device": str(dev),
        "backend": sharded.dist.get_backend() if sharded.distributed() else None,
        "rays": [lo, hi, int(v0.shape[0])], "nstep": nstep_max,
        "route": trace.route(cfg, True, dev),
        "loss": float(loss), "grad_l1": float(sum(g.abs().sum() for g in grads)),
        "deposition_sum": float(prof.sum()), "leaves": len(grads),
        "split_s": t_split, "whole_s": t_whole,
    }


def dryrun_multiprocess(n_processes, device="cuda", backend=None, init_method=None,
                        nstep_max=DRYRUN_STEPS, timeout=900):
    """One full training step split over ``n_processes`` processes, each
    started here with ``python -m rays_tpu_torch.entry --worker`` and
    joined to one group (``init_method``, default a file in a fresh
    temporary directory).  The backend is NCCL on CUDA when every process
    has a GPU of its own, gloo on the CPU and where processes share a GPU
    (NCCL refuses two ranks on one device; gloo reduces the CUDA tensors
    themselves).  Every process holds its split step to the step on the
    whole batch; any failure, or a process still running after
    ``timeout`` seconds, raises.  Returns each process's report, by rank."""
    n = int(n_processes)
    if backend is None:
        cuda = torch.device(device).type == "cuda"
        backend = "nccl" if cuda and n <= torch.cuda.device_count() else "gloo"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        url = init_method or "file://" + os.path.join(tmp, "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "rays_tpu_torch.entry", "--worker", str(r), "--dryrun",
             str(n), "--device", device, "--backend", backend, "--init-method", url,
             "--steps", str(nstep_max)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(n)]
        outs = []
        try:
            deadline = time.monotonic() + timeout
            for p in procs:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                outs.append((p.returncode, out))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    bad = [f"rank {r} exit {rc}:\n{out}" for r, (rc, out) in enumerate(outs) if rc != 0]
    if bad:
        raise RuntimeError("dryrun_multiprocess failed:\n" + "\n".join(bad))
    return [json.loads(out.strip().splitlines()[-1]) for _, out in outs]


def main(argv=None):
    ap = argparse.ArgumentParser(description="rays_tpu_torch entry points")
    ap.add_argument("--dryrun", type=int, default=0,
                    help="run the training step split over this many processes")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the CPU)")
    ap.add_argument("--backend", default=None, help="torch.distributed backend")
    ap.add_argument("--init-method", default=None, help="torch.distributed init URL")
    ap.add_argument("--steps", type=int, default=DRYRUN_STEPS, help="RK4 steps of the dry run")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    torch.zeros((), device=args.device)   # a device that is not there fails first
    if args.worker is not None:
        multihost.initialize(args.init_method, num_processes=args.dryrun,
                             process_id=args.worker, device=args.device,
                             backend=args.backend)
        try:
            report = dryrun_worker(args.device, args.steps)
        finally:
            if sharded.distributed():
                sharded.dist.destroy_process_group()
        print(json.dumps(report))
        return 0
    if args.dryrun:
        reports = dryrun_multiprocess(args.dryrun, args.device, args.backend,
                                      args.init_method, args.steps)
        r = reports[0]
        print(f"dryrun_multiprocess({args.dryrun}): loss={r['loss']:.6e} "
              f"grad-l1={r['grad_l1']:.6e} nstep={r['nstep']} "
              f"deposition_sum={r['deposition_sum']:.6e} split==whole OK "
              f"backend={r['backend']} devices={[x['device'] for x in reports]}")
        return 0
    fn, fargs = entry(args.device)
    v1, status = fn(*fargs)
    print(f"entry() ran on {v1.device}: v1 {tuple(v1.shape)}, status {tuple(status.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
