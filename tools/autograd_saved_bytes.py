"""Count the bytes that autograd keeps for the backward pass of the
training step of ``__graft_entry__.py`` in rays_tpu_torch, per RK4 step.

The step: the damped slab example (``examples.SLAB_ECH_DAMPED``) with
trajectories on, its rays' endpoint loss and the Ptotal_x profile in 32
bins, differentiated with respect to every floating Params leaf.  Two
counts, each at two depths so that their difference over the extra steps
is the cost of one step:

* remat on (the default, ``cfg.remat_steps``): the tensors that each
  step's ``torch.utils.checkpoint`` keeps to recompute the step (its
  inputs), plus what ``torch.autograd.graph.saved_tensors_hooks`` sees
  saved outside the checkpoints;
* remat off: every tensor saved for backward, through the same hooks.

Bytes are counted once per distinct storage.  The count depends on the
code and the shapes only, not on the host, so it runs on the CPU:

    python tools/autograd_saved_bytes.py                       # this checkout
    python tools/autograd_saved_bytes.py --root build/parent   # another one
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(t, seen):
    key = (t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
    if key in seen:
        return 0
    seen.add(key)
    return key[1]


def count(n_rays, steps, remat):
    """(bytes kept by the step checkpoints, bytes saved through the hooks)
    of one training step's forward pass."""
    import torch.utils.checkpoint as ckpt

    from rays_tpu_torch import examples
    from rays_tpu_torch.post import deposition
    from rays_tpu_torch.tracing import trace as trace_mod

    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_DAMPED, device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=steps, save_trajectory=True, remat_steps=remat)
    v0, st, pwr = examples.replicate_rays(v0, st, pwr, n_rays)
    leaves = []

    def leaf(t):
        t = t.detach().clone().requires_grad_(t.is_floating_point())
        leaves.append(t)
        return t

    def tmap(tree):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(tmap(x) for x in tree))
        return None if tree is None else leaf(tree)

    params = tmap(params)
    seen_ckpt, seen_hook = set(), set()
    held = {"ckpt": 0, "hook": 0}
    original = ckpt.checkpoint

    def counting_checkpoint(fn, *args, **kwargs):
        held["ckpt"] += sum(_bytes(a, seen_ckpt) for a in args if isinstance(a, torch.Tensor))
        return original(fn, *args, **kwargs)

    def pack(t):
        held["hook"] += _bytes(t, seen_hook)
        return t

    ckpt.checkpoint = counting_checkpoint
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            res = trace_mod.trace_batch(cfg, params, v0, st, pwr)
            prof = deposition.calculate_deposition_profile(
                cfg, params, res, "Ptotal_x", n_bins=32, xmin=float(params.eq.xmin.detach()),
                xmax=float(params.eq.xmax.detach())).profile
            loss = (res.end_ray_vec[:, 0:3] ** 2 * pwr[:, None]).sum() + (prof ** 2).sum()
    finally:
        ckpt.checkpoint = original
    grads = torch.autograd.grad(loss, [t for t in leaves if t.requires_grad],
                                allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    return held["ckpt"], held["hook"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose rays_tpu_torch is counted")
    ap.add_argument("--rays", type=int, default=3)
    ap.add_argument("--steps", type=int, nargs=2, default=(20, 40),
                    help="the two depths whose difference gives one step")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    out = {"root": os.path.abspath(args.root), "rays": args.rays}
    lo, hi = args.steps
    for remat in (True, False):
        a, b = count(args.rays, lo, remat), count(args.rays, hi, remat)
        name = "remat" if remat else "no_remat"
        out[name] = {f"{lo}_steps": a, f"{hi}_steps": b,
                     "per_step_checkpoint_bytes": (b[0] - a[0]) / (hi - lo),
                     "per_step_hook_bytes": (b[1] - a[1]) / (hi - lo)}
        print(f"{name}: per step {out[name]['per_step_checkpoint_bytes']:.1f} B kept by the "
              f"checkpoints, {out[name]['per_step_hook_bytes']:.1f} B saved through the hooks "
              f"({args.rays} rays)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
