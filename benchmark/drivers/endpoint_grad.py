"""Driver of an endpoint-loss gradient: ``trace.trace_rays`` under
autograd (on the card, the adjoint graph), the loss

    sum over rays of |x_end|^2 P

(a fit of the parameters to where the rays end), and its gradient in
every floating Params leaf, each call synchronized.  Reports
``grad_step_s``: the window's time over the steps completed.

The answer compared is the launch rays, each ray's end state, points,
stop code and largest residual, the loss and every leaf's gradient.
"""

from __future__ import annotations

import torch

from benchmark.lib import inputs

METRIC = "grad_step_s"


class Driver:
    def __init__(self, cell, seed, device, parts):
        self.cell, self.device = cell, device
        (self.cfg, params, self.v_base, self.v0, self.status0,
         self.pwr) = inputs.program(cell, seed, device, parts)
        from rays_tpu_torch import entry
        from rays_tpu_torch.core.types import tree_leaves
        from rays_tpu_torch.tracing import trace

        self.trace = trace
        self.params = entry.with_grad(params)
        self.names = inputs.leaf_names(params)
        self.leaves = [t for t in tree_leaves(self.params) if t.requires_grad]
        self.route = trace.route(self.cfg, True, self.v0.device)
        self.work = 1
        self.outer_steps = self.cfg.nstep_max

    def call(self):
        res = self.trace.trace_rays(self.cfg, self.params, self.v0, self.status0, self.pwr)
        loss = (res.end_ray_vec[:, 0:3] ** 2 * self.pwr[:, None]).sum()
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True,
                                    materialize_grads=True)
        if self.device != "cpu":
            torch.cuda.synchronize()
        return loss, res, grads

    def keep(self, out):
        loss, res, grads = out
        return dict(loss=loss.detach().clone(), grads=[g.detach().clone() for g in grads],
                    end=res.end_ray_vec.detach().clone(), npoints=res.npoints.clone(),
                    stop=res.stop_flag.clone(), max_res=res.max_residuals.detach().clone())

    def answer(self, kept):
        out = {k: v.cpu() for k, v in kept.items() if k != "grads"}
        out["grads"] = {n: g.cpu() for n, g in zip(self.names, kept["grads"])}
        out.update(v0=self.v_base, pwr=self.pwr.cpu())
        return out


def reference(cell, seed, device, dtype):
    """The plain reference's loss and gradients, in ``dtype``: reverse mode
    through the reference, each outer step recomputed in the backward
    pass."""
    from benchmark.reference import rays_plain

    case, v_base, v0, pwr = inputs.reference(cell, seed, device, dtype)
    leaves = rays_plain.grad_leaves(case)
    for t in leaves.values():
        t.requires_grad_(True)
    run = rays_plain.trace(case, v0, checkpoint=True)
    loss = rays_plain.endpoint_term(run, pwr)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return dict(v0=v_base, pwr=pwr.cpu(), end=run["end"].detach().cpu(),
                npoints=run["npoints"].cpu(), stop=run["stop"].cpu(),
                max_res=run["max_res"].detach().cpu(), loss=loss.detach().cpu(),
                grads={k: (g if g is not None else torch.zeros_like(t)).detach().cpu()
                       for (k, t), g in zip(leaves.items(), grads)})
