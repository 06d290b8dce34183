"""Driver of a derivative step through the power deposition: the training
step of the JAX package's entry (``__graft_entry__.py:57-99``) on the
program.  ``trace.trace_rays`` with trajectories under autograd (on the
card, the adjoint graph), the deposition profile of the configuration's
``deposition`` entry (``post.deposition.calculate_deposition_profile``),
the loss

    sum over rays of |x_end|^2 P  +  sum over bins of profile^2

and its gradient in every floating Params leaf, each call synchronized.
Reports ``grad_step_s``: the window's time over the steps completed.

The answer compared is ``endpoint_grad.py``'s: the launch rays, each
ray's end state (absorption slots included), points, stop code and
largest residual, the loss and every leaf's gradient; the deposition is
in the loss and the gradients.  It is held to the damped plain reference
(``reference/rays_damped.py``), its trace recomputed step by step in the
backward pass.
"""

from __future__ import annotations

import torch

from benchmark.lib import common

_GRAD = common.load_module(common.HERE / "drivers" / "endpoint_grad.py")
_DAMPED = common.load_module(common.HERE / "drivers" / "forward_damped.py")

METRIC = _GRAD.METRIC


class Driver(_GRAD.Driver):
    def __init__(self, cell, seed, device, parts):
        super().__init__(cell, seed, device, parts)
        from rays_tpu_torch.post import deposition

        self.deposition = deposition
        self.grid = cell.config["deposition"]

    def call(self):
        g = self.grid
        res = self.trace.trace_rays(self.cfg, self.params, self.v0, self.status0, self.pwr)
        prof = self.deposition.calculate_deposition_profile(
            self.cfg, self.params, res, g["profile"], n_bins=int(g["n_bins"]),
            xmin=float(g["xmin"]), xmax=float(g["xmax"]))
        loss = ((res.end_ray_vec[:, 0:3] ** 2 * self.pwr[:, None]).sum()
                + (prof.profile ** 2).sum())
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True,
                                    materialize_grads=True)
        if self.device != "cpu":
            torch.cuda.synchronize()
        return loss, res, grads


def reference(cell, seed, device, dtype):
    """The damped reference's loss and gradients, in ``dtype``: reverse mode
    through the reference's trace, each outer step recomputed in the
    backward pass, and through its binning."""
    from benchmark.reference import rays_damped, rays_plain

    case, v_base, v0, pwr = _DAMPED.reference_inputs(cell, seed, device, dtype)
    g = cell.config["deposition"]
    if g["profile"] != "Ptotal_x":
        raise ValueError("the damped reference bins Ptotal_x only")
    leaves = rays_plain.grad_leaves(case)
    for t in leaves.values():
        t.requires_grad_(True)
    run = rays_damped.trace(case, v0, checkpoint=True, trajectory=True)
    profile = rays_damped.deposition_profile(run, pwr, int(g["n_bins"]), float(g["xmin"]),
                                             float(g["xmax"]))
    loss = rays_plain.endpoint_term(run, pwr) + (profile ** 2).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return dict(v0=v_base, pwr=pwr.cpu(), end=run["end"].detach().cpu(),
                npoints=run["npoints"].cpu(), stop=run["stop"].cpu(),
                max_res=run["max_res"].detach().cpu(), loss=loss.detach().cpu(),
                grads={k: (g if g is not None else torch.zeros_like(t)).detach().cpu()
                       for (k, t), g in zip(leaves.items(), grads)})
