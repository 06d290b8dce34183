"""Driver of a forward trace: ``trace.trace_rays`` with summaries only (no
trajectories, no gradients), each call synchronized.  Reports
``rays_per_s``: every ray of every call over the window's time.

The answer compared is the launch rays and each ray's end state, number
of points, stop code and largest residual.
"""

from __future__ import annotations

import torch

from benchmark.lib import inputs

METRIC = "rays_per_s"


class Driver:
    def __init__(self, cell, seed, device, parts):
        self.cell, self.device = cell, device
        (self.cfg, self.params, self.v_base, self.v0, self.status0,
         self.pwr) = inputs.program(cell, seed, device, parts)
        from rays_tpu_torch.tracing import trace

        self.trace = trace
        self.route = trace.route(self.cfg, False, self.v0.device)
        if self.route == "kernel":
            from rays_tpu_torch.tracing import fused_slab

            with parts("library load"):
                fused_slab.load_libraries()
        self.work = int(self.v0.shape[0])
        self.outer_steps = self.cfg.nstep_max

    def call(self):
        with torch.no_grad():
            res = self.trace.trace_rays(self.cfg, self.params, self.v0, self.status0, self.pwr)
        if self.device != "cpu":
            torch.cuda.synchronize()
        return res

    def keep(self, res):
        """What the comparison needs of one call, copied on the device."""
        return dict(end=res.end_ray_vec.clone(), npoints=res.npoints.clone(),
                    stop=res.stop_flag.clone(), max_res=res.max_residuals.clone())

    def answer(self, kept):
        out = {k: v.cpu() for k, v in kept.items()}
        out.update(v0=self.v_base, pwr=self.pwr.cpu())
        return out


def reference(cell, seed, device, dtype):
    """The plain reference's answer to the same call, in ``dtype``."""
    from benchmark.reference import rays_plain

    case, v_base, v0, pwr = inputs.reference(cell, seed, device, dtype)
    with torch.no_grad():
        run = rays_plain.trace(case, v0)
    return dict(v0=v_base, pwr=pwr.cpu(), end=run["end"].cpu(), npoints=run["npoints"].cpu(),
                stop=run["stop"].cpu(), max_res=run["max_res"].cpu())
