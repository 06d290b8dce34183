"""Fixed-step RK4 over one outer step, batched and branch-free
(``rays_tpu.tracing.rk4``; reference RK4_ode_m.f90:59-94).

All four stages are computed for every ray and the first-flagged stage
status wins; on a nonzero status the caller keeps the old v.
"""

from __future__ import annotations

import torch

from rays_tpu_torch.tracing import rhs as rhs_mod


def _first_nonzero(*codes):
    out = codes[0]
    for c in codes[1:]:
        out = torch.where(out != 0, out, c)
    return out


def rk4_step(cfg, params, s, v):
    """One RK4 step of size params.ode.ds.  Returns (v_new, status)."""
    f1, st1 = rhs_mod.eqn_ray(cfg, params, s, v)
    return rk4_step_carried(cfg, params, s, v, f1, st1)


def rk4_step_carried(cfg, params, s, v, f1, st1):
    """RK4 step with the first stage (f1, st1) = eqn_ray(s, v) supplied by
    the caller, which carries it from the previous step's endpoint
    evaluation (4 equilibrium evaluations per step, not 5)."""
    dv, status = rk4_step_carried_delta(cfg, params, s, v, f1, st1)
    return v + dv, status


def rk4_step_carried_delta(cfg, params, s, v, f1, st1):
    """Increment form of ``rk4_step_carried``: (dv, status) with v_new =
    v + dv.  The compensated tracer (``cfg.compensated_sum``) TwoSums the
    raw increment into the carried state."""
    ds = params.ode.ds

    def f(ss, vv):
        return rhs_mod.eqn_ray(cfg, params, ss, vv)

    f2, st2 = f(s + ds / 2.0, v + ds * f1 / 2.0)
    f3, st3 = f(s + ds / 2.0, v + ds * f2 / 2.0)
    f4, st4 = f(s + ds, v + ds * f3)
    status = _first_nonzero(st1, st2, st3, st4)
    return ds * (f1 + 2.0 * f2 + 2.0 * f3 + f4) / 6.0, status
