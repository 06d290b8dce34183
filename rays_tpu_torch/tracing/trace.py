"""Batched ray tracing (``rays_tpu.tracing.trace``): a loop over steps
with mask-and-freeze stop semantics over a (B, nv) ray batch.

Stop-check order per outer step matches the reference tracing loop
(ray_tracing.f90:116-245):
  1. sout > s_max           (before stepping, :128-147)
  2. step budget            (loop length; flag NSTEP_MAX if still live)
  3. stops inside the solver (RHS statuses, :177-197)
  4. check_save stops        (residual, :212-234)
A step rejected by (3) or (4) leaves the ray state unchanged and is not
recorded.

``trace_batch`` is plain PyTorch and runs on any device, with the
fixed-step RK4 (``RK4_ODE``) or the adaptive DP5(4) stepper (``SG_ODE``,
tracing/rk45.py); autograd differentiates it with respect to every
floating Params leaf, v0 and pwr_wt (the adjoint), with each step
rematerialized on the backward pass when ``cfg.remat_steps`` is on.
``trace_rays`` is the top-level dispatch; ``route`` says from the config
alone which of the two tracers a run takes.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from rays_tpu_torch.core.types import needs_grad
from rays_tpu_torch.models import base
from rays_tpu_torch.tracing import rhs as rhs_mod
from rays_tpu_torch.tracing import compensated, rk4, rk45
from rays_tpu_torch.tracing.stop import StopCode


class RayResults(NamedTuple):
    """Analog of the reference results store (ray_results_m.f90:44-58)."""

    ray_vec: Any            # (B, nstep_max+1, nv); zeros beyond npoints
    residual: Any           # (B, nstep_max+1)
    npoints: Any            # (B,) int32
    stop_flag: Any          # (B,) int32 StopCode
    initial_ray_power: Any  # (B,)
    end_residuals: Any      # (B,)
    max_residuals: Any      # (B,)
    end_ray_parameter: Any  # (B,)
    start_ray_vec: Any      # (B, nv)
    end_ray_vec: Any        # (B, nv)
    # the compensated-summation residual of end_ray_vec under
    # cfg.compensated_sum (the accumulated state is end_ray_vec +
    # end_ray_comp, summed in float64 by compensated.resolved); None when
    # the mode is off
    end_ray_comp: Any = None


def get_step_fn(cfg):
    """(cfg, params, s, v, h) -> (v_new, status, h_next) for the solver."""
    if cfg.ode_solver_name == "RK4_ODE":
        return lambda cfg, params, s, v, h: (*rk4.rk4_step(cfg, params, s, v), h)
    if cfg.ode_solver_name == "SG_ODE":
        # the adaptive equivalent of the Shampine-Gordon suite
        return rk45.rk45_step
    raise ValueError(f"invalid ode solver {cfg.ode_solver_name}")


def get_carried_step_fn(cfg):
    """Stepper taking (cfg, params, s, v, h, f1, st1) with the first stage
    supplied from the previous step's shared endpoint evaluation."""
    if cfg.ode_solver_name == "RK4_ODE":
        return lambda cfg, params, s, v, h, f1, st1: (
            *rk4.rk4_step_carried(cfg, params, s, v, f1, st1), h)
    if cfg.ode_solver_name == "SG_ODE":
        return rk45.rk45_step_carried
    raise ValueError(f"invalid ode solver {cfg.ode_solver_name}")


def check_supported(cfg):
    """Raise for a config the port cannot trace, on every device."""
    base.get_eq_model(cfg.equilib_model)
    get_step_fn(cfg)
    rhs_mod.check_ported(cfg)


def route(cfg, needs_grad, device) -> str:
    """Which tracer a run takes, decided from the config, whether
    gradients are asked for, and the device of its tensors, before
    anything is launched: ``"kernel"`` (the slab RK4 CUDA kernel,
    tracing/fused_slab.py) or ``"plain"`` (``trace_batch`` on the tensors'
    own device).

    On a CUDA device every config that ``fused_slab.supported`` accepts
    takes the kernel, unless gradients are asked for (the kernel has no
    backward; the JAX package's adjoint, too, is reverse mode through its
    plain scan).  Every other config the port supports (the adaptive
    stepper, the Solovev tokamak, the spline geometries, the
    equilibrium-gradient slots, the autodiff derivatives, a model of the
    caller's own from ``base.register_eq_model``, even under a built-in
    name) runs ``trace_batch`` on the card, as the JAX package runs them
    as plain XLA operations.  This is a choice, not a
    fallback: a kernel that fails to build or launch raises."""
    check_supported(cfg)
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"trace_rays: unsupported device {device}")
    if kind == "cpu" or needs_grad or cfg.equilib_model in base.EQ_MODELS:
        return "plain"
    from rays_tpu_torch.tracing import fused_slab

    return "kernel" if fused_slab.supported(cfg) else "plain"


def trace_rays(cfg, params, v0, status0, pwr_wt) -> RayResults:
    """Top-level tracer dispatch (reference trace_rays,
    ray_tracing.f90:1): the tracer that ``route`` names."""
    if route(cfg, needs_grad(params, v0), v0.device) == "plain":
        return trace_batch(cfg, params, v0, status0, pwr_wt)
    from rays_tpu_torch.tracing import fused_slab

    return fused_slab.trace_batch_fused(cfg, params, v0, status0, pwr_wt)


def trace_batch(cfg, params, v0, status0, pwr_wt) -> RayResults:
    """Trace a batch of rays in plain PyTorch.  v0: (B, nv); status0: (B,)
    int32 (nonzero entries, e.g. padding rays, never start); pwr_wt: (B,).

    The endpoint evaluation that feeds check_save also supplies the next
    step's first stage (rhs.eqn_ray_and_check), so an RK4 outer step pays 4
    equilibrium evaluations.  Under ``SG_ODE`` the adaptive stepper's FSAL
    7th stage is that endpoint evaluation, and each ray carries its
    converged step size ``hstate`` from one outer step to the next.

    Under ``cfg.compensated_sum`` every accepted increment is TwoSummed
    into the state (tracing/compensated.py): the state is bit for bit the
    plain run's, and the rounding errors gather in a carried vector that
    ends as ``end_ray_comp``."""
    check_supported(cfg)
    sg = cfg.ode_solver_name == "SG_ODE"
    comp = cfg.compensated_sum
    ds, s_max = params.ode.ds, params.ode.s_max
    B, nv = v0.shape
    dev, dt = v0.device, v0.dtype

    # initial validity check (ray_tracing.f90:100-112); the initial residual
    # is recorded as 0 ("assume initial k solves the dispersion relation",
    # ray_tracing.f90:93).  The same evaluation seeds the first step's k1.
    zero_s = torch.zeros((), dtype=dt, device=dev)
    f1, st1, _, chk0 = rhs_mod.eqn_ray_and_check(cfg, params, zero_s, v0)
    status = torch.where(status0 != 0, status0.to(torch.int32), chk0)

    nstep = torch.zeros((B,), dtype=torch.int32, device=dev)
    end_res = torch.zeros((B,), dtype=dt, device=dev)
    max_res = torch.zeros((B,), dtype=dt, device=dev)
    sout_gt = torch.full_like(status, int(StopCode.SOUT_GT_SMAX))

    def step(k, v, f1, st1, hstate, status, nstep, end_res, max_res, cvec=None):
        s = k * ds
        sout = (k + 1) * ds

        active = status == 0
        status = torch.where(active & (sout > s_max), sout_gt, status)
        active = status == 0

        if sg:
            out = rk45.rk45_step_carried_full(cfg, params, s, v, hstate, f1, st1,
                                              active, cvec)
            v_new, solver_st, h_new, f_new, rhs_st_new, resid, check_st = out[:7]
            c_new = out[-1]     # the carry, when cvec was given
        else:
            if comp:
                dv, solver_st = rk4.rk4_step_carried_delta(cfg, params, s, v, f1, st1)
                v_new, c_new = compensated.two_sum_add(v, cvec, dv)
            else:
                v_new, solver_st = rk4.rk4_step_carried(cfg, params, s, v, f1, st1)
            f_new, rhs_st_new, resid, check_st = rhs_mod.eqn_ray_and_check(
                cfg, params, sout, v_new)
        status = torch.where(active & (solver_st != 0), solver_st, status)
        accepted = active & (solver_st == 0)
        status = torch.where(accepted & (check_st != 0), check_st, status)
        ok = accepted & (check_st == 0)

        okc = ok[:, None]
        if comp:
            cvec = torch.where(okc, c_new, cvec)
        v = torch.where(okc, v_new, v)
        # the endpoint RHS becomes the next step's k1; a frozen ray keeps
        # the stage matching its frozen state
        f1 = torch.where(okc, f_new, f1)
        st1 = torch.where(ok, rhs_st_new, st1)
        if sg:
            # the converged step size persists across outer steps
            hstate = torch.where(ok, h_new, hstate)
        nstep = nstep + ok.to(torch.int32)
        end_res = torch.where(ok, resid, end_res)
        max_res = torch.where(ok, torch.maximum(max_res, resid), max_res)
        row = torch.where(okc, v, 0.0)
        res_row = torch.where(ok, resid, 0.0)
        return (row, res_row, v, f1, st1, hstate, status, nstep, end_res, max_res,
                *((cvec,) if comp else ()))

    # the analog of jax.checkpoint(body) (JAX trace.py:233-238): the
    # backward pass keeps each step's inputs and recomputes its insides
    remat = cfg.remat_steps and needs_grad(params, v0)
    hstate = torch.zeros((B,), dtype=dt, device=dev) + ds
    carry = (v0, f1, st1, hstate, status, nstep, end_res, max_res,
             *((torch.zeros_like(v0),) if comp else ()))
    # trajectory rows are stacked once at the end: writing them into a
    # preallocated buffer would chain one whole-buffer copy per step into
    # the backward pass
    rows, res_rows = [v0], [torch.zeros((B,), dtype=dt, device=dev)]
    for k in range(cfg.nstep_max):
        if remat:
            out = torch.utils.checkpoint.checkpoint(
                functools.partial(step, k), *carry, use_reentrant=False)
        else:
            out = step(k, *carry)
        carry = out[2:]
        if cfg.save_trajectory:
            rows.append(out[0])
            res_rows.append(out[1])
    v, _, _, _, status, nstep, end_res, max_res = carry[:8]

    # still-live rays exhausted the step budget (ray_tracing.f90:150-172)
    status = torch.where(status == 0, torch.full_like(status, int(StopCode.NSTEP_MAX)),
                         status)
    if cfg.save_trajectory:
        ray_vec = torch.stack(rows, dim=1)
        residual = torch.stack(res_rows, dim=1)
    else:
        ray_vec = torch.zeros((B, 1, nv), dtype=dt, device=dev)
        residual = torch.zeros((B, 1), dtype=dt, device=dev)

    return RayResults(
        ray_vec=ray_vec,
        residual=residual,
        npoints=1 + nstep,
        stop_flag=status,
        initial_ray_power=pwr_wt,
        end_residuals=end_res,
        max_residuals=max_res,
        end_ray_parameter=v[:, 6],
        start_ray_vec=v0,
        end_ray_vec=v,
        end_ray_comp=carry[8] if comp else None,
    )
