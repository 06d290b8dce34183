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
``trace_rays`` is the top-level dispatch; ``route`` says from the config,
the kind of derivative and the device which of the five tracers a run
takes: the slab kernel, the graphed tracer (tracing/graphed.py, which
replays this module's ``step`` as a CUDA graph), the graphed adjoint
(tracing/graphed_adjoint.py, which replays ``step`` forward and its VJP
backward, for reverse-mode gradients on the card), the tangent graph
(tracing/graphed_tangent.py, which replays the JVP of ``step``, for
forward-mode tangents on the card) or ``trace_batch``.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from rays_tpu_torch.core.types import has_tangent, needs_grad
from rays_tpu_torch.models import base
from rays_tpu_torch.tracing import rhs as rhs_mod
from rays_tpu_torch.tracing import compensated, rk4, rk45
from rays_tpu_torch.tracing.stop import StopCode
from rays_tpu_torch.utils import spans


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


def route(cfg, needs_grad, device, tangents=False) -> str:
    """Which tracer a run takes, decided from the config, the kind of
    derivative asked for (``needs_grad``: reverse mode; ``tangents``:
    forward mode) and the device of its tensors, before anything is
    launched: ``"kernel"`` (the slab RK4 CUDA kernel,
    tracing/fused_slab.py), ``"graph"`` (``trace_batch``'s outer step
    captured once per configuration as a CUDA graph and replayed,
    tracing/graphed.py), ``"adjoint"`` (the step and its VJP captured as
    CUDA graphs, the forward replaying one and the backward the other,
    tracing/graphed_adjoint.py), ``"tangent"`` (the step's JVP captured
    as a CUDA graph and replayed, tracing/graphed_tangent.py) or
    ``"plain"`` (``trace_batch`` on the tensors' own device).  The three
    kinds of graph share one cache of ``graphed.CACHE_SIZE`` entries
    (``graphed.get_or_capture``).

    On a CUDA device without derivatives every config that
    ``fused_slab.supported`` accepts takes the kernel, and every other
    config (the adaptive stepper, the Solovev tokamak, the spline
    geometries, the equilibrium-gradient slots, the autodiff derivatives,
    the compensated carry) the graph: the counterpart of the JAX
    package's one ``jax.jit`` per config.  With reverse-mode gradients
    every config whose outer step is one graph takes the adjoint graph,
    the counterpart of the JAX package's ``jax.jit(jax.value_and_grad)``:
    RK4 on every geometry (the kernel's configs too: the kernel has no
    backward), SG with ``sg_scan_substeps > 0``, the compensated carry.
    It recomputes each step on the backward pass whatever
    ``cfg.remat_steps`` says, which sets only the plain route's memory.
    With forward-mode tangents every config but the autodiff derivatives
    takes the tangent graph, the counterpart of ``jax.jit`` around
    ``jax.jvp``, the SG loop form included.

    A model of the caller's own from ``base.register_eq_model`` takes the
    same routes as a built-in one, but never the kernel, even under the
    name ``"slab"``: the kernel's physics is the built-in slab's.  Its
    pieces are audited before their first capture (tracing/graphed.py),
    and a model that reads the host is refused with a ValueError.

    These stay plain: tangents together with reverse-mode gradients; the
    SG loop form and ``ray_deriv_name='autodiff'`` with gradients (the
    loop has no reverse rule, as in the JAX package; the autodiff
    derivatives' gradient is a second derivative through the autograd
    call inside the step); ``autodiff`` with tangents; and the CPU.  This
    is a choice, not a fallback: a kernel that fails to build or launch,
    or a capture, an audit or a replay that fails, raises."""
    check_supported(cfg)
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"trace_rays: unsupported device {device}")
    if kind == "cpu" or (tangents and needs_grad):
        return "plain"
    if tangents:
        from rays_tpu_torch.tracing import graphed_tangent

        return "plain" if graphed_tangent.refusal(cfg) else "tangent"
    if needs_grad:
        from rays_tpu_torch.tracing import graphed_adjoint

        return "plain" if graphed_adjoint.refusal(cfg) else "adjoint"
    from rays_tpu_torch.tracing import fused_slab

    return "kernel" if fused_slab.supported(cfg) else "graph"


def trace_rays(cfg, params, v0, status0, pwr_wt) -> RayResults:
    """Top-level tracer dispatch (reference trace_rays,
    ray_tracing.f90:1): the tracer that ``route`` names, inside the span
    ``rays.trace_rays.<route>`` (utils/spans.py)."""
    which = route(cfg, needs_grad(params, v0), v0.device, tangents=has_tangent(params, v0))
    with spans.span(_SPANS[which]):
        if which == "plain":
            return trace_batch(cfg, params, v0, status0, pwr_wt)
        if which == "graph":
            from rays_tpu_torch.tracing import graphed

            return graphed.trace_batch_graphed(cfg, params, v0, status0, pwr_wt)
        if which == "adjoint":
            from rays_tpu_torch.tracing import graphed_adjoint

            return graphed_adjoint.trace_batch_graphed_adjoint(cfg, params, v0, status0, pwr_wt)
        if which == "tangent":
            from rays_tpu_torch.tracing import graphed_tangent

            return graphed_tangent.trace_batch_graphed_tangent(cfg, params, v0, status0, pwr_wt)
        from rays_tpu_torch.tracing import fused_slab

        return fused_slab.trace_batch_fused(cfg, params, v0, status0, pwr_wt)


_SPANS = {"plain": "rays.trace_rays.plain", "graph": "rays.trace_rays.graph",
          "adjoint": "rays.trace_rays.adjoint", "tangent": "rays.trace_rays.tangent",
          "kernel": "rays.trace_rays.kernel"}


def step_start(params, k, status):
    """The head of outer step ``k`` (a 0-d float tensor: ``k * ds`` is
    then fl(k ds), as with a Python int): (s, sout, status, active) with
    the rays past s_max flagged (ray_tracing.f90:128-147)."""
    ds = params.ode.ds
    s = k * ds
    sout = (k + 1) * ds
    active = status == 0
    status = torch.where(active & (sout > params.ode.s_max),
                         torch.full_like(status, int(StopCode.SOUT_GT_SMAX)), status)
    return s, sout, status, status == 0


def rk4_solve(cfg, params, s, sout, v, f1, st1, cvec=None):
    """The fixed-step solver's part of an outer step, in the form of
    ``rk45.rk45_step_carried_full``'s outputs (h_new None): the RK4 step
    and the endpoint RHS and check_save from one evaluation."""
    if cvec is not None:
        dv, solver_st = rk4.rk4_step_carried_delta(cfg, params, s, v, f1, st1)
        v_new, c_new = compensated.two_sum_add(v, cvec, dv)
    else:
        v_new, solver_st = rk4.rk4_step_carried(cfg, params, s, v, f1, st1)
    f_new, rhs_st_new, resid, check_st = rhs_mod.eqn_ray_and_check(cfg, params, sout, v_new)
    return (v_new, solver_st, None, f_new, rhs_st_new, resid, check_st,
            *((c_new,) if cvec is not None else ()))


def step_end(cfg, carry, status, active, out):
    """The tail of an outer step: the solver's outputs ``out`` (see
    ``rk4_solve``) accepted where they pass the stops, into the carry
    (v, f1, st1, hstate, status, nstep, end_res, max_res, [cvec]).
    Returns (row, res_row, *new carry): the trajectory row and residual of
    the step, zero where the ray did not step."""
    v, f1, st1, hstate, _, nstep, end_res, max_res = carry[:8]
    comp = cfg.compensated_sum
    v_new, solver_st, h_new, f_new, rhs_st_new, resid, check_st = out[:7]
    status = torch.where(active & (solver_st != 0), solver_st, status)
    accepted = active & (solver_st == 0)
    status = torch.where(accepted & (check_st != 0), check_st, status)
    ok = accepted & (check_st == 0)

    okc = ok[:, None]
    if comp:
        cvec = torch.where(okc, out[-1], carry[8])
    v = torch.where(okc, v_new, v)
    # the endpoint RHS becomes the next step's k1; a frozen ray keeps
    # the stage matching its frozen state
    f1 = torch.where(okc, f_new, f1)
    st1 = torch.where(ok, rhs_st_new, st1)
    if h_new is not None:
        # the converged step size persists across outer steps
        hstate = torch.where(ok, h_new, hstate)
    nstep = nstep + ok.to(torch.int32)
    end_res = torch.where(ok, resid, end_res)
    max_res = torch.where(ok, torch.maximum(max_res, resid), max_res)
    row = torch.where(okc, v, 0.0)
    res_row = torch.where(ok, resid, 0.0)
    return (row, res_row, v, f1, st1, hstate, status, nstep, end_res, max_res,
            *((cvec,) if comp else ()))


def step(cfg, params, k, *carry):
    """One outer step of ``trace_batch`` at step index ``k`` (0-d float
    tensor) on the carry (v, f1, st1, hstate, status, nstep, end_res,
    max_res, [cvec]); returns (row, res_row, *new carry).  The graphed
    tracer captures this same function."""
    v, f1, st1, hstate, status = carry[:5]
    cvec = carry[8] if cfg.compensated_sum else None
    s, sout, status, active = step_start(params, k, status)
    if cfg.ode_solver_name == "SG_ODE":
        out = rk45.rk45_step_carried_full(cfg, params, s, v, hstate, f1, st1, active, cvec)
    else:
        out = rk4_solve(cfg, params, s, sout, v, f1, st1, cvec)
    return step_end(cfg, carry, status, active, out)


def initial_carry(cfg, params, v0, status0):
    """The carry before the first outer step (v, f1, st1, hstate, status,
    nstep, end_res, max_res, [cvec]): the initial validity check
    (ray_tracing.f90:100-112), whose evaluation seeds the first step's k1;
    the initial residual is recorded as 0 ("assume initial k solves the
    dispersion relation", ray_tracing.f90:93)."""
    B = v0.shape[0]
    dev, dt = v0.device, v0.dtype
    zero_s = torch.zeros((), dtype=dt, device=dev)
    f1, st1, _, chk0 = rhs_mod.eqn_ray_and_check(cfg, params, zero_s, v0)
    status = torch.where(status0 != 0, status0.to(torch.int32), chk0)
    hstate = torch.zeros((B,), dtype=dt, device=dev) + params.ode.ds
    return (v0, f1, st1, hstate, status, torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=dt, device=dev), torch.zeros((B,), dtype=dt, device=dev),
            *((torch.zeros_like(v0),) if cfg.compensated_sum else ()))


def step_index(k, v0):
    """Outer step ``k`` as the 0-d float tensor that ``step`` takes."""
    return torch.full((), k, dtype=v0.dtype, device=v0.device)


def results(cfg, carry, v0, pwr_wt, ray_vec, residual) -> RayResults:
    """RayResults from the final carry; rays still live exhausted the step
    budget (ray_tracing.f90:150-172)."""
    v, _, _, _, status, nstep, end_res, max_res = carry[:8]
    status = torch.where(status == 0, torch.full_like(status, int(StopCode.NSTEP_MAX)),
                         status)
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
        end_ray_comp=carry[8] if cfg.compensated_sum else None,
    )


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
    ends as ``end_ray_comp``.

    This is the eager twin of the graphed tracer (tracing/graphed.py), of
    the graphed adjoint (tracing/graphed_adjoint.py) and of the tangent
    graph (tracing/graphed_tangent.py), which replay the same ``step``;
    called directly it runs eagerly on any device."""
    check_supported(cfg)
    B, nv = v0.shape
    dev, dt = v0.device, v0.dtype
    carry = initial_carry(cfg, params, v0, status0)

    # the analog of jax.checkpoint(body) (JAX trace.py:233-238): the
    # backward pass keeps each step's inputs and recomputes its insides
    remat = cfg.remat_steps and needs_grad(params, v0)
    # trajectory rows are stacked once at the end: writing them into a
    # preallocated buffer would chain one whole-buffer copy per step into
    # the backward pass
    rows, res_rows = [v0], [torch.zeros((B,), dtype=dt, device=dev)]
    for k in range(cfg.nstep_max):
        body = functools.partial(step, cfg, params, step_index(k, v0))
        if remat:
            out = torch.utils.checkpoint.checkpoint(body, *carry, use_reentrant=False)
        else:
            out = body(*carry)
        carry = out[2:]
        if cfg.save_trajectory:
            rows.append(out[0])
            res_rows.append(out[1])

    if cfg.save_trajectory:
        ray_vec = torch.stack(rows, dim=1)
        residual = torch.stack(res_rows, dim=1)
    else:
        ray_vec = torch.zeros((B, 1, nv), dtype=dt, device=dev)
        residual = torch.zeros((B, 1), dtype=dt, device=dev)
    return results(cfg, carry, v0, pwr_wt, ray_vec, residual)
