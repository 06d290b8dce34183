"""Adaptive embedded Runge-Kutta (Dormand-Prince 5(4)) over one outer step,
batched over rays (``rays_tpu.tracing.rk45``).

The reference's adaptive path is the Shampine-Gordon Adams PECE suite
(ode_RAYS.f90, SG_ode_m.f90); as in the JAX package its place is taken by
an embedded one-step pair with PI step-size control: the same contract
(advance exactly ds to tolerance), O(1) state per ray.  Error control
follows the SG convention: the mixed test err_i / (abs_err + rel_err*|v_i|),
aborting with ODE_TOTAL_ERROR when the step size underflows or the substep
budget is exhausted (SG_ode_m.f90:89-159).

The JAX package writes the substep loop for one ray (``lax.while_loop``)
and batches it with ``vmap``.  Here the batch is explicit: the loop runs
while any ray's condition holds, and every update is a ``torch.where`` on
the ray's own condition, so a ray keeps its whole carry once it is done and
gets exactly the result it gets when traced alone.  On a CUDA device the
``any()`` is one host read per pass (the graphed tracer reads one flag per
captured chunk of passes instead, tracing/graphed.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from rays_tpu_torch import constants
from rays_tpu_torch.core.types import needs_grad
from rays_tpu_torch.tracing import rhs as rhs_mod
from rays_tpu_torch.tracing.compensated import two_sum_add
from rays_tpu_torch.tracing.stop import StopCode

# Dormand-Prince 5(4) tableau
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 5.0


class SubstepStats:
    """What the substep loop did since ``reset()``: ``loops`` passes in
    which some ray was live, ``attempts`` and ``rejected`` substeps summed
    over rays (all three counted on the rays' device, in place, so that a
    captured pass counts too; ``totals()`` reads them once), and
    ``host_reads`` of the loop's condition (a Python int)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.host_reads = 0
        self.counts = None      # (3,) int64: loops, attempts, rejected

    def bind(self, device):
        """Allocate the device counts (zero) if they are not there yet."""
        if self.counts is None:
            self.counts = torch.zeros(3, dtype=torch.int64, device=device)
        return self

    def add(self, live, accept):
        self.bind(live.device).counts.add_(torch.stack(
            [live.any().to(torch.int64), live.sum(), (live & ~accept).sum()]))

    def merge(self, other):
        """Add another record's counts and reads into this one."""
        self.host_reads += other.host_reads
        if other.counts is not None:
            self.bind(other.counts.device).counts.add_(other.counts)

    @property
    def loops(self):
        return self.totals()[0]

    def totals(self):
        """(loops, host_reads, attempts, rejected) as Python ints."""
        loops, attempts, rejected = ([0, 0, 0] if self.counts is None
                                     else self.counts.tolist())
        return loops, self.host_reads, attempts, rejected


# set to a SubstepStats to have the stepper count into it (chip_smoke.py
# does); None, the default, adds nothing to the loop
stats = None


def _dopri_step(f, f_check, t, v, h, k1, k1_st):
    """One trial DOPRI5 step with the first stage supplied (FSAL: DP5's
    7th stage is evaluated at (t+h, v5), so an accepted step's k7 is the
    next step's k1: 6 fresh RHS evaluations per substep, not 7).  The 7th
    stage uses ``f_check`` (the RHS and check_save from one equilibrium
    evaluation) so the step's endpoint check rides the same evaluation.
    t, h: (B,); v, k1: (B, nv).  Returns (v5, dv5, err_vec, status, k7,
    k7_status, resid, check_status) with v5 = v + dv5."""
    hc = h[:, None]
    ks = [k1]
    status = k1_st
    for i in range(1, 6):
        vi = v
        for j, aij in enumerate(_A[i]):
            if aij != 0.0:
                vi = vi + hc * aij * ks[j]
        ki, sti = f(t + _C[i] * h, vi)
        status = torch.where(status != 0, status, sti)
        ks.append(ki)
    # stage 7: A[6] == B5, so v7 is the 5th-order solution v5
    dv5 = torch.zeros_like(v)
    for j, aij in enumerate(_A[6]):
        if aij != 0.0:
            dv5 = dv5 + hc * aij * ks[j]
    v5 = v + dv5
    k7, st7, resid, chk = f_check(t + _C[6] * h, v5)
    status = torch.where(status != 0, status, st7)
    ks.append(k7)
    err = torch.zeros_like(v)
    for bi5, bi4, ki in zip(_B5, _B4, ks):
        err = err + hc * (bi5 - bi4) * ki
    return v5, dv5, err, status, k7, status, resid, chk


def rk45_step(cfg, params, s, v, h0):
    """Advance one outer step ds adaptively.  Returns (v_new, status, h_next)."""
    f1, st1 = rhs_mod.eqn_ray(cfg, params, s, v)
    return rk45_step_carried(cfg, params, s, v, h0, f1, st1)


def rk45_step_carried(cfg, params, s, v, h0, f1, st1):
    """Carried-stage form returning (v_new, status, h_next); see
    rk45_step_carried_full for the endpoint-sharing variant."""
    return rk45_step_carried_full(cfg, params, s, v, h0, f1, st1)[:3]


def rk45_step_carried_full(cfg, params, s, v, h0, f1, st1, active=None, c0=None):
    """Advance one outer step ds adaptively, with (f1, st1) = eqn_ray(s, v)
    supplied by the caller (the tracer carries it from the previous step's
    endpoint stage).  s: scalar; v, f1: (B, nv); h0, st1: (B,).  Returns
    (v_new, status, h_next, f_end, f_end_status, resid, check_status):
    f_end is the RHS at (sout, v_new), the FSAL 7th stage of the final
    accepted substep, and (resid, check_status) are check_save's values at
    the same point from the same equilibrium evaluation, so the tracer
    pays no separate endpoint evaluation.

    ``h0`` is the converged step size carried over from the previous outer
    step (the SG suite likewise keeps its step and order state across outer
    steps, SG_ode_m.f90:73-85 resets only at ray start).  Within the
    substep loop the first stage rides FSAL: an accepted substep's k7
    becomes the next substep's k1; a rejected substep reuses its k1.

    ``cfg.sg_scan_substeps > 0`` replaces the loop by that fixed number of
    masked substeps, unrolled: the form that differentiates.  Asking for
    gradients with ``sg_scan_substeps == 0`` raises.

    ``c0`` (B, nv), optional, is the compensated-summation carry: when it
    is given, each accepted substep's increment is TwoSummed into (v, c)
    and the returned tuple gains a trailing c_new (``cfg.compensated_sum``).
    Like the rest of the carry it changes only where a ray takes a substep.

    ``active`` (B,) bool, optional: rays outside it take no substep and
    what is returned for them means nothing.  The tracer passes the rays
    that are still live, whose results alone it keeps, so that rays which
    have stopped do not hold the loop open.

    The pieces (``substep_context``, ``substep_start``, ``substep_live``,
    ``substep_pass``, ``substep_end``) are what the graphed tracer
    captures (tracing/graphed.py): a pass in which no ray is live leaves
    the carry as it was, bit for bit, so running more passes than the loop
    needs changes nothing.
    """
    ctx = substep_context(params, s, v.shape[0], v.device, active)
    carry = substep_start(params, ctx, s, v, h0, f1, st1, c0)
    n_scan = int(cfg.sg_scan_substeps)
    if n_scan > 0:
        # a fixed budget of masked substeps, unrolled; the check after the
        # loop still fires if a ray needed more
        for _ in range(n_scan):
            carry = substep_pass(cfg, params, ctx, carry, substep_live(cfg, ctx, carry))
    else:
        if needs_grad(params, v, f1):
            raise ValueError(
                "gradients through the SG_ODE stepper need cfg.sg_scan_substeps > 0 "
                "(the fixed budget of masked substeps); with sg_scan_substeps == 0 "
                "the substep loop runs until every ray is done and is not "
                "differentiated")
        while True:
            live = substep_live(cfg, ctx, carry)
            if stats is not None:
                stats.host_reads += 1
            if not bool(live.any()):
                break
            carry = substep_pass(cfg, params, ctx, carry, live)
    return substep_end(ctx, carry)


class SubstepContext(NamedTuple):
    """What every pass of one outer step's substep loop reads besides its
    carry: the end of the step, the step-size floor, the "reached sout"
    tolerance, a (B,) ODE_TOTAL_ERROR code and the rays that may step."""

    sout: Any
    h_min: Any
    done_tol: Any
    total_error: Any
    active: Any


def substep_context(params, s, n_rays, device, active=None) -> SubstepContext:
    ds = params.ode.ds
    # "reached sout" tolerance: below ~eps*|sout| the update t += h would
    # round away and the loop could spin until the substep budget dies
    return SubstepContext(
        sout=s + ds, h_min=ds.abs() * 1e-12, done_tol=ds.abs() * 1e-10,
        total_error=torch.full((n_rays,), int(StopCode.ODE_TOTAL_ERROR), dtype=torch.int32,
                               device=device),
        active=active)


# the loop's carry with the compensated slot: (t, v, h, k1, k1_status,
# resid, check_status, c, status, n_sub)
_COMP_CARRY = 10


def substep_start(params, ctx, s, v, h0, f1, st1, c0=None):
    """The loop's carry at the start of the outer step: (t, v, h, k1,
    k1_status, resid, check_status, [c], status, n_sub)."""
    B = v.shape[0]
    dev, dt = v.device, v.dtype
    zero_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    t0 = torch.zeros((B,), dtype=dt, device=dev) + s
    h_start = torch.minimum(torch.maximum(h0, ctx.h_min), params.ode.ds.abs())
    return (t0, v, h_start, f1, st1, torch.zeros((B,), dtype=dt, device=dev),
            zero_i, *((c0,) if c0 is not None else ()), zero_i, zero_i)


def substep_live(cfg, ctx, carry):
    """(B,) bool: the rays that take a substep in the next pass."""
    t, status, n_sub = carry[0], carry[-2], carry[-1]
    live = (ctx.sout - t > ctx.done_tol) & (status == 0) & (n_sub < cfg.max_substeps)
    return live if ctx.active is None else live & ctx.active


def substep_pass(cfg, params, ctx, carry, live):
    """One lockstep pass: every ray in ``live`` takes a trial substep; the
    others keep their whole carry."""
    rel, ab = params.ode.rel_err, params.ode.abs_err
    comp = len(carry) == _COMP_CARRY
    sout, h_min = ctx.sout, ctx.h_min
    t, vv, h, k1, k1_st, resid, chk = carry[:7]
    status, n_sub = carry[-2:]

    def f(ss, x):
        return rhs_mod.eqn_ray(cfg, params, ss, x)

    def f_check(ss, x):
        return rhs_mod.eqn_ray_and_check(cfg, params, ss, x)

    # Step sizes are non-differentiated control state: the adjoint of
    # an adaptive integrator is the discrete adjoint of the frozen
    # accepted-substep sequence.  detach() cuts the whole controller
    # chain (err -> err_ratio -> factor -> h) out of the backward
    # pass; the primal values are unchanged.
    h_try = torch.minimum(h, sout - t).detach()
    v5, dv5, err, rhs_status, k7, k7_st, resid5, chk5 = _dopri_step(
        f, f_check, t, vv, h_try, k1, k1_st)

    tol = ab + rel * torch.maximum(vv.abs(), v5.abs())
    err_ratio = (err.abs() / tol).amax(dim=-1)
    accept = (err_ratio <= 1.0) & (rhs_status == 0)
    if stats is not None:
        stats.add(live, accept)

    acc = accept[:, None]
    t_new = torch.where(accept, t + h_try, t)
    v_new = torch.where(acc, v5, vv)
    if comp:
        # the TwoSum's primary sum is v5 itself, bit for bit
        cc_new = torch.where(acc, two_sum_add(vv, carry[7], dv5)[1], carry[7])
    k1_new = torch.where(acc, k7, k1)
    k1_st_new = torch.where(accept, k7_st, k1_st)
    resid_new = torch.where(accept, resid5, resid)
    chk_new = torch.where(accept, chk5, chk)

    safe_ratio = err_ratio.clamp_min(constants.SAFE_TINY)
    factor = (_SAFETY * safe_ratio ** (-0.2)).clamp(_MIN_FACTOR, _MAX_FACTOR)
    h_new = torch.maximum(h_try * factor, h_min).detach()

    status_new = torch.where(rhs_status != 0, rhs_status, status)
    status_new = torch.where((~accept) & (h_try <= h_min) & (status_new == 0),
                             ctx.total_error, status_new)
    new = (t_new, v_new, h_new, k1_new, k1_st_new, resid_new, chk_new,
           *((cc_new,) if comp else ()), status_new, n_sub + 1)
    # per ray: the new carry where its condition held, else the old
    return tuple(torch.where(live[:, None] if a.dim() == 2 else live, b, a)
                 for a, b in zip(carry, new))


def substep_end(ctx, carry):
    """The step's outputs from the loop's final carry (see
    ``rk45_step_carried_full``), with a trailing c_new when the carry has
    the compensated slot."""
    t_f, v_f, h_f, k_f, k_st_f, resid_f, chk_f = carry[:7]
    status = carry[-2]
    # substep budget exhausted without reaching sout: tolerance failure
    status = torch.where((status == 0) & (ctx.sout - t_f > ctx.done_tol), ctx.total_error,
                         status)
    return (v_f, status, h_f, k_f, k_st_f, resid_f, chk_f,
            *((carry[7],) if len(carry) == _COMP_CARRY else ()))
