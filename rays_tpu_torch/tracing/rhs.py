"""The ray right-hand side: Hamiltonian geometrical-optics equations
(``rays_tpu.tracing.rhs``; reference eqn_ray.f90), batched over rays.

State layout in the ODE vector v (B, nv) (ode_m.f90:158-175):

    v[:, 0:3] = x,  v[:, 3:6] = k,  v[:, 6] = integrated ray parameter,
    [v[:, 7] = total absorption]  [v[:, 8:8+S] = per-species absorption]
    [5 gradient-diagnostic integrals]

The equilibrium is evaluated once per call; the statuses are the
first-triggered StopCode in the reference's order (equilibrium error ->
infinite Vg -> ray stalled, eqn_ray.f90:89-169).  Two derivative paths
reproduce the reference's ray_deriv_name A/B (eqn_ray.f90:106-123):
'cold', the closed-form chain rule of the pole-free D (deriv_cold.py), and
'autodiff', reverse-mode autograd of ``dispersion.dispersion_D``, which
evaluates the equilibrium again inside the differentiated function and is
kept as the independent check.
"""

from __future__ import annotations

import torch

from rays_tpu_torch import constants
from rays_tpu_torch.core.types import needs_grad
from rays_tpu_torch.models import base
from rays_tpu_torch.tracing.stop import StopCode
from rays_tpu_torch.wave import damping as damping_mod
from rays_tpu_torch.wave import deriv_cold as deriv_cold_mod
from rays_tpu_torch.wave import dispersion


def check_ported(cfg):
    """Raise for an option the RHS does not know."""
    if cfg.ray_param not in ("arcl", "time"):
        raise ValueError(f"eqn_ray: invalid ray_param {cfg.ray_param}")
    if cfg.ray_deriv_name not in ("cold", "autodiff"):
        raise ValueError(f"eqn_ray: invalid ray_deriv_name {cfg.ray_deriv_name}")


def _deriv_autodiff(cfg, params, v):
    """(dD/dx, dD/dk, dD/domega) per ray from one reverse pass through
    the scalar D.  The rays are independent, so the gradient of the sum
    over rays holds each ray's own derivatives; omega becomes one value
    per ray to receive them.  ``torch.autograd.grad`` is used and not
    ``torch.func.grad``: the latter refuses to run under the tracer's
    per-step checkpoint.  Where the caller asks for gradients, the result
    stays differentiable (the adjoint takes a second derivative of D)."""
    wants = needs_grad(params, v)

    def leaf(t):
        return t if t.requires_grad else t.detach().requires_grad_(True)

    with torch.enable_grad():
        x, kvec = leaf(v[:, 0:3]), leaf(v[:, 3:6])
        omega = leaf(params.rf.omgrf.expand(v.shape[0]))
        total = dispersion.dispersion_D(cfg, params, x, kvec, omega).sum()
        grads = torch.autograd.grad(total, (x, kvec, omega), create_graph=wants)
    return grads if wants else tuple(g.detach() for g in grads)


def eqn_ray(cfg, params, s, v):
    """RHS at ray parameter s for v (B, nv).  Returns (dvds, status)."""
    eq = base.equilibrium(cfg, params, v[:, 0:3])
    return _eqn_ray_from_eq(cfg, params, s, v, eq)


def _eqn_ray_from_eq(cfg, params, s, v, eq):
    """Everything in eqn_ray after the equilibrium evaluation."""
    check_ported(cfg)
    kvec = v[:, 3:6]
    omgrf, k0 = params.rf.omgrf, params.rf.k0
    tiny = constants.SAFE_TINY

    if cfg.ray_deriv_name == "autodiff":
        dddx, dddk, dddw = _deriv_autodiff(cfg, params, v)
    else:
        dddx, dddk, dddw = deriv_cold_mod.deriv_cold(eq, kvec / k0, omgrf, k0)

    # group velocity (eqn_ray.f90:131-144)
    safe_dddw = torch.where(dddw == 0.0, torch.ones_like(dddw), dddw)[:, None]
    dddk_mag = torch.sqrt((dddk**2).sum(-1))

    if cfg.ray_param == "arcl":
        # integrate w.r.t. arclength (eqn_ray.f90:150-170);
        # Fortran sign(1., dddw) is +1 at dddw == 0
        sgn = torch.where(dddw >= 0.0, 1.0, -1.0).to(v.dtype)[:, None]
        m = dddk_mag.clamp_min(tiny)[:, None]
        dxds = -sgn * dddk / m
        dkds = sgn * dddx / m
        dsd_ray_param = torch.ones_like(dddw)
    else:
        # integrate w.r.t. time (eqn_ray.f90:172-181)
        dxds = -dddk / safe_dddw
        dkds = dddx / safe_dddw
        dsd_ray_param = torch.sqrt((dxds**2).sum(-1))   # |vg|

    parts = [dxds, dkds, dsd_ray_param[:, None]]
    if cfg.damping_model != "no_damp" or cfg.integrate_eq_gradients:
        vg = -dddk / safe_dddw
    if cfg.damping_model != "no_damp":
        ksi, ki = damping_mod.damping(cfg, params, eq, v[:, 0:6], vg)
        # dP/ds = dsd 2 ki (1 - P_total), P_total = v[:, 7] (eqn_ray.f90:196-213)
        one_minus_p = 1.0 - v[:, 7]
        parts.append((dsd_ray_param * 2.0 * ki * one_minus_p)[:, None])
        if cfg.multi_spec_damping:
            parts.append(dsd_ray_param[:, None] * 2.0 * ksi * one_minus_p[:, None])
    if cfg.integrate_eq_gradients:
        # d/ds of (B, ne, Te) along the ray (eqn_ray.f90:217-229)
        vg0 = torch.sqrt((vg**2).sum(-1))
        vg_unit = vg / vg0.clamp_min(tiny)[:, None]
        dsd = dsd_ray_param[:, None]
        parts.append(dsd * torch.einsum("bi,bij->bj", vg_unit, eq.gradb))
        parts.append(dsd * (vg_unit * eq.gradns[:, 0]).sum(-1, keepdim=True))
        parts.append(dsd * (vg_unit * eq.gradts[:, 0]).sum(-1, keepdim=True))
    dvds = torch.cat(parts, dim=1)

    status = torch.zeros_like(eq.err)
    if cfg.ray_param == "arcl":
        status = torch.where(dddk_mag == 0.0,
                             torch.full_like(status, int(StopCode.RAY_STALLED)), status)
    status = torch.where(dddw == 0.0,
                         torch.full_like(status, int(StopCode.INFINITE_VG)), status)
    status = torch.where(eq.err != 0, eq.err, status)
    return dvds, status


def check_save(cfg, params, v):
    """Per-step validity checks on v (reference check_save.f90).
    Returns (resid, status), each (B,)."""
    alpha, gamma, bunit, _, _, err = base.eq_point_light(cfg, params, v[:, 0:3])
    return _check_from_point(cfg, params, alpha, gamma, bunit, err, v)


def _check_from_point(cfg, params, alpha, gamma, bunit, err, v):
    """check_save given the plasma state already evaluated at v[:, 0:3]."""
    kvec = v[:, 3:6]
    k0 = params.rf.k0
    k3 = (kvec * bunit).sum(-1)
    k1 = torch.sqrt(((kvec - k3[:, None] * bunit) ** 2).sum(-1))
    resid = dispersion.residual(alpha, gamma, k1 / k0, k3 / k0)

    status = torch.zeros_like(err)
    if cfg.damping_model != "no_damp":
        status = torch.where(v[:, 7] > params.limits.total_damping_limit,
                             torch.full_like(status, int(StopCode.TOTAL_ABSORPTION)),
                             status)
    status = torch.where(resid > params.limits.dispersion_resid_limit,
                         torch.full_like(status, int(StopCode.DISPERSION_RESIDUAL)),
                         status)
    status = torch.where(err != 0, err, status)
    return resid, status


def eqn_ray_and_check(cfg, params, s, v):
    """The RHS and the check_save monitor at the same point from one
    equilibrium evaluation.  Returns (dvds, rhs_status, resid, check_status).
    The tracer carries dvds into the next step's first RK stage."""
    eq = base.equilibrium(cfg, params, v[:, 0:3])
    dvds, rhs_status = _eqn_ray_from_eq(cfg, params, s, v, eq)
    resid, check_status = _check_from_point(
        cfg, params, eq.alpha, eq.gamma, eq.bunit, eq.err, v)
    return dvds, rhs_status, resid, check_status
