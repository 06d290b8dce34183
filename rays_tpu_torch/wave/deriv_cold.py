"""Closed-form cold-plasma D-derivatives, the production derivative path
(``rays_tpu.wave.deriv_cold``; reference deriv_cold.f90:40-171), batched
over rays.  The tiny matrix-vector products are broadcast multiply-reduce,
as in the JAX package: as ``torch.matmul`` each would be a library
batched gemv, the slowest kernel of a step on the card.

This chain — slab fields, ``models.base.equilibrium``, this module and
``tracing.rhs`` — is the plain twin of the CUDA kernel in
``csrc/slab_rk4.cuh``, which unrolls the same formulas over the species.
"""

from __future__ import annotations

import torch

from rays_tpu_torch import constants
from rays_tpu_torch.wave import stix


def deriv_cold(eq, nvec, omgrf, k0):
    """(dddx (B,3), dddk (B,3), dddw (B,)) at an EqPoint for refractive
    index nvec (B,3) (deriv_cold.f90)."""
    alpha, gamma = eq.alpha, eq.gamma
    tiny = constants.SAFE_TINY
    bunit = eq.bunit

    n3 = (nvec * bunit).sum(-1)
    nperp = nvec - n3[:, None] * bunit
    n1sq = (nperp**2).sum(-1)

    # d(n3)/dk, d(n1^2)/dk  (deriv_cold.f90:49-51)
    dn3dk = bunit / k0
    dn12dk = 2.0 * nperp / k0

    # spatial derivatives (deriv_cold.f90:53-67)
    dn3dx = (eq.gradbunit * nvec[:, None, :]).sum(-1)                 # (B,3)
    dn12dx = -2.0 * n3[:, None] * dn3dx
    dadx = alpha[:, :, None] * eq.gradns / eq.ns.clamp_min(tiny)[:, :, None]
    dgdx = gamma[:, :, None] * (
        eq.gradbmag / eq.bmag.clamp_min(tiny)[:, None])[:, None, :]  # (B,S,3)

    # omega derivatives (deriv_cold.f90:69-75)
    dn3dw = -n3 / omgrf
    dn12dw = -2.0 * n1sq / omgrf
    dadw = -2.0 * alpha / omgrf
    dgdw = -gamma / omgrf

    # species products (deriv_cold.f90:77-101)
    p = 1.0 - alpha.sum(-1)
    # a multiply chain, not prod: the graphed adjoint captures this
    # function's backward, and prod's reads the host (stix.product)
    t = stix.product(1.0 - gamma**2)
    dq1da, dq2da = stix.leave_one_out_products(gamma)
    q1 = (alpha * dq1da).sum(-1)
    q2 = (alpha * dq2da).sum(-1)
    u = t - (alpha * dq1da * dq2da).sum(-1)
    q = 2.0 * u - t + q1 * q2

    duda = -dq1da * dq2da
    dqda = 2.0 * duda + dq1da * q2[:, None] + q1[:, None] * dq2da

    # per-ray scalars broadcast against the species axis
    p_, t_, u_, q_ = p[:, None], t[:, None], u[:, None], q[:, None]
    n3_, n1sq_ = n3[:, None], n1sq[:, None]

    # dD/d(alpha) (deriv_cold.f90:110-112)
    ddda = (
        -t_ * n3_**4
        + (2.0 * (u_ - p_ * duda) + (-t_ + duda) * n1sq_) * n3_**2
        - q_ + p_ * dqda - (dqda - u_ + p_ * duda) * n1sq_ + duda * n1sq_**2
    )

    # dD/d(gamma) via leave-two-out kernels (deriv_cold.f90:114-154)
    gp, gm = stix.leave_two_out_products(gamma)
    gpm = gp * gm
    a_col = alpha[:, :, None]                      # sum over the first species axis
    dtdg = 2.0 * gamma * duda
    dudg = (a_col * gpm).sum(1)
    dudg = dtdg + 2.0 * gamma * (dudg + alpha * duda)
    dq1dg = (a_col * gp).sum(1) - alpha * dq1da
    dq2dg = -(a_col * gm).sum(1) + alpha * dq2da
    dqdg = 2.0 * dudg - dtdg + dq1dg * q2[:, None] + q1[:, None] * dq2dg
    dddg = (
        dtdg * p_ * n3_**4
        + (-2.0 * p_ * dudg + (dtdg * p_ + dudg) * n1sq_) * n3_**2
        + p_ * dqdg - (dqdg + p_ * dudg) * n1sq_ + dudg * n1sq_**2
    )

    # dD/d(n3), dD/d(n1^2) (deriv_cold.f90:157-158)
    dddn3 = (4.0 * t * p * n3**2 + 2.0 * (-2.0 * p * u + (t * p + u) * n1sq)) * n3
    dddn12 = (t * p + u) * n3**2 - (q + p * u) + 2.0 * u * n1sq

    # assemble (deriv_cold.f90:160-171)
    dddk = dddn3[:, None] * dn3dk + dddn12[:, None] * dn12dk
    dddx = ((ddda[:, :, None] * dadx).sum(1)
            + (dddg[:, :, None] * dgdx).sum(1)
            + dddn3[:, None] * dn3dx + dddn12[:, None] * dn12dx)
    dddw = (ddda * dadw + dddg * dgdw).sum(-1) + dddn3 * dn3dw + dddn12 * dn12dw

    return dddx, dddk, dddw
