"""Initial ODE vectors from launch positions and refractive indices
(``rays_tpu.rayinit.vector``; reference initialize_ode_vector.f90:23-54):
v[:, 0:3] = x0, v[:, 3:6] = k0*n0, v[:, 6] = 0, the damping slots zero, and,
with the gradient-consistency diagnostics on, the trailing slots seeded
with the local B, ne and Te so that the integrated gradients can be
compared pointwise.
"""

from __future__ import annotations

import torch

from rays_tpu_torch.models import base


def initial_ode_vectors(cfg, params, rvec0, rindex_vec0):
    """(B,3),(B,3) -> (B, nv)."""
    v0 = torch.zeros((rvec0.shape[0], cfg.nv), dtype=rvec0.dtype,
                     device=rvec0.device)
    v0[:, 0:3] = rvec0
    v0[:, 3:6] = params.rf.k0 * rindex_vec0
    if cfg.integrate_eq_gradients:
        g = cfg.grad_diag_slot
        eq = base.equilibrium(cfg, params, rvec0)
        v0[:, g:g + 3] = eq.bvec
        v0[:, g + 3] = eq.ns[:, 0]
        v0[:, g + 4] = eq.ts[:, 0]
    return v0
