"""Initial ODE vectors from launch positions and refractive indices
(``rays_tpu.rayinit.vector``; reference initialize_ode_vector.f90:23-54):
v[:, 0:3] = x0, v[:, 3:6] = k0*n0, v[:, 6] = 0.
"""

from __future__ import annotations

import torch


def initial_ode_vectors(cfg, params, rvec0, rindex_vec0):
    """(B,3),(B,3) -> (B, nv)."""
    if cfg.integrate_eq_gradients:
        raise NotImplementedError(
            "integrate_eq_gradients is not ported yet (ROADMAP A14)")
    v0 = torch.zeros((rvec0.shape[0], cfg.nv), dtype=rvec0.dtype,
                     device=rvec0.device)
    v0[:, 0:3] = rvec0
    v0[:, 3:6] = params.rf.k0 * rindex_vec0
    return v0
