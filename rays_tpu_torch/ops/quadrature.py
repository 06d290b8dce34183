"""Trapezoid quadrature, plain and cumulative (``rays_tpu.ops.quadrature``;
reference RAYS_project/math_functions_lib/quad_trapezoid_m.f90), along the
last axis."""

from __future__ import annotations

import torch


def trapezoid(y, x):
    """The integral of y over x, in ``jnp.trapezoid``'s order of sums."""
    return 0.5 * ((x[..., 1:] - x[..., :-1]) * (y[..., 1:] + y[..., :-1])).sum(-1)


def cumulative_trapezoid(y, x, initial=0.0):
    """Cumulative integral on the same grid; result[..., 0] = initial."""
    incr = 0.5 * (y[..., 1:] + y[..., :-1]) * (x[..., 1:] - x[..., :-1])
    first = torch.full(y.shape[:-1] + (1,), initial, dtype=y.dtype, device=y.device)
    return torch.cat([first, initial + torch.cumsum(incr, dim=-1)], dim=-1)
