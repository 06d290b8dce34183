"""Monotonic function inversion y(x) -> x(y) (``rays_tpu.ops.invert``;
reference RAYS_project/math_functions_lib/monotonic_function_inversion.f90).

Given samples (x, y) with y monotonic, returns x on a uniform y grid by
linear interpolation, for either orientation of y.
"""

from __future__ import annotations

import torch


def interp(xq, xp, fp):
    """One-dimensional linear interpolation with ``jnp.interp``'s rules:
    xp increasing, constant fp[0] and fp[-1] outside [xp[0], xp[-1]], an
    interval no wider than the spacing of machine epsilon taking its left
    value."""
    i = torch.searchsorted(xp, xq.contiguous(), right=True).clamp(1, xp.shape[-1] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = xq - xp[i - 1]
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps ** 2   # np.spacing(eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(xq < xp[0], fp[0], f)
    return torch.where(xq > xp[-1], fp[-1], f)


def invert_monotonic(x, y, n_out: int = None, y_out=None):
    """(y_out, x(y_out)): y_out defaults to ``n_out`` (or len(x)) uniform
    points from y[0] to y[-1]."""
    if y_out is None:
        n_out = n_out or x.shape[-1]
        y_out = torch.linspace(float(y[0]), float(y[-1]), n_out, dtype=y.dtype,
                               device=y.device)
    sign = 1.0 if bool(y[-1] >= y[0]) else -1.0
    return y_out, interp(sign * y_out, sign * y, x)
