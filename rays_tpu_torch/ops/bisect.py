"""Bisection solve of f(x) = y on [xmin, xmax] (``rays_tpu.ops.bisect``;
reference RAYS_project/math_functions_lib/bisect_m.f90), batched.

A fixed number of halvings (60 reach ~1e-18 relative width) instead of the
reference's tolerance-driven loop, on a whole batch of brackets at once:
plasma-boundary finding along rays from the axis and the mirror's
R(AphiN) inversion in post-processing.
"""

from __future__ import annotations

import torch


def _brackets(y, xmin, xmax):
    """(y, a, b) as tensors of one broadcast shape, in the dtype and on the
    device of the first tensor among them (float64 on the CPU if none)."""
    ref = next((t for t in (y, xmin, xmax) if torch.is_tensor(t)), None)
    kw = (dict(dtype=ref.dtype, device=ref.device) if ref is not None
          else dict(dtype=torch.float64))
    return torch.broadcast_tensors(*(torch.as_tensor(t, **kw) for t in (y, xmin, xmax)))


def solve_bisection(f, y, xmin, xmax, iters: int = 60):
    """Returns (x, ok); ok is False where f(xmin) - y and f(xmax) - y have
    the same sign (no bracketing).  ``f`` is pointwise on a tensor of any
    shape, and y, xmin and xmax broadcast to the shape of the batch.  f(a)
    is carried from step to step: f being pointwise, it equals the value
    the JAX package recomputes each step."""
    y, a, b = _brackets(y, xmin, xmax)
    fa = f(a) - y
    fb = f(b) - y
    ok = fa * fb <= 0.0
    for _ in range(iters):
        m = 0.5 * (a + b)
        fm = f(m) - y
        go_left = fa * fm <= 0.0
        a, b, fa = (torch.where(go_left, a, m), torch.where(go_left, m, b),
                    torch.where(go_left, fa, fm))
    return 0.5 * (a + b), ok
