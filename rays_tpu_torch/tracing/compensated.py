"""Compensated (Neumaier) accumulation for the tracer's carried state
(``rays_tpu.tracing.compensated``).

Under ``cfg.compensated_sum`` each accepted increment ``v += dv`` is
TwoSummed: the state keeps ``fl(v + dv)``, bit for bit what the plain
tracer keeps, and a second vector ``c`` of the same shape collects the
exact rounding error of every such sum.  ``v + c`` is then the
accumulated state to about 2 ulp^2 (``resolved`` sums it in float64).
The JAX package measured that on the slab ECH cases this does not shrink
the float32-vs-float64 end error: the stage states ``v + h*a*k`` are
rounded to float32 inside every step, which no summation can undo.  The
mode is kept for its mechanics and for runs where the accumulation term
dominates (very long traces at large |v|).

PyTorch's eager operations do not reassociate, so ``(v - t) + dv`` keeps
the low bits it is meant to keep.  Branch-free via ``torch.where``.
"""

from __future__ import annotations

import torch


def two_sum_add(v, c, dv):
    """One compensated accumulation step: (t, c_new) with t = fl(v + dv)
    and c_new = c + (the exact error of that sum)."""
    t = v + dv
    # Neumaier: the larger operand keeps its bits, the smaller loses its
    # low bits; both branches are exact
    e = torch.where(v.abs() >= dv.abs(), (v - t) + dv, (dv - t) + v)
    return t, c + e


def resolved(v, c):
    """The best available value of the compensated state, summed in
    float64 (at the output boundary: in float32 the sum rounds c away)."""
    return v.double() + c.double()
