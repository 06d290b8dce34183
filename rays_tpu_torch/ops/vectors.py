"""3-vector helpers (``rays_tpu.ops.vectors``; reference
RAYS_project/math_functions_lib/vectors3_m.f90), batched over leading
axes: the vectors lie along the last axis."""

from __future__ import annotations

import torch


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def triple_product(a, b, c):
    return (a * cross(b, c)).sum(-1)


def unit(a, eps=1e-30):
    return a / torch.sqrt((a**2).sum(-1, keepdim=True)).clamp_min(eps)
