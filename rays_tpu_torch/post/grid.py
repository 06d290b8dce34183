"""Evaluation grids of the geometry processors: points of the y = 0 plane
as the models take them, in the parameters' dtype and on their device, and
the way back to numpy for the files."""

from __future__ import annotations

import numpy as np
import torch


def like(params, values):
    """numpy values -> a tensor in the parameters' dtype, on their device."""
    ref = params.rf.k0
    return torch.as_tensor(np.asarray(values, np.float64)).to(device=ref.device, dtype=ref.dtype)


def plane_points(r, z):
    """(x or R, Z) tensors that broadcast -> points (N, 3) in the y = 0
    plane, flattened in C order."""
    r, z = torch.broadcast_tensors(r, z)
    r, z = r.reshape(-1), z.reshape(-1)
    return torch.stack([r, torch.zeros_like(r), z], dim=-1)


def to_numpy(t):
    return t.detach().cpu().double().numpy()
