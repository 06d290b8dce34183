"""Single-ray initialization from a launch point and direction
(``rays_tpu.rayinit.one_ray``; reference one_ray_init_XYZ_k_direction_m
.f90): normalize the requested direction, find the angle to B, solve the
Appleton-Hartree form for |n| and rescale the direction
(one_ray_init_XYZ_k_direction_m.f90:131-180).  With ``use_this_n_vec`` the
given refractive-index vector is used as it is (no dispersion solve).
"""

from __future__ import annotations

import dataclasses

import torch

from rays_tpu_torch.models import base
from rays_tpu_torch.wave import dispersion


@dataclasses.dataclass(frozen=True)
class OneRayInit:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    nx: float = 0.0
    ny: float = 0.0
    nz: float = 0.0
    use_this_n_vec: bool = False


def solve_along_directions(cfg, params, rvec, nvec):
    """Re-solve the dispersion relation along each given direction: rvec,
    nvec (B,3) -> (rindex_vec (B,3), err (B,) StopCode, propagating (B,))."""
    err = base.eq_err(cfg, params, rvec)
    alpha, gamma, bunit, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    nunit = nvec / torch.sqrt((nvec * nvec).sum(-1, keepdim=True))
    theta = torch.arccos((bunit * nunit).sum(-1).clamp(-1.0, 1.0))
    nmag, valid = dispersion.solve_n_vs_theta(alpha, gamma, cfg.wave_mode,
                                              cfg.k0_sign, theta)
    return nmag[:, None] * nunit, err, valid


def one_ray_init_xyz_k_direction(cfg, params, ri: OneRayInit):
    """Returns (rvec0 (1,3), rindex_vec0 (1,3), pwr_wt (1,))."""
    k0 = params.rf.k0
    rvec = torch.tensor([[ri.x, ri.y, ri.z]], dtype=torch.float64).to(k0)
    nvec = torch.tensor([[ri.nx, ri.ny, ri.nz]], dtype=torch.float64).to(k0)
    pwr = torch.ones((1,), dtype=k0.dtype, device=k0.device)
    if ri.use_this_n_vec:
        return rvec, nvec, pwr

    rindex, err, valid = solve_along_directions(cfg, params, rvec, nvec)
    if int(err[0]) != 0:
        raise RuntimeError(
            f"one_ray_init: equilibrium error code {int(err[0])} at launch")
    if not bool(valid[0]):
        raise RuntimeError("one_ray_init: evanescent — no successful ray "
                           "initializations")
    return rvec, rindex, pwr
