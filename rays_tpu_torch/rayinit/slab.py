"""Simple-slab ray initialization (``rays_tpu.rayinit.slab``; reference
simple_slab_ray_init_m.f90).

A launch grid in (z, y, x) crossed with fans in (ny, nz); at each candidate
the local dispersion relation is solved for nx, and candidates that are
out of plasma or evanescent are dropped (simple_slab_ray_init_m.f90:
119-169).  All candidates are solved in one batch; init runs once per run,
on whatever device and dtype ``params`` has (``run.setup`` uses CPU float64).

Divergences from the reference, both kept from the JAX package:
  * the z-launch grid uses dz_launch (the reference reuses dy_launch,
    simple_slab_ray_init_m.f90:122);
  * ray power weights are 1/nray (the reference divides by nray twice,
    simple_slab_ray_init_m.f90:179-182).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rays_tpu_torch.models import base
from rays_tpu_torch.wave import dispersion


@dataclasses.dataclass(frozen=True)
class SlabInit:
    n_x_launch: int = 1
    x_launch0: float = 0.0
    dx_launch: float = 0.0
    n_y_launch: int = 1
    y_launch0: float = 0.0
    dy_launch: float = 0.0
    n_z_launch: int = 1
    z_launch0: float = 0.0
    dz_launch: float = 0.0
    n_ky_launch: int = 1
    rindex_y0: float = 0.0
    delta_rindex_y0: float = 0.0
    n_kz_launch: int = 1
    rindex_z0: float = 0.0
    delta_rindex_z0: float = 0.0


def simple_slab_ray_init(cfg, params, ri: SlabInit):
    """Returns (rvec0 (B,3), rindex_vec0 (B,3), pwr_wt (B,)), B = nray,
    on the device and in the dtype of ``params``."""
    xs = ri.x_launch0 + ri.dx_launch * np.arange(ri.n_x_launch)
    ys = ri.y_launch0 + ri.dy_launch * np.arange(ri.n_y_launch)
    zs = ri.z_launch0 + ri.dz_launch * np.arange(ri.n_z_launch)
    nys = ri.rindex_y0 + ri.delta_rindex_y0 * np.arange(ri.n_ky_launch)
    nzs = ri.rindex_z0 + ri.delta_rindex_z0 * np.arange(ri.n_kz_launch)

    # reference loop nesting: z, y, x outer; ky, kz inner
    cand = [(x, y, z, ny, nz)
            for z in zs for y in ys for x in xs for ny in nys for nz in nzs]
    cand = np.asarray(cand, dtype=np.float64)
    if cand.shape[0] > cfg.nray_max:
        raise ValueError(
            f"simple_slab_ray_init: ray count {cand.shape[0]} exceeds "
            f"nray_max {cfg.nray_max}")

    k0 = params.rf.k0
    c = torch.as_tensor(cand).to(device=k0.device, dtype=k0.dtype)
    rvec = c[:, 0:3]
    alpha, gamma, bunit, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    err = base.eq_err(cfg, params, rvec)
    # evanescent (complex nx) candidates are dropped, like the reference's
    # aimag(rindex_x) /= 0 skip
    nx, propagating = dispersion.solve_nx_vs_ny_nz_by_bz(
        alpha, gamma, bunit, cfg.wave_mode, cfg.k0_sign, c[:, 3], c[:, 4])
    valid = (err == 0) & propagating

    nray = int(valid.sum())
    if nray == 0:
        raise RuntimeError("simple_slab_ray_init: no successful ray initializations")

    rvec0 = rvec[valid]
    rindex0 = torch.stack([nx[valid], c[valid, 3], c[valid, 4]], dim=-1)
    pwr = torch.full((nray,), 1.0 / nray, dtype=k0.dtype, device=k0.device)
    return rvec0, rindex0, pwr
