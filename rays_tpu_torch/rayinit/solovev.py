"""Solovev flux-surface ray initialization (``rays_tpu.rayinit.solovev``;
reference solovev_ray_init_nphi_ntheta_m.f90).

Launch points on a (r, theta) fan in the phi = 0 plane, a (psi, theta, phi)
unit-vector frame built from grad(psi), the requested (n_phi, n_theta)
projected onto the flux surface, and the inward psi-component solved from
the cold dispersion relation (solovev_ray_init_nphi_ntheta_m.f90:124-198).
All candidates are solved in one batch; init runs once per run, on whatever
device and dtype ``params`` has (``run.setup`` uses CPU float64).

Divergence from the reference, kept from the JAX package: power weights
are a uniform 1/nray for every surviving ray; the reference only assigns a
weight to the last ray of each r-shell before normalizing
(solovev_ray_init_nphi_ntheta_m.f90:197).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rays_tpu_torch.models import base, solovev as solovev_mod
from rays_tpu_torch.wave import dispersion


@dataclasses.dataclass(frozen=True)
class SolovevInit:
    n_r_launch: int = 1
    r_launch0: float = 0.0
    dr_launch: float = 0.0
    n_theta_launch: int = 1
    theta_launch0: float = 0.0
    dtheta_launch: float = 0.0
    n_rindex_theta: int = 1
    rindex_theta0: float = 0.0
    delta_rindex_theta: float = 0.0
    n_rindex_phi: int = 1
    rindex_phi0: float = 0.0
    delta_rindex_phi: float = 0.0


def _unit(vec):
    return vec / torch.sqrt((vec * vec).sum(-1, keepdim=True))


def solovev_ray_init_nphi_ntheta(cfg, params, ri: SolovevInit):
    """Returns (rvec0 (B,3), rindex_vec0 (B,3), pwr_wt (B,)), B = nray,
    on the device and in the dtype of ``params``."""
    rmaj = float(params.eq.rmaj)
    rs = ri.r_launch0 + ri.dr_launch * np.arange(ri.n_r_launch)
    thetas = ri.theta_launch0 + ri.dtheta_launch * np.arange(ri.n_theta_launch)
    nthetas = ri.rindex_theta0 + ri.delta_rindex_theta * np.arange(ri.n_rindex_theta)
    nphis = ri.rindex_phi0 + ri.delta_rindex_phi * np.arange(ri.n_rindex_phi)

    # reference loop nesting: r, theta outer; n_theta, n_phi inner
    cand = [(rmaj + r * np.cos(th), 0.0, r * np.sin(th), nth, nph)
            for r in rs for th in thetas for nth in nthetas for nph in nphis]
    cand = np.asarray(cand, dtype=np.float64)
    if cand.shape[0] > cfg.nray_max:
        raise ValueError("solovev_ray_init: ray count exceeds nray_max")

    k0 = params.rf.k0
    c = torch.as_tensor(cand).to(device=k0.device, dtype=k0.dtype)
    rvec, nth, nph = c[:, 0:3], c[:, 3:4], c[:, 4:5]
    err = base.eq_err(cfg, params, rvec)
    alpha, gamma, bunit, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    _, gradpsi, _, _ = solovev_mod.psi(params.eq, rvec)

    zero = torch.zeros_like(gradpsi[:, 0])
    psi_unit = _unit(gradpsi)
    phi_unit = torch.stack([zero, zero + 1.0, zero], dim=-1)
    theta_unit = _unit(torch.stack([-gradpsi[:, 2], zero, gradpsi[:, 0]], dim=-1))
    trans_unit = torch.linalg.cross(bunit, psi_unit)

    # refractive index projected onto the flux surface
    rindex_vec = nph * phi_unit + nth * theta_unit
    n3 = (bunit * rindex_vec).sum(-1)
    n2 = (trans_unit * rindex_vec).sum(-1)
    npsi, propagating = dispersion.solve_n1_vs_n2_n3(
        alpha, gamma, cfg.wave_mode, cfg.k0_sign, n2, n3)
    # the psi-component points inward: the -grad(psi) direction
    rindex0 = rindex_vec - npsi[:, None] * psi_unit
    valid = (err == 0) & propagating

    nray = int(valid.sum())
    if nray == 0:
        raise RuntimeError("solovev_ray_init: no successful ray initializations")
    pwr = torch.full((nray,), 1.0 / nray, dtype=k0.dtype, device=k0.device)
    return rvec[valid], rindex0[valid], pwr
