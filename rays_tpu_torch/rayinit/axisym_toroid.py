"""Axisymmetric-toroid ray initialization from (R, Z) launch points
(``rays_tpu.rayinit.axisym_toroid``; reference
axisym_toroid_ray_init_R_Z_nphi_ntheta_m.f90): the flux-surface frame and
inward-psi dispersion solve of the Solovev initializer, with the launch
points given as (R, Z) lists against the generic axisym_toroid psi.

The frame is oriented along grad psiN, which rises outward whatever sign
the equilibrium gives psi: grad psi times the sign of psibound - psiaxis,
an exact negation where psi falls outward (the G-EQDSK that the Solovev
converter writes, and EFIT files of the other current direction), and
grad psi itself, bit for bit, where it rises.  The JAX package and the
reference take -grad(psi) as inward and so launch outward on such a file
(ROADMAP C13).

The reference supports a single R_launch0/Z_launch0 despite its
n_R_launch/n_Z_launch counts ("For now there is only one launch position",
ibid.:9); as in the JAX package the full grid is launched when the counts
exceed 1.  All candidates are solved in one batch, on whatever device and
dtype ``params`` has (``run.setup`` uses CPU float64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rays_tpu_torch.models import axisym_toroid as at_mod
from rays_tpu_torch.models import base
from rays_tpu_torch.wave import dispersion


@dataclasses.dataclass(frozen=True)
class AxisymToroidInit:
    n_r_launch: int = 1
    r_launch0: float = 0.0
    dr_launch: float = 0.0
    n_z_launch: int = 1
    z_launch0: float = 0.0
    dz_launch: float = 0.0
    n_rindex_theta: int = 1
    rindex_theta0: float = 0.0
    delta_rindex_theta: float = 0.0
    n_rindex_phi: int = 1
    rindex_phi0: float = 0.0
    delta_rindex_phi: float = 0.0


def _unit(vec):
    return vec / torch.sqrt((vec * vec).sum(-1, keepdim=True))


def axisym_toroid_ray_init(cfg, params, ri: AxisymToroidInit):
    """Returns (rvec0 (B,3), rindex_vec0 (B,3), pwr_wt (B,)), B = nray."""
    rs = ri.r_launch0 + ri.dr_launch * np.arange(ri.n_r_launch)
    zs = ri.z_launch0 + ri.dz_launch * np.arange(ri.n_z_launch)
    nthetas = ri.rindex_theta0 + ri.delta_rindex_theta * np.arange(ri.n_rindex_theta)
    nphis = ri.rindex_phi0 + ri.delta_rindex_phi * np.arange(ri.n_rindex_phi)

    # launch in the y = 0 plane; R, Z outer, n_theta, n_phi inner
    cand = [(R, 0.0, Z, nth, nph)
            for R in rs for Z in zs for nth in nthetas for nph in nphis]
    cand = np.asarray(cand, dtype=np.float64)
    if cand.shape[0] > cfg.nray_max:
        raise ValueError("axisym_toroid_ray_init: ray count exceeds nray_max")

    k0 = params.rf.k0
    c = torch.as_tensor(cand).to(device=k0.device, dtype=k0.dtype)
    rvec, nth, nph = c[:, 0:3], c[:, 3:4], c[:, 4:5]
    err = base.eq_err(cfg, params, rvec)
    alpha, gamma, bunit, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    _, gradpsi, _, gradpsin = at_mod.psi_and_grad(cfg.eq_static, params.eq, rvec)
    # grad psi along grad psiN: the sign of their dot product is that of
    # psibound - psiaxis
    gradpsi = torch.where(((gradpsi * gradpsin).sum(-1) < 0.0)[:, None], -gradpsi, gradpsi)

    zero = torch.zeros_like(gradpsi[:, 0])
    psi_unit = _unit(gradpsi)
    phi_unit = torch.stack([zero, zero + 1.0, zero], dim=-1)
    theta_unit = _unit(torch.stack([-gradpsi[:, 2], zero, gradpsi[:, 0]], dim=-1))
    trans_unit = torch.linalg.cross(bunit, psi_unit)

    rindex_vec = nph * phi_unit + nth * theta_unit
    n3 = (bunit * rindex_vec).sum(-1)
    n2 = (trans_unit * rindex_vec).sum(-1)
    npsi, propagating = dispersion.solve_n1_vs_n2_n3(
        alpha, gamma, cfg.wave_mode, cfg.k0_sign, n2, n3)
    # the psi-component points inward: the -grad(psiN) direction
    rindex0 = rindex_vec - npsi[:, None] * psi_unit
    valid = (err == 0) & propagating

    nray = int(valid.sum())
    if nray == 0:
        raise RuntimeError("axisym_toroid_ray_init: no successful ray "
                           "initializations")
    pwr = torch.full((nray,), 1.0 / nray, dtype=k0.dtype, device=k0.device)
    return rvec[valid], rindex0[valid], pwr
