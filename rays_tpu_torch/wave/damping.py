"""Damping models (``rays_tpu.wave.damping``), batched over rays.

Dispatch is static (``cfg.damping_model``), as the reference's runtime
select (damping_m.f90:93-112):

* ``no_damp``       -- zeros.
* ``damp_fund_ECH`` -- weak-damping fundamental electron-cyclotron
  absorption (damp_fund_ECH.f90), electrons only: the imaginary
  wavenumber k_i and its per-species split ksi (only ksi[:, 0] nonzero).

The ECH model takes a warm correction D_warm from the Z function at
zeta = (omega + Omega_ce)/(k_par v_th) and divides it by the cold
dispersion's directional derivative along the group velocity
(damp_fund_ECH.f90:65-123).  The no-damping conditions (k_par == 0,
|zeta| > 5, Te == 0) are masks, and every masked-out operand is made safe
BEFORE it is used (safe_k3, xi clipped to +-6), because ``torch.where``
backpropagates through both branches: a NaN or inf in the unused one
poisons the gradient (the double-where hazard).  ``csrc/slab_rk4.cuh``
(``damp_fund_ech``) computes the same ki in the kernel.
"""

from __future__ import annotations

import torch

from rays_tpu_torch import constants
from rays_tpu_torch.ops import zfun


def damping(cfg, params, eq, v_xk, vg):
    """(ksi (B, S), ki (B,)) (damping_m.f90:74-117); v_xk is v[:, 0:6]
    and vg the group velocity (B, 3)."""
    if cfg.damping_model == "no_damp":
        ksi = v_xk.new_zeros((v_xk.shape[0], cfg.ns))
        return ksi, ksi.sum(-1)
    if cfg.damping_model == "damp_fund_ECH":
        return damp_fund_ech(cfg, params, eq, v_xk, vg)
    raise ValueError(f"damping: unimplemented damping model {cfg.damping_model}")


def damp_fund_ech(cfg, params, eq, v_xk, vg):
    """Weak fundamental-ECH damping (damp_fund_ECH.f90:39-127)."""
    sp = params.species
    omgrf, k0 = params.rf.omgrf, params.rf.k0
    bunit = eq.bunit

    kvec = v_xk[:, 3:6]
    nvec = kvec / k0
    k3 = (kvec * bunit).sum(-1)
    k1sq = ((kvec - k3[:, None] * bunit) ** 2).sum(-1)
    r3 = k3 / k0
    r1s = k1sq / k0**2
    r3s = r3**2
    rs = r1s + r3s

    b1 = eq.gamma[:, 0]          # signed electron gamma (negative)
    betae = b1**2

    # thermal speed; Te = 0 ('zero' temperature model) is masked out below
    te = eq.ts[:, 0].clamp_min(1e-30)
    vth = torch.sqrt(2.0 * te / sp.ms[0])
    vt = vth / constants.CLIGHT

    safe_k3 = torch.where(k3 == 0.0, torch.ones_like(k3), k3)
    xi = (omgrf + eq.omgc[:, 0]) / (safe_k3 * vth)

    # |xi| > 5 is masked to no damping below; the argument is clipped
    # first, so that the masked-out branch never sees the inf/underflow a
    # huge xi produces (the NaN in d(loss)/d(m_e) otherwise)
    xi_z = xi.clamp(-6.0, 6.0)
    zr, zi = zfun.zfun0_real_parts(xi_z, safe_k3)
    zmag2 = (zr**2 + zi**2).clamp_min(constants.SAFE_TINY)

    p = eq.alpha[:, 0]
    q = p / 2.0 / (1.0 - b1)

    safe_r3s = torch.where(r3s == 0, torch.ones_like(r3s), r3s)
    safe_r3 = torch.where(r3 == 0, torch.ones_like(r3), r3)
    lam1 = ((1.0 - q) * rs * r1s + (1.0 - p) * rs * r3s
            - (1.0 - q) * (1.0 - p) * (rs + r3s)
            - (1.0 - 2.0 * q) * r1s + (1.0 - 2.0 * q) * (1.0 - p))
    lam2 = (-p / b1 * (rs * r1s - (1.0 - 2.0 * q) * r1s)
            + p**2 / 4.0 / betae * r1s / safe_r3s
            * (rs + r3s - 2.0 * (1.0 - 2.0 * q)))
    lam5 = p * (rs * r3s - (1.0 - q) * (rs + r3s) + (1.0 - 2.0 * q))

    # D_warm = f_real * (xi + 1/Z); only Im(xi + 1/Z) = -Im(Z)/|Z|^2
    # enters ki (damp_fund_ECH.f90:88-90 in real form)
    f_real = (-(1.0 - b1) * r3 * vt
              * (lam1 + lam2 + r1s / 2.0 / safe_r3 / betae * vt * xi_z * lam5))
    d_warm_im = f_real * (-zi / zmag2)

    # cold directional derivative of D along vg (damp_fund_ECH.f90:92-109)
    a = 1.0 - p - betae
    b = -((1.0 - p) * a + (1.0 - p) ** 2 - betae) + (a + (1.0 - p) * (1.0 - betae)) * r3s
    ddnx2 = 2.0 * a * r1s + b
    ddnz = 2.0 * r3 * ((a + (1.0 - p) * (1.0 - betae)) * r1s
                       + (1.0 - p) * (2.0 * (1.0 - betae) * r3s - 2.0 * a))
    dn_perp2 = 2.0 * (nvec - r3[:, None] * bunit)
    ddn = ddnx2[:, None] * dn_perp2 + ddnz[:, None] * bunit

    vg_mag = torch.sqrt((vg**2).sum(-1))
    vg_unit = vg / vg_mag.clamp_min(constants.SAFE_TINY)[:, None]
    denom = (ddn * vg_unit).sum(-1)
    safe_denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)

    # delta = -D_warm / (dD . vg_unit); ki = k0 * Im(delta)
    ki0 = k0 * (-d_warm_im / safe_denom)

    live = (k3 != 0.0) & (xi.abs() <= 5.0) & (eq.ts[:, 0] > 0.0) & (denom != 0.0)
    ki0 = torch.where(live, ki0, torch.zeros_like(ki0))

    ksi = torch.cat([ki0[:, None], ki0.new_zeros((ki0.shape[0], cfg.ns - 1))], dim=1)
    return ksi, ki0
