"""The scalar dispersion function D(x, k, omega) and its root solvers
(``rays_tpu.wave.dispersion``), batched over rays.

D is the pole-free polynomial form

    D = u*n1s^2 + ((t*p+u)*n3^2 - (q+p*u))*n1s + t*p*n3^4 - 2*p*u*n3^2 + p*q

with n1s = n_perp^2: prod_s(1-gamma_s^2) times the Stix biquadratic
(suscep_m.f90:244-247), finite through the cyclotron resonances.  It is
the function whose derivatives ``deriv_cold`` computes in closed form.
"""

from __future__ import annotations

import torch

from rays_tpu_torch import constants
from rays_tpu_torch.models import base
from rays_tpu_torch.wave import stix

_MODE_INDEX = {"plus": 0, "minus": 1, "fast": 2, "slow": 3}


def _per_ray(omega):
    """omega as a scalar or a (B,) tensor -> broadcastable against (B, n)."""
    omega = torch.as_tensor(omega)
    return omega[:, None] if omega.dim() == 1 else omega


def alpha_gamma(cfg, params, x, omega):
    """(alpha (B,S), gamma (B,S), bunit (B,3), bmag (B,)) at x (B,3) for
    frequency omega (a scalar or one per ray)."""
    bvec, ns, _ = base.eq_fields(cfg, params, x)
    bmag = torch.sqrt((bvec**2).sum(-1))
    bunit = bvec / bmag.clamp_min(constants.SAFE_TINY)[:, None]
    sp = params.species
    wratio = params.rf.omgrf_ref / _per_ray(omega)
    alpha = sp.alpha_coef * ns * wratio**2
    gamma = sp.gamma_coef * bmag[:, None] * wratio
    return alpha, gamma, bunit, bmag


def poly_D_of_n(alpha, gamma, n1sq, n3):
    """Pole-free dispersion function vs (n_perp^2, n_par), (B,)."""
    p, t, u, q, _, _ = stix.poly_pieces(alpha, gamma)
    return (
        u * n1sq**2
        + ((t * p + u) * n3**2 - (q + p * u)) * n1sq
        + t * p * n3**4
        - 2.0 * p * u * n3**2
        + p * q
    )


def dispersion_D(cfg, params, x, kvec, omega):
    """D(x, k, omega), (B,).  nvec = k*c/omega (k0 = omega/c, rf_m.f90:91)."""
    alpha, gamma, bunit, _ = alpha_gamma(cfg, params, x, omega)
    nvec = kvec * constants.CLIGHT / _per_ray(omega)
    n3 = (nvec * bunit).sum(-1)
    n1sq = (nvec**2).sum(-1) - n3**2
    return poly_D_of_n(alpha, gamma, n1sq, n3)


# --------------------------------------------------------------------------
# Root solvers (ray initialization) — reference dispersion_solvers_m.f90
# --------------------------------------------------------------------------


def solve_cold_n1sq_vs_n3(alpha, gamma, n3):
    """Cold-plasma n_perp^2 roots vs n_par with the numerically stable
    quadratic branch (disp_solve_cold_n1sq_vs_n3.f90:53-87).

    Returns (roots (B,4), evanescent (B,)): for a negative discriminant the
    roots are a complex pair, ``roots`` holds their common real part and
    ``evanescent`` is True.  Root order: [plus, minus, fast, slow]."""
    S, D, P, R, L = stix.rlsdp(alpha, gamma)
    a = S
    b = -R * L - P * S + n3**2 * (P + S)
    c = P * (n3**2 - R) * (n3**2 - L)
    discr = b**2 - 4.0 * a * c
    evanescent = discr < 0.0
    sqrt_d = torch.sqrt(discr.clamp_min(0.0))

    # Fortran sign(1., b) is +1 at b == 0
    b_neg = b < 0.0
    denom_plus = -b + sqrt_d   # used when b < 0
    denom_minus = -b - sqrt_d  # used when b >= 0

    def safe(d):
        return torch.where(d == 0.0, torch.ones_like(d), d)

    plus = torch.where(b_neg, denom_plus / (2.0 * a), 2.0 * c / safe(denom_minus))
    minus = torch.where(b_neg, 2.0 * c / safe(denom_plus), denom_minus / (2.0 * a))

    fast_is_plus = plus.abs() <= minus.abs()
    fast = torch.where(fast_is_plus, plus, minus)
    slow = torch.where(fast_is_plus, minus, plus)
    return torch.stack([plus, minus, fast, slow], dim=-1), evanescent


def solve_n1_vs_n2_n3(alpha, gamma, wave_mode, k_sign, n2, n3):
    """n1 for the selected mode (dispersion_solvers_m.f90:49-112).
    Returns (n1, valid); where the mode is evanescent valid is False and
    n1 is 0."""
    roots, evanescent = solve_cold_n1sq_vs_n3(alpha, gamma, n3)
    n1sq = roots[:, _MODE_INDEX[wave_mode]]
    rad = n1sq - n2**2
    valid = (~evanescent) & (rad >= 0.0)
    return k_sign * torch.sqrt(rad.clamp_min(0.0)), valid


def solve_nx_vs_ny_nz_by_bz(alpha, gamma, bunit, wave_mode, k_sign, ny, nz):
    """Resolve (ny, nz) against B in the y-z plane, then solve for nx
    (dispersion_solvers_m.f90:116-166).  Returns (nx, valid)."""
    n2 = ny * bunit[:, 2] - nz * bunit[:, 1]
    n3 = ny * bunit[:, 1] + nz * bunit[:, 2]
    return solve_n1_vs_n2_n3(alpha, gamma, wave_mode, k_sign, n2, n3)


def solve_cold_nsq_vs_theta(alpha, gamma, theta):
    """Appleton-Hartree-like n^2 roots vs the angle theta (B,) between n
    and B (disp_solve_cold_nsq_vs_theta.f90:33-70).  Returns real (B,4):
    [plus, minus, fast, slow]; entries may be negative (evanescent)."""
    S, D, P, R, L = stix.rlsdp(alpha, gamma)
    cos2 = torch.cos(theta) ** 2
    sin2 = 1.0 - cos2
    a = S * sin2 + P * cos2
    b = -R * L * sin2 - P * S * (1.0 + cos2)
    c = P * R * L
    discr = b**2 - 4.0 * a * c
    sqrt_d = torch.sqrt(discr.clamp_min(0.0))

    b_neg = b < 0.0
    denom_plus = -b + sqrt_d
    denom_minus = -b - sqrt_d
    plus = torch.where(b_neg, denom_plus / (2.0 * a), 2.0 * c / denom_minus)
    minus = torch.where(b_neg, 2.0 * c / denom_plus, denom_minus / (2.0 * a))

    fast_is_plus = plus.abs() <= minus.abs()
    fast = torch.where(fast_is_plus, plus, minus)
    slow = torch.where(fast_is_plus, minus, plus)
    return torch.stack([plus, minus, fast, slow], dim=-1)


def solve_n_vs_theta(alpha, gamma, wave_mode, k_sign, theta):
    """n for the selected mode at angle theta
    (dispersion_solvers_m.f90:169-231).  Returns (n, valid): valid is False
    where n^2 < 0 (evanescent)."""
    nsq = solve_cold_nsq_vs_theta(alpha, gamma, theta)[:, _MODE_INDEX[wave_mode]]
    return k_sign * torch.sqrt(nsq.clamp_min(0.0)), nsq >= 0.0


# --------------------------------------------------------------------------
# Dispersion residual monitor — reference check_save.f90:163-235
# --------------------------------------------------------------------------


def residual(alpha, gamma, n1, n3):
    """|det(eps_h + n n - n^2 I)| over the sum of |term| products, (B,).

    With eps = [[S,-iD,0],[iD,S,0],[0,0,P]] and n = (n1, 0, n3) the
    determinant is real:  det = M33*(M11*M22 - D^2) - n1^2 n3^2 * M22.
    """
    S, D, P, _, _ = stix.rlsdp(alpha, gamma)
    nsq = n1**2 + n3**2
    m11 = S + n1**2 - nsq
    m22 = S - nsq
    m33 = P + n3**2 - nsq
    m13 = n1 * n3
    det = m33 * (m11 * m22 - D**2) - m13**2 * m22

    # |eps_h[i,j]| + |n_i n_j| entries of the reference's norm
    # (check_save.f90:226-232); zero entries dropped
    en11 = S.abs() + n1**2
    en22 = S.abs()
    en33 = P.abs() + n3**2
    en12 = D.abs()
    en13 = m13.abs()
    denom = (
        en33 * (en11 * en22)
        + en33 * (en12 * en12)
        + en13 * (en22 * en13)
    )
    return det.abs() / denom
