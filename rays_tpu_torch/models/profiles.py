"""Shared 1-D profile shapes, NaN-safe (``rays_tpu.models.profiles``).

Every branch is computed on clipped arguments and combined with
``torch.where``, so no NaN or inf leaks through the unselected branch.
"""

import torch

from rays_tpu_torch import constants


def parabolic(rho, f_min, alpha1, alpha2):
    """(1 - |rho|^alpha2)^alpha1, clipped below at f_min, 0 where
    |rho| >= 1 (reference slab_eq_m.f90:354-381).

    Returns (f, df/drho), elementwise over rho."""
    r = rho.abs()
    tiny = constants.SAFE_TINY
    r_safe = r.clamp(tiny, 1.0)
    base = (1.0 - r_safe**alpha2).clamp_min(tiny)
    f_in = base**alpha1
    fp_in = -alpha1 * alpha2 * r_safe ** (alpha2 - 1.0) * base ** (alpha1 - 1.0)
    fp_in = torch.sign(rho) * fp_in  # chain rule through |rho|

    inside = r < 1.0
    f = torch.where(inside, f_in, torch.zeros_like(f_in))
    fp = torch.where(inside, fp_in, torch.zeros_like(fp_in))

    clipped = f < f_min
    f = torch.where(clipped, f_min * torch.ones_like(f), f)
    fp = torch.where(clipped, torch.zeros_like(fp), fp)
    return f, fp


def parabolic_psi(psiN, alpha1, alpha2):
    """Parabolic-in-psiN profile of the toroidal equilibria:
    f = (1 - psiN^alpha2)^alpha1 for psiN < 1 else 0, with df/dpsiN, which
    is an exact zero outside (reference solovev_eq_m.f90:218-225)."""
    tiny = constants.SAFE_TINY
    p = psiN.clamp(tiny, 1.0)
    base = (1.0 - p**alpha2).clamp_min(tiny)
    f_in = base**alpha1
    dd = -alpha1 * alpha2 * p ** (alpha2 - 1.0) * base ** (alpha1 - 1.0)
    inside = psiN < 1.0
    return (torch.where(inside, f_in, torch.zeros_like(f_in)),
            torch.where(inside, dd, torch.zeros_like(dd)))
