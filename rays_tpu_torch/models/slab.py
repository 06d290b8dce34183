"""1-D slab equilibrium: plasma stratified in x, uniform in y and z.

Port of ``rays_tpu.models.slab`` (reference RAYS_lib/slab_eq_m.f90).  The
JAX package takes the spatial gradients by forward-mode autodiff of
``fields``; every slab profile depends on x alone, so here the x-derivative
is written in closed form beside each value and the y and z columns of the
jacobians are exact zeros.  The tests hold both to the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from rays_tpu_torch.models import profiles
from rays_tpu_torch.tracing.stop import StopCode


@dataclasses.dataclass(frozen=True)
class SlabStatic:
    bx_prof_model: str = "zero"
    by_prof_model: str = "zero"
    bz_prof_model: str = "constant"
    dens_prof_model: str = "constant"
    t_prof_model: Tuple[str, ...] = ("zero",)  # per species, len S


class SlabParams(NamedTuple):
    # bounding box [m] (slab_eq_m.f90:35)
    xmin: Any
    xmax: Any
    ymin: Any
    ymax: Any
    zmin: Any
    zmax: Any
    # geometry scales
    rmaj: Any
    rmin: Any
    x0: Any
    # magnetics
    bx0: Any
    by0: Any
    bz0: Any
    lby_shear_scale: Any
    lbz_scale: Any
    dbzdx: Any
    # density
    ln_scale: Any
    dndx: Any
    alphan1: Any
    alphan2: Any
    n_min: Any
    # temperature
    lt_scale: Any
    dtdx: Any
    alphat1: Any  # (S,)
    alphat2: Any  # (S,)
    t_min: Any    # (S,)


def _by(m, p, x):
    """By and dBy/dx (slab_eq_m.f90:184-206)."""
    zero = torch.zeros_like(x)
    if m == "zero":
        return zero, zero
    if m == "constant":
        return p.by0 + zero, zero
    if m == "toroid":
        by = p.by0 / (1.0 + x / p.rmaj)
        return by, -by / (p.rmaj + x)
    if m == "linear_shear":
        return p.by0 * x / p.lby_shear_scale, p.by0 / p.lby_shear_scale + zero
    raise ValueError(f"slab: invalid by_prof_model {m}")


def _bz(m, p, x):
    """Bz and dBz/dx (slab_eq_m.f90:209-233)."""
    zero = torch.zeros_like(x)
    if m == "zero":
        return zero, zero
    if m == "constant":
        return p.bz0 + zero, zero
    if m == "toroid":
        bz = p.bz0 / (1.0 + x / p.rmaj)
        return bz, -bz / (p.rmaj + x)
    if m == "linear":
        return p.bz0 * (1.0 + x / p.lbz_scale), p.bz0 / p.lbz_scale + zero
    if m == "linear_2":
        return p.bz0 + p.dbzdx * (x - p.x0), p.dbzdx + zero
    raise ValueError(f"slab: invalid bz_prof_model {m}")


def _density(m, p, species, x):
    """Normalized n_s and dn_s/dx, (B, S) each (slab_eq_m.f90:237-267)."""
    n0s = species.n0s
    xc = x[:, None]
    if m == "constant":
        ns = n0s + torch.zeros_like(xc)
        return ns, torch.zeros_like(ns)
    if m == "linear":
        return n0s * (1.0 + xc / p.ln_scale), n0s / p.ln_scale + torch.zeros_like(xc)
    if m == "linear_2":
        # dndx is a physical slope [m^-3/m]; densities are normalized
        slope = (p.dndx / species.n_ref) * species.eta
        return n0s + slope * (xc - p.x0), slope + torch.zeros_like(xc)
    if m == "parabolic":
        f, fp = profiles.parabolic(x / p.rmin, p.n_min, p.alphan1, p.alphan2)
        return n0s * f[:, None], n0s * (fp / p.rmin)[:, None]
    if m == "Gaussian":
        ns = n0s * torch.exp(-3.0 * p.alphan1 * (xc / p.rmin) ** 2)
        return ns, ns * (-6.0 * p.alphan1 * xc / p.rmin**2)
    raise ValueError(f"slab: invalid dens_prof_model {m}")


def _temperature(m, p, t0, i, x):
    """T_i and dT_i/dx for species i (slab_eq_m.f90:270-301)."""
    zero = torch.zeros_like(x)
    if m == "zero":
        return zero, zero
    if m == "constant":
        return t0 + zero, zero
    if m == "linear":
        return t0 * (1.0 + x / p.lt_scale), t0 / p.lt_scale + zero
    if m == "linear_2":
        return t0 + p.dtdx * (x - p.x0), p.dtdx + zero
    if m == "parabolic":
        f, fp = profiles.parabolic((x - p.x0) / p.rmin, p.t_min[i],
                                   p.alphat1[i], p.alphat2[i])
        return t0 * f, t0 * fp / p.rmin
    raise ValueError(f"slab: invalid t_prof_model {m}")


def fields_and_jac(static: SlabStatic, p: SlabParams, species, rvec):
    """Values and jacobians at rvec (B, 3).

    Returns ((bvec (B,3), ns (B,S), ts (B,S)), (jb (B,3,3), jn (B,S,3),
    jt (B,S,3))), where jac[..., i] = d(value)/dx_i as in the JAX package's
    ``value_and_jacfwd``."""
    x = rvec[:, 0]
    if static.bx_prof_model != "zero":  # only 'zero' exists upstream
        raise ValueError(f"slab: invalid bx_prof_model {static.bx_prof_model}")
    zero = torch.zeros_like(x)
    by, dby = _by(static.by_prof_model, p, x)
    bz, dbz = _bz(static.bz_prof_model, p, x)
    ns, dns = _density(static.dens_prof_model, p, species, x)
    t_pairs = [_temperature(m, p, species.t0s[i], i, x)
               for i, m in enumerate(static.t_prof_model)]
    ts = torch.stack([t for t, _ in t_pairs], dim=1)
    dts = torch.stack([d for _, d in t_pairs], dim=1)

    bvec = torch.stack([zero, by, bz], dim=1)
    dbdx = torch.stack([zero, dby, dbz], dim=1)

    def x_only(d):  # (..., ) d/dx -> (..., 3) jacobian with zero y, z columns
        return torch.stack([d, torch.zeros_like(d), torch.zeros_like(d)], dim=-1)

    return (bvec, ns, ts), (x_only(dbdx), x_only(dns), x_only(dts))


def fields(static: SlabStatic, p: SlabParams, species, rvec):
    """B (B,3), n_s (B,S), T_s (B,S) at rvec (slab_eq_m.f90:125-309)."""
    return fields_and_jac(static, p, species, rvec)[0]


def geom_err(static: SlabStatic, p: SlabParams, rvec):
    """Bounding-box checks (slab_eq_m.f90:162-169); x before y before z."""
    x, y, z = rvec[:, 0], rvec[:, 1], rvec[:, 2]
    code = torch.zeros(x.shape, dtype=torch.int32, device=x.device)

    def flag(bad, c):
        return torch.where(bad, torch.full_like(code, int(c)), code)

    # reverse priority order: later assignments override earlier ones
    code = flag((z < p.zmin) | (z > p.zmax), StopCode.Z_OUT_OF_BOUNDS)
    code = flag((y < p.ymin) | (y > p.ymax), StopCode.Y_OUT_OF_BOUNDS)
    code = flag((x < p.xmin) | (x > p.xmax), StopCode.X_OUT_OF_BOUNDS)
    return code


def err(static: SlabStatic, p: SlabParams, species, rvec):
    """Full standalone validity check (geometry + positivity)."""
    from rays_tpu_torch.models.base import _combine_err

    _, ns, ts = fields(static, p, species, rvec)
    return _combine_err(geom_err(static, p, rvec), ns, ts)
