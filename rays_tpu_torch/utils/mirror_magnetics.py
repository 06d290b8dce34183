"""Mirror coil-field generator: Br, Bz, Aphi of circular current loops
(``rays_tpu.utils.mirror_magnetics``; reference mirror_magnetics_lib:
B_loop_m.f90 + mirror_magnetics_m.f90 + the mirror_magnetics executable).

Unit-loop fields via complete elliptic integrals with a near-axis series,
multi-coil superposition (each coil optionally a filament array), evaluated
on a uniform (r, z) grid and written to the Brz netCDF that
``models/multiple_mirror.load_field_file`` reads (r_grid, z_grid,
Br/Bz/Aphi on (n_z, n_r) in C order, LUFS scalars; NetCDF3, big-endian).
The JAX package reads the file this module writes, and this package the
file the JAX package writes.

Loop formulas (loop radius a at height z0, current I, field point (r, z),
zp = z - z0, m = k^2 = 4 a r / ((a+r)^2 + zp^2)):

    Aphi = mu0 I / (pi sqrt(m)) * sqrt(a/r) * [(1 - m/2) K(m) - E(m)]
    Br   = mu0 I zp / (2 pi r S) * [-K(m) + (a^2+r^2+zp^2)/D * E(m)]
    Bz   = mu0 I / (2 pi S) * [ K(m) + (a^2-r^2-zp^2)/D * E(m)]
    S = sqrt((a+r)^2 + zp^2),  D = (a-r)^2 + zp^2

with the r -> 0 limits Bz = mu0 I a^2/(2 (a^2+zp^2)^{3/2}), Br ~ O(r),
Aphi ~ mu0 I a^2 r / (4 (a^2+zp^2)^{3/2}) (B_loop_m.f90:40-99).  Everything
is differentiable tensor arithmetic (coil-current adjoints), float64 on the
CPU unless the inputs say otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rays_tpu_torch import constants
from rays_tpu_torch.ops import elliptic

_R_AXIS_EPS = 1e-9


def _f64(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x, dtype=np.float64))


def b_loop(a, current, r, z):
    """(Br, Bz, Aphi) of one loop of radius a at z=0 carrying `current`;
    the arguments broadcast against each other."""
    a, current, r, z = _f64(a), _f64(current), _f64(r), _f64(z)
    mu0_i = constants.MU0 * current
    r_safe = r.clamp_min(_R_AXIS_EPS)
    s2 = (a + r_safe) ** 2 + z**2
    s = torch.sqrt(s2)
    d = (a - r_safe) ** 2 + z**2
    m = (4.0 * a * r_safe / s2).clamp(1e-14, 1.0 - 1e-12)
    K, E = elliptic.ellipk_ellipe(m)

    br = mu0_i * z / (2.0 * math.pi * r_safe * s) * (
        -K + (a**2 + r_safe**2 + z**2) / d * E)
    bz = mu0_i / (2.0 * math.pi * s) * (K + (a**2 - r_safe**2 - z**2) / d * E)
    aphi = (mu0_i / (math.pi * torch.sqrt(m)) * torch.sqrt(a / r_safe)
            * ((1.0 - m / 2.0) * K - E))

    # near-axis limits
    on_axis = r < 1e-6
    denom = (a**2 + z**2) ** 1.5
    bz_axis = mu0_i * a**2 / (2.0 * denom)
    br_axis = 3.0 * mu0_i * a**2 * r * z / (4.0 * (a**2 + z**2) ** 2.5)
    aphi_axis = mu0_i * a**2 * r / (4.0 * denom)
    return (torch.where(on_axis, br_axis, br), torch.where(on_axis, bz_axis, bz),
            torch.where(on_axis, aphi_axis, aphi))


def coil_set_fields(coil_r, coil_z, coil_current, r, z, n_filaments=3,
                    filament_dr=0.01, filament_dz=0.01):
    """Superpose coils; each coil is an n x n filament array around its
    centre (mirror_magnetics_m.f90 3x3 filament arrays per coil).  r, z:
    field points of one shape; returns three tensors of that shape."""
    coil_r, coil_z, coil_current = _f64(coil_r), _f64(coil_z), _f64(coil_current)
    r, z = _f64(r), _f64(z)
    offs = torch.arange(n_filaments, dtype=r.dtype, device=r.device) \
        - (n_filaments - 1) / 2.0
    # axes (coil, radial filament, axial filament, *points)
    lead = (slice(None),) * 3 + (None,) * r.dim()
    a = (coil_r[:, None, None] + (offs * filament_dr)[None, :, None])[lead]
    z0 = (coil_z[:, None, None] + (offs * filament_dz)[None, None, :])[lead]
    cur = (coil_current / n_filaments**2)[:, None, None][lead]
    br, bz, aphi = b_loop(a, cur, r[None, None, None], z[None, None, None] - z0)
    return tuple(f.sum(dim=(1, 2)).sum(dim=0) for f in (br, bz, aphi))


def generate_field_file(path, coil_r, coil_z, coil_current,
                        r_max=0.2, z_min=0.0, z_max=4.0, n_r=51, n_z=201,
                        r_lufs=None, z_lufs=None, n_filaments=3):
    """Evaluate the coil set on the uniform grid and write the Brz netCDF
    (the mirror_magnetics executable's product, mirror_magnetics_m.f90:377).
    """
    from scipy.io import netcdf_file

    rg = np.linspace(0.0, r_max, n_r)
    zg = np.linspace(z_min, z_max, n_z)
    R, Z = np.meshgrid(rg, zg, indexing="ij")
    br, bz, aphi = (f.numpy().reshape(n_r, n_z) for f in coil_set_fields(
        coil_r, coil_z, coil_current, R.ravel(), Z.ravel(), n_filaments))

    if r_lufs is None:
        r_lufs = 0.9 * r_max
    if z_lufs is None:
        z_lufs = zg[len(zg) // 2]

    f = netcdf_file(path, "w")
    try:
        f.createDimension("n_r", n_r)
        f.createDimension("n_z", n_z)
        for name, val in [("r_min", 0.0), ("r_max", r_max),
                          ("z_min", z_min), ("z_max", z_max),
                          ("r_LUFS", r_lufs), ("z_LUFS", z_lufs)]:
            v = f.createVariable(name, np.float64, ())
            v.data[()] = val
        v = f.createVariable("r_grid", np.float64, ("n_r",))
        v[:] = rg
        v = f.createVariable("z_grid", np.float64, ("n_z",))
        v[:] = zg
        # the (n_z, n_r) C-order layout of the reference's field files
        for name, arr in [("Br", br), ("Bz", bz), ("Aphi", aphi)]:
            v = f.createVariable(name, np.float64, ("n_z", "n_r"))
            v[:] = arr.T
    finally:
        f.close()
    return path
