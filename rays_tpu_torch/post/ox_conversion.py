"""O-X mode-conversion analysis, Mjolhus 1984 model
(``rays_tpu.post.ox_conversion``).

Re-design of reference RAYS_project/post_process_lib/OX_conv_analysis_m.f90:
for each O-mode ray approaching cutoff from low density,
1) find the trajectory point of maximum alpha = (omega_pe/omega)^2,
2) Newton-iterate from there to the nearest point of the cutoff surface
   alpha = 1 along grad(alpha),
3) evaluate the Mjolhus Eq. 19 conversion coefficient in the
   (grad ne, B) frame (OX_conv_analysis_m.f90:318-394):

   n_crit = sin(theta) sqrt(gamma/(1+gamma))
   F = (1+gamma) sqrt(gamma) / 2 / ((1+gamma) cos^2 + sin^2/2)^{3/2}
   G = sqrt(gamma) / 2 / sqrt((1+gamma) cos^2 + sin^2/2)
   T = exp(-pi k0 L (F (|nz| - n_crit)^2 + G |ny|^2)),  L = ne/|grad ne|

4) rays with T <= 1e-4 (conversion_threshold) are considered
   non-converting.

The JAX package makes two device calls per ray.  Here alpha along every
trajectory is one pass, and the Newton iteration (the gradient by
autograd, as ``jax.value_and_grad`` takes it) and the coefficient run once
on all the rays that have an interior maximum below the cutoff.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rays_tpu_torch.models import base
from rays_tpu_torch.ops import vectors
from rays_tpu_torch.wave import dispersion

CONVERSION_THRESHOLD = 1.0e-4  # OX_conv_analysis_m.f90:32
_NEWTON_ITERS = 20
# trajectory points whose alpha is evaluated at once
CHUNK_POINTS = 1 << 22


class OXConv(NamedTuple):
    ray_number: int
    step_number: int
    alpha_max: float
    x_max: np.ndarray
    k_max: np.ndarray
    x_cut: np.ndarray
    conv_coeff: float


def _alpha_e(cfg, params, x):
    """alpha of the electrons at points x (N, 3)."""
    alpha, _, _, _ = dispersion.alpha_gamma(cfg, params, x, params.rf.omgrf)
    return alpha[:, 0]


def _find_cutoff_point(cfg, params, x0):
    """Newton toward alpha(x) = 1 along grad(alpha) from points x0 (N, 3):
    (x_cut, ok)."""
    x = x0.detach()
    with torch.enable_grad():
        for _ in range(_NEWTON_ITERS):
            x = x.detach().requires_grad_(True)
            a = _alpha_e(cfg, params, x)
            # a density that does not vary has no graph: its gradient is 0
            g = (torch.autograd.grad(a.sum(), x)[0] if a.requires_grad
                 else torch.zeros_like(x))
            g2 = (g**2).sum(-1).clamp_min(1e-30)
            x = x.detach() + (1.0 - a.detach())[:, None] * g / g2[:, None]
    x = x.detach()
    with torch.no_grad():
        return x, (_alpha_e(cfg, params, x) - 1.0).abs() < 1e-6


@torch.no_grad()
def _conv_coeff(cfg, params, x_max, k_max, x_cut):
    """Mjolhus Eq. 19 in the reference's (xc, yc, zc) frame, for points
    (N, 3)."""
    k0 = params.rf.k0
    eq = base.equilibrium(cfg, params, x_cut)
    gradne = eq.gradns[:, 0]
    norm_gradne = torch.linalg.vector_norm(gradne, dim=-1)
    xc = gradne / norm_gradne.clamp_min(1e-30)[:, None]
    yc = vectors.cross(eq.bunit, xc)
    yc = yc / torch.linalg.vector_norm(yc, dim=-1).clamp_min(1e-30)[:, None]
    zc = vectors.cross(xc, yc)
    theta = torch.arccos(((xc * eq.bunit).sum(-1)).clamp(-1.0, 1.0))
    gam = eq.gamma[:, 0].abs()
    L = eq.ns[:, 0] / norm_gradne.clamp_min(1e-30)

    nz_c = (k_max * zc).sum(-1) / k0
    ny_c = (k_max * yc).sum(-1) / k0

    c2, s2 = torch.cos(theta) ** 2, torch.sin(theta) ** 2
    n_crit = torch.sin(theta) * torch.sqrt(gam / (1.0 + gam))
    F = 0.5 * (1.0 + gam) * torch.sqrt(gam) / ((1.0 + gam) * c2 + s2 / 2.0) ** 1.5
    G = 0.5 * torch.sqrt(gam) / torch.sqrt((1.0 + gam) * c2 + s2 / 2.0)
    return torch.exp(-torch.pi * k0 * L
                     * (F * (nz_c.abs() - n_crit) ** 2 + G * ny_c**2))


@torch.no_grad()
def alpha_maxima(cfg, params, results):
    """(step of the largest alpha_e on each ray's valid points (first of
    equals), that alpha), each (B,), from one pass over the trajectories."""
    ray_vec, npoints = results.ray_vec, results.npoints
    B, n_pts, _ = ray_vec.shape
    valid = torch.arange(n_pts, device=ray_vec.device)[None, :] < npoints[:, None]
    rays = max(1, CHUNK_POINTS // max(n_pts, 1))
    alphas = torch.cat([_alpha_e(cfg, params, ray_vec[i:i + rays, :, 0:3].reshape(-1, 3))
                        .reshape(-1, n_pts) for i in range(0, B, rays)])
    alphas = torch.where(valid, alphas, torch.full_like(alphas, -torch.inf))
    alpha_max, step = alphas.max(dim=1)
    return step, alpha_max


def candidates(cfg, params, results):
    """The rays whose largest alpha_e is an interior maximum below the
    cutoff (found_max semantics): (ray indices, their steps, their alpha)."""
    step, alpha_max = alpha_maxima(cfg, params, results)
    n = results.npoints.to(step.dtype)
    cand = ((step != 0) & (step != n - 1) & ~(alpha_max >= 1.0)).nonzero()[:, 0]
    return cand, step, alpha_max


def ox_conv_analysis(cfg, params, results):
    """Returns the list of converting rays (OX_conv records) in ray order."""
    cand, step, alpha_max = candidates(cfg, params, results)
    if cand.numel() == 0:
        return []
    v_max = results.ray_vec[cand, step[cand], 0:6]
    x_cut, ok = _find_cutoff_point(cfg, params, v_max[:, 0:3])
    coeff = _conv_coeff(cfg, params, v_max[:, 0:3], v_max[:, 3:6], x_cut)
    keep = ok & (coeff > CONVERSION_THRESHOLD)
    host = [t.cpu() for t in (cand, step[cand], alpha_max[cand], v_max, x_cut, coeff, keep)]
    cand, steps, amax, v_max, x_cut, coeff, keep = (t.numpy() for t in host)
    return [OXConv(ray_number=int(cand[j]) + 1, step_number=int(steps[j]),
                   alpha_max=float(amax[j]), x_max=v_max[j, 0:3], k_max=v_max[j, 3:6],
                   x_cut=x_cut[j], conv_coeff=float(coeff[j]))
            for j in np.nonzero(keep)[0]]


def write_ox_conversion_data(converted, run_label, path=None):
    """List-directed output (OX_conv_analysis_m.f90:411+)."""
    fname = path or f"OX_conversion.{run_label}"
    with open(fname, "w") as f:
        f.write(f" number_of_rays_converted = {len(converted)}\n")
        for c in converted:
            f.write(f"\n ray {c.ray_number}  step {c.step_number}\n")
            f.write(f" alpha_max = {c.alpha_max:.8g}\n")
            f.write(f" x_max = {' '.join(f'{v:.8g}' for v in c.x_max)}\n")
            f.write(f" x_cut = {' '.join(f'{v:.8g}' for v in c.x_cut)}\n")
            f.write(f" conv_coeff = {c.conv_coeff:.8g}\n")
    return fname
