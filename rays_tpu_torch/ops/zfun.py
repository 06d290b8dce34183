"""Plasma dispersion (Fried-Conte Z) function (``rays_tpu.ops.zfun``).

On the real axis Z comes from the Dawson function,

    Z(x) = -2*dawsn(x) + i*sqrt(pi)*exp(-x^2),

with ``dawsn`` by Rybicki's sampling formula

    dawsn(x) ~= (1/sqrt(pi)) * sum_{n odd} exp(-(x - n h)^2) / n,

84 odd terms at h = 0.25 (error O(exp(-(pi/(2h))^2)), ~7e-18): a
fixed-size, branch-free sum that autograd differentiates exactly.  The
damping model (``wave/damping.py``) and the CUDA kernel
(``csrc/slab_rk4.cuh``, the same 84 terms as a loop) use it.

Off the real axis, the Faddeeva function w(z) is Weideman's rational
approximation (SIAM J. Numer. Anal. 31 (1994) 1497) in real-pair
arithmetic, its 64 coefficients built with numpy at import exactly as in
the JAX package.  Functions returning (Re, Im) pairs take real tensors;
the complex conveniences at the end are host-side.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_H = 0.25
# 84 positive odd integers, n*h up to 41.75
_N_ODD = np.arange(1, 169, 2)


def dawsn(x):
    """Dawson integral F(x) = exp(-x^2) * int_0^x exp(t^2) dt, real x."""
    x = torch.as_tensor(x)
    # made on x's device (no copy from the host inside a ray step): the
    # odd integers of _N_ODD, exact in every float type
    n = torch.arange(1, 2 * len(_N_ODD), 2, dtype=x.dtype, device=x.device)
    nh = n * _H
    # odd symmetry folded in: sum over +-n of e^{-(x-nh)^2}/n
    terms = (torch.exp(-(x[..., None] - nh) ** 2)
             - torch.exp(-(x[..., None] + nh) ** 2)) / n
    return terms.sum(-1) / math.sqrt(math.pi)


def zfun_real_parts(x):
    """(Re, Im) of Z(x) for real x: (-2*dawsn(x), sqrt(pi)*exp(-x^2))."""
    x = torch.as_tensor(x)
    return -2.0 * dawsn(x), math.sqrt(math.pi) * torch.exp(-(x**2))


def zfun0_real_parts(x, kz):
    """(Re, Im) of Z with the Landau-sign convention of the reference
    ``zfun0``: Z(x) for kz > 0, -Z(-x) for kz < 0 (zfunctions_m.f90:57-75).
    Branch-free: -Z(-x) = -2*dawsn(x) - i*sqrt(pi)*e^{-x^2}."""
    x = torch.as_tensor(x)
    re = -2.0 * dawsn(x)
    im = math.sqrt(math.pi) * torch.exp(-(x**2)) * torch.sign(torch.as_tensor(kz))
    return re, im


def zfun_real(x):
    """Complex Z(x) for real x (host-side convenience)."""
    re, im = zfun_real_parts(x)
    return torch.complex(re, im)


def zfun_prime_real(x):
    """Z'(x) = -2*(1 + x*Z(x)) (host-side convenience)."""
    return -2.0 * (1.0 + torch.as_tensor(x) * zfun_real(x))


# --- complex argument: Weideman's w(z) ------------------------------------

_WEIDEMAN_N = 64


def _weideman_coeffs(n: int) -> tuple[np.ndarray, float]:
    """Polynomial coefficients a_0..a_{n-1} (highest degree first) and the
    map scale L of Weideman's w(z) approximation."""
    m = 2 * n
    L = math.sqrt(n / math.sqrt(2.0))
    k = np.arange(-m + 1, m)
    theta = k * np.pi / m
    t = L * np.tan(theta / 2.0)
    f = np.exp(-(t**2)) * (L**2 + t**2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2.0 * m)
    a = a[1:n + 1][::-1]  # highest degree first, for Horner
    return a, L


_W_COEF, _W_L = _weideman_coeffs(_WEIDEMAN_N)
_SQRT_PI = math.sqrt(math.pi)


def _wofz_upper(x, y):
    """(Re, Im) of w(x + iy) for y >= 0 (Weideman rational approximation)."""
    L = _W_L
    # d = L - i z = (L + y) - i x ;  Z = (L + i z)/d
    dr, di = L + y, -x
    d2 = dr * dr + di * di
    zr = (L * L - x * x - y * y) / d2
    zi = (2.0 * L * x) / d2
    # Horner in complex (zr, zi) with real coefficients
    pr = torch.full_like(x, float(_W_COEF[0]))
    pi_ = torch.zeros_like(x)
    for c in _W_COEF[1:]:
        pr, pi_ = pr * zr - pi_ * zi + float(c), pr * zi + pi_ * zr
    # w = 2 p / d^2 + (1/sqrt(pi)) / d
    d2r, d2i = dr * dr - di * di, 2.0 * dr * di
    d2n = d2r * d2r + d2i * d2i
    wr = 2.0 * (pr * d2r + pi_ * d2i) / d2n + (dr / d2) / _SQRT_PI
    wi = 2.0 * (pi_ * d2r - pr * d2i) / d2n + (-di / d2) / _SQRT_PI
    return wr, wi


def wofz_parts(x, y):
    """(Re, Im) of the Faddeeva function w(z), z = x + iy, full plane.

    Lower half-plane by w(z) = 2 exp(-z^2) - w(-z) (zfunctions_m.f90:
    117-130); there w grows as exp(y^2 - x^2) (Landau growth), and overflow
    is physical."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    x, y = torch.broadcast_tensors(x, y)
    upper = y >= 0.0
    xs = torch.where(upper, x, -x)
    ys = y.abs()
    wr, wi = _wofz_upper(xs, ys)
    # 2 exp(-z^2): -z^2 = (y^2 - x^2) - 2ixy
    er = 2.0 * torch.exp(y * y - x * x) * torch.cos(2.0 * x * y)
    ei = -2.0 * torch.exp(y * y - x * x) * torch.sin(2.0 * x * y)
    return torch.where(upper, wr, er - wr), torch.where(upper, wi, ei - wi)


def zfun_parts(x, y):
    """(Re, Im) of Z(zeta) = i sqrt(pi) w(zeta), zeta = x + iy (reference
    zzdisp, zfunctions_m.f90:109-130)."""
    wr, wi = wofz_parts(x, y)
    return -_SQRT_PI * wi, _SQRT_PI * wr


def zfun0_parts(x, y, kz):
    """Complex-argument Z with the Landau-sign convention of ``zfun0``:
    Z(zeta) for kz > 0, -Z(-zeta) for kz < 0; kz = 0 selects the kz > 0
    branch (callers mask)."""
    neg = torch.as_tensor(kz) < 0.0
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    zr, zi = zfun_parts(torch.where(neg, -x, x), torch.where(neg, -y, y))
    sgn = torch.where(neg, -1.0, 1.0).to(zr.dtype)
    return sgn * zr, sgn * zi


def wofz(z):
    """Complex w(z) (host-side convenience)."""
    z = torch.as_tensor(z)
    re, im = wofz_parts(z.real, z.imag)
    return torch.complex(re, im)


def zfun(z):
    """Complex Z(z) (host-side convenience, reference zfun_D)."""
    z = torch.as_tensor(z)
    re, im = zfun_parts(z.real, z.imag)
    return torch.complex(re, im)
