"""Cold-plasma Stix parameters and the pole-free polynomial pieces
(``rays_tpu.wave.stix``).

Functions of the per-species tensors ``alpha = (omega_p/omega)^2`` and
``gamma = omega_c/omega`` of shape (B, S), electron gamma negative
(reference suscep_m.f90:65-75).

* ``rlsdp``: R, L, S, D, P as in Stix eq. 1.19-1.22 (suscep_m.f90:180-219),
  with poles at the cyclotron resonances gamma = +-1.
* ``poly_pieces``: the pole-free species products (p, t, u, q, q1, q2)
  under the reference's hand-derived ray derivatives
  (deriv_cold.f90:77-101): t = prod_s(1-gamma_s^2), u = t*S, q = t*R*L.
* ``cold_eps_hermitian``: the cold dielectric tensor itself, complex
  (B, 3, 3); nothing on the tracing path needs it.

Leave-one-out and leave-two-out products are masked products, never
divisions, so gamma = +-1 is exactly representable.
"""

from __future__ import annotations

import torch


def rlsdp(alpha, gamma):
    """Returns (S, D, P, R, L), each (B,) (suscep_m.f90:180-219)."""
    R = 1.0 - (alpha / (1.0 + gamma)).sum(-1)
    L = 1.0 - (alpha / (1.0 - gamma)).sum(-1)
    S = (R + L) / 2.0
    D = (R - L) / 2.0
    P = 1.0 - alpha.sum(-1)
    return S, D, P, R, L


def product(x):
    """The product over the last axis as a chain of multiplies, (...,).
    Autograd's formula for ``prod`` reads the host (it looks for zero
    factors), which a CUDA graph cannot capture; the autodiff derivatives
    (tracing/rhs.py) differentiate these products inside the graphed step,
    the graphed adjoint (tracing/graphed_adjoint.py) captures the backward
    of every step, and a chain's backward is plain multiplies."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out * x[..., i]
    return out


def leave_one_out_products(gamma):
    """(dq1da, dq2da), each (B, S): dq1da[:, s] = prod_{i!=s}(1+gamma_i),
    dq2da likewise with (1-gamma_i) (deriv_cold.f90:83-91)."""
    n = gamma.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=gamma.device)
    one = torch.ones((), dtype=gamma.dtype, device=gamma.device)
    mp = torch.where(eye, one, (1.0 + gamma)[:, None, :])
    mm = torch.where(eye, one, (1.0 - gamma)[:, None, :])
    return product(mp), product(mm)


def leave_two_out_products(gamma):
    """(gp, gm), each (B, S, S): gp[:, s1, s2] = prod_{i not in {s1,s2}}
    (1+gamma_i), gm likewise with (1-gamma_i) (deriv_cold.f90:116-125)."""
    n = gamma.shape[-1]
    i = torch.arange(n, device=gamma.device)
    # keep[s1, s2, i] = (i != s1) & (i != s2)
    keep = (i[None, None, :] != i[:, None, None]) & (i[None, None, :] != i[None, :, None])
    one = torch.ones((), dtype=gamma.dtype, device=gamma.device)
    gp = product(torch.where(keep, (1.0 + gamma)[:, None, None, :], one))
    gm = product(torch.where(keep, (1.0 - gamma)[:, None, None, :], one))
    return gp, gm


def poly_pieces(alpha, gamma):
    """(p, t, u, q, q1, q2), each (B,) (deriv_cold.f90:77-101)."""
    dq1da, dq2da = leave_one_out_products(gamma)
    t = product((1.0 + gamma) * (1.0 - gamma))
    q1 = (alpha * dq1da).sum(-1)
    q2 = (alpha * dq2da).sum(-1)
    u = t - (alpha * dq1da * dq2da).sum(-1)
    q = 2.0 * u - t + q1 * q2
    p = 1.0 - alpha.sum(-1)
    return p, t, u, q, q1, q2


def cold_eps_hermitian(alpha, gamma):
    """Cold dielectric tensor (Hermitian; no collisions), complex (B, 3, 3)
    (dielectric_cold, suscep_m.f90:142-176):
    eps = [[S, -iD, 0], [iD, S, 0], [0, 0, P]]."""
    S, D, P, _, _ = rlsdp(alpha, gamma)
    z = torch.zeros_like(S)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    re = mat([[S, z, z], [z, S, z], [z, z, P]])
    im = mat([[z, -D, z], [D, z, z], [z, z, z]])
    return torch.complex(re, im)
