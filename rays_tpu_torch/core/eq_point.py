"""The equilibrium-point data contract (``rays_tpu.core.eq_point``).

``EqPoint`` is the batched analog of the reference derived type
``eq_point`` (reference RAYS_lib/equilibrium_m.f90:39-59); every field has
the ray axis first.  Index conventions are those of the JAX package:
  * gradb[b, i, j]  = d B_j / d x_i
  * gradns[b, s, i] = d n_s / d x_i
  * gradts[b, s, i] = d T_s / d x_i
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from rays_tpu_torch import constants


class RawEq(NamedTuple):
    """What an equilibrium model provides at a batch of points."""

    bvec: Any    # (B,3)
    gradb: Any   # (B,3,3)
    ns: Any      # (B,S)
    gradns: Any  # (B,S,3)
    ts: Any      # (B,S)
    gradts: Any  # (B,S,3)
    err: Any     # (B,) int32 StopCode (0 = ok)


class EqPoint(NamedTuple):
    bvec: Any       # (B,3)
    bmag: Any       # (B,)
    bunit: Any      # (B,3)
    gradb: Any      # (B,3,3)
    gradbmag: Any   # (B,3)
    gradbunit: Any  # (B,3,3)
    ns: Any         # (B,S)
    gradns: Any     # (B,S,3)
    ts: Any         # (B,S)
    gradts: Any     # (B,S,3)
    omgc: Any       # (B,S) cyclotron frequency, signed (electron negative)
    omgp2: Any      # (B,S) plasma frequency squared
    alpha: Any      # (B,S) omgp2/omgrf^2
    gamma: Any      # (B,S) omgc/omgrf
    err: Any        # (B,) int32


def derive_eq_point(raw: RawEq, species, rf) -> EqPoint:
    """Raw fields -> full EqPoint (reference equilibrium_m.f90:237-269),
    with alpha and gamma formed from the nondimensional coefficients."""
    bvec = raw.bvec
    bmag = torch.sqrt((bvec**2).sum(-1))
    bsafe = bmag.clamp_min(constants.SAFE_TINY)
    bunit = bvec / bsafe[:, None]
    gradbmag = torch.matmul(raw.gradb, bunit[:, :, None])[:, :, 0]
    gradbunit = (raw.gradb - gradbmag[:, :, None] * bunit[:, None, :]) \
        / bsafe[:, None, None]

    wref = rf.omgrf_ref
    b = bmag[:, None]
    omgc = species.gamma_coef * b * wref
    omgp2 = species.alpha_coef * raw.ns * wref**2
    wratio = wref / rf.omgrf
    alpha = species.alpha_coef * raw.ns * wratio**2
    gamma = species.gamma_coef * b * wratio

    return EqPoint(
        bvec=bvec, bmag=bmag, bunit=bunit, gradb=raw.gradb,
        gradbmag=gradbmag, gradbunit=gradbunit,
        ns=raw.ns, gradns=raw.gradns, ts=raw.ts, gradts=raw.gradts,
        omgc=omgc, omgp2=omgp2, alpha=alpha, gamma=gamma, err=raw.err,
    )


def value_and_jacfwd(f, x):
    """Values and jacobians of ``f`` at a batch of points x (B, 3) by
    forward mode, one JVP per coordinate (``rays_tpu.core.eq_point``).

    ``f`` maps x (B, 3) to a tuple of tensors (B, ...), each ray's values
    depending on its own point only, so one tangent e_i on every row gives
    every ray's d/dx_i at once.  Returns (values, jacobians) with
    jac[b, ..., i] = d value[b, ...] / d x[b, i]: for a model's ``fields``,
    jb[b, j, i] = dB_j/dx_i, jn[b, s, i] and jt[b, s, i]."""
    columns = []
    for i in range(x.shape[-1]):
        tangent = torch.zeros_like(x)
        tangent[:, i] = 1.0
        y, dy = torch.func.jvp(f, (x,), (tangent,))
        columns.append(dy)
    jac = tuple(torch.stack(cols, dim=-1) for cols in zip(*columns))
    return y, jac
