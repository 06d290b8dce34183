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
import torch.autograd.forward_ad as fwAD

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
    # gradbmag[i] = sum_j gradb[i,j] * bunit[j], broadcast multiply-reduce
    # as in the JAX package (no library gemv inside a ray step)
    gradbmag = (raw.gradb * bunit[:, None, :]).sum(-1)
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


def forward_level_open() -> bool:
    """Whether a forward-AD level (``forward_ad.dual_level``) is open.
    Inside one, ``torch.func.jvp`` cannot open its own: PyTorch's forward
    AD does not nest levels.  x need not be dual for this to hold (a
    tangent on a Params leaf alone leaves the first step's x primal)."""
    return fwAD._current_level >= 0


def value_and_jacfwd(f, x, create_graph=False):
    """Values and jacobians of ``f`` at a batch of points x (B, 3) by
    forward mode, one JVP per coordinate (``rays_tpu.core.eq_point``).

    ``f`` maps x (B, 3) to a tuple of tensors (B, ...), each ray's values
    depending on its own point only, so one tangent e_i on every row gives
    every ray's d/dx_i at once.  Returns (values, jacobians) with
    jac[b, ..., i] = d value[b, ...] / d x[b, i]: for a model's ``fields``,
    jb[b, j, i] = dB_j/dx_i, jn[b, s, i] and jt[b, s, i].  The tangents are
    rows of an identity made on x's device (no Python number is written
    into a tensor, so nothing is copied from the host: the graph routes
    capture this).

    Inside a caller's forward-AD level the jacobians come by reverse mode
    instead (``_value_and_jac_in_level``): the caller's tangents then ride
    through ``f`` and its backward pass, forward over reverse, and the
    jacobian's tangent is the second derivative that ``jax.jvp`` over
    ``jax.jacfwd`` gives.  ``create_graph``: the caller also takes a
    reverse-mode gradient through the results (only read in a level)."""
    if forward_level_open():
        return _value_and_jac_in_level(f, x, create_graph)
    unit = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    columns = []
    for i in range(x.shape[-1]):
        y, dy = torch.func.jvp(f, (x,), (unit[i].expand_as(x),))
        columns.append(dy)
    jac = tuple(torch.stack(cols, dim=-1) for cols in zip(*columns))
    return y, jac


def _without_history(t):
    """``t`` with its tangent and no autograd history (views, no copy)."""
    primal, tangent = fwAD.unpack_dual(t)
    primal = primal.detach()
    return primal if tangent is None else fwAD.make_dual(primal, tangent.detach())


def _value_and_jac_in_level(f, x, create_graph):
    """``value_and_jacfwd`` inside an open forward-AD level: ``f`` runs
    once on x (dual or not) under autograd, and one batched backward pass
    over a basis of its output components (``is_grads_batched``) gives
    every row of every ray's jacobian.  Without ``create_graph`` the
    backward is recorded by forward AD alone and the results carry their
    tangents and no autograd history (the values are stripped of the
    graph that the backward pass needed); with it they keep the graph to
    x and the Params leaves, so that an outer gradient runs through them.
    An output that depends on neither has zero jacobian rows."""
    primal, tangent = fwAD.unpack_dual(x)
    with torch.enable_grad():
        if create_graph and x.requires_grad:
            wrt = inp = x
        else:
            wrt = primal.detach().requires_grad_()
            inp = wrt if tangent is None else fwAD.make_dual(wrt, tangent)
        y = f(inp)
        flat = torch.cat([t.reshape(t.shape[0], -1) for t in y], dim=-1)   # (B, K)
        n, k = flat.shape
        if flat.requires_grad:
            basis = torch.eye(k, dtype=flat.dtype, device=flat.device)[:, None, :]
            rows, = torch.autograd.grad(flat, wrt, basis.expand(k, n, k),
                                        create_graph=create_graph, is_grads_batched=True,
                                        allow_unused=True, materialize_grads=True)  # (K, B, 3)
        else:
            rows = flat.new_zeros((k,) + tuple(x.shape))
    jac, start = [], 0
    for t in y:
        width = t[0].numel()
        jac.append(rows[start:start + width].movedim(0, 1).reshape(t.shape + (x.shape[-1],)))
        start += width
    if not create_graph:
        y = map(_without_history, y)
    return tuple(y), tuple(jac)
