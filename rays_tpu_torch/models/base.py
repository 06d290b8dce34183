"""Generic equilibrium layer (``rays_tpu.models.base``).

A model module provides, on a batch of points x (B, 3):

  fields_and_jac(static, params, species, x)
      -> ((bvec, ns, ts), (jb, jn, jt)), values and jacobians;
  fields(static, params, species, x) -> (bvec, ns, ts);
  geom_err(static, params, x) -> (B,) int32 StopCode, geometry only;
  err(static, params, species, x) -> geometry + positivity.

A model may also provide ``fields_jac_geom`` -> (values, jacobians,
geometry code) from one evaluation of its magnetics; the spline geometries
do, so that a ray step fetches each spline row once.  A model whose
closed forms cover only some of its options says which with
``supports_analytic_jac(static, params)``.  A model with neither closed
form, or outside them, gets its jacobians by forward mode through
``fields`` (``core.eq_point.value_and_jacfwd``), as in the JAX package;
inside a caller's forward-AD level (tangents on the rays or the Params),
by reverse mode on the caller's dual tensors, so that the tangents ride
through the jacobian as through ``jax.jvp`` over ``jax.jacfwd``.

All four models of the JAX package are here: the slab, the Solovev
tokamak, the generic axisymmetric toroid (Solovev, EQDSK spline and EQDSK
bilinear magnetics) and the multiple mirror.  A library user adds a model
of their own with ``register_eq_model(name, module)``; the registry is
looked up before the four built-in names.
"""

from __future__ import annotations

import torch

from rays_tpu_torch import constants
from rays_tpu_torch.core.eq_point import EqPoint, RawEq, derive_eq_point, value_and_jacfwd
from rays_tpu_torch.core.types import needs_grad
from rays_tpu_torch.tracing.stop import StopCode

# models registered by name (``register_eq_model``); the four built-in
# models are imported on first use by ``get_eq_model`` instead, which keeps
# their modules out of an import cycle with this one
EQ_MODELS: dict[str, object] = {}


def register_eq_model(name: str, module) -> None:
    """Make ``module`` the equilibrium model of ``equilib_model=name``.
    It provides ``fields``, ``geom_err`` and ``err`` (module docstring)
    and may provide the closed forms."""
    EQ_MODELS[name] = module


def get_eq_model(name: str):
    if name in EQ_MODELS:
        return EQ_MODELS[name]
    if name == "slab":
        from rays_tpu_torch.models import slab

        return slab
    if name == "solovev":
        from rays_tpu_torch.models import solovev

        return solovev
    if name == "axisym_toroid":
        from rays_tpu_torch.models import axisym_toroid

        return axisym_toroid
    if name == "multiple_mirror":
        from rays_tpu_torch.models import multiple_mirror

        return multiple_mirror
    raise NotImplementedError(f"equilib_model {name!r}")


def eq_fields(cfg, params, x):
    """(bvec, ns, ts) at x."""
    model = get_eq_model(cfg.equilib_model)
    return model.fields(cfg.eq_static, params.eq, params.species, x)


def eq_err(cfg, params, x):
    model = get_eq_model(cfg.equilib_model)
    return model.err(cfg.eq_static, params.eq, params.species, x)


def _combine_err(geom_code, ns, ts):
    """Positivity checks layered under the geometry code
    (slab_eq_m.f90:303-306 et al.)."""
    code = torch.zeros_like(geom_code)
    code = torch.where(ts.amin(-1) < 0.0,
                       torch.full_like(code, int(StopCode.NEGATIVE_TEMP)), code)
    code = torch.where(ns.amin(-1) < 0.0,
                       torch.full_like(code, int(StopCode.NEGATIVE_DENS)), code)
    return torch.where(geom_code != 0, geom_code, code)


def eq_point_light(cfg, params, x):
    """Gradient-free plasma state: (alpha, gamma, bunit, ns, ts, err)."""
    model = get_eq_model(cfg.equilib_model)
    bvec, ns, ts = model.fields(cfg.eq_static, params.eq, params.species, x)
    err = _combine_err(model.geom_err(cfg.eq_static, params.eq, x), ns, ts)
    bmag = torch.sqrt((bvec**2).sum(-1))
    bunit = bvec / bmag.clamp_min(constants.SAFE_TINY)[:, None]
    sp = params.species
    wratio = params.rf.omgrf_ref / params.rf.omgrf
    alpha = sp.alpha_coef * ns * wratio**2
    gamma = sp.gamma_coef * bmag[:, None] * wratio
    return alpha, gamma, bunit, ns, ts, err


def equilibrium(cfg, params, x) -> EqPoint:
    """Full equilibrium point with gradients (reference
    equilibrium_m.f90:135): one evaluation of the model's values and
    jacobians, validity from the geometry check and the positivity of the
    same ns and ts.  The jacobians come from the model's closed form where
    it has one that covers this config, else by forward mode through its
    ``fields`` (rays_tpu/models/base.py:91-106): forward over reverse
    inside a forward-AD level, with the autograd graph kept for an outer
    gradient where one is asked for (``needs_grad``)."""
    model = get_eq_model(cfg.equilib_model)
    st, p, sp = cfg.eq_static, params.eq, params.species
    analytic = getattr(model, "supports_analytic_jac", None)
    closed = analytic is None or analytic(st, p)
    fused = getattr(model, "fields_jac_geom", None)
    if closed and fused is not None:
        (bvec, ns, ts), (jb, jn, jt), geom = fused(st, p, sp, x)
    else:
        if closed and hasattr(model, "fields_and_jac"):
            (bvec, ns, ts), (jb, jn, jt) = model.fields_and_jac(st, p, sp, x)
        else:
            (bvec, ns, ts), (jb, jn, jt) = value_and_jacfwd(
                lambda xx: model.fields(st, p, sp, xx), x,
                create_graph=needs_grad(params, x))
        geom = model.geom_err(st, p, x)
    err = _combine_err(geom, ns, ts)
    # jb[b, j, i] = dB_j/dx_i  ->  gradb[b, i, j], the reference convention
    raw = RawEq(bvec=bvec, gradb=jb.transpose(1, 2), ns=ns, gradns=jn,
                ts=ts, gradts=jt, err=err)
    return derive_eq_point(raw, params.species, params.rf)
