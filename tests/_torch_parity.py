"""Shared inputs and checks for the rays_tpu_torch parity tests.

Inputs are built once on the JAX side and carried to the port through
``rays_tpu_torch.convert``, so both packages compute on identical numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.models import slab as jslab
from rays_tpu_torch import convert

# slab profile-model combinations: together they cover every model of
# models/slab.py (by, bz, density, per-species temperature)
MODEL_COMBOS = [
    ("constant", "constant", "linear", ("zero", "zero")),
    ("zero", "toroid", "constant", ("constant", "constant")),
    ("toroid", "linear", "parabolic", ("parabolic", "linear")),
    ("linear_shear", "linear_2", "Gaussian", ("linear_2", "parabolic")),
    ("constant", "linear", "linear_2", ("linear", "constant")),
]
# the subset the CUDA kernel supports (fused_slab.supported)
KERNEL_COMBOS = [c for c in MODEL_COMBOS if c[2] in ("constant", "linear", "Gaussian")]

# profile parameters that make every model above non-trivial
SLAB_OVERRIDES = dict(
    by0=0.3, bz0=1.286, lby_shear_scale=1.5, lbz_scale=1.125, dbzdx=0.4,
    x0=0.05, ln_scale=0.714286, dndx=1.0e20, alphan1=1.5, alphan2=2.0,
    n_min=0.05, lt_scale=0.8, dtdx=-1.0e-16, rmin=0.5, rmaj=1.0,
    alphat1=np.array([1.2, 2.0]), alphat2=np.array([2.0, 3.0]),
    t_min=np.array([0.01, 0.02]),
)


def jax_case(text=jex.SLAB_ECH_90GHZ, combo=None, ds=None, **cfg_changes):
    """(cfg, params, v0, status0, pwr) of the JAX package, with optional
    slab models (``combo``), step size and Config changes."""
    cfg, params, v0, st, pwr = jex.setup_example(text)
    if combo is not None:
        by, bz, dens, tm = combo
        cfg = dataclasses.replace(cfg, eq_static=jslab.SlabStatic(
            by_prof_model=by, bz_prof_model=bz, dens_prof_model=dens,
            t_prof_model=tuple(tm)))
        params = params._replace(eq=params.eq._replace(
            **{k: jnp.asarray(v, jnp.float64) for k, v in SLAB_OVERRIDES.items()}))
    if ds is not None:
        params = params._replace(ode=params.ode._replace(ds=jnp.float64(ds)))
    cfg = dataclasses.replace(cfg, **cfg_changes)
    return cfg, params, v0, st, pwr


def to_port(cfg, params, *arrays, dtype=torch.float64):
    """The JAX case as the port's (cfg, params, *tensors); float arrays in
    ``dtype``, int arrays as they are."""
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    pp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   dtype=dtype)
    ts = []
    for a in arrays:
        t = torch.from_numpy(np.array(a))
        ts.append(t.to(dtype) if t.is_floating_point() else t)
    return (pcfg, pp, *ts)


def assert_scaled_close(got, ref, rtol, axis, what=""):
    """|got - ref| <= rtol * scale per ray, for positions (slots 0-2),
    wavevector (3-5) and the ray parameter (6) separately, the scale being
    the reference's max magnitude over ``axis`` (the trajectory scale of
    tests/test_parity.py, or the endpoint's own for axis=-1)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    for sl, name in ((slice(0, 3), "position"), (slice(3, 6), "k"),
                     (slice(6, 7), "ray parameter")):
        r = ref[..., sl]
        scale = np.maximum(np.abs(r).max(axis=axis, keepdims=True), 1e-12)
        err = np.abs(got[..., sl] - r) / scale
        assert np.all(err <= rtol), (
            f"{what} {name}: max scaled error {err.max():.3e} > {rtol}")
