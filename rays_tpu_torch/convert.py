"""Carry the JAX package's run description across to the port, so that
both packages can compute on identical inputs.

``params_from_numpy`` takes the JAX ``Params`` as nested NamedTuples of
numpy arrays (what ``jax.tree_util.tree_map(np.asarray, params)`` gives);
``config_from_dict`` takes ``dataclasses.asdict(cfg)``;
``results_from_numpy`` takes a JAX ``RayResults`` of numpy arrays, so that
both packages post-process the same trajectories.  None imports JAX: the
NamedTuples are matched by class name and field names.
"""

from __future__ import annotations

import numpy as np
import torch

from rays_tpu_torch.core import types
from rays_tpu_torch.models import axisym_toroid, multiple_mirror, slab, solovev
from rays_tpu_torch.ops import splines
from rays_tpu_torch.rayinit import axisym_toroid as axisym_init
from rays_tpu_torch.rayinit import file_input as file_init
from rays_tpu_torch.rayinit import one_ray as one_ray_init
from rays_tpu_torch.rayinit import slab as slab_init
from rays_tpu_torch.rayinit import solovev as solovev_init

_PARAM_TYPES = {
    "Params": types.Params,
    "SpeciesParams": types.SpeciesParams,
    "RFParams": types.RFParams,
    "OdeParams": types.OdeParams,
    "Limits": types.Limits,
    "SlabParams": slab.SlabParams,
    "SolovevParams": solovev.SolovevParams,
    "AxisymToroidParams": axisym_toroid.AxisymToroidParams,
    "SolovevMagParams": axisym_toroid.SolovevMagParams,
    "EqdskMagParams": axisym_toroid.EqdskMagParams,
    "EqdskLinMagParams": axisym_toroid.EqdskLinMagParams,
    "MultipleMirrorParams": multiple_mirror.MultipleMirrorParams,
    "Spline1D": splines.Spline1D,
    "Spline2D": splines.Spline2D,
    "CellSpline2D": splines.CellSpline2D,
}
_EQ_STATIC = {"slab": slab.SlabStatic, "solovev": solovev.SolovevStatic,
              "axisym_toroid": axisym_toroid.AxisymToroidStatic,
              "multiple_mirror": multiple_mirror.MultipleMirrorStatic}
_INIT_STATIC = {
    "simple_slab": slab_init.SlabInit,
    "solovev_ray_init_nphi_ntheta": solovev_init.SolovevInit,
    "axisym_toroid_ray_init_R_Z_nphi_ntheta": axisym_init.AxisymToroidInit,
    "one_ray_init_XYZ_k_direction": one_ray_init.OneRayInit,
    "file_input_ray_init": file_init.FileInputInit,
}


def params_from_numpy(tree, device="cpu", dtype=torch.float64):
    """JAX Params of numpy leaves -> the port's Params on ``device`` in
    ``dtype``.  ``None`` entries (a spline the file gives no data for) stay
    ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        name = type(tree).__name__
        cls = _PARAM_TYPES.get(name)
        if cls is None:
            raise NotImplementedError(f"{name} has no counterpart in the port yet")
        if tuple(cls._fields) != tuple(tree._fields):
            raise ValueError(f"{name}: fields {tree._fields} != {cls._fields}")
        return cls(*(params_from_numpy(x, device, dtype) for x in tree))
    return torch.from_numpy(np.array(tree, dtype=np.float64)).to(
        device=device, dtype=dtype)


def config_from_dict(d):
    """``dataclasses.asdict`` of a JAX Config -> the port's Config.  The
    JAX-only ``fused_kernel`` switch is dropped."""
    d = dict(d)
    d.pop("fused_kernel", None)
    if d.get("equilib_model") not in _EQ_STATIC:
        raise NotImplementedError(f"equilib_model {d.get('equilib_model')!r}")
    if d.get("ray_init_model") not in _INIT_STATIC:
        raise NotImplementedError(f"ray_init_model {d.get('ray_init_model')!r}")
    # asdict turns the tuples of per-species model names into lists
    eq = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d["eq_static"].items()}
    d["eq_static"] = _EQ_STATIC[d["equilib_model"]](**eq)
    d["rayinit_static"] = _INIT_STATIC[d["ray_init_model"]](**d["rayinit_static"])
    return types.Config(**d)


def results_from_numpy(tree, device="cpu", dtype=torch.float64):
    """JAX ``RayResults`` of numpy leaves -> the port's ``RayResults`` on
    ``device``: floating fields in ``dtype``, ``npoints`` and
    ``stop_flag`` as int32, ``end_ray_comp`` (the compensated carry)
    ``None`` where the JAX run had none."""
    from rays_tpu_torch.tracing.trace import RayResults

    if type(tree).__name__ != "RayResults":
        raise ValueError(f"expected a RayResults, got {type(tree).__name__}")
    if tuple(tree._fields) != tuple(RayResults._fields):
        raise ValueError(f"RayResults fields {tree._fields} != {RayResults._fields}")

    def leaf(name):
        a = getattr(tree, name)
        if a is None:
            return None
        a = np.asarray(a)
        if name in ("npoints", "stop_flag"):
            return torch.from_numpy(a.astype(np.int32)).to(device)
        return torch.from_numpy(a.astype(np.float64)).to(device=device, dtype=dtype)

    return RayResults(*(leaf(name) for name in RayResults._fields))
