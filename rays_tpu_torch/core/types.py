"""Core parameter types and the static run configuration.

The split follows ``rays_tpu.core.types``: everything numeric lives in
``Params`` (NamedTuples of tensors, all on one device in one float dtype),
everything that selects code paths lives in ``Config`` (a frozen
dataclass).  Field names and meanings are those of the JAX package, so a
``Params`` tree carries over leaf by leaf (``convert.params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch


class SpeciesParams(NamedTuple):
    """Plasma species table (reference RAYS_lib/species_m.f90).

    Index 0 is electrons, 1..nspec are ions; tensors have length nspec+1.

    Densities are NORMALIZED: ``n0s`` holds the species densities relative
    to the reference electron density ``n_ref`` (the eta concentrations).
    The physical scale lives only in the host-precomputed nondimensional
    coefficients

        alpha_coef_s = n_ref * qs^2 / (eps0 * ms * omgrf_ref^2)
        gamma_coef_s = qs / (ms * omgrf_ref)

    so that alpha_s = alpha_coef_s * ns_s * (omgrf_ref/omega)^2 and
    gamma_s = gamma_coef_s * |B| * (omgrf_ref/omega).  The forms are kept
    from the JAX package: parity with it depends on them.
    """

    qs: Any          # (S,) charge [C]
    ms: Any          # (S,) mass [kg]
    eta: Any         # (S,) concentration as fraction of electron density
    n0s: Any         # (S,) NORMALIZED reference densities (= eta)
    n_ref: Any       # () physical reference electron density [m^-3]
    t0s: Any         # (S,) temperature [J]
    alpha_coef: Any  # (S,) n_ref*qs^2/(eps0*ms*omgrf_ref^2)
    gamma_coef: Any  # (S,) qs/(ms*omgrf_ref)


class RFParams(NamedTuple):
    """Wave parameters (reference RAYS_lib/rf_m.f90:17-20)."""

    omgrf: Any      # 2*pi*frf
    k0: Any         # omgrf/clight
    omgrf_ref: Any  # reference omega used in the species coefficients


class OdeParams(NamedTuple):
    """Integrator parameters (reference RAYS_lib/ode_m.f90:98-104)."""

    ds: Any        # outer step in ray parameter (arclength or time)
    s_max: Any     # maximum ray parameter
    rel_err: Any   # adaptive stepper relative tolerance (SG rel_err0)
    abs_err: Any   # adaptive stepper absolute tolerance (SG abs_err0)


class Limits(NamedTuple):
    """Run-validity limits enforced each step (reference check_save.f90)."""

    dispersion_resid_limit: Any   # rf_m.f90:48
    total_damping_limit: Any      # damping_m.f90:38
    sg_error_limit: Any           # SG_ode_m error-growth abort


class Params(NamedTuple):
    """The full parameter bundle for a run.  ``eq`` is a model-specific
    NamedTuple (``models.slab.SlabParams``, ``models.solovev.SolovevParams``,
    ``models.axisym_toroid.AxisymToroidParams``,
    ``models.multiple_mirror.MultipleMirrorParams``) selected by
    ``Config.equilib_model``.  The spline geometries nest further tuples
    (splines, cell tables) and may hold ``None`` where a file gives no
    data (no Q profile, no cell table)."""

    species: SpeciesParams
    rf: RFParams
    eq: Any
    ode: OdeParams
    limits: Limits


@dataclasses.dataclass(frozen=True)
class Config:
    """Static configuration: selects code paths.

    Copied from ``rays_tpu.core.types.Config`` without ``fused_kernel``:
    here the CUDA kernel is simply the dispatch for the configs it
    supports (``tracing/fused_slab.supported``).
    """

    # identity
    run_label: str = "run"
    run_description: str = ""

    # species (names fix charge/mass lookup; count fixes array sizes)
    nspec: int = 1  # number of ION species; arrays sized nspec+1

    # rf (rf_m.f90 namelist)
    ray_dispersion_model: str = "cold"
    wave_mode: str = "plus"        # plus | minus | fast | slow
    k0_sign: int = 1
    ray_param: str = "arcl"        # arcl | time

    # equilibrium
    equilib_model: str = "slab"    # slab | solovev | axisym_toroid | multiple_mirror
    eq_static: Any = None          # model-specific frozen dataclass

    # damping
    damping_model: str = "no_damp"  # no_damp | damp_fund_ECH
    multi_spec_damping: bool = False

    # diagnostics
    integrate_eq_gradients: bool = False
    verbosity: int = 0

    # integrator
    ode_solver_name: str = "RK4_ODE"  # RK4_ODE | SG_ODE
    ray_deriv_name: str = "cold"      # cold | autodiff
    nstep_max: int = 500
    max_substeps: int = 512
    sg_scan_substeps: int = 0
    remat_steps: bool = True
    # the compensated (Neumaier) carry of the state, float32 runs'
    # accumulation mode (tracing/compensated.py; RayResults.end_ray_comp)
    compensated_sum: bool = False

    # ray initialization
    ray_init_model: str = "simple_slab"
    rayinit_static: Any = None     # model-specific frozen dataclass
    nray_max: int = 10000

    # output
    save_trajectory: bool = True
    write_formatted_ray_files: bool = False
    write_results_list_directed: bool = False
    write_results_netcdf: bool = False

    @property
    def ns(self) -> int:
        """Number of species entries (electrons + ions)."""
        return self.nspec + 1

    @property
    def nv(self) -> int:
        """ODE vector length (reference RAYS_lib/ode_m.f90:158-175)."""
        nv = 7
        if self.damping_model != "no_damp":
            nv += 1
            if self.multi_spec_damping:
                nv += 1 + self.nspec
        if self.integrate_eq_gradients:
            nv += 5
        return nv

    @property
    def damping_slot(self) -> int:
        """Index of the total-absorption slot in v, or -1 if absent."""
        return 7 if self.damping_model != "no_damp" else -1

    @property
    def grad_diag_slot(self) -> int:
        """Index of the first gradient-diagnostic slot in v, or -1."""
        if not self.integrate_eq_gradients:
            return -1
        return self.nv - 5


def tree_to(tree, device=None, dtype=None):
    """Move every floating-point tensor leaf of a NamedTuple tree to
    ``device`` and ``dtype`` (integer leaves keep their dtype, ``None``
    stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return tree.to(device=device, dtype=dtype)
        return tree.to(device=device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(x, device, dtype) for x in tree))
    raise TypeError(f"tree_to: unsupported leaf {type(tree).__name__}")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a NamedTuple tree, with the matching
    leaves of the trees in ``rest`` (of the same structure) as further
    arguments.  ``None`` entries stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_leaves(tree):
    """Flatten a NamedTuple tree of tensors into a list of its leaves
    (``None`` entries are no leaves)."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def needs_grad(params, *tensors) -> bool:
    """Whether gradients are asked for: grad mode is on and a Params leaf
    or one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and (
        any(t.requires_grad for t in tensors)
        or any(leaf.requires_grad for leaf in tree_leaves(params)))


def has_tangent(params, *tensors) -> bool:
    """Whether forward-mode derivatives ride on a Params leaf or one of
    ``tensors`` (dual tensors of ``torch.autograd.forward_ad``)."""
    from torch.autograd import forward_ad

    return any(forward_ad.unpack_dual(t).tangent is not None
               for t in (*tensors, *tree_leaves(params)))


def asarrays(tree, dtype=torch.float64, device="cpu"):
    """Map a NamedTuple tree of python scalars, lists and tensors to
    tensors of ``dtype`` on ``device`` (``rays_tpu.core.types.asarrays``,
    with the device made explicit).  ``None`` entries stay ``None``."""
    return tree_map(lambda x: torch.as_tensor(x, dtype=dtype, device=device), tree)
