"""Build (Config, Params) from a parsed namelist dict
(``rays_tpu.config.schema``).

Ports the species, rf, ode, limits, slab, solovev and the two matching
ray-init parts of ``from_namelist``.  Coefficients are computed on the host in numpy
float64, exactly as the JAX package computes them, and only then become
tensors of the requested device and dtype.  Other equilibrium and
ray-init models raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rays_tpu_torch import constants
from rays_tpu_torch.core.types import (
    Config, Limits, OdeParams, Params, RFParams, SpeciesParams,
)
from rays_tpu_torch.models import slab as slab_mod
from rays_tpu_torch.models import solovev as solovev_mod
from rays_tpu_torch.rayinit import slab as slab_init_mod
from rays_tpu_torch.rayinit import solovev as solovev_init_mod

NSPEC0 = 5  # max ion species (species_m.f90:25)

_NOT_PORTED_EQ = {
    "axisym_toroid": "ROADMAP A13",
    "multiple_mirror": "ROADMAP A13",
}
_NOT_PORTED_INIT = {
    "axisym_toroid_ray_init_R_Z_nphi_ntheta": "ROADMAP A13",
    "one_ray_init_XYZ_n_direction": "ROADMAP A13",
    "one_ray_init_XYZ_k_direction": "ROADMAP A13",
    "file_input_ray_init": "ROADMAP A13",
}


def _arr(group, key, n, default=0.0, base=0):
    """Assemble a length-n array from a namelist entry that may be a
    scalar, a list, or an {index: value} dict (indices start at `base`)."""
    out = np.full((n,), default, dtype=np.float64)
    if key not in group:
        return out
    val = group[key]
    if isinstance(val, dict):
        for i, v in val.items():
            out[i - base] = v
    elif isinstance(val, (list, tuple)):
        out[: len(val)] = val
    else:
        out[:] = val
    return out


def _strlist(group, key, n, default):
    out = [default] * n
    if key not in group:
        return out
    val = group[key]
    if isinstance(val, dict):
        for i, v in val.items():
            out[i] = v
    elif isinstance(val, (list, tuple)):
        out[: len(val)] = list(val)
    else:
        out = [val] * n
    return out


def _get(group, key, default=None):
    return group.get(key, default)


def species_from_namelist(nml):
    """Species table + neutrality check (species_m.f90:97-168)."""
    g = nml.get("species_list", {})
    n0 = float(_get(g, "n0", 1.0e19))
    eta_in = _arr(g, "eta", NSPEC0 + 1)
    names = _strlist(g, "spec_name", NSPEC0 + 1, "")
    # t0s_eV (current namelist name) and t0s (committed example inputs)
    t0_ev_in = _arr(g, "t0s_ev", NSPEC0 + 1)
    if "t0s" in g:
        t0_ev_in = _arr(g, "t0s", NSPEC0 + 1)
    neutrality = float(_get(g, "neutrality", 1.0e-10))

    # electrons forced (species_m.f90:120-124)
    qs_unit = [-1.0]
    ms_unit = [1.0]
    eta = [1.0]
    t0_ev = [t0_ev_in[0]]
    spec_names = ["electron"]
    for i in range(1, NSPEC0 + 1):
        if eta_in[i] > 0.0:
            name = names[i].strip()
            if name not in constants.SPECIES_TABLE:
                raise ValueError(f"unknown species name '{name}'")
            q, m = constants.SPECIES_TABLE[name]
            qs_unit.append(q)
            ms_unit.append(m)
            eta.append(eta_in[i])
            t0_ev.append(t0_ev_in[i])
            spec_names.append(name)

    charge = float(np.dot(qs_unit, eta))
    if abs(charge) > neutrality:
        raise ValueError(f"charge neutrality violated, charge = {charge}")

    qs = np.asarray(qs_unit) * constants.E_CHARGE
    ms = np.asarray(ms_unit) * constants.ME
    eta = np.asarray(eta)
    return (qs, ms, eta, n0, np.asarray(t0_ev)), len(qs_unit) - 1, tuple(spec_names)


def _tensor(x, device, dtype):
    """Host value -> tensor, rounded once from float64."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(device=device, dtype=dtype)


def build_species_params(qs, ms, eta, n0, t0_ev, omgrf_ref, device, dtype):
    """SpeciesParams with the nondimensional coefficients computed on the
    host in float64 and densities normalized to n_ref."""
    alpha_coef = n0 * qs**2 / (constants.EPS0 * ms * omgrf_ref**2)
    gamma_coef = qs / (ms * omgrf_ref)

    def t(x):
        return _tensor(x, device, dtype)

    return SpeciesParams(
        qs=t(qs), ms=t(ms), eta=t(eta),
        n0s=t(eta),        # normalized: ns in units of n_ref
        n_ref=t(n0),
        t0s=t(t0_ev * constants.E_CHARGE),
        alpha_coef=t(alpha_coef), gamma_coef=t(gamma_coef),
    )


def _slab_from_namelist(nml, ns):
    g = nml.get("slab_eq_list", {})
    static = slab_mod.SlabStatic(
        bx_prof_model=_get(g, "bx_prof_model", "zero"),
        by_prof_model=_get(g, "by_prof_model", "zero"),
        bz_prof_model=_get(g, "bz_prof_model", "constant"),
        dens_prof_model=_get(g, "dens_prof_model", "constant"),
        t_prof_model=tuple(_strlist(g, "t_prof_model", ns, "zero")),
    )
    p = slab_mod.SlabParams(
        xmin=_get(g, "xmin", -1.0), xmax=_get(g, "xmax", 1.0),
        ymin=_get(g, "ymin", -1.0), ymax=_get(g, "ymax", 1.0),
        zmin=_get(g, "zmin", -1.0), zmax=_get(g, "zmax", 1.0),
        rmaj=_get(g, "rmaj", 1.0), rmin=_get(g, "rmin", 0.5),
        x0=_get(g, "x0", 0.0),
        bx0=_get(g, "bx0", 0.0), by0=_get(g, "by0", 0.0),
        bz0=_get(g, "bz0", 1.0),
        lby_shear_scale=_get(g, "lby_shear_scale", 1.0),
        lbz_scale=_get(g, "lbz_scale", 1.0),
        dbzdx=_get(g, "dbzdx", 0.0),
        ln_scale=_get(g, "ln_scale", 1.0),
        dndx=_get(g, "dndx", 0.0),
        alphan1=_get(g, "alphan1", 1.0), alphan2=_get(g, "alphan2", 2.0),
        n_min=_get(g, "n_min", 0.0),
        lt_scale=_get(g, "lt_scale", 1.0), dtdx=_get(g, "dtdx", 0.0),
        alphat1=_arr(g, "alphat1", ns, 0.0),
        alphat2=_arr(g, "alphat2", ns, 0.0),
        t_min=_arr(g, "t_min", ns, 0.0),
    )
    return static, p


def _solovev_from_namelist(nml, ns):
    g = nml.get("solovev_eq_list", {})
    static = solovev_mod.SolovevStatic(
        dens_prof_model=_get(g, "dens_prof_model", "parabolic"),
        t_prof_model=tuple(_strlist(g, "t_prof_model", ns, "zero")),
    )
    p = solovev_mod.SolovevParams(
        rmaj=_get(g, "rmaj", 1.0), kappa=_get(g, "kappa", 1.0),
        bphi0=_get(g, "bphi0", 1.0), iota0=_get(g, "iota0", 0.5),
        outer_bound=_get(g, "outer_bound", 1.3),
        alphan1=_get(g, "alphan1", 1.0), alphan2=_get(g, "alphan2", 2.0),
        alphat1=_arr(g, "alphat1", ns, 1.0),
        alphat2=_arr(g, "alphat2", ns, 2.0),
        box_rmin=_get(g, "box_rmin", 0.0), box_rmax=_get(g, "box_rmax", 10.0),
        box_zmin=_get(g, "box_zmin", -10.0), box_zmax=_get(g, "box_zmax", 10.0),
    )
    return static, p


def _slab_init_from_namelist(nml):
    g = nml.get("simple_slab_ray_init_list", {})
    return slab_init_mod.SlabInit(
        n_x_launch=int(_get(g, "n_x_launch", 1)),
        x_launch0=float(_get(g, "x_launch0", 0.0)),
        dx_launch=float(_get(g, "dx_launch", 0.0)),
        n_y_launch=int(_get(g, "n_y_launch", 1)),
        y_launch0=float(_get(g, "y_launch0", 0.0)),
        dy_launch=float(_get(g, "dy_launch", 0.0)),
        n_z_launch=int(_get(g, "n_z_launch", 1)),
        z_launch0=float(_get(g, "z_launch0", 0.0)),
        dz_launch=float(_get(g, "dz_launch", 0.0)),
        n_ky_launch=int(_get(g, "n_ky_launch", 1)),
        rindex_y0=float(_get(g, "rindex_y0", 0.0)),
        delta_rindex_y0=float(_get(g, "delta_rindex_y0", 0.0)),
        n_kz_launch=int(_get(g, "n_kz_launch", 1)),
        rindex_z0=float(_get(g, "rindex_z0", 0.0)),
        delta_rindex_z0=float(_get(g, "delta_rindex_z0", 0.0)),
    )


def _solovev_init_from_namelist(nml):
    g = nml.get("solovev_ray_init_nphi_ktheta_list", {})
    return solovev_init_mod.SolovevInit(
        n_r_launch=int(_get(g, "n_r_launch", 1)),
        r_launch0=float(_get(g, "r_launch0", 0.0)),
        dr_launch=float(_get(g, "dr_launch", 0.0)),
        n_theta_launch=int(_get(g, "n_theta_launch", 1)),
        theta_launch0=float(_get(g, "theta_launch0", 0.0)),
        dtheta_launch=float(_get(g, "dtheta_launch", 0.0)),
        n_rindex_theta=int(_get(g, "n_rindex_theta", 1)),
        rindex_theta0=float(_get(g, "rindex_theta0", 0.0)),
        delta_rindex_theta=float(_get(g, "delta_rindex_theta", 0.0)),
        n_rindex_phi=int(_get(g, "n_rindex_phi", 1)),
        rindex_phi0=float(_get(g, "rindex_phi0", 0.0)),
        delta_rindex_phi=float(_get(g, "delta_rindex_phi", 0.0)),
    )


def from_namelist(nml: dict, input_dir=".", device="cpu", dtype=torch.float64):
    """Parsed namelist dict -> (Config, Params), Params on ``device`` in
    ``dtype``.  ``input_dir`` is accepted for the JAX signature; no ported
    model reads data files yet."""
    del input_dir
    diag = nml.get("diagnostics_list", {})
    rf = nml.get("rf_list", {})
    damp = nml.get("damping_list", {})
    eqg = nml.get("equilibrium_list", {})
    ode = nml.get("ode_list", {})
    sg = nml.get("sg_ode_list", {})
    ri = nml.get("ray_init_list", {})
    rres = nml.get("ray_results_list", {})

    sp_raw, nspec, _ = species_from_namelist(nml)
    ns = nspec + 1

    equilib_model = _get(eqg, "equilib_model", "slab")
    if equilib_model == "slab":
        eq_static, eq_params = _slab_from_namelist(nml, ns)
    elif equilib_model == "solovev":
        eq_static, eq_params = _solovev_from_namelist(nml, ns)
    else:
        where = _NOT_PORTED_EQ.get(equilib_model)
        if where is None:
            raise NotImplementedError(f"equilib_model {equilib_model}")
        raise NotImplementedError(
            f"equilib_model {equilib_model!r} is not ported yet ({where})")

    ray_init_model = _get(ri, "ray_init_model", "simple_slab")
    if ray_init_model == "simple_slab":
        rayinit_static = _slab_init_from_namelist(nml)
    elif ray_init_model == "solovev_ray_init_nphi_ntheta":
        rayinit_static = _solovev_init_from_namelist(nml)
    else:
        where = _NOT_PORTED_INIT.get(ray_init_model, "not in the ROADMAP")
        raise NotImplementedError(
            f"ray_init_model {ray_init_model!r} is not ported yet ({where})")

    cfg = Config(
        run_label=str(_get(diag, "run_label", "run")),
        run_description=str(_get(diag, "run_description", "")),
        nspec=nspec,
        ray_dispersion_model=_get(rf, "ray_dispersion_model", "cold"),
        wave_mode=_get(rf, "wave_mode", "plus"),
        k0_sign=int(_get(rf, "k0_sign", 1)),
        ray_param=_get(rf, "ray_param", "arcl"),
        equilib_model=equilib_model,
        eq_static=eq_static,
        damping_model=_get(damp, "damping_model", "no_damp"),
        multi_spec_damping=bool(_get(damp, "multi_spec_damping", False)),
        integrate_eq_gradients=bool(_get(diag, "integrate_eq_gradients", False)),
        verbosity=int(_get(diag, "verbosity", 0)),
        write_formatted_ray_files=bool(
            _get(diag, "write_formatted_ray_files", False)),
        write_results_list_directed=bool(
            _get(rres, "write_results_list_directed", False)),
        write_results_netcdf=bool(
            _get(rres, "write_results_netcdf", False)),
        ode_solver_name=_get(ode, "ode_solver_name", "RK4_ODE"),
        # 'numerical' (the reference's FD A/B) maps to the autodiff path
        ray_deriv_name={"cold": "cold", "numerical": "autodiff",
                        "autodiff": "autodiff"}[
            _get(ode, "ray_deriv_name", "cold")],
        nstep_max=int(_get(ode, "nstep_max", 500)),
        ray_init_model=ray_init_model,
        rayinit_static=rayinit_static,
        nray_max=int(_get(ri, "nray_max", 10000)),
    )

    def t(x):
        return _tensor(x, device, dtype)

    frf = float(_get(rf, "frf", 1.0e9))
    omgrf = 2.0 * constants.PI * frf
    qs, ms, eta, n0, t0_ev = sp_raw
    params = Params(
        species=build_species_params(qs, ms, eta, n0, t0_ev, omgrf, device, dtype),
        rf=RFParams(omgrf=t(omgrf), k0=t(omgrf / constants.CLIGHT),
                    omgrf_ref=t(omgrf)),
        eq=type(eq_params)(*(t(x) for x in eq_params)),
        ode=OdeParams(
            ds=t(_get(ode, "ds", 1.0e-3)),
            s_max=t(_get(ode, "s_max", 1.0)),
            rel_err=t(_get(sg, "rel_err0", 1.0e-6)),
            abs_err=t(_get(sg, "abs_err0", 1.0e-6)),
        ),
        limits=Limits(
            dispersion_resid_limit=t(_get(rf, "dispersion_resid_limit", 0.1)),
            total_damping_limit=t(_get(damp, "total_damping_limit", 0.99)),
            sg_error_limit=t(_get(sg, "sg_error_limit", 0.1)),
        ),
    )
    return cfg, params


def from_file(path, device="cpu", dtype=torch.float64):
    from rays_tpu_torch.config.namelist import read_namelist_file

    return from_namelist(read_namelist_file(path),
                         input_dir=os.path.dirname(os.path.abspath(path)),
                         device=device, dtype=dtype)
