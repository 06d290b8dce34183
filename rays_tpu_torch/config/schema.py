"""Build (Config, Params) from a parsed namelist dict
(``rays_tpu.config.schema``).

Every equilibrium model (slab, solovev, axisym_toroid, multiple_mirror)
and every ray-init model of the JAX package's ``from_namelist``.
Coefficients and spline tables are computed on the host in float64, as the
JAX package computes them, and only then become tensors of the requested
device and dtype.  The spline geometries read data files: the G-EQDSK file
by the name the namelist gives, the mirror field netCDF and the ray-init
file relative to ``input_dir``.
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


def _profile_knots(nml, static):
    """(ne_knots, te_knots, ti_knots) of the spline profile models, each
    (2, K) rows (f, m); a (2, 4) block of zeros where a model is unused."""
    from rays_tpu_torch.models.axisym_toroid import build_spline_knots

    ne_knots = te_knots = ti_knots = torch.zeros((2, 4), dtype=torch.float64)
    if static.density_prof_model == "density_spline_interp":
        gd = nml.get("density_spline_interp_list", {})
        ngrid = int(_get(gd, "ngrid", 0))
        ne_knots = build_spline_knots(
            _arr(gd, "ne_in", max(ngrid, 4), base=1)[:ngrid])
    if "temperature_spline_interp" in static.temperature_prof_model:
        gt = nml.get("temperature_spline_interp_list", {})
        ngrid = int(_get(gt, "ngrid", 0))
        te_knots = build_spline_knots(
            _arr(gt, "te_in", max(ngrid, 4), base=1)[:ngrid])
        ti_knots = build_spline_knots(
            _arr(gt, "ti_in", max(ngrid, 4), base=1)[:ngrid])
    return ne_knots, te_knots, ti_knots


def _axisym_toroid_from_namelist(nml, ns):
    from rays_tpu_torch.models import axisym_toroid as at

    g = nml.get("axisym_toroid_eq_list", {})
    mag_model = _get(g, "magnetics_model", "solovev_magnetics")
    static = at.AxisymToroidStatic(
        magnetics_model=mag_model,
        density_prof_model=_get(g, "density_prof_model", "parabolic"),
        temperature_prof_model=tuple(
            _strlist(g, "temperature_prof_model", ns, "zero")),
    )

    if mag_model == "solovev_magnetics":
        gm = nml.get("solovev_magnetics_list", {})
        mag = at.SolovevMagParams(
            rmaj=_get(gm, "rmaj", 1.0), kappa=_get(gm, "kappa", 1.0),
            bphi0=_get(gm, "bphi0", 1.0), iota0=_get(gm, "iota0", 0.5),
            outer_bound=_get(gm, "outer_boundary", 1.3),
        )
        box = (_get(gm, "box_rmin", 0.05), _get(gm, "box_rmax", 10.0),
               _get(gm, "box_zmin", -10.0), _get(gm, "box_zmax", 10.0))
    elif mag_model in ("eqdsk_magnetics_spline_interp",
                       "eqdsk_magnetics_lin_interp"):
        gm = nml.get("eqdsk_magnetics_spline_interp_list",
                     nml.get("eqdsk_magnetics_lin_interp_list", {}))
        fname = _get(gm, "eqdsk_file_name")
        if fname is None:
            raise ValueError("eqdsk magnetics needs eqdsk_file_name")
        if mag_model == "eqdsk_magnetics_lin_interp":
            mag, geq = at.build_eqdsk_lin_mag_params(fname)
        else:
            mag, geq = at.build_eqdsk_mag_params(fname)
        # the box of an EQDSK run is the file's
        box = (geq.rboxlft, geq.rboxlft + geq.rboxlen,
               geq.zoff - geq.zboxlen / 2.0, geq.zoff + geq.zboxlen / 2.0)
    else:
        raise NotImplementedError(f"magnetics_model {mag_model}")

    ne_knots, te_knots, ti_knots = _profile_knots(nml, static)
    p = at.AxisymToroidParams(
        mag=mag,
        plasma_psi_limit=_get(g, "plasma_psi_limit", 1.0),
        alphan1=_get(g, "alphan1", 1.0), alphan2=_get(g, "alphan2", 2.0),
        d_scrape_off=_get(g, "d_scrape_off", 0.0),
        ne_knots=ne_knots,
        alphat1=_arr(g, "alphat1", ns, 1.0),
        alphat2=_arr(g, "alphat2", ns, 2.0),
        t_scrape_off=_get(g, "t_scrape_off", 0.0),
        te_knots=te_knots, ti_knots=ti_knots,
        box_rmin=box[0], box_rmax=box[1], box_zmin=box[2], box_zmax=box[3],
    )
    return static, p


def _multiple_mirror_from_namelist(nml, ns, input_dir="."):
    from rays_tpu_torch.models import multiple_mirror as mm

    g = nml.get("multiple_mirror_eq_list", {})
    static = mm.MultipleMirrorStatic(
        magnetics_model=_get(g, "magnetics_model",
                             "mirror_magnetics_spline_interp"),
        density_prof_model=_get(g, "density_prof_model", "parabolic"),
        temperature_prof_model=tuple(
            _strlist(g, "temperature_prof_model", ns, "zero")),
    )
    gm = nml.get("mirror_magnetics_spline_interp_list", {})
    fname = _get(gm, "mirror_field_nc_file")
    if fname is None:
        raise ValueError("multiple_mirror needs mirror_field_NC_file")
    if not os.path.isabs(fname):
        fname = os.path.join(input_dir, fname)
    (br_sp, bz_sp, aphi_sp, aphi_lufs, box,
     field_cells) = mm.load_field_file(fname)

    ne_knots, te_knots, ti_knots = _profile_knots(nml, static)
    p = mm.MultipleMirrorParams(
        br_spline=br_sp, bz_spline=bz_sp, aphi_spline=aphi_sp,
        aphi_lufs=aphi_lufs,
        plasma_aphin_limit=_get(g, "plasma_aphin_limit", 1.0),
        alphan1=_get(g, "alphan1", 1.0), alphan2=_get(g, "alphan2", 2.0),
        aphin0_d=_get(g, "aphin0_d", 0.05), delta_d=_get(g, "delta_d", 0.05),
        d_scrape_off=_get(g, "d_scrape_off", 0.0),
        ne_knots=ne_knots,
        alphat1=_arr(g, "alphat1", ns, 1.0),
        alphat2=_arr(g, "alphat2", ns, 2.0),
        aphin0_t=_arr(g, "aphin0_t", ns, 0.05),
        delta_t=_arr(g, "delta_t", ns, 0.05),
        t_scrape_off=_get(g, "t_scrape_off", 0.0),
        te_knots=te_knots, ti_knots=ti_knots,
        box_rmax=box[0], box_zmin=box[1], box_zmax=box[2],
        field_cells=field_cells,
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


def _axisym_init_from_namelist(nml):
    from rays_tpu_torch.rayinit.axisym_toroid import AxisymToroidInit

    g = nml.get("axisym_toroid_ray_init_r_z_nphi_ntheta_list", {})
    return AxisymToroidInit(
        n_r_launch=int(_get(g, "n_r_launch", 1)),
        r_launch0=float(_get(g, "r_launch0", 0.0)),
        dr_launch=float(_get(g, "dr_launch", 0.0)),
        n_z_launch=int(_get(g, "n_z_launch", 1)),
        z_launch0=float(_get(g, "z_launch0", 0.0)),
        dz_launch=float(_get(g, "dz_launch", 0.0)),
        n_rindex_theta=int(_get(g, "n_rindex_theta", 1)),
        rindex_theta0=float(_get(g, "rindex_theta0", 0.0)),
        delta_rindex_theta=float(_get(g, "delta_rindex_theta", 0.0)),
        n_rindex_phi=int(_get(g, "n_rindex_phi", 1)),
        rindex_phi0=float(_get(g, "rindex_phi0", 0.0)),
        delta_rindex_phi=float(_get(g, "delta_rindex_phi", 0.0)),
    )


def _one_ray_init_from_namelist(nml):
    from rays_tpu_torch.rayinit.one_ray import OneRayInit

    g = nml.get("one_ray_init_xyz_k_direction_list", {})
    return OneRayInit(
        x=float(_get(g, "x", 0.0)), y=float(_get(g, "y", 0.0)),
        z=float(_get(g, "z", 0.0)),
        nx=float(_get(g, "nx", 0.0)), ny=float(_get(g, "ny", 0.0)),
        nz=float(_get(g, "nz", 0.0)),
        use_this_n_vec=bool(_get(g, "use_this_n_vec", False)),
    )


def _tree_tensor(tree, device, dtype):
    """Host values, float64 tensors and nested NamedTuples of them -> the
    same tree of tensors on ``device`` in ``dtype``; ``None`` stays."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_tensor(x, device, dtype) for x in tree))
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=dtype)
    return _tensor(tree, device, dtype)


def from_namelist(nml: dict, input_dir=".", device="cpu", dtype=torch.float64):
    """Parsed namelist dict -> (Config, Params), Params on ``device`` in
    ``dtype``.  ``input_dir`` resolves relative data-file paths (the mirror
    field netCDF, the ray-init file)."""
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
    elif equilib_model == "axisym_toroid":
        eq_static, eq_params = _axisym_toroid_from_namelist(nml, ns)
    elif equilib_model == "multiple_mirror":
        eq_static, eq_params = _multiple_mirror_from_namelist(nml, ns, input_dir)
    else:
        raise NotImplementedError(f"equilib_model {equilib_model}")

    ray_init_model = _get(ri, "ray_init_model", "simple_slab")
    if ray_init_model == "simple_slab":
        rayinit_static = _slab_init_from_namelist(nml)
    elif ray_init_model == "solovev_ray_init_nphi_ntheta":
        rayinit_static = _solovev_init_from_namelist(nml)
    elif ray_init_model == "axisym_toroid_ray_init_R_Z_nphi_ntheta":
        rayinit_static = _axisym_init_from_namelist(nml)
    elif ray_init_model in ("one_ray_init_XYZ_n_direction",
                            "one_ray_init_XYZ_k_direction"):
        ray_init_model = "one_ray_init_XYZ_k_direction"
        rayinit_static = _one_ray_init_from_namelist(nml)
    elif ray_init_model == "file_input_ray_init":
        from rays_tpu_torch.rayinit.file_input import FileInputInit

        label = str(_get(diag, "run_label", "run"))
        rayinit_static = FileInputInit(
            filename=os.path.join(input_dir, f"ray_init_{label}.in"))
    else:
        raise NotImplementedError(f"ray_init_model {ray_init_model!r}")

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
        eq=_tree_tensor(eq_params, device, dtype),
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
