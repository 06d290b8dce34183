"""Documentation extractor (``rays_tpu.utils.doc_modules``).

The analog of the reference's RAYS_project/doc/doc_modules.py: walks the
package, writes every module docstring into ``module_description.md`` and
catalogs the supported namelist groups and keys (those of
config/schema.py's importer) into ``namelist_description.md``, the two
files the reference generates as API checklists.

    python -m rays_tpu_torch.utils.doc_modules [outdir]   # default build/docs
"""

from __future__ import annotations

import ast
import os
import sys

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Namelist groups the importer understands, with their handled keys
# (kept in sync with config/schema.py; exercised by the example inputs).
NAMELIST_CATALOG = {
    "diagnostics_list": ["run_label", "run_description", "verbosity",
                         "integrate_eq_gradients", "messages_to_stdout",
                         "write_formatted_ray_files"],
    "species_list": ["n0", "spec_name(0:5)", "spec_model(0:5)", "eta(1:5)",
                     "t0s_eV(0:5)", "t0s(0:5) [accepted alias]",
                     "neutrality"],
    "rf_list": ["frf", "wave_mode", "k0_sign", "ray_param",
                "ray_dispersion_model", "dispersion_resid_limit"],
    "damping_list": ["damping_model", "multi_spec_damping",
                     "total_damping_limit"],
    "equilibrium_list": ["equilib_model"],
    "slab_eq_list": ["bx/by/bz_prof_model", "bx0", "by0", "bz0",
                     "LBy_shear_scale", "LBz_scale", "dBzdx",
                     "dens_prof_model", "Ln_scale", "dndx", "alphan1",
                     "alphan2", "n_min", "t_prof_model(0:nspec)",
                     "LT_scale", "dtdx", "alphat1", "alphat2", "T_min",
                     "rmaj", "rmin", "x0", "xmin..zmax"],
    "solovev_eq_list": ["rmaj", "outer_bound", "kappa", "bphi0", "iota0",
                        "dens_prof_model", "alphan1", "alphan2",
                        "t_prof_model", "alphat1", "alphat2",
                        "box_rmin..box_zmax"],
    "axisym_toroid_eq_list": ["magnetics_model", "plasma_psi_limit",
                              "density_prof_model", "d_scrape_off",
                              "alphan1", "alphan2",
                              "temperature_prof_model", "alphat1",
                              "alphat2", "T_scrape_off"],
    "solovev_magnetics_list": ["rmaj", "outer_boundary", "kappa", "bphi0",
                               "iota0", "box_rmin..box_zmax"],
    "eqdsk_magnetics_spline_interp_list": ["eqdsk_file_name"],
    "eqdsk_magnetics_lin_interp_list": ["eqdsk_file_name"],
    "multiple_mirror_eq_list": ["magnetics_model", "plasma_AphiN_limit",
                                "density_prof_model", "d_scrape_off",
                                "alphan1", "alphan2", "Aphin0_d", "delta_d",
                                "temperature_prof_model", "alphat1",
                                "alphat2", "Aphin0_t", "delta_t",
                                "T_scrape_off"],
    "mirror_magnetics_spline_interp_list": ["mirror_field_NC_file"],
    "density_spline_interp_list": ["ngrid", "ne_in"],
    "temperature_spline_interp_list": ["ngrid", "Te_in", "Ti_in"],
    "ray_init_list": ["ray_init_model", "nray_max"],
    "simple_slab_ray_init_list": ["n_x/y/z_launch", "x/y/z_launch0",
                                  "dx/dy/dz_launch", "n_ky_launch",
                                  "rindex_y0", "delta_rindex_y0",
                                  "n_kz_launch", "rindex_z0",
                                  "delta_rindex_z0"],
    "solovev_ray_init_nphi_ktheta_list": ["n_r_launch", "r_launch0",
                                          "dr_launch", "n_theta_launch",
                                          "theta_launch0", "dtheta_launch",
                                          "n_rindex_theta", "rindex_theta0",
                                          "delta_rindex_theta",
                                          "n_rindex_phi", "rindex_phi0",
                                          "delta_rindex_phi"],
    "axisym_toroid_ray_init_R_Z_nphi_ntheta_list": [
        "n_R_launch", "R_launch0", "n_Z_launch", "Z_launch0",
        "n_rindex_theta", "rindex_theta0", "delta_rindex_theta",
        "n_rindex_phi", "rindex_phi0", "delta_rindex_phi"],
    "one_ray_init_XYZ_k_direction_list": ["X", "Y", "Z", "nX", "nY", "nZ",
                                          "use_this_n_vec"],
    "file_input_ray_init_list": ["n_rays_in", "rvec_in", "rindex_vec_in",
                                 "ray_pwr_wt_in"],
    "ode_list": ["ode_solver_name", "ray_deriv_name", "nstep_max", "ds",
                 "s_max"],
    "sg_ode_list": ["rel_err0", "abs_err0", "SG_error_limit"],
    "ray_results_list": ["write_results_list_directed",
                         "write_results_netCDF"],
    "post_process_list": ["processor", "ray_data_input_mode"],
    "deposition_profiles_list": ["n_bins"],
    "slab_processor_list": ["num_plot_k_vectors", "scale_k_vec",
                            "k_vec_base_length", "set_XY_lim", "n_X",
                            "calculate_dep_profiles", "write_dep_profiles",
                            "calculate_ray_diag",
                            "write_eq_X_profile_data"],
    "solovev_processor_list": ["processor", "num_plot_k_vectors",
                               "scale_k_vec", "set_XY_lim"],
    "axisym_toroid_processor_list": [
        "num_plot_k_vectors", "scale_k_vec", "k_vec_base_length",
        "set_XY_lim", "calculate_dep_profiles", "write_dep_profiles",
        "calculate_ray_diag", "write_contour_data", "N_pointsR_eq",
        "N_pointsZ_eq", "write_eq_RZ_grid_data",
        "write_eq_radial_profile_data", "n_psiN", "bisection_eps",
        "n_rho"],
    "mirror_processor_list": [
        "num_plot_k_vectors", "scale_k_vec", "k_vec_base_length",
        "set_XY_lim", "calculate_dep_profiles", "write_dep_profiles",
        "calculate_ray_diag", "write_contour_data", "N_pointsX_eq",
        "N_pointsZ_eq", "write_eq_XZ_grid_data",
        "write_eq_radial_profile_data", "n_AphiN", "bisection_eps",
        "n_rho", "z_reference", "do_OX_conv_analysis"],
}


def accepted_namelist_groups():
    """The namelist group names the importers accept, read from the source
    (AST) of the entry points that read parsed namelists, after the
    reference's doc extractor (doc/doc_modules.py:1-18).  NAMELIST_CATALOG
    is held to this set by a test, so the catalog cannot leave out a group
    that the code reads."""
    srcs = [os.path.join(PKG_ROOT, "config", "schema.py"),
            os.path.join(PKG_ROOT, "post", "process.py"),
            os.path.join(PKG_ROOT, "rayinit", "file_input.py"),
            os.path.join(PKG_ROOT, "run.py")]
    groups = set()
    for path in srcs:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            # nml.get("group", ...): the importer's accept pattern
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "nml"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                groups.add(node.args[0].value.lower())
            # nml["group"]: the required-group pattern
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "nml"
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                groups.add(node.slice.value.lower())
    # processor groups are accepted by name through this table
    from rays_tpu_torch.post.process import PROCESSOR_GROUP

    groups.update(g.lower() for g in PROCESSOR_GROUP.values())
    return groups


def extract_module_docs():
    """(path relative to the package's parent, docstring) of every module."""
    rows = []
    for root, dirs, files in os.walk(PKG_ROOT):
        dirs.sort()
        for fn in sorted(files):
            if not fn.endswith(".py") or fn.startswith("__"):
                continue
            path = os.path.join(root, fn)
            rel = os.path.relpath(path, os.path.dirname(PKG_ROOT))
            with open(path) as f:
                tree = ast.parse(f.read())
            rows.append((rel, ast.get_docstring(tree) or "(no docstring)"))
    return rows


def write_docs(outdir="."):
    """Write module_description.md and namelist_description.md into
    ``outdir``; returns their paths."""
    os.makedirs(outdir, exist_ok=True)
    mod_path = os.path.join(outdir, "module_description.md")
    with open(mod_path, "w") as f:
        f.write("# rays_tpu_torch module descriptions (auto-generated)\n")
        for rel, doc in extract_module_docs():
            f.write(f"\n## {rel}\n\n{doc}\n")

    nml_path = os.path.join(outdir, "namelist_description.md")
    with open(nml_path, "w") as f:
        f.write("# Supported namelist groups (auto-generated)\n\n"
                "Groups/keys of the reference's rays.in format understood "
                "by rays_tpu_torch.config (reference catalog: "
                "RAYS_lib/namelist_description.md).\n")
        for group, keys in NAMELIST_CATALOG.items():
            f.write(f"\n## &{group}\n\n")
            for k in keys:
                f.write(f"- `{k}`\n")
    return mod_path, nml_path


if __name__ == "__main__":
    print(*write_docs(sys.argv[1] if len(sys.argv) > 1 else os.path.join("build", "docs")))
