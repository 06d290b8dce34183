"""Shared inputs and checks for the rays_tpu_torch parity tests.

Inputs are built once on the JAX side and carried to the port through
``rays_tpu_torch.convert``, so both packages compute on identical numbers.
"""

import dataclasses
import os

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


# --------------------------------------------------------------------------
# the spline geometries: input files and cases set up by both packages
# --------------------------------------------------------------------------

PROFILE_LISTS = """
&density_spline_interp_list
 ngrid=6, ne_in=1.0, 0.93, 0.74, 0.45, 0.2, 0.05
/
&temperature_spline_interp_list
 ngrid=5, te_in=2.0, 1.7, 1.1, 0.5, 0.1, ti_in=1.0, 0.9, 0.6, 0.3, 0.04
/
"""

MIRROR_TMPL = """
&diagnostics_list
 run_label='mirror', integrate_eq_gradients=.false.
/
&species_list
 n0={N0}, spec_name(0)='electron', t0s(0)=200.,
 spec_name(1)='deuterium', t0s(1)=50., eta(1)=1.
/
&rf_list
 frf={FRF}, k0_sign=1, wave_mode='plus', ray_dispersion_model='cold',
 ray_param='arcl', dispersion_resid_limit=0.1
/
&damping_list
 damping_model='{DAMP}'
/
&equilibrium_list
 equilib_model='multiple_mirror'
/
&multiple_mirror_eq_list
 magnetics_model='mirror_magnetics_spline_interp', plasma_AphiN_limit=1.0,
 density_prof_model='{DENS}', AphiN0_d=0.5, delta_d=0.15, d_scrape_off=0.05,
 alphan1=1.0, alphan2=2.0,
 temperature_prof_model={TEMP}, AphiN0_t=2*0.5, delta_t=2*0.2, t_scrape_off=0.02,
 alphat1=2*1.0, alphat2=2*2.0
/
&mirror_magnetics_spline_interp_list
 mirror_field_NC_file='Brz_fields.test.nc'
/
&ray_init_list
 ray_init_model='file_input_ray_init', nray_max=20
/
&ode_list
 ode_solver_name='RK4_ODE', nstep_max={NSTEP}, ds=2.e-3, s_max=4.0
/
"""

# four candidates, Fortran column-major 3 x n; the third starts outside the
# last uninterrupted flux surface and is dropped
MIRROR_RAY_INIT = """
&file_input_ray_init_list
 n_rays_in=4,
 rvec_in = 0.02,0.0,1.4,  0.0,0.03,1.5,  0.15,0.0,1.45,  -0.02,0.01,1.6,
 rindex_vec_in = 0.3,0.0,1.0,  0.0,0.2,1.0,  0.2,0.0,1.0,  -0.3,0.1,1.0,
 ray_pwr_wt_in = 1.0, 2.0, 1.0, 0.5
/
"""

# a small coil set: four coils of radius 0.3 m along 4 m of axis, ~0.8-0.9 T
# between them (the fundamental at 22 GHz, the second harmonic at 56 GHz)
MIRROR_COILS = dict(coil_r=[0.3, 0.3, 0.3, 0.3], coil_z=[0.5, 1.5, 2.5, 3.5],
                    coil_current=[6.0e5, 4.0e5, 4.0e5, 6.0e5])


def write_solovev_geqdsk(path, n=65, with_q=False):
    """A Solovev G-EQDSK file written by the JAX package's generator; with
    ``with_q`` a smooth safety-factor profile is grafted on, so that the
    rho coordinate maps exist (tests/test_axisym.py)."""
    from rays_tpu.utils import solovev_2_eqdsk
    from rays_tpu.utils.eqdsk_io import write_geqdsk

    eq = solovev_2_eqdsk.solovev_geqdsk(rmaj=1.2, kappa=1.5, bphi0=2.2, iota0=0.3,
                                        outer_bound=1.55, nrbox=n, nzbox=n)
    if with_q:
        eq = dataclasses.replace(eq, Q=1.1 + 2.4 * np.linspace(0.0, 1.0, n) ** 2)
    write_geqdsk(str(path), eq)
    return str(path)


def write_mirror_inputs(directory, n_r=21, n_z=81, **fmt):
    """The mirror field file (JAX generator), the ray-init file and
    ``rays.in`` in ``directory``; returns the path of ``rays.in``."""
    from rays_tpu.utils import mirror_magnetics

    directory = str(directory)
    mirror_magnetics.generate_field_file(
        os.path.join(directory, "Brz_fields.test.nc"),
        *(np.asarray(MIRROR_COILS[k]) for k in ("coil_r", "coil_z", "coil_current")),
        n_r=n_r, n_z=n_z)
    with open(os.path.join(directory, "ray_init_mirror.in"), "w") as f:
        f.write(MIRROR_RAY_INIT)
    return write_mirror_namelist(directory, **fmt)


def write_mirror_namelist(directory, name="rays.in", extra="", **fmt):
    args = dict(N0="2.0e19", FRF="56.e9", DAMP="no_damp", DENS="hyperbolic",
                TEMP="2*'hyperbolic'", NSTEP=60)
    args.update(fmt)
    path = os.path.join(str(directory), name)
    with open(path, "w") as f:
        f.write(MIRROR_TMPL.format(**args) + extra)
    return path


def both_from_text(text, input_dir="."):
    """((jax cfg, params), (port cfg, params)) of one namelist text, each
    set up by its own package's importer."""
    from rays_tpu.config import schema as jschema
    from rays_tpu.config.namelist import parse_namelist as jparse
    from rays_tpu_torch.config import schema as tschema
    from rays_tpu_torch.config.namelist import parse_namelist as tparse

    return (jschema.from_namelist(jparse(text), input_dir=input_dir),
            tschema.from_namelist(tparse(text), input_dir=input_dir))


def jax_launch(cfg, params):
    """(v0, status0, pwr) of the JAX package's ray init for (cfg, params)."""
    from rays_tpu import run as jrun
    from rays_tpu.rayinit import vector as jvector

    rvec0, rindex0, pwr = jrun.init_rays(cfg, params)
    v0 = jvector.initial_ode_vectors(cfg, params, rvec0, rindex0)
    return v0, jnp.zeros((v0.shape[0],), jnp.int32), pwr


def assert_rows_close(got, ref, tol, what=""):
    """|got - ref| <= tol * (largest |ref| of the same point), point by
    point (axis 0): a point near the axis or far outside the grid, where
    values are huge, does not set the bar for the others."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    flat = np.abs(ref).reshape(ref.shape[0], -1)
    scale = np.maximum(flat.max(axis=1), 1e-300).reshape((-1,) + (1,) * (ref.ndim - 1))
    err = np.abs(got - ref) / scale
    assert np.all(err <= tol), f"{what}: max scaled error {err.max():.3e} > {tol}"


# leaves that come out of a matrix product or a bisection, which the two
# packages round differently; every other leaf is held to equality
DERIVED_LEAVES = ("m", "mx", "my", "mxy", "cells", "ne_knots", "te_knots", "ti_knots",
                  "aphi_lufs", "psin_rho_spline.f")


def assert_leaves_close(port_tree, jax_tree, tol, path=""):
    """Every leaf of the port's Params tree against the JAX tree's, name by
    name: equal, except the ``DERIVED_LEAVES``, which are held to ``tol``
    of the leaf's scale (of 1 at least); ``None`` where JAX has ``None``.  Returns the
    number of leaves compared."""
    if jax_tree is None or port_tree is None:
        assert jax_tree is None and port_tree is None, path
        return 0
    if isinstance(jax_tree, tuple) and hasattr(jax_tree, "_fields"):
        assert type(port_tree).__name__ == type(jax_tree).__name__, path
        assert port_tree._fields == jax_tree._fields, path
        return sum(assert_leaves_close(getattr(port_tree, name), getattr(jax_tree, name),
                                       tol, f"{path}.{name}" if path else name)
                   for name in jax_tree._fields)
    ref = np.asarray(jax_tree)
    got = port_tree.numpy()
    assert got.shape == ref.shape and got.dtype == np.float64, path
    if any(path == d or path.endswith("." + d) for d in DERIVED_LEAVES):
        # a table that is zero but for rounding (the second derivatives of
        # a constant R*Bphi) is held to tol itself
        np.testing.assert_allclose(got, ref, rtol=0, err_msg=path,
                                   atol=tol * max(np.abs(ref).max(), 1.0))
    else:
        np.testing.assert_array_equal(got, ref, err_msg=path)
    return 1


# --------------------------------------------------------------------------
# post-processing: results carried across, output files compared
# --------------------------------------------------------------------------


def carry_results(results, device="cpu"):
    """A JAX RayResults as the port's, on ``device``: the same trajectories
    go through both post-processors."""
    return convert.results_from_numpy(jax.tree_util.tree_map(np.asarray, results), device)


def _nc_read(path):
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    try:
        dims = dict(f.dimensions)
        attrs = {k: v for k, v in f._attributes.items()}
        out = {k: (v.dimensions, np.array(v.data)) for k, v in f.variables.items()}
        return dims, attrs, out
    finally:
        f.close()


def assert_arrays_close(got, ref, tol, what):
    """Equal shapes and dtypes; numbers within ``tol`` of the reference's
    largest magnitude, characters and integers equal."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (what, got.shape, ref.shape)
    if ref.dtype.kind == "f" and ref.size:
        scale = max(float(np.abs(ref).max()), 1e-300)
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale, err_msg=what)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


def assert_nc_files_match(got_path, ref_path, tol, tols=None, skip=("date_vector",)):
    """Two netCDF files: the same dimensions, attributes and variables in
    the same order, each variable within its tolerance (``tols`` by name,
    else ``tol``) of the reference's scale; ``skip`` holds the wall-clock
    stamps.  Files of named curves are held curve by curve."""
    gd, ga, gv = _nc_read(got_path)
    rd, ra, rv = _nc_read(ref_path)
    assert gd == rd, (got_path, gd, rd)
    assert {k: v for k, v in ga.items() if k not in skip} == \
        {k: v for k, v in ra.items() if k not in skip}, got_path
    assert list(gv) == list(rv), (got_path, list(gv), list(rv))
    curves = "curve" in rv and "curve_name" in rv
    for name in rv:
        if name in skip:
            continue
        assert gv[name][0] == rv[name][0], (got_path, name)
        if curves and name in ("grid", "curve"):
            continue
        assert_arrays_close(gv[name][1], rv[name][1], (tols or {}).get(name, tol),
                            f"{got_path}:{name}")
    if curves:
        from rays_tpu_torch.post.xy_curves import read_xy_curves_nc

        for g, r in zip(read_xy_curves_nc(got_path), read_xy_curves_nc(ref_path)):
            assert (g.grid_name, g.curve_name) == (r.grid_name, r.curve_name)
            assert_arrays_close(g.grid, r.grid, tol, f"{got_path}:{r.curve_name} grid")
            assert_arrays_close(g.curve, r.curve, tol, f"{got_path}:{r.curve_name}")


def assert_text_files_match(got_path, ref_path, rtol=1e-8, atol=0.0):
    """Two text files token by token: words equal, numbers within rtol of
    the larger plus atol (the last printed digit may round either way)."""
    with open(got_path) as f:
        got = f.read().split("\n")
    with open(ref_path) as f:
        ref = f.read().split("\n")
    assert len(got) == len(ref), (got_path, len(got), len(ref))
    for i, (gl, rl) in enumerate(zip(got, ref)):
        gt, rt = gl.split(), rl.split()
        assert len(gt) == len(rt), (got_path, i, gl, rl)
        for a, b in zip(gt, rt):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, (got_path, i, gl, rl)
                continue
            assert abs(fa - fb) <= rtol * max(abs(fa), abs(fb)) + atol, (got_path, i, a, b)


def run_in_dirs(tmp_path, monkeypatch, jax_fn, port_fn, inputs=None):
    """jax_fn run with tmp_path/jax as its working directory, port_fn with
    tmp_path/port, each holding the same input files (name -> text or
    bytes): (port dir, jax dir, port value, jax value)."""
    out = []
    for tag, fn in (("jax", jax_fn), ("port", port_fn)):
        d = tmp_path / tag
        d.mkdir()
        for name, data in (inputs or {}).items():
            (d / name).write_bytes(data if isinstance(data, bytes) else data.encode())
        monkeypatch.chdir(d)
        out.append(fn())
    return str(tmp_path / "port"), str(tmp_path / "jax"), out[1], out[0]


def assert_output_dirs_match(got_dir, ref_dir, tol=1e-12, tols=None, text_atol=0.0,
                             ignore=()):
    """Every file of two output directories, name by name: netCDF files by
    ``assert_nc_files_match``, the others as text.  Returns the names."""
    names = sorted(p for p in os.listdir(ref_dir) if p not in ignore)
    assert sorted(p for p in os.listdir(got_dir) if p not in ignore) == names, (
        sorted(os.listdir(got_dir)), names)
    for name in names:
        g, r = os.path.join(got_dir, name), os.path.join(ref_dir, name)
        if name.endswith(".nc"):
            assert_nc_files_match(g, r, tol, tols)
        else:
            assert_text_files_match(g, r, atol=text_atol)
    return names


def jax_trace(cfg, params, v0, st, pwr):
    """The JAX package's trace_batch, compiled."""
    from rays_tpu.tracing import trace as jtrace

    return jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))(params, v0, st, pwr)


# the damped slab example cut to 100 steps of 1 cm: the rays are absorbed
# (TOTAL_ABSORPTION) at 74-83 points instead of 293-329 points of 2.5 mm
DAMPED_SLAB_SHORT = dict(ds=1.0e-2, nstep_max=100)


def post_case(name, directory):
    """(jax cfg, params, RayResults) of a small traced case of each
    geometry: the damped slab, the Solovev fan (RK4, 60 steps), the EQDSK
    tokamak of ``write_solovev_geqdsk`` (RK4, 60 steps) and the damped
    four-coil mirror of ``write_mirror_inputs`` (100 steps)."""
    from rays_tpu.config import schema as jschema
    from rays_tpu.config.namelist import parse_namelist as jparse

    directory = str(directory)
    if name == "slab":
        cfg, params, v0, st, pwr = jax_case(jex.SLAB_ECH_DAMPED, **DAMPED_SLAB_SHORT)
    elif name == "solovev":
        cfg, params, v0, st, pwr = jax_case(jex.SOLOVEV_ECH_90GHZ, ode_solver_name="RK4_ODE",
                                            nstep_max=60)
    elif name == "eqdsk":
        from test_axisym import AXISYM_TMPL

        geqdsk = write_solovev_geqdsk(os.path.join(directory, "solovev.geqdsk"))
        cfg, params = jschema.from_namelist(jparse(AXISYM_TMPL.format(
            MAG="eqdsk_magnetics_spline_interp", EQDSK=geqdsk)))
        v0, st, pwr = jax_launch(cfg, params)
    elif name == "mirror":
        cfg, params = jschema.from_file(write_mirror_inputs(
            directory, FRF="22.e9", N0="1.0e18", DAMP="damp_fund_ECH", NSTEP=100))
        v0, st, pwr = jax_launch(cfg, params)
    else:
        raise ValueError(name)
    return cfg, params, jax_trace(cfg, params, v0, st, pwr)
