"""rays_tpu_torch's mirror post-processor and O-X conversion analysis
(post/mirror_processor.py, post/ox_conversion.py) against the JAX package.

The mirror is the four-coil cell of ``write_mirror_inputs`` (the MPEX files
of tests/test_post.py are not in the repository), at the second harmonic
(56 GHz, no damping) for the geometry files and at the fundamental
(22 GHz, damped, 100 steps) for traced rays; the JAX tables and
trajectories are carried across.  O-X also runs on the analytic slab of
tests/test_ox.py against its NumPy closed form and JAX.

Tolerances: grids, contours and profiles within 1e-12 of each variable's
(each curve's) scale; bisection roots within 1e-12 of their bracket; the
O-X cutoff point within 1e-12 of its scale and the coefficient within
1e-10 (the Newton steps divide by |grad alpha|^2); the coefficient against
the closed form at tests/test_ox.py's rtol of 2e-5; text files word for
word, numbers within 1e-8 of their size.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.config import schema as jschema
from rays_tpu.config.namelist import parse_namelist as jparse
from rays_tpu.post import mirror_processor as jmp
from rays_tpu.post import ox_conversion as jox
from rays_tpu.post import process as jpp
from rays_tpu.results.netcdf import write_results_nc
from rays_tpu_torch.post import mirror_processor as tmp_
from rays_tpu_torch.post import ox_conversion as tox
from rays_tpu_torch.post import process as tpp
from test_ox import OX_SLAB, _analytic, _synthetic_results

TOL = 1e-12


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    """The 56 GHz mirror: its directory, (jax cfg, params), (port cfg,
    params)."""
    d = tmp_path_factory.mktemp("mirror")
    jcfg, jparams = jschema.from_file(tp.write_mirror_inputs(d))
    return d, (jcfg, jparams), tp.to_port(jcfg, jparams)


@pytest.fixture(scope="module")
def damped(tmp_path_factory):
    """The damped 22 GHz mirror traced by JAX, carried across."""
    d = tmp_path_factory.mktemp("damped_mirror")
    jcfg, jparams, jres = tp.post_case("mirror", d)
    pcfg, pparams = tp.to_port(jcfg, jparams)
    return d, (jcfg, jparams, jres), (pcfg, pparams, tp.carry_results(jres))


def test_eq_contours_schema_and_values(mirror, tmp_path, monkeypatch):
    """tests/test_post.py's schema test on the port's file, and the file
    equal to the JAX package's."""
    from scipy.io import netcdf_file

    _, (jcfg, jparams), (pcfg, pparams) = mirror
    got_dir, ref_dir, got, _ = tp.run_in_dirs(
        tmp_path, monkeypatch, lambda: jmp.write_eq_contours(jcfg, jparams, n_x=21, n_z=31),
        lambda: tmp_.write_eq_contours(pcfg, pparams, n_x=21, n_z=31))
    tp.assert_output_dirs_match(got_dir, ref_dir)
    f = netcdf_file(f"{got_dir}/{got}", "r", mmap=False)
    try:
        aphin = np.array(f.variables["AphiN"][:])
        gam = np.array(f.variables["gamma_array"][:])
        wpn = np.array(f.variables["omega_pN_array"][:])
        assert aphin.shape == (21, 31) and gam.shape == wpn.shape == (pcfg.ns, 21, 31)
        assert f.variables["X"].shape == (21,) and f.variables["Z"].shape == (31,)
        np.testing.assert_allclose(aphin, aphin[::-1, :], atol=1e-10)
        assert (gam >= 0).all() and (wpn >= 0).all()
        # second-harmonic ECH: electron gamma crosses 1/2 in the cell
        assert gam[0].min() < 0.5 < gam[0].max()
    finally:
        f.close()


@pytest.mark.parametrize("z_reference", [1.0, 2.0])
def test_radial_profiles_match_jax(mirror, z_reference, tmp_path, monkeypatch):
    _, (jcfg, jparams), (pcfg, pparams) = mirror
    got_dir, ref_dir, _, _ = tp.run_in_dirs(
        tmp_path, monkeypatch,
        lambda: jmp.write_radial_profiles(jcfg, jparams, z_reference, n_points=17),
        lambda: tmp_.write_radial_profiles(pcfg, pparams, z_reference, n_points=17))
    tp.assert_output_dirs_match(got_dir, ref_dir)
    from rays_tpu_torch.post.xy_curves import read_xy_curves_nc

    curves = read_xy_curves_nc(f"{got_dir}/eq_radial_profiles.{pcfg.run_label}.nc")
    assert len(curves) == 8 and curves[0].curve_name == "R"
    # R(AphiN) increases; at AphiN = 0 the bracket [0, box_rmax] holds no
    # sign change (AphiN > 0 off the axis guard), and the bisection ends
    # at box_rmax in both packages
    assert np.all(np.diff(curves[0].curve[1:]) > 0)
    assert curves[0].curve[0] == float(pparams.eq.box_rmax)


@pytest.mark.parametrize("z_reference", [1.0, 2.0, 3.9])
@pytest.mark.parametrize("n0", ["1.0e18", "2.0e19"])
def test_r_omode_cutoff_matches_jax(mirror, n0, z_reference):
    """At 22 GHz the O-mode cutoff density is 6e18 m^-3: none at 1e18 (0),
    the bisection's root at 2e19, in both packages."""
    d, _, _ = mirror
    jcfg, jparams = jschema.from_file(tp.write_mirror_namelist(
        d, name=f"omode_{n0}.in", N0=n0, FRF="22.e9"))
    pcfg, pparams = tp.to_port(jcfg, jparams)
    ref = jmp.r_omode_cutoff(jcfg, jparams, z_reference)
    got = tmp_.r_omode_cutoff(pcfg, pparams, z_reference)
    assert abs(got - ref) <= TOL * float(jparams.eq.box_rmax), (got, ref)
    if n0 == "1.0e18":
        assert got == ref == 0.0


def test_processor_knobs_match_jax(mirror, tmp_path, monkeypatch):
    """tests/test_post.py's knob test on both packages: the grid and gate
    knobs of &mirror_processor_list, and every file equal."""
    from scipy.io import netcdf_file

    _, (jcfg, jparams), (pcfg, pparams) = mirror
    knobs = {"n_pointsx_eq": 9, "n_pointsz_eq": 11, "write_eq_radial_profile_data": False,
             "num_plot_k_vectors": 3, "z_reference": 1.25}
    got_dir, ref_dir, got, ref = tp.run_in_dirs(
        tmp_path, monkeypatch,
        lambda: jmp.process(jcfg, jparams, None, do_ox_analysis=False, knobs=knobs),
        lambda: tmp_.process(pcfg, pparams, None, do_ox_analysis=False, knobs=knobs))
    assert got == ref and "radial_profiles" not in got
    tp.assert_output_dirs_match(got_dir, ref_dir)
    f = netcdf_file(f"{got_dir}/{got['eq_contours']}", "r", mmap=False)
    try:
        assert np.array(f.variables["AphiN"][:]).shape == (9, 11)
    finally:
        f.close()
    with open(f"{got_dir}/graphics_description_mirror.dat") as f:
        gd = f.read()
    assert " num_plot_k_vectors = 3\n" in gd and " z_reference = 1.25\n" in gd


def test_process_with_diagnostics_and_ox_matches_jax(damped, tmp_path, monkeypatch):
    _, (jcfg, jparams, jres), (pcfg, pparams, pres) = damped
    got_dir, ref_dir, got, ref = tp.run_in_dirs(
        tmp_path, monkeypatch,
        lambda: jmp.process(jcfg, jparams, jres, calculate_ray_diag=True),
        lambda: tmp_.process(pcfg, pparams, pres, calculate_ray_diag=True))
    assert got == ref
    names = tp.assert_output_dirs_match(got_dir, ref_dir, tols={"n_imag": 1e-10})
    assert f"OX_conversion.{pcfg.run_label}" in names
    assert f"ray_detailed_diagnostics.{pcfg.run_label}.nc" in names


def test_standalone_post_process_matches_jax(damped, tmp_path, monkeypatch):
    """The mirror through ``main`` in both packages (the port on --device
    cpu): geometry files, diagnostics, O-X and the AphiN deposition."""
    d, (jcfg, _, jres), _ = damped
    monkeypatch.chdir(d)
    nc = write_results_nc(jcfg, jres)
    inputs = {p.name: p.read_bytes() for p in d.iterdir()}
    inputs["post_process_rays.in"] = (
        b"&post_process_list\n z_reference=1.8\n/\n"
        b"&mirror_processor_list\n N_pointsX_eq=7, N_pointsZ_eq=9, n_AphiN=11\n/\n")
    got_dir, ref_dir, _, _ = tp.run_in_dirs(tmp_path, monkeypatch, lambda: jpp.main(["rays.in"]),
                                      lambda: tpp.main(["rays.in", "--device", "cpu"]), inputs)
    names = tp.assert_output_dirs_match(got_dir, ref_dir, tols={"n_imag": 1e-10})
    assert nc in names and f"deposition_profiles.{jcfg.run_label}.nc" in names


# --------------------------------------------------------------------------
# O-X conversion
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ox_case():
    jcfg, jparams = jschema.from_namelist(jparse(OX_SLAB))
    return (jcfg, jparams), tp.to_port(jcfg, jparams)


def test_newton_finds_cutoff(ox_case):
    """tests/test_ox.py's analytic cutoff x = Ln (1/alpha0 - 1), from a
    batch of starting points, against JAX's point by point."""
    (jcfg, jparams), (pcfg, pparams) = ox_case
    a = _analytic(jcfg, jparams)
    x0 = np.array([[0.0, 0.0, 0.0], [-0.2, 0.1, 0.3], [0.05, -0.02, 0.0]])
    x_cut, ok = tox._find_cutoff_point(pcfg, pparams, torch.as_tensor(x0))
    assert ok.all()
    np.testing.assert_allclose(x_cut[:, 0].numpy(), a["x_cut"], rtol=1e-6)
    np.testing.assert_allclose(x_cut[:, 1:].numpy(), x0[:, 1:], atol=1e-12)
    for i in range(3):
        jx, jok = jox._find_cutoff_point(jcfg, jparams, jnp.asarray(x0[i]))
        assert bool(jok)
        np.testing.assert_allclose(x_cut[i].numpy(), np.asarray(jx), rtol=0, atol=TOL)


def test_conv_coeff_matches_numpy_and_jax(ox_case):
    (jcfg, jparams), (pcfg, pparams) = ox_case
    a = _analytic(jcfg, jparams)
    g = a["gamma"]
    F = 0.5 * (1.0 + g) * math.sqrt(g) / 0.5**1.5
    G = 0.5 * math.sqrt(g) / math.sqrt(0.5)
    launches = [(a["n_crit"], 0.0), (a["n_crit"] - 0.05, 0.0), (a["n_crit"] + 0.03, 0.01),
                (a["n_crit"], 0.02), (0.0, 0.0)]
    k_max = np.array([[0.1 * a["k0"], ny * a["k0"], nz * a["k0"]] for nz, ny in launches])
    x_cut = np.tile([a["x_cut"], 0.0, 0.0], (len(launches), 1))
    x_max = x_cut - [0.05, 0.0, 0.0]
    got = tox._conv_coeff(pcfg, pparams, torch.as_tensor(x_max), torch.as_tensor(k_max),
                          torch.as_tensor(x_cut)).numpy()
    for i, (nz, ny) in enumerate(launches):
        want = math.exp(-math.pi * a["k0"] * a["L"]
                        * (F * (abs(nz) - a["n_crit"]) ** 2 + G * ny**2))
        np.testing.assert_allclose(got[i], want, rtol=2e-5, err_msg=f"nz={nz} ny={ny}")
        ref = float(jox._conv_coeff(jcfg, jparams, jnp.asarray(x_max[i]),
                                    jnp.asarray(k_max[i]), jnp.asarray(x_cut[i])))
        np.testing.assert_allclose(got[i], ref, rtol=1e-10)


def test_branches_and_file_match_jax(ox_case, tmp_path):
    """Converting, non-converting (large ny) and monotonic (no interior
    maximum) rays, in one batch and one at a time, and the file."""
    (jcfg, jparams), (pcfg, pparams) = ox_case
    a = _analytic(jcfg, jparams)
    conv = _synthetic_results(jcfg, jparams, [0.0, 0.0, a["n_crit"] * a["k0"]])
    bad = _synthetic_results(jcfg, jparams, [0.0, 0.3 * a["k0"], 0.0])
    ray_vec = np.zeros((1, 41, jcfg.nv))
    ray_vec[0, :, 0] = np.linspace(-0.3, 0.05, 41)
    mono = conv._replace(ray_vec=jnp.asarray(ray_vec))
    for res, n_conv in ((conv, 1), (bad, 0), (mono, 0)):
        assert len(tox.ox_conv_analysis(pcfg, pparams, tp.carry_results(res))) == n_conv
    # the three rays as one batch, each ray a record or none, in ray order
    batch = conv._replace(**{f: jnp.concatenate([getattr(r, f) for r in (bad, conv, mono, conv)])
                             for f in ("ray_vec", "residual", "npoints", "stop_flag",
                                       "initial_ray_power", "end_residuals", "max_residuals",
                                       "end_ray_parameter", "start_ray_vec", "end_ray_vec")})
    ref = jox.ox_conv_analysis(jcfg, jparams, batch)
    got = tox.ox_conv_analysis(pcfg, pparams, tp.carry_results(batch))
    assert [c.ray_number for c in got] == [c.ray_number for c in ref] == [2, 4]
    for g, r in zip(got, ref):
        assert g.step_number == r.step_number and 0 < g.step_number < 40
        assert g.alpha_max == r.alpha_max and g.conv_coeff > 0.99
        np.testing.assert_array_equal(g.x_max, r.x_max)
        np.testing.assert_array_equal(g.k_max, r.k_max)
        np.testing.assert_allclose(g.x_cut, r.x_cut, rtol=0, atol=TOL)
        np.testing.assert_allclose(g.conv_coeff, r.conv_coeff, rtol=1e-10)
    tp.assert_text_files_match(
        tox.write_ox_conversion_data(got, "ox", path=str(tmp_path / "port")),
        jox.write_ox_conversion_data(ref, "ox", path=str(tmp_path / "jax")))
    assert "number_of_rays_converted = 2" in open(tmp_path / "port").read()


def test_ox_on_mirror_trajectories_matches_jax(damped):
    """Every ray of the traced mirror: the maxima of alpha along it, and
    the records (none or some, as the JAX package finds)."""
    _, (jcfg, jparams, jres), (pcfg, pparams, pres) = damped
    step, amax = tox.alpha_maxima(pcfg, pparams, pres)
    alpha_along = jax.jit(jax.vmap(lambda x: jox._alpha_e(jcfg, jparams, x)))
    for i in range(pres.npoints.shape[0]):
        ja = np.asarray(alpha_along(jres.ray_vec[i, :int(pres.npoints[i]), 0:3]))
        assert int(step[i]) == int(np.argmax(ja))
        np.testing.assert_allclose(float(amax[i]), ja.max(), rtol=1e-13)
    ref = jox.ox_conv_analysis(jcfg, jparams, jres)
    got = tox.ox_conv_analysis(pcfg, pparams, pres)
    assert [(c.ray_number, c.step_number) for c in got] == \
        [(c.ray_number, c.step_number) for c in ref]
