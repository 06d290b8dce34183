"""rays_tpu_torch's toroid post-processor (post/toroid_processor.py)
against the JAX package, on the Solovev tokamak, the axisymmetric toroid
with Solovev magnetics and the EQDSK tokamak of the G-EQDSK file that
``write_solovev_geqdsk`` writes (the JAX tables carried across).  Each
package writes into a directory of its own and every file is compared
name by name and field by field, then the standalone post-processor runs
on a traced Solovev fan in both packages.

Tolerances: the plasma boundary within 1e-12 of the bisection bracket
(3 m; the two packages may round psiN differently at the root); grids,
contours and profiles within 1e-12 of each variable's (each curve's)
scale; text files word for word, numbers within 1e-8 of their size.
"""

import os

import numpy as np
import pytest

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.config import schema as jschema
from rays_tpu.config.namelist import parse_namelist as jparse
from rays_tpu.post import process as jpp
from rays_tpu.post import toroid_processor as jtp
from rays_tpu.results.netcdf import write_results_nc
from rays_tpu_torch.post import process as tpp
from rays_tpu_torch.post import toroid_processor as ttp
from test_axisym import AXISYM_TMPL

TOL = 1e-12
R_MAX = 3.0
GEOMETRIES = ["solovev", "axisym_solovev", "eqdsk"]


@pytest.fixture(scope="module")
def eqdsk_file(tmp_path_factory):
    return tp.write_solovev_geqdsk(tmp_path_factory.mktemp("eqdsk") / "solovev.geqdsk")


def _text(name, eqdsk_file):
    if name == "solovev":
        return jex.SOLOVEV_ECH_90GHZ
    mag = "solovev_magnetics" if name == "axisym_solovev" else "eqdsk_magnetics_spline_interp"
    return AXISYM_TMPL.format(MAG=mag, EQDSK=eqdsk_file)


@pytest.fixture(scope="module", params=GEOMETRIES)
def case(request, eqdsk_file):
    jcfg, jparams = jschema.from_namelist(jparse(_text(request.param, eqdsk_file)))
    return request.param, (jcfg, jparams), tp.to_port(jcfg, jparams)


@pytest.mark.parametrize("n_theta, eps", [(64, 1e-6), (7, 1e-3)])
def test_plasma_boundary_matches_jax(case, n_theta, eps):
    name, (jcfg, jparams), (pcfg, pparams) = case
    jr, jz, jok = jtp.find_plasma_boundary(jcfg, jparams, n_theta=n_theta, eps=eps)
    tr, tz, tok = ttp.find_plasma_boundary(pcfg, pparams, n_theta=n_theta, eps=eps)
    np.testing.assert_array_equal(tok, np.asarray(jok))
    # the EQDSK axis guess is the middle of the file's box, from which some
    # directions cross no psiN = 1 before r_max (ok False in both)
    assert tok.all() or (name == "eqdsk" and tok.any())
    np.testing.assert_allclose(tr, jr, rtol=0, atol=TOL * R_MAX)
    np.testing.assert_allclose(tz, jz, rtol=0, atol=TOL * R_MAX)
    if name != "eqdsk":  # the outer midplane crossing is the Solovev outer bound
        np.testing.assert_allclose(tr.max(), 1.55, atol=1e-9)


WRITERS = {
    "eq_contour_grids": lambda m, c, p: m.write_eq_contour_grids(c, p, n_r=17, n_z=23),
    "eq_contours": lambda m, c, p: m.write_eq_contours(c, p, n_r=17, n_z=23),
    "normalized_psi": lambda m, c, p: m.write_normalized_psi_nc(c, p, n_r=17, n_z=23),
    "radial_profiles": lambda m, c, p: m.write_radial_profiles(c, p, n_points=29),
    "graphics_description": lambda m, c, p: m.write_graphics_description(
        c, p, num_plot_k_vectors=4, bisection_eps=1e-5),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_writers_match_jax(case, writer, tmp_path, monkeypatch):
    _, (jcfg, jparams), (pcfg, pparams) = case
    got_dir, ref_dir, got, ref = tp.run_in_dirs(tmp_path, monkeypatch,
                                          lambda: WRITERS[writer](jtp, jcfg, jparams),
                                          lambda: WRITERS[writer](ttp, pcfg, pparams))
    assert got == ref
    tp.assert_output_dirs_match(got_dir, ref_dir)


def test_process_and_knobs_match_jax(case, tmp_path, monkeypatch):
    """process() with the grid and gate knobs of the namelist group."""
    name, (jcfg, jparams), (pcfg, pparams) = case
    knobs = {"N_pointsR_eq": 13, "n_pointsz_eq": 15, "n_psiN": 21, "bisection_eps": 1e-7,
             "write_contour_data": name != "eqdsk", "scale_k_vec": "False"}
    got_dir, ref_dir, got, ref = tp.run_in_dirs(
        tmp_path, monkeypatch, lambda: jtp.process(jcfg, jparams, None, knobs=knobs),
        lambda: ttp.process(pcfg, pparams, None, knobs=knobs))
    assert list(got) == list(ref)
    np.testing.assert_allclose(got["boundary"][0], ref["boundary"][0], rtol=0,
                               atol=TOL * R_MAX)
    names = tp.assert_output_dirs_match(got_dir, ref_dir)
    assert (f"eq_RZ_grids.{pcfg.run_label}.nc" in names) == (name != "eqdsk")
    gd = "graphics_description_solovev.dat" if name == "solovev" else \
        "graphics_description_axisym_toroid.dat"
    assert gd in names


@pytest.mark.parametrize("name", ["solovev", "eqdsk"])
def test_standalone_post_process_matches_jax(name, eqdsk_file, tmp_path, monkeypatch):
    """The toroid processor through ``main`` in both packages (the port on
    --device cpu) on a traced fan: the geometry files and the ray
    diagnostics the file-driven gate asks for."""
    jcfg, jparams, jres = tp.post_case(name, tmp_path)
    (tmp_path / "run").mkdir()
    monkeypatch.chdir(tmp_path / "run")
    nc = write_results_nc(jcfg, jres)
    text = jex.SOLOVEV_ECH_90GHZ if name == "solovev" else _text("eqdsk", eqdsk_file)
    inputs = {"rays.in": text.encode(), nc: (tmp_path / "run" / nc).read_bytes(),
              "post_process_rays.in": (
                  f"&post_process_list\n/\n&{jpp.PROCESSOR_GROUP[jcfg.equilib_model]}\n"
                  " N_pointsR_eq=11, N_pointsZ_eq=9, n_psiN=15\n/\n").encode()}
    got_dir, ref_dir, _, _ = tp.run_in_dirs(tmp_path, monkeypatch, lambda: jpp.main(["rays.in"]),
                                      lambda: tpp.main(["rays.in", "--device", "cpu"]), inputs)
    names = tp.assert_output_dirs_match(got_dir, ref_dir)
    assert f"ray_detailed_diagnostics.{jcfg.run_label}.nc" in names
    assert f"normalized_psi.{jcfg.run_label}.nc" in names
    assert tpp.PROCESSOR_GROUP == jpp.PROCESSOR_GROUP
    assert os.path.exists(os.path.join(got_dir, f"eq_contours.{jcfg.run_label}.nc"))
