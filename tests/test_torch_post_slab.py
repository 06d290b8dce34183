"""rays_tpu_torch's slab post-processor and the standalone post-processor
(post/slab_processor.py, post/process.py) against the JAX package.  The
JAX package traces; its results (and its results files) go to both
packages, which write into directories of their own; every output file is
then compared name by name and field by field.

Tolerances: scan values, profiles, kx roots, diagnostics and deposition
profiles within 1e-12 of each variable's (each curve's) scale, n_imag
1e-10; crossing counts equal and locations within 1e-12 of the box width
(the grid spacing is 1e-3 of it); text files word for word, numbers within
1e-8 of their size plus one unit of the last printed digit of the '%.6f'
crossings (1.5e-6); the wall-clock stamps are not compared.
"""

import os

import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu import run as jrun
from rays_tpu.post import deposition as jdep
from rays_tpu.post import process as jpp
from rays_tpu.post import slab_processor as jsp
from rays_tpu.results import ascii as jascii
from rays_tpu.results.netcdf import write_results_nc
from rays_tpu_torch.post import deposition as tdep
from rays_tpu_torch.post import process as tpp
from rays_tpu_torch.post import slab_processor as tsp
from rays_tpu_torch.post.xy_curves import read_xy_curves_nc

TOL = 1e-12
TOLS = {"n_imag": 1e-10}
TEXT_ATOL = 1.5e-6
SHORT_DAMPED = jex.SLAB_ECH_DAMPED.replace("nstep_max=400, ds=2.5e-3",
                                           "nstep_max=100, ds=1.0e-2")
SHORT_90GHZ = jex.SLAB_ECH_90GHZ.replace("nstep_max=500", "nstep_max=100").replace(
    " verbosity=0,", " verbosity=0,\n write_formatted_ray_files=.true.,")


@pytest.fixture(scope="module")
def damped():
    """The damped slab at 100 steps of 1 cm: (jax cfg, params, results),
    (port cfg, params, results), the port's rindex_vec0."""
    jcfg, jparams, jres = tp.post_case("slab", ".")
    pcfg, pparams = tp.to_port(jcfg, jparams)
    pres = tp.carry_results(jres)
    return (jcfg, jparams, jres), (pcfg, pparams, pres), pres.start_ray_vec[:, 3:6] / pparams.rf.k0


def _rindex(jres, jparams):
    return np.asarray(jres.start_ray_vec[:, 3:6]) / float(jparams.rf.k0)


def test_scan_quantities_match_jax(damped):
    (jcfg, jparams, jres), (pcfg, pparams, _), rindex = damped
    xs = np.linspace(float(jparams.eq.xmin), float(jparams.eq.xmax), 257)
    nz = rindex[:, 2]
    got = tsp.scan_quantities(pcfg, pparams, torch.as_tensor(xs), nz)
    assert got.shape == (3, 257, 6)
    for i in range(3):
        ref = np.asarray(jsp.scan_quantities(jcfg, jparams, xs, float(nz[i])))
        for q, name in enumerate(tsp.SCAN_NAMES):
            tp.assert_arrays_close(got[i, :, q].numpy(), ref[:, q], TOL, f"ray {i} {name}")
    # one refractive index: the JAX function's shape
    one = tsp.scan_quantities(pcfg, pparams, torch.as_tensor(xs), nz[0])
    assert one.shape == (257, 6) and torch.equal(one, got[0])


@pytest.mark.parametrize("text", ["damped", "undamped_90GHz"])
def test_find_res_and_cuts_matches_jax(text, damped, tmp_path, monkeypatch):
    """Counts of crossings first, then their locations, then the file."""
    if text == "damped":
        (jcfg, jparams, jres), (pcfg, pparams, _), rindex = damped
        jrindex = _rindex(jres, jparams)
    else:
        jcfg, jparams, v0, _, _ = jex.setup_example(jex.SLAB_ECH_90GHZ)
        pcfg, pparams = tp.to_port(jcfg, jparams)
        jrindex = np.asarray(v0[:, 3:6]) / float(jparams.rf.k0)
        rindex = torch.as_tensor(jrindex)
    got_dir, ref_dir, got, ref = tp.run_in_dirs(
        tmp_path, monkeypatch, lambda: jsp.find_res_and_cuts(jcfg, jparams, jrindex),
        lambda: tsp.find_res_and_cuts(pcfg, pparams, rindex))
    assert len(got) == len(ref) == rindex.shape[0]
    width = float(jparams.eq.xmax) - float(jparams.eq.xmin)
    for g, r in zip(got, ref):
        assert list(g) == list(r) == list(tsp.SCAN_NAMES)
        assert [len(g[k]) for k in g] == [len(r[k]) for k in r]
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=TOL * width, err_msg=k)
    assert sum(len(v) for e in got for v in e.values()) > 0
    tp.assert_output_dirs_match(got_dir, ref_dir, text_atol=TEXT_ATOL)


def test_batched_scan_in_chunks_equals_one_pass(damped, monkeypatch):
    """All rays in one pass and in chunks of one ray give the same records."""
    _, (pcfg, pparams, _), rindex = damped
    whole = tsp.find_res_and_cuts(pcfg, pparams, rindex, write_file=False)
    monkeypatch.setattr(tsp, "CHUNK_ELEMENTS", 1)
    single = tsp.find_res_and_cuts(pcfg, pparams, rindex, write_file=False)
    for w, s in zip(whole, single):
        for k in w:
            np.testing.assert_array_equal(s[k], w[k])


@pytest.mark.parametrize("writer", ["eq_profiles", "kx_profiles", "kx_profiles_text",
                                    "graphics_description"])
def test_writers_match_jax(writer, damped, tmp_path, monkeypatch):
    (jcfg, jparams, jres), (pcfg, pparams, _), rindex = damped
    jrindex = _rindex(jres, jparams)
    calls = {
        "eq_profiles": (lambda m, c, p, r: m.write_eq_profiles(c, p, n_points=37)),
        "kx_profiles": (lambda m, c, p, r: m.write_kx_profiles(c, p, r)),
        "kx_profiles_text": (lambda m, c, p, r: m.write_kx_profiles_text(c, p, r)),
        "graphics_description": (lambda m, c, p, r: m.write_graphics_description(
            c, p, num_plot_k_vectors=7, scale_k_vec="False")),
    }[writer]
    got_dir, ref_dir, got, ref = tp.run_in_dirs(
        tmp_path, monkeypatch, lambda: calls(jsp, jcfg, jparams, jrindex),
        lambda: calls(tsp, pcfg, pparams, rindex))
    assert got == ref
    tp.assert_output_dirs_match(got_dir, ref_dir)


def test_kx_profiles_cover_every_ray_and_root(damped):
    """Four roots per ray in ray order; the minus root propagates where the
    ray was launched."""
    _, (pcfg, pparams, pres), rindex = damped
    xs, kx = tsp.kx_profiles(pcfg, pparams, rindex)
    assert kx.shape == (3, 201, 4) and xs.shape == (201,)
    i = int(np.argmin(np.abs(xs - float(pres.start_ray_vec[0, 0]))))
    assert (kx[:, i, 1] > 0).all()


def test_process_matches_jax(damped, tmp_path, monkeypatch):
    (jcfg, jparams, jres), (pcfg, pparams, pres), rindex = damped
    knobs = {"n_X": 21, "num_plot_k_vectors": 3}
    got_dir, ref_dir, got, ref = tp.run_in_dirs(
        tmp_path, monkeypatch,
        lambda: jsp.process(jcfg, jparams, jres, _rindex(jres, jparams), knobs=knobs),
        lambda: tsp.process(pcfg, pparams, pres, rindex, knobs=knobs))
    assert list(got) == list(ref)
    names = tp.assert_output_dirs_match(got_dir, ref_dir, text_atol=TEXT_ATOL)
    assert len(names) == 5


def test_processor_namelist_knobs_drive_outputs(damped, tmp_path, monkeypatch):
    """tests/test_post.py's knob test on both packages through the
    standalone post-processor (the port on --device cpu): the
    &slab_processor_list knobs reach the graphics description, n_X the
    profile grid, the file-driven gates write the diagnostics, and every
    file is the JAX package's."""
    (jcfg, _, jres), _, _ = damped
    (tmp_path / "run").mkdir()
    monkeypatch.chdir(tmp_path / "run")
    nc = write_results_nc(jcfg, jres, ray_trace_time=jrun.ray_trace_times(jres, 1.0))
    inputs = {"rays.in": SHORT_DAMPED, nc: (tmp_path / "run" / nc).read_bytes(),
              "post_process_rays.in":
                  "&post_process_list\n processor = 'slab'\n/\n"
                  "&slab_processor_list\n num_plot_k_vectors = 15\n scale_k_vec = 'False'\n"
                  " set_XY_lim = 'False'\n n_X = 33\n/\n"}
    got_dir, ref_dir, _, _ = tp.run_in_dirs(
        tmp_path, monkeypatch, lambda: jpp.main(["rays.in"]),
        lambda: tpp.main(["rays.in", "--device", "cpu"]), inputs)
    names = tp.assert_output_dirs_match(got_dir, ref_dir, tols=TOLS, text_atol=TEXT_ATOL)
    label = jcfg.run_label
    assert f"ray_detailed_diagnostics_slab.{label}.nc" in names
    assert f"deposition_profiles.{label}.nc" in names
    with open(os.path.join(got_dir, "graphics_description_slab.dat")) as f:
        gd = f.read()
    assert " num_plot_k_vectors = 15\n" in gd and " scale_k_vec = False\n" in gd
    assert " set_XY_lim = False\n" in gd
    curves = read_xy_curves_nc(os.path.join(got_dir, f"eq_X_profiles.{label}.nc"))
    assert all(c.grid.shape == (33,) for c in curves)
    # write_eq_X_profile_data=.false. suppresses the profiles
    monkeypatch.chdir(got_dir)
    os.remove(f"eq_X_profiles.{label}.nc")
    with open("post_process_rays.in", "w") as f:
        f.write("&post_process_list\n processor = 'slab'\n/\n"
                "&slab_processor_list\n write_eq_X_profile_data = .false.\n/\n")
    tpp.main(["rays.in", "--device", "cpu"])
    assert not os.path.exists(f"eq_X_profiles.{label}.nc")


def test_deposition_ld_writer_roundtrip(damped, tmp_path):
    """The list-directed deposition file of both packages, and its values
    equal to the profile computed (deposition_profiles_m.f90:296-331)."""
    (jcfg, jparams, jres), (pcfg, pparams, pres), _ = damped
    jfn = jdep.write_deposition_profiles_ld(jcfg, jparams, jres, n_bins=20,
                                            path=str(tmp_path / "jax_ld"))
    tfn = tdep.write_deposition_profiles_ld(pcfg, pparams, pres, n_bins=20,
                                            path=str(tmp_path / "port_ld"))
    # the bin edges come from two linspace implementations: an edge at 0
    # may be +-1e-17 in either
    tp.assert_text_files_match(tfn, jfn, rtol=1e-12, atol=1e-15)
    lines = [ln.strip() for ln in open(tfn)]
    assert lines[0] == "profile_name = Ptotal_x" and lines[2] == "grid_name = x"
    ref = tdep.calculate_deposition_profile(pcfg, pparams, pres, "Ptotal_x", 20,
                                            float(pparams.eq.xmin), float(pparams.eq.xmax))
    np.testing.assert_allclose([float(v) for v in lines[1].split()], ref.profile.numpy(),
                               rtol=1e-12)
    assert float(lines[5]) == pytest.approx(float(ref.profile.sum()))


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """The undamped 90 GHz slab example at 100 steps traced by the JAX
    package, and its results in the three formats the post-processor reads:
    run_results.<label>.nc, run_results.<label> and ray_out/ray_list."""
    d = tmp_path_factory.mktemp("run_files")
    (d / "rays.in").write_text(SHORT_90GHZ)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        cfg, res, wall = jrun.run("rays.in")
        times = jrun.ray_trace_times(res, wall)
        write_results_nc(cfg, res, total_trace_time=wall, ray_trace_time=times)
        jascii.write_results_ld(cfg, res, total_trace_time=wall, ray_trace_time=times)
    finally:
        os.chdir(cwd)
    assert cfg.nstep_max == 100
    return d, cfg, res


@pytest.mark.parametrize("mode", ["NC", "LD", "ASCII"])
def test_standalone_post_process_input_modes(mode, run_files, tmp_path, monkeypatch):
    """tests/test_run_io.py's input modes on both packages: the same files
    read back by each loader drive the same outputs."""
    d, cfg, res = run_files
    inputs = {p.name: p.read_bytes() for p in d.iterdir()}
    inputs["post_process_rays.in"] = (f"&post_process_list\n processor='slab', "
                                      f"ray_data_input_mode='{mode}'\n/\n")
    got_dir, ref_dir, _, _ = tp.run_in_dirs(
        tmp_path, monkeypatch, lambda: jpp.main(["rays.in"]),
        lambda: tpp.main(["rays.in", "--device", "cpu"]), inputs)
    names = tp.assert_output_dirs_match(got_dir, ref_dir, tols=TOLS, text_atol=TEXT_ATOL)
    assert f"kx_profiles_slab.{cfg.run_label}" in names
    monkeypatch.chdir(got_dir)
    load = {"NC": lambda: tpp.load_results_nc(f"run_results.{cfg.run_label}.nc"),
            "LD": lambda: tpp.load_results_ld(f"run_results.{cfg.run_label}"),
            "ASCII": lambda: tpp.load_results_ascii(cfg.run_label)}[mode]
    back = load()
    jback = {"NC": lambda: jpp.load_results_nc(f"run_results.{cfg.run_label}.nc"),
             "LD": lambda: jpp.load_results_ld(f"run_results.{cfg.run_label}"),
             "ASCII": lambda: jpp.load_results_ascii(cfg.run_label)}[mode]()
    assert back.end_ray_comp is None and jback.end_ray_comp is None   # no file holds a carry
    for name in back._fields[:-1]:
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(jback, name)), err_msg=name)
    np.testing.assert_array_equal(back.npoints.numpy(), np.asarray(res.npoints))
    np.testing.assert_array_equal(back.stop_flag.numpy(), np.asarray(res.stop_flag))
