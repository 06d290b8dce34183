"""rays_tpu_torch's CLI outputs against the JAX package's: the same input
file goes through ``python -m rays_tpu.run`` and ``python -m
rays_tpu_torch.run --device cpu`` (both called in process), and the
list-directed results file, the formatted ray files, the netCDF file and
the run log are compared name by name and field by field.

Values: npoints, flags, labels and shapes exact; trajectories to 1e-9 of
trajectory scale (the traces agree to rounding, tests/test_torch_trace.py
and tests/test_torch_adaptive.py); times and dates are the run's own and
are only checked for shape."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex, run as jrun
from rays_tpu.results import ascii as jascii
from rays_tpu.results.netcdf import read_results_nc as jread_nc
from rays_tpu.utils.diagnostics import Diagnostics as JDiagnostics
from rays_tpu_torch import examples as tex, run as trun
from rays_tpu_torch.results import ascii as tascii
from rays_tpu_torch.results.netcdf import read_results_nc as tread_nc
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.tracing.stop import StopCode, flag_string
from rays_tpu_torch.utils.diagnostics import Diagnostics as TDiagnostics

TRAJ_RTOL = 1e-9
OUTPUT_FLAGS = ("&ray_results_list\n write_results_list_directed=.true.,"
                " write_results_netcdf=.true.\n/\n")


def _with_outputs(text, verbosity=1):
    """The example with every output on and the per-ray log lines."""
    return (text.replace("verbosity=0,", f"verbosity={verbosity}, write_formatted_ray_files=.true.,")
            + OUTPUT_FLAGS)


CASES = {
    "slab": _with_outputs(jex.SLAB_ECH_90GHZ.replace("nstep_max=500", "nstep_max=30")),
    "slab_damped": _with_outputs(jex.SLAB_ECH_DAMPED.replace("nstep_max=400", "nstep_max=300")),
    "solovev": _with_outputs(jex.SOLOVEV_ECH_90GHZ),
}
LABELS = {"slab": "slab_demo", "slab_damped": "slab_damped", "solovev": "solovev_demo"}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    """Both CLIs run once on the case's input, each in its own directory."""
    name = request.param
    root = tmp_path_factory.mktemp(name)
    path = root / "rays.in"
    path.write_text(CASES[name])
    cwd = os.getcwd()
    dirs = {}
    try:
        for side, main, extra in (("jax", jrun.main, []), ("port", trun.main, ["--device", "cpu"])):
            dirs[side] = root / side
            dirs[side].mkdir()
            os.chdir(dirs[side])
            main([str(path), *extra])
    finally:
        os.chdir(cwd)
    return name, LABELS[name], dirs


def test_same_files_written(runs):
    name, label, dirs = runs
    want = {f"run_results.{label}", f"run_results.{label}.nc", f"ray_out.{label}",
            f"ray_list.{label}", f"log.RAYS.{label}"}
    assert {p.name for p in dirs["jax"].iterdir()} == want
    assert {p.name for p in dirs["port"].iterdir()} == want


def test_list_directed_file_matches_jax(runs):
    name, label, dirs = runs
    files = {side: dirs[side] / f"run_results.{label}" for side in dirs}
    # the same names in the same order, one value line after each
    lines = {side: files[side].read_text().split("\n") for side in files}
    assert lines["port"][0::2] == lines["jax"][0::2]
    assert len(lines["port"]) == len(lines["jax"])
    ref = jascii.read_results_ld(str(files["jax"]))
    got = tascii.read_results_ld(str(files["port"]))
    # either reader reads either file
    cross = jascii.read_results_ld(str(files["port"]))
    assert sorted(got) == sorted(ref) == sorted(cross)
    for k in ref:
        if k in ("total_trace_time", "ray_trace_time"):
            assert np.shape(got[k]) == np.shape(ref[k]), k
        elif k in ("ray_vec", "start_ray_vec", "end_ray_vec"):
            assert got[k].shape == ref[k].shape, k
            axis = 1 if k == "ray_vec" else -1
            tp.assert_scaled_close(got[k], ref[k], TRAJ_RTOL, axis=axis, what=k)
            if ref[k].shape[-1] > 7:       # absorption slots
                np.testing.assert_allclose(got[k][..., 7:], ref[k][..., 7:], rtol=0, atol=1e-9)
            np.testing.assert_array_equal(cross[k], got[k])
        elif k in ("residual", "end_residuals", "max_residuals"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-12, err_msg=k)
        elif isinstance(ref[k], np.ndarray) and ref[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)
        else:
            assert np.all(np.asarray(got[k]) == np.asarray(ref[k])), k
    assert got["RAYS_run_label"] == label
    assert got["ray_vec"].shape == (got["number_of_rays"], got["max_number_of_points"],
                                    got["dim_v_vector"])


def test_formatted_ray_files_match_jax(runs):
    name, label, dirs = runs
    ref = jascii.read_ray_data(label, str(dirs["jax"]))
    got = tascii.read_ray_data(label, str(dirs["port"]))
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["npoints"], ref["npoints"])
    np.testing.assert_array_equal(got["npoints_declared"], ref["npoints_declared"])
    assert got["ray_stop_flag"] == ref["ray_stop_flag"]
    np.testing.assert_allclose(got["end_residuals"], ref["end_residuals"], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got["s_vec"], ref["s_vec"], rtol=1e-15)
    assert got["v_vec"].shape == ref["v_vec"].shape
    tp.assert_scaled_close(got["v_vec"], ref["v_vec"], TRAJ_RTOL, axis=1, what="ray_out")
    # the header lines of ray_list: ray count and vector length
    head = {s: (dirs[s] / f"ray_list.{label}").read_text().split("\n")[:3] for s in dirs}
    assert head["port"] == head["jax"]
    # the stream holds what the list-directed file holds
    ld = tascii.read_results_ld(str(dirs["port"] / f"run_results.{label}"))
    np.testing.assert_array_equal(got["v_vec"], ld["ray_vec"])


def test_netcdf_matches_jax(runs):
    name, label, dirs = runs
    ref = jread_nc(str(dirs["jax"] / f"run_results.{label}.nc"))
    got = tread_nc(str(dirs["port"] / f"run_results.{label}.nc"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k not in ("date_vector", "RAYS_run_label"):
            assert np.shape(got[k]) == np.shape(ref[k]) and got[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(got["npoints"], ref["npoints"])
    np.testing.assert_array_equal(got["ray_stop_flag"], ref["ray_stop_flag"])
    tp.assert_scaled_close(got["ray_vec"], ref["ray_vec"], TRAJ_RTOL, axis=1, what="netCDF")
    ld = tascii.read_results_ld(str(dirs["port"] / f"run_results.{label}"))
    np.testing.assert_array_equal(got["ray_vec"], ld["ray_vec"])
    np.testing.assert_array_equal(got["npoints"], ld["npoints"])


def _log_lines(path):
    """(text before ' = ', value) per line; lines without a value whole."""
    out = []
    for line in path.read_text().split("\n"):
        key, sep, val = line.partition(" = ")
        out.append((key, val if sep else None))
    return out


def test_run_log_matches_jax(runs):
    """The same lines in the same order: the echoed namelist groups, the
    run's head, per-ray npoints, flags and times at verbosity 1, what was
    written.  Times are the run's own; the first message names the package."""
    name, label, dirs = runs
    ref = _log_lines(dirs["jax"] / f"log.RAYS.{label}")
    got = _log_lines(dirs["port"] / f"log.RAYS.{label}")
    assert len(got) == len(ref)
    timed = 0
    for (gk, gv), (rk, rv) in zip(got, ref):
        if rk == " rays_tpu run":
            assert gk == " rays_tpu_torch run" and gv == rv == label
        elif "time" in rk.lower():
            assert gk == rk and float(gv) >= 0.0
            timed += 1
        elif rk == " max dispersion residual":
            assert gk == rk
            np.testing.assert_allclose(float(gv), float(rv), rtol=1e-6, atol=1e-12)
        else:
            assert (gk, gv) == (rk, rv)
    nray = int(dict(got)[" number of rays"])
    assert timed == nray + 2
    keys = [k for k, _ in got]
    for want in (" &diagnostics_list", " nv", " ray 1: npoints", " ray 1: stop flag",
                 " wrote formatted ray files", " wrote results", " Wall time total (s)"):
        assert want in keys, want
    assert keys.count(" wrote results") == 2


def test_solovev_cli_matches_library(tmp_path, monkeypatch):
    """The CLI's Solovev run, as shipped plus --netcdf, holds what
    trace_rays gives on the example."""
    path = tmp_path / "solovev.in"
    path.write_text(tex.SOLOVEV_ECH_90GHZ)
    monkeypatch.chdir(tmp_path)
    trun.main([str(path), "--netcdf", "--device", "cpu"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "log.RAYS.solovev_demo", "run_results.solovev_demo.nc", "solovev.in"]
    cfg, params, v0, st, pwr = tex.setup_example(tex.SOLOVEV_ECH_90GHZ, device="cpu")
    res = ttrace.trace_rays(cfg, params, v0, st, pwr)
    nc = tread_nc(str(tmp_path / "run_results.solovev_demo.nc"))
    assert nc["npoints"].tolist() == res.npoints.tolist() == [201] * 5
    flags = {row.tobytes().decode().strip() for row in nc["ray_stop_flag"]}
    assert flags == {flag_string(int(StopCode.NSTEP_MAX)).strip()}
    np.testing.assert_array_equal(nc["ray_vec"], res.ray_vec.numpy())


def test_no_log_and_forced_netcdf(tmp_path, monkeypatch):
    """--no-log writes no log; --netcdf writes the netCDF file though the
    namelist does not ask; nothing else appears."""
    path = tmp_path / "rays.in"
    path.write_text(tex.SLAB_ECH_90GHZ.replace("nstep_max=500", "nstep_max=5"))
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.chdir(out)
    trun.main([str(path), "--device", "cpu", "--no-log"])
    assert not list(out.iterdir())
    trun.main([str(path), "--device", "cpu", "--no-log", "--netcdf"])
    assert [p.name for p in out.iterdir()] == ["run_results.slab_demo.nc"]
    trun.main([str(path), "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == ["log.RAYS.slab_demo",
                                                     "run_results.slab_demo.nc"]


def test_formatted_files_need_the_trajectory(tmp_path, monkeypatch):
    """Without the saved trajectory the formatted writer raises, and run()
    warns and skips it, as the JAX package does."""
    cfg, params, v0, st, pwr = tex.setup_example(
        tex.SLAB_ECH_90GHZ.replace("nstep_max=500", "nstep_max=5"), device="cpu")
    res = ttrace.trace_rays(dataclasses.replace(cfg, save_trajectory=False), params, v0, st, pwr)
    with pytest.raises(ValueError, match="save_trajectory"):
        tascii.write_formatted_ray_files(cfg, res, directory=str(tmp_path))
    # a truncated stream (a crashed run) reads back as far as it got
    full = ttrace.trace_rays(cfg, params, v0, st, pwr)
    out_p, _ = tascii.write_formatted_ray_files(cfg, full, directory=str(tmp_path),
                                                ds=float(params.ode.ds))
    lines = open(out_p).read().split("\n")
    open(out_p, "w").write("\n".join(lines[:8]) + "\n")
    back = tascii.read_ray_data(cfg.run_label, str(tmp_path))
    assert back["npoints"].tolist() == [6, 2, 0] and back["npoints_declared"].tolist() == [6] * 3


@pytest.mark.parametrize("verbosity,stdout", [(0, False), (1, True), (-1, False)])
def test_diagnostics_matches_jax(tmp_path, monkeypatch, capsys, verbosity, stdout):
    """The Diagnostics copy writes what the JAX package's class writes."""
    nml = {"diagnostics_list": {"run_label": "x", "verbosity": verbosity},
           "rf_list": {"frf": 9.0e10, "wave_mode": "minus"}}
    texts = {}
    for side, cls in (("jax", JDiagnostics), ("port", TDiagnostics)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        diag = cls(run_label="x", verbosity=verbosity, messages_to_stdout=stdout)
        diag.echo_namelists(nml)
        diag.message("always", 1, threshold=0)
        diag.message("detail", [1, 2], threshold=1)
        diag.message("bare", threshold=verbosity)
        assert diag.finalize() == "log.RAYS.x"
        assert sorted(p.name for p in d.iterdir()) == ["log.RAYS.x"]
        texts[side] = [ln for ln in (d / "log.RAYS.x").read_text().split("\n")
                       if "Wall time" not in ln]
        printed = capsys.readouterr().out
        assert bool(printed) == stdout
    assert texts["port"] == texts["jax"]
    assert (" detail = [1, 2]" in texts["port"]) == (verbosity >= 1)


def test_results_on_another_dtype_write_the_same_schema(tmp_path):
    """float32 results go through the writers: values rounded once."""
    cfg, params, v0, st, pwr = tex.setup_example(
        tex.SLAB_ECH_90GHZ.replace("nstep_max=500", "nstep_max=5"), device="cpu",
        dtype=torch.float32)
    res = ttrace.trace_rays(cfg, params, v0, st, pwr)
    fn = tascii.write_results_ld(cfg, res, total_trace_time=1.5, path=str(tmp_path / "r"),
                                 ray_trace_time=np.array([0.5, 0.5, 0.5]))
    back = tascii.read_results_ld(fn)
    assert back["total_trace_time"] == 1.5 and back["ray_trace_time"].tolist() == [0.5] * 3
    np.testing.assert_array_equal(back["ray_vec"], res.ray_vec.double().numpy())
