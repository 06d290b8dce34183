"""rays_tpu_torch's end-to-end pipeline, netCDF4 shim and documentation
extractor against the JAX package's (``utils/erays.py``,
``compat/netCDF4.py``, ``utils/doc_modules.py``).

* The shim reads the port's run_results file exactly as scipy does.
* ``run_pipeline`` (trace -> netCDF -> post-process -> plot -> run log) on
  the damped slab cut to 100 steps of 1 cm writes the files that the JAX
  package's ``run_pipeline`` writes from the same namelist, each traced by
  its own package: netCDF and text files equal to 1e-9 of each variable's
  scale (the two traces agree to rounding; tests/test_torch_trace.py),
  stop flags, labels and shapes exact; the dispersion residuals, which
  are rounding noise here, within 1e-12; wall times and dates are each
  run's own and are checked for shape only.
* ``NAMELIST_CATALOG`` and ``accepted_namelist_groups()`` equal the JAX
  package's, and the catalog cannot drift from what the importers read.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import netcdf_file

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.results.netcdf import read_results_nc as jread_nc
from rays_tpu.utils import doc_modules as jdoc, erays as jerays
from rays_tpu_torch import examples as tex
from rays_tpu_torch.compat import netCDF4 as shim
from rays_tpu_torch.results.netcdf import read_results_nc as tread_nc, write_results_nc
from rays_tpu_torch.tracing.trace import trace_rays
from rays_tpu_torch.utils import doc_modules as tdoc, erays as terays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
DAMPED_SHORT = jex.SLAB_ECH_DAMPED.replace("nstep_max=400, ds=2.5e-3",
                                           "nstep_max=100, ds=1.0e-2")
TIMES = ("total_trace_time", "ray_trace_time")
# the dispersion residuals of the damped slab are rounding noise (~1e-16):
# held absolutely, far under the physics bar of 1e-6
RESID_ATOL = 1e-12


def test_shim_reads_port_netcdf_as_scipy_does(tmp_path):
    cfg, params, v0, st, pwr = tex.setup_example(tex.SLAB_ECH_DAMPED, device="cpu")
    res = trace_rays(cfg, params, v0, st, pwr)
    path = write_results_nc(cfg, res, total_trace_time=1.5, path=str(tmp_path / "r.nc"))
    ds = shim.Dataset(path)
    ref = netcdf_file(path, "r", mmap=False)
    try:
        assert {k: len(d) for k, d in ds.dimensions.items()} == dict(ref.dimensions)
        assert ds.ncattrs() == list(ref._attributes)
        assert ds.RAYS_run_label == "slab_damped" == ds.getncattr("RAYS_run_label")
        assert list(ds.variables) == list(ref.variables)
        for name, var in ref.variables.items():
            got = ds.variables[name]
            assert got.shape == var.shape and got.dimensions == var.dimensions, name
            want = np.asarray(var[:] if var.shape else var.getValue())
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
            if want.dtype.kind == "S" and want.ndim == 2:
                # a row of a char matrix comes back as bytes, as netCDF4 gives it
                assert got[0] == want[0].tobytes()
        np.testing.assert_array_equal(ds.variables["npoints"][:], res.npoints.numpy())
    finally:
        ds.close()
        ref.close()


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both pipelines on the same namelist, each in its own directory."""
    root = tmp_path_factory.mktemp("erays")
    cwd = os.getcwd()
    outs = {}
    try:
        for side, fn in (("jax", lambda: jerays.run_pipeline("rays.in", plots=True)),
                         ("port", lambda: terays.run_pipeline("rays.in", plots=True,
                                                              device="cpu"))):
            d = root / side
            d.mkdir()
            (d / "rays.in").write_text(DAMPED_SHORT)
            os.chdir(d)
            outs[side] = fn()
    finally:
        os.chdir(cwd)
    return root, outs


def test_run_pipeline_writes_the_same_files(pipelines):
    root, outs = pipelines
    label = "slab_damped"
    got, ref = root / "port", root / "jax"
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    assert set(outs["port"]) == set(outs["jax"])
    assert sorted(outs["port"]["post"]) == sorted(outs["jax"]["post"])
    # the post-processor's files, name by name
    special = {f"run_results.{label}.nc", f"log.RAYS.{label}", f"rays_{label}.png", "rays.in"}
    names = tp.assert_output_dirs_match(str(got), str(ref), tol=TOL, ignore=special)
    assert f"deposition_profiles.{label}.nc" in names and f"res_and_cut.{label}" in names
    # the run's results file: every variable but the run's own times
    g, r = tread_nc(str(got / f"run_results.{label}.nc")), jread_nc(str(ref / f"run_results.{label}.nc"))
    assert sorted(g) == sorted(r)
    for k in r:
        if k in TIMES + ("date_vector",):
            assert np.shape(g[k]) == np.shape(r[k]), k
        elif "resid" in k:
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=RESID_ATOL, err_msg=k)
        elif np.asarray(r[k]).dtype.kind == "f":
            tp.assert_arrays_close(g[k], r[k], TOL, k)
        else:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    assert (got / f"rays_{label}.png").stat().st_size > 0


def test_run_pipeline_log_matches_jax(pipelines):
    """The run log line by line: the package's name in the first message,
    the run's own wall time."""
    root, _ = pipelines
    lines = {side: (root / side / "log.RAYS.slab_damped").read_text().split("\n")
             for side in ("jax", "port")}
    assert len(lines["port"]) == len(lines["jax"])
    for g, r in zip(lines["port"], lines["jax"]):
        gk, _, gv = g.partition(" = ")
        rk, _, rv = r.partition(" = ")
        if rk == " rays_tpu run":
            assert gk == " rays_tpu_torch run" and gv == rv
        elif "time" in rk.lower():
            assert gk == rk and float(gv) >= 0.0
        elif rk == " max dispersion residual":
            np.testing.assert_allclose(float(gv), float(rv), rtol=1e-6, atol=1e-12)
        else:
            assert (gk, gv) == (rk, rv)


def test_run_pipeline_results_equal_jax(pipelines):
    _, outs = pipelines
    g, r = outs["port"]["results"], outs["jax"]["results"]
    np.testing.assert_array_equal(g.npoints.numpy(), np.asarray(r.npoints))
    np.testing.assert_array_equal(g.stop_flag.numpy(), np.asarray(r.stop_flag))
    tp.assert_scaled_close(g.ray_vec.numpy(), np.asarray(r.ray_vec), TOL, axis=1, what="ray_vec")


def test_reference_plot_scripts_use_the_port_shim(tmp_path):
    """The reference's plot scripts on the port's output, through the
    port's netCDF4 shim (after tests/test_plotters.py, which skips without
    the reference's checkout)."""
    if not os.path.isdir(terays.REFERENCE_GRAPHICS):
        pytest.skip("the reference's graphics_RAYS directory is absent "
                    "(RAYS_REFERENCE_GRAPHICS)")
    cfg, params, v0, st, pwr = tex.setup_example(tex.SLAB_ECH_90GHZ, device="cpu")
    res = trace_rays(cfg, params, v0, st, pwr)
    write_results_nc(cfg, res, path=str(tmp_path / f"run_results.{cfg.run_label}.nc"))
    proc = terays.plot_with_reference_scripts(cfg, workdir=str(tmp_path))
    assert proc.returncode == 0, proc.stderr


def test_run_reference_script_puts_the_port_compat_first(tmp_path, monkeypatch):
    """A script run by ``run_reference_script`` imports the port's shim as
    ``netCDF4``."""
    script = tmp_path / "probe.py"
    script.write_text("import netCDF4; print(netCDF4.__file__)\n")
    monkeypatch.setattr(terays, "REFERENCE_GRAPHICS", str(tmp_path))
    proc = terays.run_reference_script("probe.py", workdir=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert os.path.samefile(proc.stdout.strip(), shim.__file__)


def test_namelist_catalog_equals_jax():
    assert tdoc.NAMELIST_CATALOG == jdoc.NAMELIST_CATALOG
    assert tdoc.accepted_namelist_groups() == jdoc.accepted_namelist_groups()


def test_namelist_catalog_cannot_drift():
    """The catalog's groups are the groups the port's importers accept,
    read from their source (after tests/test_run_io.py)."""
    accepted = tdoc.accepted_namelist_groups()
    catalog = {g.lower() for g in tdoc.NAMELIST_CATALOG}
    assert accepted - catalog == set(), sorted(accepted - catalog)
    assert catalog - accepted == set(), sorted(catalog - accepted)


def test_write_docs(tmp_path):
    """Every module of the port has its section; the namelist file is the
    JAX package's but for the package's name."""
    mod, nml = tdoc.write_docs(str(tmp_path / "docs"))
    ref_mod, ref_nml = jdoc.write_docs(str(tmp_path))
    text = open(mod).read()
    rels = [rel for rel, _ in tdoc.extract_module_docs()]
    assert all(rel.startswith("rays_tpu_torch" + os.sep) for rel in rels)
    for rel in ("rays_tpu_torch/utils/erays.py", "rays_tpu_torch/parallel/multihost.py",
                "rays_tpu_torch/tracing/compensated.py"):
        assert f"\n## {rel}\n" in text
    assert open(nml).read() == open(ref_nml).read().replace(
        "by rays_tpu.config", "by rays_tpu_torch.config")
    proc = subprocess.run([sys.executable, "-m", "rays_tpu_torch.utils.doc_modules",
                           str(tmp_path / "cli")], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path / "cli")) == ["module_description.md",
                                                     "namelist_description.md"]
