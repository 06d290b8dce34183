"""rays_tpu_torch's per-point ray diagnostics (post/ray_diags.py) against
the JAX package, on the same trajectories: JAX traces each case and its
RayResults are carried across (convert.results_from_numpy), so the
trajectory's sensitivity near the ECH resonance cannot enter.  Four
geometries: the damped slab, the Solovev fan, the EQDSK tokamak and the
damped four-coil mirror.

Tolerances: every variable within 1e-12 of its largest magnitude (closed
forms of the equilibrium at the same points), n_imag within 1e-10 (the Z
function and the group velocity divide rounding by small numbers); the
masked points are exact zeros in both; the netCDF files equal but for the
wall-clock stamp.
"""

import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.post import ray_diags as jrd
from rays_tpu_torch.post import ray_diags as trd

TOL = 1e-12
TOLS = {"n_imag": 1e-10}
GEOMETRIES = ["slab", "solovev", "eqdsk", "mirror"]
COORDS = {"slab": ("X", "Y", "Z"), "solovev": ("Psi", "R", "Z"),
          "eqdsk": ("Psi", "R", "Z"), "mirror": ("Aphi", "R", "Z")}


@pytest.fixture(scope="module", params=GEOMETRIES)
def case(request, tmp_path_factory):
    jcfg, jparams, jres = tp.post_case(request.param, tmp_path_factory.mktemp(request.param))
    pcfg, pparams = tp.to_port(jcfg, jparams)
    return request.param, (jcfg, jparams, jres), (pcfg, pparams, tp.carry_results(jres))


def test_every_variable_matches_jax(case):
    name, (jcfg, jparams, jres), (pcfg, pparams, pres) = case
    ref = jrd.compute_ray_diagnostics(jcfg, jparams, jres)
    got = trd.compute_ray_diagnostics(pcfg, pparams, pres)
    assert list(got) == list(ref) and list(got)[-1] == "residual"
    assert set(COORDS[name]) < set(got)
    npts = pres.npoints.numpy()
    valid = np.arange(pres.ray_vec.shape[1])[None, :] < npts[:, None]
    for var in ref:
        g, r = got[var].numpy(), np.asarray(ref[var])
        tp.assert_arrays_close(g, r, TOLS.get(var, TOL), f"{name} {var}")
        assert np.isfinite(g).all() and (g[~valid] == 0.0).all(), var
    if name in ("slab", "mirror"):   # the damped cases absorb
        assert got["n_imag"].max() > 0 and got["P_absorbed"].max() > 0.5


def test_chunks_change_nothing(case, monkeypatch):
    """Rays in chunks of one or two give what one pass gives, bit for bit."""
    _, _, (pcfg, pparams, pres) = case
    whole = trd.compute_ray_diagnostics(pcfg, pparams, pres)
    monkeypatch.setattr(trd, "CHUNK_POINTS", 2 * pres.ray_vec.shape[1] - 1)
    chunked = trd.compute_ray_diagnostics(pcfg, pparams, pres)
    for var in whole:
        assert torch.equal(chunked[var], whole[var]), var


def test_netcdf_files_match_jax(case, tmp_path):
    _, (jcfg, jparams, jres), (pcfg, pparams, pres) = case
    jfn = jrd.write_ray_diagnostics_nc(jcfg, jparams, jres, path=str(tmp_path / "jax.nc"))
    tfn = trd.write_ray_diagnostics_nc(pcfg, pparams, pres, path=str(tmp_path / "port.nc"))
    tp.assert_nc_files_match(tfn, jfn, TOL, TOLS)


def test_default_file_names(case, tmp_path, monkeypatch):
    """ray_detailed_diagnostics_slab.<label>.nc for the slab, without the
    suffix for the other geometries, in the working directory."""
    name, _, (pcfg, pparams, pres) = case
    monkeypatch.chdir(tmp_path)
    fn = trd.write_ray_diagnostics_nc(pcfg, pparams, pres)
    suffix = "_slab" if name == "slab" else ""
    assert fn == f"ray_detailed_diagnostics{suffix}.{pcfg.run_label}.nc"
    assert (tmp_path / fn).exists()


@pytest.mark.parametrize("case", ["slab"], indirect=True)
def test_slab_diagnostics_values(case):
    """The physics cross-checks of tests/test_post.py on the port's damped
    slab diagnostics (slab_processor_m.f90:123-330,
    axisym_toroid_processor_m.f90:407-411)."""
    _, _, (pcfg, pparams, pres) = case
    d = {k: v.numpy() for k, v in trd.compute_ray_diagnostics(pcfg, pparams, pres).items()}
    vr = pres.ray_vec.numpy()
    ir, istep = 0, 5
    assert d["X"][ir, istep] == vr[ir, istep, 0] and d["s"][ir, istep] == vr[ir, istep, 6]
    assert d["P_absorbed"][ir, istep] == vr[ir, istep, 7]
    x0, x1, x2 = (d[f"xi_{h}"][ir, istep] for h in range(3))
    assert x0 > x1 > x2
    assert (x1 - x0) == pytest.approx(x2 - x1, rel=1e-10)
    n = int(pres.npoints[ir])
    k = int(np.argmax(np.diff(vr[ir, :n, 7])))
    assert d["n_imag"][ir, k] > 0
