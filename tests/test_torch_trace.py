"""rays_tpu_torch ray init, plain tracer and CLI against the JAX package
(and the slab case against the NumPy oracle of tests/_oracle.py).

Trajectories and endpoints agree to 1e-9 of the trajectory scale with
equal npoints and stop flags; both sides run float64 on the CPU."""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex, run as jrun
from rays_tpu.results.netcdf import read_results_nc as jread
from rays_tpu.tracing import trace as jtrace
from rays_tpu.tracing.stop import StopCode
from rays_tpu_torch import examples as tex, run as trun
from rays_tpu_torch.results.netcdf import read_results_nc as tread
from rays_tpu_torch.tracing import trace as ttrace
from test_parity import _assert_parity, _oracle_cfg, _slab_eq_fn

TRAJ_RTOL = 1e-9
# the dispersion residual is a cancellation of O(1) terms: compare it at
# its rounding floor, not relatively
RESID_TOL = dict(rtol=1e-6, atol=1e-12)

# a wider launch grid than the example: three x, two ny, four nz, some of
# them evanescent or out of plasma, so the drop order is exercised
WIDE_LAUNCH = jex.SLAB_ECH_90GHZ.replace(
    "n_x_launch=1, x_launch0=-0.08, dx_launch=0.4,",
    "n_x_launch=3, x_launch0=-0.45, dx_launch=0.4,").replace(
    "n_ky_launch=1, rindex_y0=0., delta_rindex_y0=.1,",
    "n_ky_launch=2, rindex_y0=0., delta_rindex_y0=.3,").replace(
    "n_kz_launch=3, rindex_z0=0.4, delta_rindex_z0=0.1",
    "n_kz_launch=4, rindex_z0=0.4, delta_rindex_z0=0.4")


@functools.lru_cache(maxsize=None)
def _jax_tracer(cfg):
    """One compiled JAX tracer per config; params are traced arguments."""
    return jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))


def _jax_trace(cfg, params, v0, st, pwr):
    res = _jax_tracer(cfg)(params, v0, st, pwr)
    return jax.tree_util.tree_map(np.asarray, jax.block_until_ready(res))


def _assert_results_match(got, ref, save):
    np.testing.assert_array_equal(got.npoints.numpy(), ref.npoints)
    np.testing.assert_array_equal(got.stop_flag.numpy(), ref.stop_flag)
    if save:
        assert got.ray_vec.shape == ref.ray_vec.shape
        tp.assert_scaled_close(got.ray_vec, ref.ray_vec, TRAJ_RTOL, axis=1,
                               what="trajectory")
        # zero rows past the stop, on both sides
        for i, n in enumerate(ref.npoints):
            assert not got.ray_vec[i, n:].any()
        np.testing.assert_allclose(got.residual.numpy(), ref.residual, **RESID_TOL)
    else:
        assert got.ray_vec.shape == ref.ray_vec.shape == (ref.npoints.shape[0], 1, 7)
    scale = np.maximum(np.abs(ref.ray_vec).max(axis=1), np.abs(ref.end_ray_vec))
    assert np.all(np.abs(got.end_ray_vec.numpy() - ref.end_ray_vec)
                  <= TRAJ_RTOL * np.maximum(scale, 1e-12))
    np.testing.assert_allclose(got.max_residuals.numpy(), ref.max_residuals, **RESID_TOL)
    np.testing.assert_allclose(got.end_residuals.numpy(), ref.end_residuals, **RESID_TOL)
    np.testing.assert_array_equal(got.start_ray_vec.numpy(), ref.start_ray_vec)
    np.testing.assert_array_equal(got.initial_ray_power.numpy(), ref.initial_ray_power)


@pytest.mark.parametrize("text", [jex.SLAB_ECH_90GHZ, WIDE_LAUNCH],
                         ids=["example", "wide_launch"])
def test_ray_init_matches_jax(text):
    _, _, v0, st, pwr = jex.setup_example(text)
    _, _, tv0, tst, tpw = tex.setup_example(text, device="cpu")
    v0 = np.asarray(v0)
    assert tv0.shape == v0.shape and tv0.dtype == torch.float64
    np.testing.assert_allclose(tv0.numpy(), v0, rtol=1e-14, atol=0)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(st))
    np.testing.assert_array_equal(tpw.numpy(), np.asarray(pwr))


def test_wide_launch_drops_candidates():
    _, _, tv0, _, _ = tex.setup_example(WIDE_LAUNCH, device="cpu")
    assert 0 < tv0.shape[0] < 3 * 2 * 4


@pytest.mark.parametrize("save", [True, False], ids=["save", "nosave"])
@pytest.mark.parametrize("ray_param,ds", [("time", None), ("arcl", 2.5e-3)])
def test_trace_batch_matches_jax(ray_param, ds, save):
    cfg, params, v0, st, pwr = tp.jax_case(
        ds=ds, ray_param=ray_param, nstep_max=120, save_trajectory=save)
    ref = _jax_trace(cfg, params, v0, st, pwr)
    assert ref.npoints.tolist() == [121] * 3
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    got = ttrace.trace_batch(pcfg, pp, tv0, tst, tpw)
    _assert_results_match(got, ref, save)


@pytest.mark.parametrize("stop", ["x_bounds", "s_max", "resid_limit", "not_started"])
def test_trace_batch_stops_match_jax(stop):
    """Each stop of the tracing loop, with the rows past it zeroed."""
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=60)
    st = np.asarray(st).copy()
    if stop == "x_bounds":
        params = params._replace(eq=params.eq._replace(xmax=jax.numpy.float64(-0.0795)))
        want = StopCode.X_OUT_OF_BOUNDS
    elif stop == "s_max":
        params = params._replace(ode=params.ode._replace(s_max=jax.numpy.float64(1.2e-9)))
        want = StopCode.SOUT_GT_SMAX
    elif stop == "resid_limit":
        params = params._replace(limits=params.limits._replace(
            dispersion_resid_limit=jax.numpy.float64(1.5e-9)))
        want = StopCode.DISPERSION_RESIDUAL
    else:
        st[1] = int(StopCode.DID_NOT_START)
        want = StopCode.DID_NOT_START
    ref = _jax_trace(cfg, params, v0, st, pwr)
    assert int(want) in ref.stop_flag.tolist()
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    _assert_results_match(ttrace.trace_batch(pcfg, pp, tv0, tst, tpw), ref, True)


def test_slab_matches_oracle():
    """The port's slab trajectory against the scalar NumPy transcription of
    the reference, at the tolerance of tests/test_parity.py (200 of the
    example's 500 steps, to keep the scalar oracle quick)."""
    cfg, params, v0, st, pwr = tex.setup_example(tex.SLAB_ECH_90GHZ, device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=200)
    res = ttrace.trace_batch(cfg, params, v0, st, pwr)
    oc = _oracle_cfg(cfg, params, _slab_eq_fn(cfg, params))
    _assert_parity(cfg, params, res, oc)


def test_trace_rays_cpu_runs_plain_tracer():
    cfg, params, v0, st, pwr = tex.setup_example(tex.SLAB_ECH_90GHZ, device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=20)
    a = ttrace.trace_rays(cfg, params, v0, st, pwr)
    b = ttrace.trace_batch(cfg, params, v0, st, pwr)
    assert a.end_ray_comp is None and b.end_ray_comp is None   # no compensated carry
    for x, y in zip(a[:-1], b[:-1]):
        assert torch.equal(x, y)
    # a leaf that requires grad takes the adjoint route: trace_batch, with
    # the same values and a graph back to the leaf
    grad_params = params._replace(rf=params.rf._replace(
        omgrf=params.rf.omgrf.clone().requires_grad_(True)))
    g = ttrace.trace_rays(cfg, grad_params, v0, st, pwr)
    for x, y in zip(g[:-1], b[:-1]):
        assert torch.equal(x.detach(), y)
    assert g.end_ray_vec.requires_grad
    # the adaptive stepper rides the same dispatch
    sg = dataclasses.replace(cfg, ode_solver_name="SG_ODE")
    a = ttrace.trace_rays(sg, params, v0, st, pwr)
    assert a.npoints.tolist() == [21] * 3
    for x, y in zip(a[:-1], ttrace.trace_batch(sg, params, v0, st, pwr)[:-1]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="invalid ode solver"):
        ttrace.trace_batch(dataclasses.replace(cfg, ode_solver_name="EULER"),
                           params, v0, st, pwr)


def test_cli_netcdf_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "slab_ECH_90GHz_case_1.in"
    path.write_text(jex.SLAB_ECH_90GHZ)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jrun.main([str(path), "--netcdf", "--no-log"])
    monkeypatch.chdir(tmp_path / "port")
    trun.main([str(path), "--device", "cpu", "--netcdf"])
    name = "run_results.slab_demo.nc"
    ref = jread(str(tmp_path / "jax" / name))
    got = tread(str(tmp_path / "port" / name))
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k in ("date_vector", "RAYS_run_label"):
            continue
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == r.dtype, k
    assert got["RAYS_run_label"] == ref["RAYS_run_label"] == "slab_demo"
    np.testing.assert_array_equal(got["npoints"], ref["npoints"])
    np.testing.assert_array_equal(got["ray_stop_flag"], ref["ray_stop_flag"])
    tp.assert_scaled_close(got["ray_vec"], ref["ray_vec"], TRAJ_RTOL, axis=1,
                           what="netCDF ray_vec")
    # the port's CLI writes its run log unless --no-log is given
    assert not os.path.exists(tmp_path / "jax" / "log.RAYS.slab_demo")
    assert os.path.exists(tmp_path / "port" / "log.RAYS.slab_demo")
    assert not os.path.exists(tmp_path / "port" / "messages")
