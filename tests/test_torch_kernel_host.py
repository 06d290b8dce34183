"""The CUDA kernel's body on the CPU: csrc/slab_rk4.cuh compiled by g++
through csrc/host_shim.cpp (a loop over rays) and driven through the same
wrapper code as the CUDA library (fused_slab.run_library).

float64 is held to the JAX Pallas kernel in interpret mode and to the
plain twin (1e-9 of scale, equal flags and npoints); float32 is held to
the JAX float64 scan at the bounds of tests/test_fused.py.  The damped
body (one build per damping variant) is held to the plain twin and to
the JAX scan (the Pallas kernel has no damping) at 1e-9 of scale with
the absorption slots within 1e-12 absolute, and at float32 to the JAX
float64 scan at the bounds of tests/test_precision.py.  This is where the
kernel's arithmetic is checked before it runs on the card."""

import dataclasses
import functools
import shutil

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.tracing import fused_slab as jfused, trace as jtrace
from rays_tpu.tracing.stop import StopCode
from rays_tpu_torch.tracing import fused_slab as tfused

RTOL = 1e-9
ABSORB_ATOL = 1e-12


@pytest.fixture(scope="module")
def host_libs():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel body needs it")
    return tp.host_kernel_libraries()


@pytest.fixture(scope="module")
def host_lib(host_libs):
    return host_libs[0]


def _compare(got, ref, rtol, trajectory=False):
    assert got.npoints.tolist() == ref.npoints.tolist()
    assert got.stop_flag.tolist() == ref.stop_flag.tolist()
    tp.assert_scaled_close(got.end_ray_vec, ref.end_ray_vec, rtol, axis=-1, what="end")
    np.testing.assert_allclose(got.max_residuals.numpy(), ref.max_residuals.numpy(),
                               rtol=1e-6, atol=1e-12)
    if trajectory:
        assert got.ray_vec.shape == ref.ray_vec.shape
        tp.assert_scaled_close(got.ray_vec, ref.ray_vec, rtol, axis=1, what="trajectory")
        np.testing.assert_array_equal(got.ray_vec.numpy() == 0, ref.ray_vec.numpy() == 0)
        np.testing.assert_allclose(got.residual.numpy(), ref.residual.numpy(),
                                   rtol=1e-6, atol=1e-12)


def test_host_f64_matches_pallas_and_plain(host_lib, monkeypatch):
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=40, save_trajectory=False)
    monkeypatch.setattr(jfused.pl, "pallas_call",
                        functools.partial(jfused.pl.pallas_call, interpret=True))
    pallas = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)),
        jfused.trace_batch_fused(cfg, params, v0, st, pwr))
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    got = tfused.run_library(host_lib, pcfg, pp, tv0, tst, tpw)
    _compare(got, pallas, RTOL)
    _compare(got, tfused.trace_batch_fused_reference(pcfg, pp, tv0, tst, tpw), RTOL)


@pytest.mark.parametrize("ray_param,ds", [("time", None), ("arcl", 2.5e-3)])
def test_host_trajectory_matches_plain(host_lib, ray_param, ds):
    cfg, params, v0, st, pwr = tp.jax_case(ds=ds, ray_param=ray_param, nstep_max=120)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    got = tfused.run_library(host_lib, pcfg, pp, tv0, tst, tpw)
    assert got.ray_vec.shape == (3, 121, 7) and got.residual.shape == (3, 121)
    _compare(got, tfused.trace_batch_fused_reference(pcfg, pp, tv0, tst, tpw), RTOL,
             trajectory=True)


@pytest.mark.parametrize("combo", tp.KERNEL_COMBOS,
                         ids=["-".join((c[0], c[1], c[2], *c[3])) for c in tp.KERNEL_COMBOS])
def test_host_profile_models_match_plain(host_lib, combo):
    """Every profile branch of the kernel against the generic plain chain."""
    cfg, params, v0, st, pwr = tp.jax_case(combo=combo, nstep_max=60)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    got = tfused.run_library(host_lib, pcfg, pp, tv0, tst, tpw)
    _compare(got, tfused.trace_batch_fused_reference(pcfg, pp, tv0, tst, tpw), RTOL,
             trajectory=True)


@pytest.mark.parametrize("stop", ["x_bounds", "s_max", "resid_limit", "not_started",
                                  "negative_temp"])
def test_host_stops_match_plain(host_lib, stop):
    """Each stop of the loop, with the rows past it left zero."""
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=60)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    one = torch.ones((), dtype=torch.float64)
    if stop == "x_bounds":
        pp = pp._replace(eq=pp.eq._replace(xmax=-0.0795 * one))
        want = StopCode.X_OUT_OF_BOUNDS
    elif stop == "s_max":
        pp = pp._replace(ode=pp.ode._replace(s_max=1.2e-9 * one))
        want = StopCode.SOUT_GT_SMAX
    elif stop == "resid_limit":
        pp = pp._replace(limits=pp.limits._replace(dispersion_resid_limit=1.5e-9 * one))
        want = StopCode.DISPERSION_RESIDUAL
    elif stop == "not_started":
        tst = tst.clone()
        tst[1] = int(StopCode.DID_NOT_START)
        want = StopCode.DID_NOT_START
    else:
        # ion temperature falling through zero along the rays' path
        st_ = dataclasses.replace(pcfg.eq_static, t_prof_model=("zero", "linear_2"))
        pcfg = dataclasses.replace(pcfg, eq_static=st_)
        pp = pp._replace(eq=pp.eq._replace(x0=-0.0795 * one, dtdx=-1.0 * one))
        want = StopCode.NEGATIVE_TEMP
    ref = tfused.trace_batch_fused_reference(pcfg, pp, tv0, tst, tpw)
    assert int(want) in ref.stop_flag.tolist()
    got = tfused.run_library(host_lib, pcfg, pp, tv0, tst, tpw)
    _compare(got, ref, RTOL, trajectory=True)


def test_host_f32_matches_jax_f64_scan(host_lib):
    """float32 kernel body against the float64 truth over the example's
    500 steps (tests/test_fused.py: endpoints within 5e-4 of scale, max
    residual below 5e-3)."""
    cfg, params, v0, st, pwr = tp.jax_case(save_trajectory=False)
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))(
        params, v0, st, pwr)
    ref = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), ref)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr, dtype=torch.float32)
    got = tfused.run_library(host_lib, pcfg, pp, tv0, tst, tpw)
    assert got.end_ray_vec.dtype == torch.float32
    assert got.npoints.tolist() == ref.npoints.tolist() == [501] * 3
    assert got.stop_flag.tolist() == ref.stop_flag.tolist()
    tp.assert_scaled_close(got.end_ray_vec, ref.end_ray_vec, 5e-4, axis=-1, what="f32 end")
    mr = got.max_residuals.double().numpy()
    assert np.isfinite(mr).all() and (mr > 0).all() and mr.max() < 5e-3


def _damped_case(multi):
    """The damped example (400 steps, trajectories on), with or without
    the per-species slots, and its JAX float64 trace."""
    cfg, params, v0, st, pwr = tp.jax_case(jex.SLAB_ECH_DAMPED, multi_spec_damping=multi)
    v0 = np.asarray(v0)[:, :cfg.nv]
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))(params, v0, st, pwr)
    ref = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), ref)
    return (cfg, params, v0, st, pwr), ref


@pytest.mark.parametrize("multi", [True, False], ids=["multi_spec", "total_only"])
def test_host_damped_matches_plain_and_jax(host_libs, multi):
    (cfg, params, v0, st, pwr), jref = _damped_case(multi)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    assert tfused.supported(pcfg) and pcfg.nv == (10 if multi else 8)
    lib = host_libs[tfused._variant(pcfg)]
    got = tfused.run_library(lib, pcfg, pp, tv0, tst, tpw)
    assert set(got.stop_flag.tolist()) == {int(StopCode.TOTAL_ABSORPTION)}
    assert got.end_ray_vec[:, 7].min() > 0.98
    plain = tfused.trace_batch_fused_reference(pcfg, pp, tv0, tst, tpw)
    for ref in (plain, jref):
        _compare(got, ref, RTOL, trajectory=True)
        np.testing.assert_allclose(got.ray_vec[..., 7:].numpy(), ref.ray_vec[..., 7:].numpy(),
                                   rtol=0, atol=ABSORB_ATOL)
    # a library of another damping variant refuses the config
    with pytest.raises(ValueError, match="damping variant"):
        tfused.run_library(host_libs[0], pcfg, pp, tv0, tst, tpw)


@pytest.mark.parametrize("multi", [True, False], ids=["multi_spec", "total_only"])
def test_host_damped_f32_matches_jax_f64(host_libs, multi):
    """tests/test_precision.py's damped bounds: positions and k within
    5e-4 of trajectory scale, integrated absorption within 2e-4."""
    (cfg, params, v0, st, pwr), ref = _damped_case(multi)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr, dtype=torch.float32)
    got = tfused.run_library(host_libs[tfused._variant(pcfg)], pcfg, pp, tv0, tst, tpw)
    assert got.ray_vec.dtype == torch.float32
    assert got.npoints.tolist() == ref.npoints.tolist()
    assert got.stop_flag.tolist() == ref.stop_flag.tolist()
    tp.assert_scaled_close(got.ray_vec, ref.ray_vec, 5e-4, axis=1, what="f32 trajectory")
    np.testing.assert_allclose(got.end_ray_vec[:, 7].double().numpy(),
                               ref.end_ray_vec[:, 7].numpy(), rtol=0, atol=2e-4)
