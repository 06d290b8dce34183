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

import ctypes
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
from rays_tpu_torch import constants
from rays_tpu_torch.core.types import tree_to
from rays_tpu_torch.tracing import fused_slab as tfused

RTOL = 1e-9
ABSORB_ATOL = 1e-12


@pytest.fixture(scope="module")
def host_libs():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel body needs it")
    return tfused.load_host_libraries()


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
                                  "negative_temp", "infinite_vg", "ray_stalled"])
def test_host_stops_match_plain(host_lib, stop):
    """Each stop of the loop, with the rows past it left zero."""
    cfg, params, v0, st, pwr = tp.jax_case(
        nstep_max=60, ray_param="arcl" if stop == "ray_stalled" else "time")
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    one = torch.ones((), dtype=torch.float64)
    if stop in ("infinite_vg", "ray_stalled"):
        # k = 0 passes the initial check only under a lax residual limit;
        # then dD/dk = 0 exactly (the ray stalls), and in a vacuum without
        # a field dD/dw = 0 too (the guarded reciprocal's case)
        tv0 = tv0.clone()
        tv0[:, 3:6] = 0.0
        pp = pp._replace(limits=pp.limits._replace(dispersion_resid_limit=10.0 * one))
    if stop == "x_bounds":
        pp = pp._replace(eq=pp.eq._replace(xmax=-0.0795 * one))
        want = StopCode.X_OUT_OF_BOUNDS
    elif stop == "s_max":
        pp = pp._replace(ode=pp.ode._replace(s_max=1.2e-9 * one))
        want = StopCode.SOUT_GT_SMAX
    elif stop == "resid_limit":
        pp = pp._replace(limits=pp.limits._replace(dispersion_resid_limit=1.5e-9 * one))
        want = StopCode.DISPERSION_RESIDUAL
    elif stop == "infinite_vg":
        st_ = dataclasses.replace(pcfg.eq_static, by_prof_model="zero", bz_prof_model="zero")
        pcfg = dataclasses.replace(pcfg, eq_static=st_)
        pp = pp._replace(species=pp.species._replace(n0s=0.0 * pp.species.n0s))
        want = StopCode.INFINITE_VG
    elif stop == "ray_stalled":
        want = StopCode.RAY_STALLED
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
    if stop in ("infinite_vg", "ray_stalled"):
        assert got.npoints.tolist() == [1] * 3 and torch.isfinite(got.end_ray_vec).all()


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
def test_host_damped_time_parameter_matches_plain(host_libs, multi):
    """With time as the ray parameter the damping's group-velocity
    direction is f[0:3] over its magnitude (one reciprocal), where arc
    length has a unit vector already."""
    cfg, params, v0, st, pwr = tp.jax_case(jex.SLAB_ECH_DAMPED, ds=1.2e-11, ray_param="time",
                                           multi_spec_damping=multi)
    v0 = np.asarray(v0)[:, :cfg.nv]
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    got = tfused.run_library(host_libs[tfused._variant(pcfg)], pcfg, pp, tv0, tst, tpw)
    ref = tfused.trace_batch_fused_reference(pcfg, pp, tv0, tst, tpw)
    assert int(StopCode.TOTAL_ABSORPTION) in got.stop_flag.tolist()
    assert got.end_ray_vec[:, 7].max() > 0.98
    _compare(got, ref, RTOL, trajectory=True)
    np.testing.assert_allclose(got.ray_vec[..., 7:].numpy(), ref.ray_vec[..., 7:].numpy(),
                               rtol=0, atol=ABSORB_ATOL)


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


@pytest.mark.parametrize("multi", [True, False], ids=["multi_spec", "total_only"])
@pytest.mark.parametrize("case", ["k_par_zero", "zero_te", "far_from_resonance"])
def test_host_damping_never_live_gives_exact_zero(host_libs, case, multi):
    """Where damping is masked at every evaluation (k_par = 0, a 'zero'
    electron temperature, or |xi| > 5 throughout) the kernel skips the
    Dawson sum; the absorption slots must be exactly 0.0, as the plain
    twin's, and the trajectories equal."""
    text = jex.SLAB_ECH_DAMPED
    if case == "k_par_zero":
        text = text.replace("n_kz_launch=3, rindex_z0=0.1, delta_rindex_z0=0.1",
                            "n_kz_launch=1, rindex_z0=0.0, delta_rindex_z0=0.0")
        assert text != jex.SLAB_ECH_DAMPED
    cfg, params, v0, st, pwr = tp.jax_case(text, multi_spec_damping=multi, nstep_max=120)
    v0 = np.asarray(v0)[:, :cfg.nv]
    if case == "far_from_resonance":
        # the first ray's |xi| falls from 17.6 and passes 5 only after 250 steps
        v0, st, pwr = v0[:1], np.asarray(st)[:1], np.asarray(pwr)[:1]
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    if case == "zero_te":
        st_ = dataclasses.replace(pcfg.eq_static, t_prof_model=("zero", "constant"))
        pcfg = dataclasses.replace(pcfg, eq_static=st_)
    if case == "k_par_zero":
        assert (tv0[:, 4:6] == 0).all()
    got = tfused.run_library(host_libs[tfused._variant(pcfg)], pcfg, pp, tv0, tst, tpw)
    ref = tfused.trace_batch_fused_reference(pcfg, pp, tv0, tst, tpw)
    assert got.npoints.min() > 20
    _compare(got, ref, RTOL, trajectory=True)
    for res in (got, ref):
        assert (res.ray_vec[..., 7:] == 0.0).all() and (res.end_ray_vec[:, 7:] == 0.0).all()


# SlabRun's derived fields in the order host_shim.cpp's read_run writes them
DERIVED = ("inv_k0", "inv_k0sq", "inv_omgrf", "inv_rmaj", "inv_rmin", "inv_lby", "inv_lbz",
           "inv_ln", "inv_lt", "gauss_coef", "half_ds", "sixth_ds", "omgc_coef",
           "two_over_ms0", "inv_clight")
DERIVED_SPECIES = ("alpha_w2", "gamma_w", "dn_linear")


def _read_run(lib, pcfg, pp, dtype):
    """The run constants as the host build's load_run fills them from the
    packed rows: {field name: value, or per-species values}."""
    packed = torch.cat(tfused.run_rows(pcfg, pp))
    codes = tfused.model_codes(pcfg)
    out = torch.full((256,), float("nan"), dtype=dtype)
    fn = getattr(lib, f"rays_slab_read_run_{tfused._SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = fn(packed.data_ptr(), codes, pcfg.ns, out.data_ptr())
    lib.rays_slab_row_names.restype = ctypes.c_char_p
    lists = [names.split() for names in lib.rays_slab_row_names().decode().split("|")]
    ns, fields, at = pcfg.ns, {}, 0
    for names, width in zip(lists + [DERIVED, DERIVED_SPECIES, ("codes",)],
                            (1, ns, 1, ns, 1, ns, 4 + ns)):
        for name in names:
            fields[name] = out[at] if width == 1 else out[at:at + width]
            at += width
    assert n == at == packed.numel() + len(DERIVED) + 3 * ns + 4 + ns
    return packed, fields


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("text", [jex.SLAB_ECH_90GHZ, jex.SLAB_ECH_DAMPED],
                         ids=["undamped", "damped"])
def test_host_loaded_run_fields(host_lib, text, dtype):
    """Every field of SlabRun that load_run fills from the packed rows, read
    back from the host build by the names of its row lists: each row's
    field holds its Params value read alone, each derived field its formula
    in the kernel's precision, the codes the config's.  The deck's values
    are replaced by distinct ones, so a row in another field shows here."""
    from test_torch_fused import params_field

    cfg, params, *_ = tp.jax_case(text, combo=tp.KERNEL_COMBOS[2])
    pcfg, pp = tp.to_port(cfg, params)
    at = 0
    for group, name in tfused.ROWS + tfused.SPECIES_ROWS + tfused.FORWARD_ROWS + \
            tfused.FORWARD_SPECIES_ROWS:
        t = getattr(getattr(pp, group), name)
        values = 1 + torch.arange(at, at + t.numel(), dtype=torch.float64).reshape(t.shape) / 64
        pp = pp._replace(**{group: getattr(pp, group)._replace(**{name: values})})
        at += t.numel()
    pp = tree_to(pp, dtype=dtype)
    packed, fields = _read_run(host_lib, pcfg, pp, dtype)
    raw = {n: t for n, t in fields.items() if n not in DERIVED + DERIVED_SPECIES + ("codes",)}
    assert len(raw) == len(tfused.run_leaves(pp))
    for name, got in raw.items():
        want = params_field(pp, name).reshape(-1)[:got.numel()]
        assert got.reshape(-1).tolist() == want.tolist(), name
    assert len(set(packed.tolist())) == packed.numel()
    assert fields["codes"].tolist() == list(tfused.model_codes(pcfg))[:4 + pcfg.ns]

    ftype = np.float64 if dtype == torch.float64 else np.float32
    g = lambda n: ftype(raw[n].item())
    species = lambda n: raw[n].numpy()
    one, wratio = ftype(1), g("omgrf_ref") / g("omgrf")
    want = {
        "inv_k0": one / g("k0"), "inv_k0sq": one / (g("k0") * g("k0")),
        "inv_omgrf": one / g("omgrf"), "inv_rmaj": one / g("rmaj"),
        "inv_rmin": one / g("rmin"), "inv_lby": one / g("lby_shear_scale"),
        "inv_lbz": one / g("lbz_scale"), "inv_ln": one / g("ln_scale"),
        "inv_lt": one / g("lt_scale"),
        "gauss_coef": ftype(-3) * g("alphan1") / (g("rmin") * g("rmin")),
        "half_ds": g("ds") / ftype(2), "sixth_ds": g("ds") / ftype(6),
        "omgc_coef": species("gamma_coef")[0] * g("omgrf_ref"),
        "two_over_ms0": ftype(2) / g("ms"),
        "inv_clight": one / ftype(constants.CLIGHT),
    }
    assert tuple(want) == DERIVED
    got = [fields[n].item() for n in DERIVED]
    assert len(set(got)) == len(got) and all(np.isfinite(got)), "ambiguous case"
    for n, w in want.items():
        assert fields[n].item() == w, n
    want_species = {
        "alpha_w2": species("alpha_coef") * (wratio * wratio),
        "gamma_w": species("gamma_coef") * wratio,
        "dn_linear": species("n0s") / g("ln_scale"),
    }
    for n, w in want_species.items():
        np.testing.assert_array_equal(fields[n].numpy(), w, err_msg=n)


def test_swapped_row_fails_at_bind(host_lib, monkeypatch):
    """Two rows swapped in the Python tables: loading a library refuses
    them, as it would two swapped in csrc/slab_rk4.cuh."""
    tfused.check_rows(host_lib)
    rows = list(tfused.ROWS)
    rows[0], rows[1] = rows[1], rows[0]
    monkeypatch.setattr(tfused, "_LISTS", (tuple(rows), *tfused._LISTS[1:]))
    with pytest.raises(RuntimeError, match="packed run constants differ"):
        tfused.check_rows(host_lib)


def test_count_ops_counts_what_the_rays_need(host_libs):
    """The operation count behind the kernel's bound: the same trajectories
    on a counting type.  Undamped, S = 2, time parameter: 2 divisions and 2
    square roots per evaluation, 3 and 1 more per residual check."""
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=40, save_trajectory=False)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    ops, npoints = tfused.count_ops(host_libs[0], pcfg, pp, tv0, tst)
    assert npoints.tolist() == tfused.run_library(host_libs[0], pcfg, pp, tv0, tst,
                                                  tpw).npoints.tolist() == [41] * 3
    steps = 3 * 40
    assert ops["div"] == 3 * 5 + 11 * steps and ops["sqrt"] == 3 * 3 + 9 * steps
    assert ops["exp"] == ops["pow"] == 0
    assert 1300 * steps < ops["add"] + ops["mul"] < 1450 * steps

    # damped: exponentials only where damping is live, and far fewer than
    # the 168 per evaluation of the whole Dawson sum
    (cfg, params, v0, st, pwr), _ = _damped_case(True)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    far = dataclasses.replace(pcfg, nstep_max=120)
    ops_far, n_far = tfused.count_ops(host_libs[2], far, pp, tv0[:1], tst[:1])
    assert n_far.tolist() == [121] and ops_far["exp"] == 0
    ops_live, n_live = tfused.count_ops(host_libs[2], pcfg, pp, tv0, tst)
    evals = 4 * int((n_live - 1).sum()) + 3
    assert n_live.tolist() == [329, 309, 293]
    assert 0 < ops_live["exp"] < 0.2 * 169 * evals
    with pytest.raises(ValueError, match="damping variant"):
        tfused.count_ops(host_libs[0], pcfg, pp, tv0, tst)
    with pytest.raises(ValueError, match="float64 CPU"):
        tfused.count_ops(host_libs[2], pcfg, pp, tv0.float(), tst)
