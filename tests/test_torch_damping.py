"""rays_tpu_torch damping against the JAX package: the Z function
(ops/zfun.py), the fundamental-ECH damping model (wave/damping.py), the
damped RHS and check, and the damped trace against JAX and against the
NumPy oracle of tests/_oracle.py.

Tolerances: the Z function rtol 1e-13 (the same sums in the same order);
damp_fund_ech rtol 1e-12 with a floor of 1e-14 of scale, the dispersion
residual (a cancellation of O(1) terms) at its rounding floor; the damped trace
1e-9 of trajectory scale with the absorption slots within 1e-12
absolute; the oracle at tests/test_parity.py's 5e-7 for the damped case
(its Z function is scipy's wofz)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.models import base as jbase
from rays_tpu.ops import zfun as jz
from rays_tpu.tracing import rhs as jrhs, trace as jtrace
from rays_tpu.tracing.stop import StopCode
from rays_tpu.wave import damping as jdamp, deriv_cold as jderiv
from rays_tpu_torch import examples as tex
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.ops import zfun as tz
from rays_tpu_torch.tracing import rhs as trhs, trace as ttrace
from rays_tpu_torch.wave import damping as tdamp
from test_parity import _assert_parity, _oracle_cfg, _slab_eq_fn

Z_RTOL = 1e-13
DAMP_RTOL, ATOL_OF_SCALE = 1e-12, 1e-14
RESID_ATOL = 1e-15
TRAJ_RTOL, ABSORB_ATOL = 1e-9, 1e-12
# 120 steps of 6.5e-3 reach the resonance: one ray runs out of steps
# partly absorbed, two stop by total absorption
TRACE_STEPS, TRACE_DS = 120, 6.5e-3


def _close(got, ref, rtol, what="", atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=max(atol, ATOL_OF_SCALE * scale),
                               err_msg=what)


# --- the Z function ---------------------------------------------------------

X_GRID = np.concatenate([np.linspace(-8.0, 8.0, 161), [0.0, 1e-3, -1e-3, 5.0, -5.0]])


def test_dawsn_and_real_axis_z_match_jax():
    x = torch.from_numpy(X_GRID)
    np.testing.assert_allclose(tz.dawsn(x).numpy(), np.asarray(jz.dawsn(jnp.asarray(X_GRID))),
                               rtol=Z_RTOL, atol=0)
    for got, ref in zip(tz.zfun_real_parts(x), jz.zfun_real_parts(jnp.asarray(X_GRID))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=Z_RTOL, atol=0)
    assert tz.dawsn(torch.zeros(1, dtype=torch.float64)).item() == 0.0


@pytest.mark.parametrize("kz_sign", [1.0, -1.0])
def test_zfun0_real_parts_match_jax(kz_sign):
    x = torch.from_numpy(X_GRID)
    kz = kz_sign * np.linspace(0.5, 3.0, X_GRID.shape[0])
    got = tz.zfun0_real_parts(x, torch.from_numpy(kz))
    ref = jz.zfun0_real_parts(jnp.asarray(X_GRID), jnp.asarray(kz))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=Z_RTOL, atol=0)
    # Landau sign convention: Im Z has the sign of kz
    assert np.all(np.sign(got[1].numpy()) == kz_sign)


@pytest.mark.parametrize("half", ["upper", "lower"])
def test_wofz_and_zfun_parts_match_jax(half):
    rng = np.random.default_rng(3)
    x = rng.uniform(-6.0, 6.0, 200)
    y = rng.uniform(0.0, 4.0, 200) if half == "upper" else -rng.uniform(0.0, 2.0, 200)
    y[:5] = 0.0 if half == "upper" else -1e-3
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    kz = np.where(np.arange(200) % 2 == 0, 1.0, -1.0)
    for got, ref in ((tz.wofz_parts(tx, ty), jz.wofz_parts(jx, jy)),
                     (tz.zfun_parts(tx, ty), jz.zfun_parts(jx, jy)),
                     (tz.zfun0_parts(tx, ty, torch.from_numpy(kz)),
                      jz.zfun0_parts(jx, jy, jnp.asarray(kz)))):
        for g, r in zip(got, ref):
            _close(g, r, Z_RTOL)
    # the complex conveniences agree with their parts
    z = tx + 1j * ty
    w = tz.wofz(z)
    np.testing.assert_array_equal(w.real.numpy(), tz.wofz_parts(tx, ty)[0].numpy())
    np.testing.assert_array_equal(tz.zfun(z).imag.numpy(), tz.zfun_parts(tx, ty)[1].numpy())


# --- the damping model ------------------------------------------------------

@pytest.fixture(scope="module")
def damped():
    """The damped example on both sides, and equilibrium points across the
    slab (through the resonance near x = 0.3) with k from the launch rays,
    one at k_par = 0 (B is along z there)."""
    jcfg, jparams, jv0, *_ = tp.jax_case(jex.SLAB_ECH_DAMPED)
    pcfg, pp = tp.to_port(jcfg, jparams)
    xs = np.linspace(-0.45, 0.45, 31)
    n = xs.shape[0]
    x = np.stack([xs, np.zeros(n), np.zeros(n)], axis=1)
    k = np.asarray(jv0)[np.arange(n) % 3, 3:6].copy()
    k[-1, 2] = 0.0                      # k_par = 0
    k[::4, 2] *= -1.0                   # both signs of k_par
    return dict(jcfg=jcfg, jparams=jparams, pcfg=pcfg, pp=pp, x=x, k=k)


def test_damp_fund_ech_matches_jax(damped):
    d = damped
    jcfg, jp = d["jcfg"], d["jparams"]
    x, k = jnp.asarray(d["x"]), jnp.asarray(d["k"])

    @jax.jit
    def reference(x, k):
        eq = jax.vmap(lambda xx: jbase.equilibrium(jcfg, jp, xx))(x)
        _, dddk, dddw = jax.vmap(lambda e, kk: jderiv.deriv_cold(
            e, kk / jp.rf.k0, jp.rf.omgrf, jp.rf.k0))(eq, k)
        vg = -dddk / dddw[:, None]
        v_xk = jnp.concatenate([x, k], axis=1)
        return v_xk, vg, jax.vmap(lambda e, v, g: jdamp.damping(jcfg, jp, e, v, g))(eq, v_xk, vg)

    v_xk, vg, (ksi_ref, ki_ref) = reference(x, k)

    teq = tbase.equilibrium(d["pcfg"], d["pp"], torch.from_numpy(d["x"]))
    tv_xk, tvg = torch.from_numpy(np.array(v_xk)), torch.from_numpy(np.array(vg))
    ksi, ki = tdamp.damping(d["pcfg"], d["pp"], teq, tv_xk, tvg)
    _close(ki, ki_ref, DAMP_RTOL, "ki")
    _close(ksi, ksi_ref, DAMP_RTOL, "ksi")
    ki = ki.numpy()
    # both sides of the |xi| <= 5 window, and k_par = 0 masked to zero
    assert (ki != 0).sum() >= 3 and (ki == 0).sum() >= 3
    assert ki[-1] == 0.0
    assert not ksi[:, 1:].any()
    # no_damp is zeros
    nd = dataclasses.replace(d["pcfg"], damping_model="no_damp")
    z_ksi, z_ki = tdamp.damping(nd, d["pp"], teq, tv_xk, tvg)
    assert z_ksi.shape == ksi.shape and not z_ksi.any() and not z_ki.any()


@pytest.mark.parametrize("multi", [True, False], ids=["multi_spec", "total_only"])
def test_damped_eqn_ray_and_check_matches_jax(damped, multi):
    """All slots and statuses; absorption above total_damping_limit on some
    points gives TOTAL_ABSORPTION, below the other stops in priority."""
    d = damped
    jcfg = dataclasses.replace(d["jcfg"], multi_spec_damping=multi)
    pcfg = dataclasses.replace(d["pcfg"], multi_spec_damping=multi)
    n = d["x"].shape[0]
    absorbed = np.linspace(0.0, 0.995, n)[:, None]
    per_species = np.zeros((n, pcfg.ns)) if multi else np.zeros((n, 0))
    v = np.concatenate([d["x"], d["k"], np.zeros((n, 1)), absorbed, per_species], axis=1)
    v[-3, 0] = 0.7                      # out of bounds beats absorption
    assert v.shape[1] == pcfg.nv == (10 if multi else 8)
    ref = jax.vmap(lambda vv: jrhs.eqn_ray_and_check(
        jcfg, d["jparams"], jnp.float64(0.0), vv))(jnp.asarray(v))
    got = trhs.eqn_ray_and_check(pcfg, d["pp"], torch.zeros((), dtype=torch.float64),
                                 torch.from_numpy(v))
    for g, r, name in zip(got, ref, ("dvds", "rhs_status", "resid", "check_status")):
        if np.asarray(r).dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            _close(g, r, DAMP_RTOL, name, atol=RESID_ATOL if name == "resid" else 0.0)
    flags = set(got[3].tolist())
    assert {int(StopCode.TOTAL_ABSORPTION), int(StopCode.X_OUT_OF_BOUNDS)} <= flags
    assert np.asarray(got[0])[:, 7].any()


# --- the damped trace -------------------------------------------------------

@pytest.fixture(scope="module")
def damped_trace():
    cfg, params, v0, st, pwr = tp.jax_case(jex.SLAB_ECH_DAMPED, ds=TRACE_DS,
                                           nstep_max=TRACE_STEPS)
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))(params, v0, st, pwr)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    return ref, ttrace.trace_batch(pcfg, pp, tv0, tst, tpw)


def test_damped_trace_matches_jax(damped_trace):
    ref, got = damped_trace
    np.testing.assert_array_equal(got.npoints.numpy(), ref.npoints)
    np.testing.assert_array_equal(got.stop_flag.numpy(), ref.stop_flag)
    assert int(StopCode.TOTAL_ABSORPTION) in ref.stop_flag.tolist()
    assert ref.ray_vec.shape == (3, TRACE_STEPS + 1, 10)
    tp.assert_scaled_close(got.ray_vec, ref.ray_vec, TRAJ_RTOL, axis=1, what="damped")
    np.testing.assert_allclose(got.ray_vec[..., 7:].numpy(), ref.ray_vec[..., 7:],
                               rtol=0, atol=ABSORB_ATOL)
    np.testing.assert_allclose(got.end_ray_vec[:, 7:].numpy(), ref.end_ray_vec[:, 7:],
                               rtol=0, atol=ABSORB_ATOL)
    assert ref.end_ray_vec[:, 7].max() > 0.9
    # only the electrons absorb, and their slot is the total
    np.testing.assert_array_equal(got.ray_vec[..., 8].numpy(), got.ray_vec[..., 7].numpy())
    assert not got.ray_vec[..., 9].any()


def test_damped_trace_matches_oracle():
    """The damped example's full 400 steps against the scalar NumPy
    transcription of the reference (tests/test_parity.py's damped bound)."""
    cfg, params, v0, st, pwr = tex.setup_example(tex.SLAB_ECH_DAMPED, device="cpu")
    res = ttrace.trace_batch(cfg, params, v0, st, pwr)
    assert set(res.stop_flag.tolist()) == {int(StopCode.TOTAL_ABSORPTION)}
    oc = _oracle_cfg(cfg, params, _slab_eq_fn(cfg, params))
    _assert_parity(cfg, params, res, oc, rtol=5e-7)
