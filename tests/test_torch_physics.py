"""rays_tpu_torch physics against the JAX package on a grid of points, over
every slab profile model: slab fields, the EqPoint, the Stix pieces, the
dispersion function and its root solvers, the residual, deriv_cold (also
against torch.func.grad of dispersion_D) and the ray RHS.

Tolerance: rtol 1e-12 with an absolute floor of 1e-14 of each array's
scale (the two packages round in different orders, never differently in
substance)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.models import base as jbase, slab as jslab
from rays_tpu.tracing import rhs as jrhs
from rays_tpu.wave import deriv_cold as jderiv, dispersion as jdisp, stix as jstix
from rays_tpu_torch.models import base as tbase, slab as tslab
from rays_tpu_torch.tracing import rhs as trhs
from rays_tpu_torch.tracing.stop import StopCode
from rays_tpu_torch.wave import deriv_cold as tderiv, dispersion as tdisp, stix as tstix

RTOL, ATOL_OF_SCALE = 1e-12, 1e-14


def close(got, ref, rtol=RTOL, what="", scale=None):
    """``scale`` defaults to max|ref|; pass the natural scale where exact
    cancellation leaves ref itself at rounding level."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    if scale is None:
        scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=ATOL_OF_SCALE * scale,
                               err_msg=what)


def _points():
    """Positions inside the slab plus a few outside each bound, and
    refractive indices, from a fixed seed."""
    rng = np.random.default_rng(7)
    xs = np.concatenate([np.linspace(-0.45, 0.45, 13), [0.6, -0.7, 0.1, 0.2]])
    n = xs.shape[0]
    ys = rng.uniform(-0.4, 0.4, n)
    zs = rng.uniform(-0.9, 0.9, n)
    ys[-2] = 0.7      # y out of bounds
    zs[-1] = -1.2     # z out of bounds
    x = np.stack([xs, ys, zs], axis=1)
    nvec = rng.uniform(-1.2, 1.2, (n, 3))
    return x, nvec


@pytest.fixture(scope="module", params=range(len(tp.MODEL_COMBOS)),
                ids=["-".join((c[0], c[1], c[2], *c[3])) for c in tp.MODEL_COMBOS])
def case(request):
    combo = tp.MODEL_COMBOS[request.param]
    jcfg, jparams, *_ = tp.jax_case(combo=combo)
    pcfg, pparams = tp.to_port(jcfg, jparams)
    x, nvec = _points()
    k0 = float(jparams.rf.k0)
    return dict(jcfg=jcfg, jparams=jparams, pcfg=pcfg, pparams=pparams,
                x=x, nvec=nvec, kvec=k0 * nvec, tx=torch.from_numpy(x),
                tn=torch.from_numpy(nvec), tk=torch.from_numpy(k0 * nvec))


def _jax_eq(c):
    return jax.vmap(lambda xx: jbase.equilibrium(c["jcfg"], c["jparams"], xx))(
        jnp.asarray(c["x"]))


def test_slab_fields_and_err(case):
    c = case
    st, jp, pp = c["jcfg"].eq_static, c["jparams"], c["pparams"]
    ref = jax.vmap(lambda xx: jslab.fields(st, jp.eq, jp.species, xx))(jnp.asarray(c["x"]))
    got = tslab.fields(c["pcfg"].eq_static, pp.eq, pp.species, c["tx"])
    for g, r, name in zip(got, ref, ("bvec", "ns", "ts")):
        close(g, r, what=name)
    err_ref = jax.vmap(lambda xx: jslab.err(st, jp.eq, jp.species, xx))(jnp.asarray(c["x"]))
    err_got = tslab.err(c["pcfg"].eq_static, pp.eq, pp.species, c["tx"])
    close(err_got, err_ref, what="err")
    codes = set(err_got.tolist())
    assert {int(StopCode.X_OUT_OF_BOUNDS), int(StopCode.Y_OUT_OF_BOUNDS),
            int(StopCode.Z_OUT_OF_BOUNDS)} <= codes


def test_equilibrium_eq_point(case):
    ref = _jax_eq(case)
    got = tbase.equilibrium(case["pcfg"], case["pparams"], case["tx"])
    # gradbunit = (gradb - gradbmag bunit)/|B| cancels exactly where B has
    # one component; its natural scale is |gradb|/|B|
    scales = {"gradbunit": np.abs(np.asarray(ref.gradb)).max()
              / np.abs(np.asarray(ref.bmag)).min()}
    for name in ref._fields:
        close(getattr(got, name), getattr(ref, name), what=name, scale=scales.get(name))
    light = tbase.eq_point_light(case["pcfg"], case["pparams"], case["tx"])
    jlight = jax.vmap(lambda xx: jbase.eq_point_light(
        case["jcfg"], case["jparams"], xx))(jnp.asarray(case["x"]))
    for g, r in zip(light, jlight):
        close(g, r, what="eq_point_light")


def test_stix_pieces(case):
    eq = _jax_eq(case)
    a, g = np.asarray(eq.alpha), np.asarray(eq.gamma)
    ta, tg = torch.tensor(a), torch.tensor(g)
    for fn_t, fn_j in ((tstix.rlsdp, jstix.rlsdp), (tstix.poly_pieces, jstix.poly_pieces)):
        ref = jax.vmap(fn_j)(jnp.asarray(a), jnp.asarray(g))
        for gg, rr in zip(fn_t(ta, tg), ref):
            close(gg, rr, what=fn_t.__name__)
    for fn_t, fn_j in ((tstix.leave_one_out_products, jstix.leave_one_out_products),
                       (tstix.leave_two_out_products, jstix.leave_two_out_products)):
        ref = jax.vmap(fn_j)(jnp.asarray(g))
        for gg, rr in zip(fn_t(tg), ref):
            close(gg, rr, what=fn_t.__name__)


def test_dispersion_D_and_residual(case):
    c = case
    omg = float(c["jparams"].rf.omgrf)
    ref = jax.vmap(lambda xx, kk: jdisp.dispersion_D(
        c["jcfg"], c["jparams"], xx, kk, omg))(jnp.asarray(c["x"]), jnp.asarray(c["kvec"]))
    got = tdisp.dispersion_D(c["pcfg"], c["pparams"], c["tx"], c["tk"],
                             c["pparams"].rf.omgrf)
    close(got, ref, what="dispersion_D")

    eq = _jax_eq(c)
    a, g = jnp.asarray(eq.alpha), jnp.asarray(eq.gamma)
    n1, n3 = jnp.asarray(c["nvec"][:, 0]), jnp.asarray(c["nvec"][:, 2])
    ref = jax.vmap(jdisp.residual)(a, g, n1, n3)
    got = tdisp.residual(*(torch.tensor(np.asarray(t)) for t in (a, g, n1, n3)))
    close(got, ref, what="residual")
    ref = jax.vmap(jdisp.poly_D_of_n)(a, g, n1**2, n3)
    got = tdisp.poly_D_of_n(*(torch.tensor(np.asarray(t)) for t in (a, g, n1**2, n3)))
    close(got, ref, what="poly_D_of_n")


def test_root_solvers(case):
    c = case
    jcfg, jp = c["jcfg"], c["jparams"]
    omg = jp.rf.omgrf
    a, g, bu, bm = jax.vmap(lambda xx: jdisp.alpha_gamma(jcfg, jp, xx, omg))(
        jnp.asarray(c["x"]))
    got = tdisp.alpha_gamma(c["pcfg"], c["pparams"], c["tx"], c["pparams"].rf.omgrf)
    for gg, rr in zip(got, (a, g, bu, bm)):
        close(gg, rr, what="alpha_gamma")
    ta, tg, tbu = (torch.tensor(np.asarray(t)) for t in (a, g, bu))
    n2 = jnp.asarray(c["nvec"][:, 1])
    n3 = jnp.asarray(c["nvec"][:, 2])
    tn2, tn3 = torch.tensor(np.asarray(n2)), torch.tensor(np.asarray(n3))

    roots, evan = jax.vmap(jdisp.solve_cold_n1sq_vs_n3)(a, g, n3)
    troots, tevan = tdisp.solve_cold_n1sq_vs_n3(ta, tg, tn3)
    close(troots, roots, what="n1sq roots")
    close(tevan, evan, what="evanescent")
    for mode in ("plus", "minus", "fast", "slow"):
        for k_sign in (1, -1):
            n1, ok = jax.vmap(lambda aa, gg, x2, x3: jdisp.solve_n1_vs_n2_n3(
                aa, gg, mode, k_sign, x2, x3))(a, g, n2, n3)
            tn1, tok = tdisp.solve_n1_vs_n2_n3(ta, tg, mode, k_sign, tn2, tn3)
            close(tn1, n1, what=f"n1 {mode}")
            close(tok, ok, what=f"valid {mode}")
            nx, okx = jax.vmap(lambda aa, gg, bb, x2, x3: jdisp.solve_nx_vs_ny_nz_by_bz(
                aa, gg, bb, mode, k_sign, x2, x3))(a, g, bu, n2, n3)
            tnx, tokx = tdisp.solve_nx_vs_ny_nz_by_bz(ta, tg, tbu, mode, k_sign, tn2, tn3)
            close(tnx, nx, what=f"nx {mode}")
            close(tokx, okx, what=f"valid nx {mode}")


def test_deriv_cold_matches_jax(case):
    c = case
    jp = c["jparams"]
    eq = _jax_eq(c)
    ref = jax.vmap(lambda e, n: jderiv.deriv_cold(e, n, jp.rf.omgrf, jp.rf.k0))(
        eq, jnp.asarray(c["nvec"]))
    teq = tbase.equilibrium(c["pcfg"], c["pparams"], c["tx"])
    got = tderiv.deriv_cold(teq, c["tn"], c["pparams"].rf.omgrf, c["pparams"].rf.k0)
    for gg, rr, name in zip(got, ref, ("dddx", "dddk", "dddw")):
        close(gg, rr, what=name)


def test_deriv_cold_matches_autograd(case):
    """The closed-form chain rule against torch.func.grad of the scalar D
    (tests/test_wave.py tolerances: rtol 1e-8 in x, 1e-10 in k and w)."""
    c = case
    pcfg, pp = c["pcfg"], c["pparams"]
    inside = (np.abs(c["x"][:, 0]) < 0.5) & (np.abs(c["x"][:, 1]) < 0.5) & \
        (np.abs(c["x"][:, 2]) < 1.0)
    x, k = c["tx"][inside], c["tk"][inside]
    w = pp.rf.omgrf.expand(x.shape[0]).clone()

    def total_D(xx, kk, ww):
        return tdisp.dispersion_D(pcfg, pp, xx, kk, ww).sum()

    dx_ad, dk_ad, dw_ad = torch.func.grad(total_D, argnums=(0, 1, 2))(x, k, w)
    eq = tbase.equilibrium(pcfg, pp, x)
    dx, dk, dw = tderiv.deriv_cold(eq, k / pp.rf.k0, pp.rf.omgrf, pp.rf.k0)
    np.testing.assert_allclose(dx_ad.numpy(), dx.numpy(), rtol=1e-8, atol=1e-20)
    np.testing.assert_allclose(dk_ad.numpy(), dk.numpy(), rtol=1e-10)
    np.testing.assert_allclose(dw_ad.numpy(), dw.numpy(), rtol=1e-10)


@pytest.mark.parametrize("ray_param", ["time", "arcl"])
def test_eqn_ray_and_check(case, ray_param):
    c = case
    jcfg = dataclasses.replace(c["jcfg"], ray_param=ray_param)
    pcfg = dataclasses.replace(c["pcfg"], ray_param=ray_param)
    v = np.concatenate([c["x"], c["kvec"], np.zeros((c["x"].shape[0], 1))], axis=1)
    ref = jax.vmap(lambda vv: jrhs.eqn_ray_and_check(
        jcfg, c["jparams"], jnp.float64(0.0), vv))(jnp.asarray(v))
    tv = torch.from_numpy(v)
    got = trhs.eqn_ray_and_check(pcfg, c["pparams"], torch.zeros((), dtype=torch.float64), tv)
    for gg, rr, name in zip(got, ref, ("dvds", "rhs_status", "resid", "check_status")):
        close(gg, rr, what=name)
    # eqn_ray and check_save alone agree with the combined evaluation
    dv, st = trhs.eqn_ray(pcfg, c["pparams"], 0.0, tv)
    assert torch.equal(dv, got[0]) and torch.equal(st, got[1])
    res, cst = trhs.check_save(pcfg, c["pparams"], tv)
    close(res, got[2].numpy(), what="check_save resid")
    assert torch.equal(cst, got[3])


def test_rhs_refuses_later_slices():
    """No RHS option is left to a later slice: the equilibrium-gradient
    slots and the autodiff derivatives compute (held to the JAX package in
    tests/test_torch_adaptive.py), damping runs with its slots, and only
    an option that does not exist raises."""
    jcfg, jparams, *_ = tp.jax_case()
    pcfg, pp = tp.to_port(jcfg, jparams)
    v = torch.zeros((1, 7), dtype=torch.float64)
    v[0, 0], v[0, 3] = -0.08, 1.0
    base_dv, base_st = trhs.eqn_ray(pcfg, pp, 0.0, v)
    grads = dataclasses.replace(pcfg, integrate_eq_gradients=True)
    vg = torch.cat([v, torch.zeros((1, 5), dtype=torch.float64)], dim=1)
    dv, st = trhs.eqn_ray(grads, pp, 0.0, vg)
    assert dv.shape == (1, grads.nv) == (1, 12) and st.tolist() == [0]
    assert torch.equal(dv[:, :7], base_dv)
    dv, st = trhs.eqn_ray(dataclasses.replace(pcfg, ray_deriv_name="autodiff"), pp, 0.0, v)
    assert st.tolist() == base_st.tolist()
    np.testing.assert_allclose(dv.numpy(), base_dv.numpy(), rtol=1e-8)
    for change in (dict(ray_deriv_name="numerical"), dict(ray_param="phase")):
        with pytest.raises(ValueError, match="invalid"):
            trhs.eqn_ray(dataclasses.replace(pcfg, **change), pp, 0.0, v)
    damped = dataclasses.replace(pcfg, damping_model="damp_fund_ECH")
    vd = torch.cat([v, torch.zeros((1, 1), dtype=torch.float64)], dim=1)
    dv, st = trhs.eqn_ray(damped, pp, 0.0, vd)
    assert dv.shape == (1, damped.nv) == (1, 8) and st.tolist() == [0]
    assert torch.equal(dv[:, :7], trhs.eqn_ray(pcfg, pp, 0.0, v)[0])
