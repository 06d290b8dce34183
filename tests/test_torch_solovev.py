"""rays_tpu_torch's Solovev tokamak against the JAX package: the model
(values, the closed-form jacobian against ``value_and_jacfwd`` of the JAX
fields, psi, the validity codes), the EqPoint, the ray init, the fixed-step
trace against the NumPy oracle, and gradients through the closed form
against ``jax.grad``.

Tolerance: rtol 1e-12 with an absolute floor of 1e-14 of each array's
scale on the point grid (the two packages round in different orders, never
differently in substance); 1e-14 relative on the launch vectors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.core.eq_point import value_and_jacfwd
from rays_tpu.models import base as jbase, profiles as jprofiles, solovev as jsol
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch import examples as tex
from rays_tpu_torch.models import base as tbase, profiles as tprofiles, solovev as tsol
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.tracing.stop import StopCode
from test_parity import _assert_parity, _oracle_cfg, _solovev_eq_fn

RTOL, ATOL_OF_SCALE = 1e-12, 1e-14

# every density and temperature model of models/solovev.py
MODEL_COMBOS = [("parabolic", ("parabolic", "parabolic")),
                ("constant", ("zero", "constant")),
                ("parabolic", ("constant", "parabolic"))]
PROFILE_OVERRIDES = dict(alphan1=1.5, alphan2=2.5,
                         alphat1=np.array([1.2, 2.0]), alphat2=np.array([2.0, 3.0]))

# a fan over two radii, three angles, two n_theta and two n_phi: some of
# its candidates lie outside the plasma or are evanescent
WIDE_FAN = jex.SOLOVEV_ECH_90GHZ.replace(
    "n_r_launch=1, r_launch0=0.3, dr_launch=0.0,",
    "n_r_launch=2, r_launch0=0.2, dr_launch=0.12,").replace(
    "n_theta_launch=4, theta_launch0=0.0, dtheta_launch=0.7854,",
    "n_theta_launch=3, theta_launch0=-0.5, dtheta_launch=1.3,").replace(
    "n_rindex_phi=1, rindex_phi0=0.3, delta_rindex_phi=0.0",
    "n_rindex_phi=2, rindex_phi0=0.1, delta_rindex_phi=0.5")


def close(got, ref, what="", rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=ATOL_OF_SCALE * scale, err_msg=what)


def _points():
    """Points from a fixed seed, as (R, phi, z): inside the plasma, between
    the boundary (psiN > 1) and the box, and outside the box in R (both
    sides) and in z."""
    rng = np.random.default_rng(12)
    n = 40
    R = rng.uniform(0.9, 1.5, n)
    z = rng.uniform(-0.45, 0.45, n)
    R[24:32] = rng.uniform(1.6, 2.3, 8)       # outside the boundary, in the box
    z[28:32] = rng.uniform(0.9, 1.8, 4)
    R[32:34] = [0.1, 0.15]                    # inside box_rmin
    R[34:36] = [2.6, 3.0]                     # beyond box_rmax
    z[36:38] = [2.2, -2.5]                    # beyond the box in z
    phi = rng.uniform(-np.pi, np.pi, n)
    return np.stack([R * np.cos(phi), R * np.sin(phi), z], axis=1)


@pytest.fixture(scope="module", params=range(len(MODEL_COMBOS)),
                ids=["-".join((d, *t)) for d, t in MODEL_COMBOS])
def case(request):
    dens, tm = MODEL_COMBOS[request.param]
    jcfg, jparams, *_ = jex.setup_example(jex.SOLOVEV_ECH_90GHZ)
    jcfg = dataclasses.replace(jcfg, eq_static=jsol.SolovevStatic(
        dens_prof_model=dens, t_prof_model=tm))
    jparams = jparams._replace(eq=jparams.eq._replace(
        **{k: jnp.asarray(v, jnp.float64) for k, v in PROFILE_OVERRIDES.items()}))
    pcfg, pparams = tp.to_port(jcfg, jparams)
    x = _points()
    return dict(jcfg=jcfg, jparams=jparams, pcfg=pcfg, pparams=pparams, x=x,
                tx=torch.from_numpy(x))


def test_grid_covers_every_region(case):
    """The grid has points inside the plasma, outside its boundary but in
    the box, and outside the box on every side."""
    psiN = tsol.psi(case["pparams"].eq, case["tx"])[2]
    err = tsol.geom_err(case["pcfg"].eq_static, case["pparams"].eq, case["tx"])
    assert int(((psiN < 1) & (err == 0)).sum()) >= 20
    assert int(((psiN > 1) & (err == 0)).sum()) >= 8
    assert {int(StopCode.R_OUT_OF_BOX), int(StopCode.Z_OUT_OF_BOX)} <= set(err.tolist())


def test_fields_match_jax(case):
    c = case
    st, jp, pp = c["jcfg"].eq_static, c["jparams"], c["pparams"]
    ref = jax.vmap(lambda xx: jsol.fields(st, jp.eq, jp.species, xx))(jnp.asarray(c["x"]))
    got = tsol.fields(c["pcfg"].eq_static, pp.eq, pp.species, c["tx"])
    for g, r, name in zip(got, ref, ("bvec", "ns", "ts")):
        close(g, r, what=name)
    br = jax.vmap(lambda xx: jsol.b_cylindrical(jp.eq, xx))(jnp.asarray(c["x"]))
    for g, r, name in zip(tsol.b_cylindrical(pp.eq, c["tx"]), br, ("br", "bz", "bphi")):
        close(g, r, what=name)


def test_closed_form_jacobian_matches_jacfwd(case):
    """jb, jn, jt of fields_and_jac against forward-mode autodiff of the JAX
    fields, inside and outside the plasma boundary; outside, the profile
    gradients are exact zeros on both sides."""
    c = case
    st, jp, pp = c["jcfg"].eq_static, c["jparams"], c["pparams"]
    vals, jacs = jax.vmap(lambda xx: value_and_jacfwd(
        lambda y: jsol.fields(st, jp.eq, jp.species, y), xx))(jnp.asarray(c["x"]))
    gvals, gjacs = tsol.fields_and_jac(c["pcfg"].eq_static, pp.eq, pp.species, c["tx"])
    for g, r, name in zip(gvals, vals, ("bvec", "ns", "ts")):
        close(g, r, what=name)
    for g, r, name in zip(gjacs, jacs, ("jb", "jn", "jt")):
        assert tuple(g.shape) == np.asarray(r).shape, name
        close(g, r, what=name)
    outside = (tsol.psi(pp.eq, c["tx"])[2] >= 1).numpy()
    if st.dens_prof_model == "parabolic":
        assert not gjacs[1][outside].any() and not np.asarray(jacs[1])[outside].any()
        assert gjacs[1][~outside].abs().amax() > 0
    assert not gjacs[2][outside].any() and not np.asarray(jacs[2])[outside].any()


def test_psi_and_boundaries_match_jax(case):
    c = case
    jp, pp = c["jparams"], c["pparams"]
    ref = jax.vmap(lambda xx: jsol.psi(jp.eq, xx))(jnp.asarray(c["x"]))
    for g, r, name in zip(tsol.psi(pp.eq, c["tx"]), ref,
                          ("psi", "gradpsi", "psiN", "gradpsiN")):
        close(g, r, what=name)
    close(tsol.psi_boundary(pp.eq), jsol.psi_boundary(jp.eq), what="psi_boundary")
    for g, r in zip(tsol.boundaries(pp.eq), jsol.boundaries(jp.eq)):
        close(g, r, what="boundaries")
    # psi broadcasts over leading axes (post/deposition.py hands it (B, n, 3))
    grid = c["tx"].reshape(4, 10, 3)
    assert torch.equal(tsol.psi(pp.eq, grid)[2].reshape(-1), tsol.psi(pp.eq, c["tx"])[2])


def test_err_codes_match_jax(case):
    c = case
    st, jp, pp = c["jcfg"].eq_static, c["jparams"], c["pparams"]
    x = jnp.asarray(c["x"])
    close(tsol.geom_err(c["pcfg"].eq_static, pp.eq, c["tx"]),
          jax.vmap(lambda xx: jsol.geom_err(st, jp.eq, xx))(x), what="geom_err")
    close(tsol.err(c["pcfg"].eq_static, pp.eq, pp.species, c["tx"]),
          jax.vmap(lambda xx: jsol.err(st, jp.eq, jp.species, xx))(x), what="err")
    close(tbase.eq_err(c["pcfg"], pp, c["tx"]),
          jax.vmap(lambda xx: jbase.eq_err(c["jcfg"], jp, xx))(x), what="eq_err")


def test_equilibrium_eq_point_matches_jax(case):
    """The EqPoint, whose gradb is the transpose of jb: the index order of
    both packages' models/base.py."""
    c = case
    ref = jax.vmap(lambda xx: jbase.equilibrium(c["jcfg"], c["jparams"], xx))(
        jnp.asarray(c["x"]))
    got = tbase.equilibrium(c["pcfg"], c["pparams"], c["tx"])
    for name in ref._fields:
        close(getattr(got, name), getattr(ref, name), what=name)
    jb = tsol.fields_and_jac(c["pcfg"].eq_static, c["pparams"].eq, c["pparams"].species,
                             c["tx"])[1][0]
    assert torch.equal(got.gradb, jb.transpose(1, 2))
    assert (got.gradb - got.gradb.transpose(1, 2)).abs().amax() > 0.1   # not symmetric
    light = tbase.eq_point_light(c["pcfg"], c["pparams"], c["tx"])
    jlight = jax.vmap(lambda xx: jbase.eq_point_light(c["jcfg"], c["jparams"], xx))(
        jnp.asarray(c["x"]))
    for g, r in zip(light, jlight):
        close(g, r, what="eq_point_light")


def test_axis_guard():
    """On the axis R is held at 1e-12 and its derivative is zero: values
    and jacobian stay finite."""
    pcfg, pp = tp.to_port(*jex.setup_example(jex.SOLOVEV_ECH_90GHZ)[:2])
    x = torch.tensor([[0.0, 0.0, 0.1], [1e-13, 0.0, -0.2]], dtype=torch.float64)
    vals, jacs = tsol.fields_and_jac(pcfg.eq_static, pp.eq, pp.species, x)
    for t in (*vals, *jacs):
        assert torch.isfinite(t).all()
    assert not jacs[1].any() and not jacs[2].any()
    assert tsol.geom_err(pcfg.eq_static, pp.eq, x).tolist() == [int(StopCode.R_OUT_OF_BOX)] * 2


@pytest.mark.parametrize("a1,a2", [(1.0, 2.0), (1.5, 2.5), (2.0, 3.0)])
def test_parabolic_psi_matches_jax(a1, a2):
    psiN = np.concatenate([np.linspace(0.0, 1.3, 27), [1.0, 1e-40, 0.999999]])
    ref = jax.vmap(lambda p: jprofiles.parabolic_psi(p, a1, a2))(jnp.asarray(psiN))
    got = tprofiles.parabolic_psi(torch.from_numpy(psiN), torch.tensor(a1, dtype=torch.float64),
                                  torch.tensor(a2, dtype=torch.float64))
    for g, r, name in zip(got, ref, ("f", "df")):
        close(g, r, what=name)
    assert not got[0][psiN >= 1].any() and not got[1][psiN >= 1].any()


@pytest.mark.parametrize("text", [jex.SOLOVEV_ECH_90GHZ, WIDE_FAN], ids=["example", "wide_fan"])
def test_ray_init_matches_jax(text):
    """Count and order exact, values to 1e-14; both fans drop candidates."""
    jcfg, _, v0, st, pwr = jex.setup_example(text)
    pcfg, _, tv0, tst, tpw = tex.setup_example(text, device="cpu")
    v0 = np.asarray(v0)
    ri = pcfg.rayinit_static
    n_cand = ri.n_r_launch * ri.n_theta_launch * ri.n_rindex_theta * ri.n_rindex_phi
    assert 0 < v0.shape[0] < n_cand
    assert tv0.shape == v0.shape and tv0.dtype == torch.float64
    np.testing.assert_array_equal(tv0[:, 0:3].numpy(), v0[:, 0:3])
    np.testing.assert_allclose(tv0.numpy(), v0, rtol=1e-14, atol=1e-14 * np.abs(v0).max())
    np.testing.assert_array_equal(tst.numpy(), np.asarray(st))
    np.testing.assert_array_equal(tpw.numpy(), np.asarray(pwr))


def test_ray_init_errors():
    cfg, params, *_ = tex.setup_example(tex.SOLOVEV_ECH_90GHZ, device="cpu")
    from rays_tpu_torch import run as trun

    with pytest.raises(ValueError, match="nray_max"):
        trun.init_rays(dataclasses.replace(cfg, nray_max=3), params)
    outside = dataclasses.replace(cfg.rayinit_static, r_launch0=3.0)   # out of the box
    with pytest.raises(RuntimeError, match="no successful ray"):
        trun.init_rays(dataclasses.replace(cfg, rayinit_static=outside), params)


def test_solovev_rk4_matches_oracle():
    """The fan under fixed-step RK4 against the scalar NumPy transcription
    of the reference, at the bar of tests/test_parity.py::
    test_parity_solovev_rk4 (80 of the example's 200 steps, to keep the
    scalar oracle quick)."""
    cfg, params, v0, st, pwr = tex.setup_example(tex.SOLOVEV_ECH_90GHZ, device="cpu")
    cfg = dataclasses.replace(cfg, ode_solver_name="RK4_ODE", nstep_max=80)
    res = ttrace.trace_batch(cfg, params, v0, st, pwr)
    assert res.npoints.tolist() == [81] * 5
    oc = _oracle_cfg(cfg, params, _solovev_eq_fn(cfg, params))
    _assert_parity(cfg, params, res, oc)


def test_solovev_rk4_matches_jax():
    """The same trace against the JAX tracer: 1e-9 of trajectory scale."""
    cfg, params, v0, st, pwr = tp.jax_case(
        jex.SOLOVEV_ECH_90GHZ, ode_solver_name="RK4_ODE", nstep_max=80)
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))(params, v0, st, pwr)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    got = ttrace.trace_batch(pcfg, pp, tv0, tst, tpw)
    np.testing.assert_array_equal(got.npoints.numpy(), np.asarray(ref.npoints))
    np.testing.assert_array_equal(got.stop_flag.numpy(), np.asarray(ref.stop_flag))
    tp.assert_scaled_close(got.ray_vec, np.asarray(ref.ray_vec), 1e-9, axis=1,
                           what="trajectory")


def test_gradients_through_closed_form_match_jax():
    """Autograd differentiates the closed-form jacobian: the gradient of an
    RK4 trace's end point with respect to the equilibrium, rf and species
    leaves against jax.grad through jacfwd of the fields (rtol 1e-8)."""
    cfg, params, v0, st, pwr = tp.jax_case(
        jex.SOLOVEV_ECH_90GHZ, ode_solver_name="RK4_ODE", nstep_max=6, save_trajectory=False)

    def jloss(p):
        r = jtrace.trace_batch(cfg, p, v0, st, pwr)
        return jnp.sum(r.end_ray_vec[:, 0:6] ** 2 * pwr[:, None])

    ref = jax.jit(jax.grad(jloss))(params)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    from rays_tpu_torch.core.types import tree_leaves, tree_map

    pg = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    r = ttrace.trace_rays(pcfg, pg, tv0, tst, tpw)
    loss = (r.end_ray_vec[:, 0:6] ** 2 * tpw[:, None]).sum()
    grads = torch.autograd.grad(loss, tree_leaves(pg), allow_unused=True, materialize_grads=True)
    close(loss, jloss(params), what="loss")
    names = [f"{g}.{f}" for g, sub in zip(pp._fields, pp) for f in sub._fields]
    live = 0
    for name, g, r_ in zip(names, grads, jax.tree_util.tree_leaves(ref)):
        r_ = np.asarray(r_)
        np.testing.assert_allclose(g.numpy(), r_, rtol=1e-8,
                                   atol=1e-12 * max(np.abs(r_).max(), 1e-300), err_msg=name)
        live += bool(np.abs(r_).max() > 0)
    assert live >= 10
