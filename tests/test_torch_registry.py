"""The port's equilibrium-model registry and generic forward-mode jacobian
against the JAX package's (``rays_tpu.models.base.register_eq_model``,
``rays_tpu.core.eq_point.value_and_jacfwd``).

* A toy model with only ``fields``, ``geom_err`` and ``err`` (the slab's
  fields shifted in x), registered in both packages under one name, traces
  the slab example's 3 rays x 40 RK4 steps at f64 to the same end states:
  within 1e-9 of each ray's scale, npoints and flags equal.  Both packages
  take its jacobians by forward mode.
* ``value_and_jacfwd`` of each built-in model's ``fields`` equals its
  closed-form jacobian within 1e-10 of scale: the slab (every profile
  model), Solovev, the three ``axisym_toroid`` magnetics backends and the
  mirror.  The JAX forward mode gives the same columns on the slab.
* ``equilibrium`` takes forward mode when ``supports_analytic_jac`` says
  no, and the EqPoint is the closed form's within 1e-10 of scale.
* ``default_params`` equals the JAX one field for field; ``asarrays``
  makes every leaf a tensor of the dtype and device asked for.
* A name nobody registered still raises ``NotImplementedError``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from test_axisym import AXISYM_TMPL
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.core import eq_point as jeq
from rays_tpu.models import base as jbase
from rays_tpu.models import slab as jslab
from rays_tpu.models import solovev as jsolovev
from rays_tpu_torch import examples, run as trun
from rays_tpu_torch.core import eq_point as teq
from rays_tpu_torch.core.types import asarrays, tree_leaves
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.models import slab as tslab
from rays_tpu_torch.models import solovev as tsolovev
from rays_tpu_torch.tracing import fused_slab
from rays_tpu_torch.tracing import trace as ttrace

END_RTOL = 1e-9
JAC_RTOL = 1e-10
TOY_STEPS = 40
SHIFT = 2.0e-3      # m, the toy's shift of the slab's profiles in x


def _jax_toy():
    def fields(static, p, species, rvec):
        return jslab.fields(static, p, species, rvec - jnp.array([SHIFT, 0.0, 0.0]))

    def geom_err(static, p, rvec):
        return jslab.geom_err(static, p, rvec)

    def err(static, p, species, rvec):
        return jslab.err(static, p, species, rvec - jnp.array([SHIFT, 0.0, 0.0]))

    return types.SimpleNamespace(fields=fields, geom_err=geom_err, err=err)


def _port_toy():
    def shifted(rvec):
        return rvec - torch.tensor([SHIFT, 0.0, 0.0], dtype=rvec.dtype, device=rvec.device)

    def fields(static, p, species, rvec):
        return tslab.fields(static, p, species, shifted(rvec))

    def geom_err(static, p, rvec):
        return tslab.geom_err(static, p, rvec)

    def err(static, p, species, rvec):
        return tslab.err(static, p, species, shifted(rvec))

    return types.SimpleNamespace(fields=fields, geom_err=geom_err, err=err)


@pytest.fixture
def toy_registered():
    """The toy model under the name 'shifted_slab' in both registries,
    taken out again after the test."""
    name = "shifted_slab"
    jbase.register_eq_model(name, _jax_toy())
    tbase.register_eq_model(name, _port_toy())
    try:
        yield name
    finally:
        jbase.EQ_MODELS.pop(name, None)
        tbase.EQ_MODELS.pop(name, None)


def test_registered_model_traces_like_jax(toy_registered):
    jcfg, jparams, jv0, jst, jpwr = tp.jax_case(nstep_max=TOY_STEPS, save_trajectory=False)
    jcfg = dataclasses.replace(jcfg, equilib_model=toy_registered)
    # the launch points move with the profiles: the toy's rays are the
    # slab's, translated by SHIFT
    jv0 = jv0.at[:, 0].add(SHIFT)
    jres = tp.jax_trace(jcfg, jparams, jv0, jst, jpwr)
    base_cfg, pparams, v0, st, pwr = tp.to_port(*tp.jax_case(nstep_max=TOY_STEPS,
                                                             save_trajectory=False)[:2],
                                                jv0, jst, jpwr)
    pcfg = dataclasses.replace(base_cfg, equilib_model=toy_registered)
    # a registered model takes the plain route on every device, the kernel
    # gate is the slab's alone
    for dev in ("cpu", "cuda"):
        assert ttrace.route(pcfg, False, dev) == "plain"
    assert not fused_slab.supported(pcfg) and fused_slab.supported(base_cfg)
    before = fused_slab.LAUNCHES
    res = ttrace.trace_rays(pcfg, pparams, v0, st, pwr)
    assert fused_slab.LAUNCHES == before
    np.testing.assert_array_equal(res.npoints.numpy(), np.asarray(jres.npoints))
    np.testing.assert_array_equal(res.stop_flag.numpy(), np.asarray(jres.stop_flag))
    tp.assert_scaled_close(res.end_ray_vec.numpy(), np.asarray(jres.end_ray_vec), END_RTOL,
                           axis=-1, what="toy model end state")
    assert int(res.npoints.min()) > TOY_STEPS // 2
    # ... and they are the slab's rays translated by SHIFT
    moved = v0.clone()
    moved[:, 0] -= SHIFT
    slab = ttrace.trace_rays(base_cfg, pparams, moved, st, pwr)
    back = res.end_ray_vec.clone()
    back[:, 0] -= SHIFT
    assert torch.equal(slab.npoints, res.npoints)
    tp.assert_scaled_close(back.numpy(), slab.end_ray_vec.numpy(), END_RTOL, axis=-1,
                           what="toy minus shift against the slab")


def test_registered_name_shadows_a_built_in_one():
    """A model registered under a built-in name is the one that runs, and
    the slab kernel never takes it."""
    cfg, params, v0, _, _ = examples.setup_example(device="cpu")
    assert ttrace.route(cfg, False, "cuda") == "kernel"
    tbase.register_eq_model("slab", _port_toy())
    try:
        assert tbase.get_eq_model("slab") is tbase.EQ_MODELS["slab"]
        assert ttrace.route(cfg, False, "cuda") == "plain"
        shifted = tbase.equilibrium(cfg, params, v0[:, :3])
    finally:
        tbase.EQ_MODELS.pop("slab")
    assert tbase.get_eq_model("slab") is tslab
    moved = v0[:, :3] - torch.tensor([SHIFT, 0.0, 0.0], dtype=v0.dtype)
    ref = tbase.equilibrium(cfg, params, moved)
    for name in ("bvec", "gradb", "ns", "gradns", "alpha", "gamma"):
        tp.assert_rows_close(getattr(shifted, name), getattr(ref, name).numpy(), JAC_RTOL, name)


def test_unknown_name_still_raises():
    cfg = examples.setup_example(device="cpu")[0]
    for dev in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match="tokamak_3d"):
            ttrace.route(dataclasses.replace(cfg, equilib_model="tokamak_3d"), False, dev)
    with pytest.raises(NotImplementedError, match="tokamak_3d"):
        tbase.get_eq_model("tokamak_3d")


def _points(v0, n=16, seed=0):
    """n points near the launch points (numpy seed): the first three
    coordinates of v0 jittered by up to 2 cm."""
    rng = np.random.default_rng(seed)
    base = v0[:, :3].double().numpy()
    pts = base[np.arange(n) % base.shape[0]] + rng.uniform(-0.02, 0.02, (n, 3))
    return torch.from_numpy(pts)


def _assert_jac_matches(cfg, params, x):
    model = tbase.get_eq_model(cfg.equilib_model)
    st, p, sp = cfg.eq_static, params.eq, params.species
    vals, jacs = model.fields_and_jac(st, p, sp, x)
    got_vals, got_jacs = teq.value_and_jacfwd(lambda xx: model.fields(st, p, sp, xx), x)
    for name, g, r in zip(("bvec", "ns", "ts"), got_vals, vals):
        tp.assert_rows_close(g, r.numpy(), 1e-14, name)
    for name, g, r in zip(("jb", "jn", "jt"), got_jacs, jacs):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        scale = max(float(r.abs().max()), 1e-300)
        err = float((g - r).abs().max()) / scale
        assert err <= JAC_RTOL, f"{cfg.equilib_model} {name}: {err:.3e} of scale"


@pytest.mark.parametrize("combo", tp.MODEL_COMBOS, ids=lambda c: "-".join((c[0], c[1], c[2])))
def test_jacfwd_matches_closed_form_slab(combo):
    jcfg, jparams, jv0, jst, jpwr = tp.jax_case(combo=combo)
    cfg, params, v0 = tp.to_port(jcfg, jparams, jv0)
    x = _points(v0, seed=1)
    _assert_jac_matches(cfg, params, x)
    # the JAX package's forward mode gives the same columns, point by point
    (jb, jn, jt) = jax.vmap(lambda r: jeq.value_and_jacfwd(
        lambda rr: jslab.fields(jcfg.eq_static, jparams.eq, jparams.species, rr), r)[1])(
            jnp.asarray(x.numpy()))
    got = teq.value_and_jacfwd(
        lambda xx: tslab.fields(cfg.eq_static, params.eq, params.species, xx), x)[1]
    for name, g, r in zip(("jb", "jn", "jt"), got, (jb, jn, jt)):
        tp.assert_rows_close(g, np.asarray(r), JAC_RTOL, name)


def test_jacfwd_matches_closed_form_solovev():
    cfg, params, v0, _, _ = examples.setup_example(examples.SOLOVEV_ECH_90GHZ, device="cpu")
    _assert_jac_matches(cfg, params, _points(v0, seed=2))


@pytest.fixture(scope="module")
def eqdsk_file(tmp_path_factory):
    return tp.write_solovev_geqdsk(tmp_path_factory.mktemp("eqdsk") / "solovev.geqdsk")


@pytest.mark.parametrize("mag", ["eqdsk_magnetics_spline_interp", "eqdsk_magnetics_lin_interp",
                                 "solovev_magnetics"])
def test_jacfwd_matches_closed_form_axisym(mag, eqdsk_file):
    from rays_tpu_torch.config import schema as tschema
    from rays_tpu_torch.config.namelist import parse_namelist as tparse

    cfg, params = tschema.from_namelist(tparse(AXISYM_TMPL.format(MAG=mag, EQDSK=eqdsk_file)))
    assert cfg.eq_static.magnetics_model == mag
    pts = torch.tensor([[1.45, 0.0, 0.1], [1.2, 0.3, -0.2], [0.9, 0.2, 0.4],
                        [1.5, 0.0, 0.0]], dtype=torch.float64)
    _assert_jac_matches(cfg, params, _points(torch.cat([pts, pts.new_zeros((4, 4))], 1),
                                             seed=3))


def test_jacfwd_matches_closed_form_mirror(tmp_path):
    path = examples.write_mirror_example(tmp_path, n_r=21, n_z=81)
    cfg, params, v0, _, _ = trun.setup(path, device="cpu")
    x = _points(v0, seed=4)
    x[:, :2] *= 0.5     # inside the last uninterrupted flux surface
    _assert_jac_matches(cfg, params, x)


def test_equilibrium_takes_forward_mode_where_the_closed_form_says_no(tmp_path):
    """A module that has the closed forms but whose supports_analytic_jac
    is false: equilibrium takes forward mode through ``fields``, and the
    EqPoint equals the closed form's."""
    from rays_tpu_torch.models import multiple_mirror as tmm

    path = examples.write_mirror_example(tmp_path, n_r=21, n_z=81)
    cfg, params, v0, _, _ = trun.setup(path, device="cpu")
    assert tmm.supports_analytic_jac(cfg.eq_static, params.eq)
    calls = []

    def fields(*a):
        calls.append(1)
        return tmm.fields(*a)

    no_closed = types.SimpleNamespace(
        fields=fields, geom_err=tmm.geom_err, err=tmm.err,
        fields_and_jac=tmm.fields_and_jac, fields_jac_geom=tmm.fields_jac_geom,
        supports_analytic_jac=lambda static, p: False)
    x = _points(v0, seed=5)
    x[:, :2] *= 0.5
    ref = tbase.equilibrium(cfg, params, x)
    tbase.register_eq_model("mirror_by_jvp", no_closed)
    try:
        got = tbase.equilibrium(dataclasses.replace(cfg, equilib_model="mirror_by_jvp"),
                                params, x)
    finally:
        tbase.EQ_MODELS.pop("mirror_by_jvp")
    assert len(calls) == 3       # one JVP per coordinate
    for name in ("bvec", "gradb", "gradbmag", "gradbunit", "ns", "gradns", "ts", "gradts"):
        tp.assert_rows_close(getattr(got, name), getattr(ref, name).numpy(), JAC_RTOL, name)
    assert torch.equal(got.err, ref.err)


@pytest.mark.parametrize("ns", [1, 3])
@pytest.mark.parametrize("pair", [(jslab, tslab), (jsolovev, tsolovev)],
                         ids=["slab", "solovev"])
def test_default_params_match_jax(pair, ns):
    jmod, tmod = pair
    j, t = jmod.default_params(ns), tmod.default_params(ns)
    assert type(t).__name__ == type(j).__name__ and t._fields == j._fields
    for name in j._fields:
        a, b = np.asarray(getattr(j, name)), np.asarray(getattr(t, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_asarrays_maps_every_leaf():
    p = asarrays(tsolovev.default_params(2), dtype=torch.float32, device="cpu")
    leaves = tree_leaves(p)
    assert len(leaves) == len(p._fields)
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
               and x.device.type == "cpu" for x in leaves)
    assert p.alphat2.tolist() == [2.0, 2.0] and float(p.outer_bound) == pytest.approx(1.3)
