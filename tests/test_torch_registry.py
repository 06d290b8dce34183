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
* A registered model takes the compiled routes on the card (graph,
  adjoint, tangent), never the kernel.  The static twins of the graph
  route and the adjoint graph equal ``trace_batch`` (bit for bit; the
  gradients within 1e-12 of scale) on the toy model and on a mirror
  without its closed forms; the tangent graph's twin equals eager forward
  AD on the built-in slab and Solovev modules registered under new names
  (the toy's tangents, whose jacobians come forward over reverse, are
  held to the JAX package in tests/test_torch_jacfwd_tangents.py).  A
  model that reads the host is refused with its name before anything is
  captured; the toy passes the same audit on all three loops.
* ``default_params`` equals the JAX one field for field; ``asarrays``
  makes every leaf a tensor of the dtype and device asked for.
* A name nobody registered still raises ``NotImplementedError``.
"""

import contextlib
import dataclasses
import types
import torch.autograd.forward_ad as fwAD

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
from rays_tpu_torch.tracing import capture_audit, fused_slab, graphed, graphed_adjoint as ga
from rays_tpu_torch.tracing import graphed_tangent as gt
from rays_tpu_torch.tracing import trace as ttrace
from test_torch_graph_cache import _assert_grads_close, _grads, _loss, _with_grad
from test_torch_graphed_tangent import TANGENT_RTOL, _assert_same_tangents, _direction, _traced

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
        # a row of an identity on rvec's device, not a tensor made from a
        # Python list: that would be copied from the host at each call,
        # which the graph routes refuse to capture
        return rvec - SHIFT * torch.eye(3, dtype=rvec.dtype, device=rvec.device)[0]

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
    # a registered model takes the compiled routes on the card (the CPU
    # stays plain); the kernel gate is the slab's alone
    assert ttrace.route(pcfg, False, "cpu") == "plain"
    assert ttrace.route(pcfg, False, "cuda") == "graph"
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
    the slab kernel never takes it: it takes the graph route."""
    cfg, params, v0, _, _ = examples.setup_example(device="cpu")
    assert ttrace.route(cfg, False, "cuda") == "kernel"
    tbase.register_eq_model("slab", _port_toy())
    try:
        assert tbase.get_eq_model("slab") is tbase.EQ_MODELS["slab"]
        assert ttrace.route(cfg, False, "cuda") == "graph"
        assert not fused_slab.supported(cfg)
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


# --- the compiled routes ----------------------------------------------------------

COMPILED_STEPS = 12


def _host_reading_slab():
    """The slab with its closed form, reading the host in it (a
    ``.item()``)."""
    def fields_and_jac(static, p, species, rvec):
        if rvec[:, 0].max().item() > 1e9:
            raise AssertionError("never")
        return tslab.fields_and_jac(static, p, species, rvec)

    return types.SimpleNamespace(fields=tslab.fields, geom_err=tslab.geom_err, err=tslab.err,
                                 fields_and_jac=fields_and_jac)


def test_registered_model_takes_the_compiled_routes(toy_registered):
    cfg = dataclasses.replace(examples.setup_example(device="cpu")[0],
                              equilib_model=toy_registered)
    assert ttrace.route(cfg, False, "cuda") == "graph"
    assert ttrace.route(cfg, True, "cuda") == "adjoint"
    assert ttrace.route(cfg, False, "cuda", tangents=True) == "tangent"
    assert ttrace.route(cfg, True, "cuda", tangents=True) == "plain"
    for needs, tangents in ((False, False), (True, False), (False, True)):
        assert ttrace.route(cfg, needs, "cpu", tangents=tangents) == "plain"
    # ... by the same rules as a built-in config: the SG loop form has no
    # reverse rule, the autodiff derivatives take neither derivative graph
    sg = dataclasses.replace(cfg, ode_solver_name="SG_ODE", sg_scan_substeps=0)
    assert [ttrace.route(sg, *a) for a in ((False, "cuda"), (True, "cuda"))] == ["graph", "plain"]
    assert ttrace.route(sg, False, "cuda", tangents=True) == "tangent"
    auto = dataclasses.replace(cfg, ray_deriv_name="autodiff")
    assert ttrace.route(auto, True, "cuda") == ttrace.route(auto, False, "cuda",
                                                          tangents=True) == "plain"


def _registered_case(which, tmp_path):
    """(cfg, params, v0, st, pwr) of a registered model on the CPU: the
    toy on the slab's rays moved by SHIFT, or the mirror taking forward
    mode (``mirror_by_jvp``), at COMPILED_STEPS steps with trajectories."""
    if which == "toy":
        cfg, params, v0, st, pwr = examples.setup_example(device="cpu")
        v0 = v0.clone()
        v0[:, 0] += SHIFT
        model = _port_toy()
    else:
        from rays_tpu_torch.models import multiple_mirror as tmm

        cfg, params, v0, st, pwr = trun.setup(
            examples.write_mirror_example(tmp_path, n_r=17, n_z=41), device="cpu")
        model = types.SimpleNamespace(fields=tmm.fields, geom_err=tmm.geom_err, err=tmm.err,
                                      supports_analytic_jac=lambda static, p: False)
    cfg = dataclasses.replace(cfg, equilib_model=f"{which}_registered",
                              nstep_max=COMPILED_STEPS, save_trajectory=True)
    return model, (cfg, params, v0, st, pwr)


@pytest.mark.parametrize("which", ["toy", "mirror_by_jvp"])
def test_graph_and_adjoint_twins_on_a_registered_model(which, tmp_path):
    model, (cfg, params, v0, st, pwr) = _registered_case(which, tmp_path)
    tbase.register_eq_model(cfg.equilib_model, model)
    try:
        assert ttrace.route(cfg, False, "cuda") == "graph"
        ref = ttrace.trace_batch(cfg, params, v0, st, pwr)
        got = graphed.trace_batch_static(cfg, params, v0, st, pwr)
        for name, g, r in zip(ttrace.RayResults._fields, got, ref):
            assert (g is None and r is None) or torch.equal(g, r), name
        assert int(ref.npoints.max()) > COMPILED_STEPS // 2
        p, q = _with_grad(params), _with_grad(params)
        loss = _loss(ga.trace_batch_static_adjoint(cfg, p, v0, st, pwr))
        ref_loss = _loss(ttrace.trace_batch(cfg, q, v0, st, pwr))
        assert torch.equal(loss.detach(), ref_loss.detach())
        _assert_grads_close(_grads(loss, p), _grads(ref_loss, q))
    finally:
        tbase.EQ_MODELS.pop(cfg.equilib_model)


@pytest.mark.parametrize("text", [examples.SLAB_ECH_90GHZ, examples.SOLOVEV_ECH_90GHZ],
                         ids=["slab", "solovev"])
def test_tangent_twin_on_a_built_in_model_under_a_new_name(text):
    cfg, params, v0, st, pwr = examples.setup_example(text, device="cpu")
    name = f"{cfg.equilib_model}_registered"
    cfg = dataclasses.replace(cfg, equilib_model=name, nstep_max=COMPILED_STEPS,
                              save_trajectory=True)
    tbase.register_eq_model(name, tbase.get_eq_model(cfg.equilib_model.rsplit("_", 1)[0]))
    try:
        assert ttrace.route(cfg, False, "cuda", tangents=True) == "tangent"
        direction = _direction(params, v0, pwr)
        ref = _traced(ttrace.trace_batch, cfg, params, v0, st, pwr, direction)
        got = _traced(gt.trace_batch_static_tangent, cfg, params, v0, st, pwr, direction)
    finally:
        tbase.EQ_MODELS.pop(name)
    _assert_same_tangents(got, ref, TANGENT_RTOL, name)
    assert float(ref["end_ray_vec"][1].abs().max()) > 0


@pytest.mark.parametrize("kind", ["graph", "adjoint", "tangent"])
def test_a_host_reading_model_is_refused_before_any_capture(kind):
    """The audit runs each piece once eagerly before the capture and
    raises with the model's name, the piece and the operation; on the CPU
    the refusal comes before anything touches a card."""
    cfg, params, v0, st, pwr = examples.setup_example(device="cpu")
    cfg = dataclasses.replace(cfg, equilib_model="item_reader", nstep_max=3)
    tbase.register_eq_model("item_reader", _host_reading_slab())
    try:
        with fwAD.dual_level():
            if kind == "graph":
                loop = graphed.StaticLoop(cfg, params, v0, st)
                load = lambda: loop.load(params, v0, st)   # noqa: E731
            elif kind == "adjoint":
                loop = ga.StaticAdjoint(cfg, params, v0, st)
                carry = ttrace.initial_carry(cfg, params, v0, st)
                load = lambda: loop.load_inputs(carry, tree_leaves(params))   # noqa: E731
            else:
                dual = fwAD.make_dual(v0, torch.ones_like(v0))
                loop = gt.StaticTangent(cfg, params, dual, st)
                load = lambda: loop.load(params, dual, st)   # noqa: E731
            before = (graphed.CAPTURES, ga.CAPTURES, gt.CAPTURES)
            with pytest.raises(ValueError, match=r"'item_reader'.*piece 'step'.*reads the host "
                                                 r"\(_local_scalar_dense\)"):
                graphed.Captured(loop, load)
            assert (graphed.CAPTURES, ga.CAPTURES, gt.CAPTURES) == before
    finally:
        tbase.EQ_MODELS.pop("item_reader")
    # the toy, which reads nothing on the host, passes the same audit, and
    # the loop runs on after it, as the capture's warm-up does (under
    # no_grad, as graphed.Captured is made; the tangent loop inside a dual
    # level, where the toy's jacobians come forward over reverse)
    tbase.register_eq_model("item_reader", _port_toy())
    level = fwAD.dual_level() if kind == "tangent" else contextlib.nullcontext()
    try:
        with level, torch.no_grad():
            if kind == "graph":
                loop = graphed.StaticLoop(cfg, params, v0, st)
                load = lambda: loop.load(params, v0, st)   # noqa: E731
            elif kind == "adjoint":
                loop = ga.StaticAdjoint(cfg, params, v0, st)
                carry = ttrace.initial_carry(cfg, params, v0, st)
                load = lambda: loop.load_inputs(carry, tree_leaves(params))   # noqa: E731
            else:
                dual = fwAD.make_dual(v0, torch.ones_like(v0))
                loop = gt.StaticTangent(cfg, params, dual, st)
                load = lambda: loop.load(params, dual, st)   # noqa: E731
            load()
            capture_audit.require_capturable(loop)
            load()
            for _ in range(2):
                for fn in loop.functions().values():
                    fn()
    finally:
        tbase.EQ_MODELS.pop("item_reader")
