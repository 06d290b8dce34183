"""Forward-mode tangents through a model whose jacobians come by forward
mode (``core.eq_point.value_and_jacfwd``), against the JAX package.

PyTorch's forward AD does not nest levels, so inside a caller's level the
port takes such a model's jacobians by reverse mode on the caller's dual
tensors (forward over reverse); the JAX package takes ``jax.jvp`` over
``jax.jacfwd`` (``rays_tpu/core/eq_point.py:92-99``).  Held:

* the toy model of ``tests/test_torch_registry.py`` (the slab's fields
  shifted in x, ``fields`` only), registered under one name in both
  packages: its tangents along a direction on v0 and along one on the
  Params leaves, eagerly through ``trace_batch`` and through the tangent
  graph's static twin (``graphed_tangent.trace_batch_static_tangent``),
  against ``jax.jvp`` of the JAX package's trace within JAX_RTOL of each
  field's scale (the residuals by magnitude, as
  ``tests/test_torch_graphed_tangent.py`` holds them);
* Solovev registered with its ``fields``, ``geom_err`` and ``err`` alone
  against the closed-form Solovev: primal and tangents within
  TANGENT_RTOL of scale, RK4 and the adaptive stepper in its loop form;
* a run with tangents and no reverse mode returns results without
  autograd history; with reverse mode too (the plain route) the gradient
  runs through the jacobian and equals the closed form's;
* ``value_and_jacfwd`` with no level open is the old form bit for bit;
  inside one, values, jacobians and their tangents are the closed form's,
  with x dual or with only a Params leaf dual;
* the tangent graph's pieces of such a model pass the capture audit, and
  the census of its step counts the batched backward's rows.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.models import base as jbase
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch import examples
from rays_tpu_torch.core import eq_point as teq
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.models import solovev as tsolovev
from rays_tpu_torch.tracing import capture_audit, graphed_tangent as gt
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.tracing.capture_audit import HOST_READING_BACKWARDS, BackwardAudit, PieceAudit
from rays_tpu_torch.utils import op_census
from test_torch_graphed_adjoint import GRAD_RTOL, _weighted_loss, _with_grad
from test_torch_graphed_tangent import (TANGENT_RTOL, _assert_matches_jax, _direction,
                                        _dual_inputs, _parts, _tangent, _traced)
from test_torch_registry import SHIFT, _jax_toy, _port_toy

TOY = "shifted_slab_by_jvp"
TOY_STEPS = 12
SOLOVEV_STEPS = 10
TRACERS = {"eager": ttrace.trace_batch, "static": gt.trace_batch_static_tangent}


def _solovev_by_jvp():
    """Solovev's fields, geometry and validity checks alone: no closed form."""
    return types.SimpleNamespace(fields=tsolovev.fields, geom_err=tsolovev.geom_err,
                                 err=tsolovev.err)


@pytest.fixture(scope="module")
def toy_jvp():
    """The toy registered under TOY in both packages for the module, and
    jax.jvp of the JAX package's trace of its rays (compiled once):
    (jitted jvp, JAX case)."""
    jbase.register_eq_model(TOY, _jax_toy())
    tbase.register_eq_model(TOY, _port_toy())
    try:
        cfg, params, v0, st, pwr = tp.jax_case(nstep_max=TOY_STEPS, save_trajectory=True,
                                               equilib_model=TOY)
        v0 = v0.at[:, 0].add(SHIFT)
        jvp = jax.jit(lambda p, v, w, dp, dv, dw: jax.jvp(
            lambda p_, v_, w_: jtrace.trace_batch(cfg, p_, v_, st, w_), (p, v, w), (dp, dv, dw)))
        yield jvp, (cfg, params, v0, st, pwr)
    finally:
        jbase.EQ_MODELS.pop(TOY, None)
        tbase.EQ_MODELS.pop(TOY, None)


def _toy_direction(case, which, seed):
    """A numpy-seeded direction on v0 alone or on the Params leaves alone,
    as JAX tangents (numpy) and as the port's (tensors, leaf by leaf)."""
    cfg, params, v0, st, pwr = case
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    on_params = which == "params"
    dleaves = [np.asarray(leaf) * (rng.standard_normal(np.shape(leaf)) if on_params else 0.0)
               for leaf in leaves]
    dv = np.asarray(v0) * (0.0 if on_params else rng.standard_normal(np.shape(v0)))
    dw = np.zeros(np.shape(pwr))
    return jax.tree_util.tree_unflatten(tree, dleaves), dleaves, dv, dw


@pytest.mark.parametrize("tracer", list(TRACERS))
@pytest.mark.parametrize("which", ["v0", "params"])
def test_toy_tangents_match_jax_jvp(toy_jvp, which, tracer):
    jvp, case = toy_jvp
    cfg, params, v0, st, pwr = case
    dp, dleaves, dv, dw = _toy_direction(case, which, seed=12)
    jres, jtan = jvp(params, v0, pwr, dp, dv, dw)
    ref = {name: (np.asarray(r), np.asarray(t))
           for name, r, t in zip(jres._fields, jres, jtan) if r is not None}
    # the port's converter knows the built-in names only: the slab's
    # config under the toy's name
    pcfg, pp, tv0, tst, tpw = tp.to_port(dataclasses.replace(cfg, equilib_model="slab"),
                                         params, v0, st, pwr)
    pcfg = dataclasses.replace(pcfg, equilib_model=TOY)
    assert ttrace.route(pcfg, False, "cuda", tangents=True) == "tangent"
    it = iter(dleaves)
    direction = (tree_map(lambda t: torch.as_tensor(next(it), dtype=t.dtype), pp),
                 torch.from_numpy(dv), torch.from_numpy(dw))
    got = _traced(TRACERS[tracer], pcfg, pp, tv0, tst, tpw, direction)
    _assert_matches_jax(got, ref, f"toy {which} {tracer}")
    assert np.abs(ref["end_ray_vec"][1]).max() > 0
    assert int(ref["npoints"][0].min()) > TOY_STEPS // 2


def _assert_close_fields(got, ref, rtol, what):
    """``_assert_matches_jax``'s measure between two of the port's runs."""
    as_numpy = {name: (p.numpy(), _tangent(p, t).numpy()) for name, (p, t) in ref.items()}
    _assert_matches_jax(got, as_numpy, what, rtol=rtol)


@pytest.fixture
def solovev_by_jvp():
    tbase.register_eq_model("solovev_by_jvp", _solovev_by_jvp())
    try:
        yield "solovev_by_jvp"
    finally:
        tbase.EQ_MODELS.pop("solovev_by_jvp", None)


def _solovev_case(**changes):
    cfg, params, v0, st, pwr = examples.setup_example(examples.SOLOVEV_ECH_90GHZ, device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=SOLOVEV_STEPS, save_trajectory=True, **changes)
    return cfg, params, v0, st, pwr


@pytest.mark.parametrize("tracer", list(TRACERS))
@pytest.mark.parametrize("solver", ["RK4_ODE", "SG_ODE"])
def test_solovev_by_forward_mode_matches_closed_form(solovev_by_jvp, solver, tracer):
    cfg, params, v0, st, pwr = _solovev_case(ode_solver_name=solver)
    by_jvp = dataclasses.replace(cfg, equilib_model=solovev_by_jvp)
    assert ttrace.route(by_jvp, False, "cuda", tangents=True) == "tangent"
    direction = _direction(params, v0, pwr, seed=13)
    ref = _traced(ttrace.trace_batch, cfg, params, v0, st, pwr, direction)
    got = _traced(TRACERS[tracer], by_jvp, params, v0, st, pwr, direction)
    _assert_close_fields(got, ref, TANGENT_RTOL, f"solovev {solver} {tracer}")
    assert float(ref["end_ray_vec"][1].abs().max()) > 0


def test_tangent_only_results_carry_no_history(solovev_by_jvp):
    """Grad mode on, tangents on v0 and every Params leaf, no leaf that
    requires grad: every field of trace_rays (plain on the CPU) and of the
    static twin carries its tangent and no autograd history."""
    cfg, params, v0, st, pwr = _solovev_case(ode_solver_name="RK4_ODE",
                                             equilib_model=solovev_by_jvp)
    direction = _direction(params, v0, pwr, seed=14)
    assert torch.is_grad_enabled()
    for tracer in (ttrace.trace_rays, gt.trace_batch_static_tangent):
        with fwAD.dual_level():
            p, v, w = _dual_inputs(params, v0, pwr, direction)
            res = tracer(cfg, p, v, st, w)
            for name, t in zip(ttrace.RayResults._fields, res):
                if t is None:
                    continue
                assert not t.requires_grad and t.grad_fn is None, (tracer.__name__, name)
                if t.is_floating_point() and name != "initial_ray_power":
                    assert fwAD.unpack_dual(t).tangent is not None, (tracer.__name__, name)


def test_tangents_with_reverse_mode_through_forward_mode_model(solovev_by_jvp):
    """Tangents and a reverse-mode gradient together take the plain route;
    the gradient of a loss on every floating field runs through the
    forward-over-reverse jacobian and equals the closed form's, and so
    do the tangents."""
    cfg, params, v0, st, pwr = _solovev_case(ode_solver_name="RK4_ODE")
    by_jvp = dataclasses.replace(cfg, equilib_model=solovev_by_jvp)
    assert ttrace.route(by_jvp, True, "cuda", tangents=True) == "plain"
    direction = _direction(params, v0, pwr, seed=15)
    out = {}
    for c in (cfg, by_jvp):
        with fwAD.dual_level():
            q = _with_grad(params)
            p, v, w = _dual_inputs(q, v0, pwr, direction)
            res = ttrace.trace_rays(c, p, v, st, w)
            loss = _weighted_loss([fwAD.unpack_dual(t).primal if t is not None else None
                                   for t in res])
            leaves = [t for t in tree_leaves(q) if t.is_floating_point()]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            out[c.equilib_model] = (loss.detach(), grads, _parts(res))
    (ref_loss, ref_grads, ref), (loss, grads, got) = out["solovev"], out[solovev_by_jvp]
    assert abs(float(loss - ref_loss)) <= GRAD_RTOL * abs(float(ref_loss))
    nonzero = 0
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        scale = float(r.abs().max()) if r.numel() else 0.0
        err = float((g - r).abs().max()) if r.numel() else 0.0
        assert bool(torch.isfinite(g).all()) and err <= GRAD_RTOL * scale, (i, err, scale)
        nonzero += scale > 0
    assert nonzero >= 5
    detached = {name: (p.detach(), None if t is None else t.detach())
                for name, (p, t) in got.items()}
    _assert_close_fields(detached, {name: (p.detach(), None if t is None else t.detach())
                                    for name, (p, t) in ref.items()},
                         TANGENT_RTOL, "tangents with gradients")


# --- value_and_jacfwd ---------------------------------------------------------


def _old_value_and_jacfwd(f, x):
    """The form ``value_and_jacfwd`` keeps with no level open."""
    unit = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    columns = []
    for i in range(x.shape[-1]):
        y, dy = torch.func.jvp(f, (x,), (unit[i].expand_as(x),))
        columns.append(dy)
    return y, tuple(torch.stack(cols, dim=-1) for cols in zip(*columns))


def _solovev_fields():
    cfg, params, v0, _, _ = examples.setup_example(examples.SOLOVEV_ECH_90GHZ, device="cpu")
    rng = np.random.default_rng(16)
    x = v0[:, :3] + torch.from_numpy(rng.uniform(-0.02, 0.02, (v0.shape[0], 3)))
    return cfg, params, x


def test_value_and_jacfwd_with_no_level_is_the_old_form():
    cfg, params, x = _solovev_fields()
    f = lambda xx: tsolovev.fields(cfg.eq_static, params.eq, params.species, xx)  # noqa: E731
    assert not teq.forward_level_open()
    got, ref = teq.value_and_jacfwd(f, x), _old_value_and_jacfwd(f, x)
    for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
        assert torch.equal(g, r) and not g.requires_grad


@pytest.mark.parametrize("dual", ["x", "kappa"])
def test_value_and_jacfwd_in_a_level_is_the_closed_form(dual):
    """Inside a level, with x dual or with only a Params leaf dual (x
    primal, as at a column's first step): values, jacobians and their
    tangents equal the closed form's under forward AD within 1e-10 of
    scale, and carry no autograd history."""
    cfg, params, x = _solovev_fields()
    st, sp = cfg.eq_static, params.species
    rng = np.random.default_rng(17)
    with fwAD.dual_level():
        assert teq.forward_level_open()
        if dual == "x":
            xx, p = fwAD.make_dual(x, torch.from_numpy(rng.standard_normal(x.shape))), params.eq
        else:
            xx = x
            p = params.eq._replace(kappa=fwAD.make_dual(params.eq.kappa,
                                                        torch.ones_like(params.eq.kappa)))
        got_vals, got_jacs = teq.value_and_jacfwd(lambda r: tsolovev.fields(st, p, sp, r), xx)
        ref_vals, ref_jacs = tsolovev.fields_and_jac(st, p, sp, xx)
        for name, g, r in zip(("bvec", "ns", "ts", "jb", "jn", "jt"),
                              (*got_vals, *got_jacs), (*ref_vals, *ref_jacs)):
            assert g.shape == r.shape and not g.requires_grad, name
            for part in (0, 1):
                gp, rp = fwAD.unpack_dual(g)[part], fwAD.unpack_dual(r)[part]
                gp = torch.zeros_like(g) if gp is None else gp
                rp = torch.zeros_like(r) if rp is None else rp
                scale = max(float(rp.abs().max()), 1e-300)
                assert float((gp - rp).abs().max()) <= 1e-10 * scale, (dual, name, part)
        assert float(fwAD.unpack_dual(got_jacs[0]).tangent.abs().max()) > 0


def test_value_and_jacfwd_in_a_level_with_constant_outputs():
    """Outputs that depend on x in part, or not at all (a uniform
    profile): their jacobian rows are zero, the others those of the
    closed form, and the tangents ride through both."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((6, 3)))
    t = torch.from_numpy(rng.standard_normal((6, 3)))

    def f(r):
        return (torch.stack([r[:, 0] * r[:, 1], torch.sin(r[:, 2])], -1),
                torch.ones_like(r[:, :2]))

    with fwAD.dual_level():
        xd = fwAD.make_dual(x, t)
        (vals, const), (jac, zero) = teq.value_and_jacfwd(f, xd)
        assert zero.shape == (6, 2, 3) and not bool(zero.any())
        assert not const.requires_grad and not vals.requires_grad
        (only,), (jac_only,) = teq.value_and_jacfwd(lambda r: (torch.ones_like(r[:, :2]),), xd)
        assert jac_only.shape == (6, 2, 3) and not bool(jac_only.any())
        primal, tangent = fwAD.unpack_dual(jac)
    ref = torch.zeros((6, 2, 3), dtype=x.dtype)
    ref[:, 0, 0], ref[:, 0, 1], ref[:, 1, 2] = x[:, 1], x[:, 0], torch.cos(x[:, 2])
    dref = torch.zeros_like(ref)
    dref[:, 0, 0], dref[:, 0, 1], dref[:, 1, 2] = t[:, 1], t[:, 0], -torch.sin(x[:, 2]) * t[:, 2]
    assert torch.allclose(primal, ref, rtol=0, atol=1e-15)
    assert torch.allclose(tangent, dref, rtol=0, atol=1e-15)


# --- the tangent graph's pieces -----------------------------------------------


@pytest.mark.parametrize("model", ["toy", "solovev"])
def test_forward_mode_pieces_pass_the_capture_audit(model):
    """The audit that runs before a registered model's first capture
    passes on the tangent graph's pieces of a forward-mode model: no host
    read, no copy across devices, no autograd node whose backward reads
    the host; the loop runs on after it and the tangents are eager's."""
    if model == "toy":
        cfg, params, v0, st, pwr = examples.setup_example(device="cpu")
        v0 = v0.clone()
        v0[:, 0] += SHIFT
        module = _port_toy()
    else:
        cfg, params, v0, st, pwr = _solovev_case(ode_solver_name="SG_ODE", sg_scan_substeps=0)
        module = _solovev_by_jvp()
    name = f"{model}_audited"
    cfg = dataclasses.replace(cfg, equilib_model=name, nstep_max=4, save_trajectory=True)
    tbase.register_eq_model(name, module)
    try:
        direction = _direction(params, v0, pwr, seed=18)
        with fwAD.dual_level(), torch.no_grad():
            p, v, w = _dual_inputs(params, v0, pwr, direction)
            loop = gt.StaticTangent(cfg, p, v, st)
            loop.load(p, v, st)
            capture_audit.require_capturable(loop)
            nodes = set()
            for piece, fn in loop.functions().items():
                loop.load(p, v, st)
                audit, backward = PieceAudit(), BackwardAudit()
                with backward, audit:
                    loop.with_own_stats(fn)
                assert not audit.reads and not audit.crossings, (piece, audit.reads)
                nodes |= set(backward.nodes)
            # the jacobian's backward pass is recorded, and none of its
            # nodes reads the host
            assert nodes and not nodes & HOST_READING_BACKWARDS
            got = _parts(gt.trace_batch_static_tangent(cfg, p, v, st, w, loop=loop))
        ref = _traced(ttrace.trace_batch, cfg, params, v0, st, pwr, direction)
    finally:
        tbase.EQ_MODELS.pop(name)
    assert got.keys() == ref.keys()
    for field, (rp, rt) in ref.items():
        gp, gtan = got[field]
        assert torch.equal(gp, rp), field
        if rp.is_floating_point():
            assert torch.equal(_tangent(gp, gtan), _tangent(rp, rt)), field


def test_census_of_a_forward_mode_step(solovev_by_jvp):
    """The census of one outer step with tangents through the
    forward-mode Solovev: batch independent, the batched backward's rows
    counted as elements per ray, and more of both than the closed form's."""
    cfg, params, v0, st, pwr = _solovev_case(ode_solver_name="RK4_ODE")

    def census(model, n):
        v, s, w = examples.replicate_rays(v0, st, pwr, n)
        with fwAD.dual_level():
            p, vv, ww = _dual_inputs(params, v, w, _direction(params, v, w, seed=19))
            return op_census.step_census(dataclasses.replace(cfg, equilib_model=model),
                                         p, vv, s, ww)

    small, large = census(solovev_by_jvp, 5), census(solovev_by_jvp, 13)
    assert small.ops == large.ops and small.by_class() == large.by_class()
    assert small.host_reads == 0
    closed = census("solovev", 5).by_class()
    by_jvp = small.by_class()
    assert sum(n for n, _ in by_jvp.values()) > sum(n for n, _ in closed.values())
    assert sum(e for _, e in by_jvp.values()) > sum(e for _, e in closed.values())
    # the backward's rows (basis rows x rays) are elements per ray
    assert sum(e for _, e in by_jvp.values()) > 1.2 * sum(e for _, e in closed.values())

