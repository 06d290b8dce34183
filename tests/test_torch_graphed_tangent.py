"""rays_tpu_torch's tangent graph (tracing/graphed_tangent.py) on the CPU.

The graphs are captured only on a CUDA device; here the same pieces run
on the same static buffers, called directly
(``graphed_tangent.trace_batch_static_tangent``), which is what the graphs
replay.  Held:

* against eager forward AD through ``trace.trace_batch`` on every config
  of the graph route that ``refusal`` accepts (the SG loop form
  included), with trajectories on and off, the tangent a direction from a
  numpy seed on every floating Params leaf, v0 and pwr_wt: the primal of
  every RayResults field bit for bit, each field's tangent within
  TANGENT_RTOL of its eager scale in float64 (F32_TANGENT_RTOL in
  float32);
* eager forward AD and the static twin against ``jax.jvp`` of the JAX
  package within JAX_RTOL of each field's scale: the inverse demo's two
  Gauss-Newton columns at its start (scripts/inverse_demo.py:125-131), the
  damped slab of ``__graft_entry__.py`` and the slab under the adaptive
  stepper in its loop form (``lax.while_loop`` in the JAX package);
* the JVP pieces read nothing on the host, cross no device and build no
  autograd node (capture_audit's audits);
* one reused loop answers each call with its own tangents;
* the dispatch: the tangent graph on the card with tangents, for every
  config but the autodiff derivatives; plain with reverse mode too, and
  on the CPU; the tangent graph raises where it cannot capture.
"""

import collections
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.tracing import graphed, graphed_tangent as gt
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.tracing.capture_audit import BackwardAudit, PieceAudit
from test_torch_adjoint import GRAFT_DS, GRAFT_STEPS
from test_torch_graphed import CASES, LOOP_FORM, _case, setups  # noqa: F401  (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TANGENT_RTOL = 1e-12        # float64: of each field's largest eager tangent
F32_TANGENT_RTOL = 1e-5     # float32
JAX_RTOL = 1e-10            # against jax.jvp, of each field's scale
# the dispersion residual |D| (normalized to 1) sits at the rounding level
# of the step: the two packages' residuals agree to an absolute bound, not
# to their own scale (RESID_ATOL of test_torch_entry.py), and the sign of
# D, which the tangent of |D| carries, is the rounding's; so the tangents'
# magnitudes are compared.  Which step holds a ray's largest residual is
# the rounding's too: max_residuals is compared without its tangent
RESIDUAL_FIELDS = ("residual", "end_residuals", "max_residuals")
INVERSE_STEPS = 20
TANGENT_CASES = [name for name in CASES if name != "slab_rk4_autodiff"]


def _direction(params, v0, pwr, seed=11):
    """A tangent for every floating Params leaf, v0 and pwr_wt: each
    tensor times N(0, 1) entries from a numpy seed (a relative direction,
    so every leaf moves on its own scale)."""
    rng = np.random.default_rng(seed)

    def draw(t):
        return t * torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=t.dtype)

    return (tree_map(lambda t: draw(t) if t.is_floating_point() else None, params),
            draw(v0), draw(pwr))


def _dual_inputs(params, v0, pwr, direction):
    """The inputs as dual tensors at the current level."""
    dp, dv, dw = direction
    params = tree_map(lambda t, d: t if d is None else fwAD.make_dual(t, d), params, dp)
    return params, fwAD.make_dual(v0, dv), fwAD.make_dual(pwr, dw)


def _parts(res):
    """{field: (primal, tangent or None)} of a RayResults, unpacked at the
    current level."""
    return {name: tuple(fwAD.unpack_dual(t)) for name, t in zip(ttrace.RayResults._fields, res)
            if t is not None}


def _tangent(primal, tangent):
    return torch.zeros_like(primal) if tangent is None else tangent


def _assert_same_tangents(got, ref, rtol, what):
    """Primal bit for bit, tangents within rtol of the reference's scale
    (an absent tangent is zero)."""
    assert got.keys() == ref.keys(), what
    for name, (p, t) in ref.items():
        gp, gtan = got[name]
        assert gp.dtype == p.dtype and torch.equal(gp, p), (what, name)
        if not p.is_floating_point():
            assert t is None and gtan is None, (what, name)
            continue
        r, g = _tangent(p, t), _tangent(gp, gtan)
        scale = float(r.abs().max()) if r.numel() else 0.0
        err = float((g - r).abs().max()) if r.numel() else 0.0
        assert bool(torch.isfinite(g).all()) and err <= rtol * scale, (what, name, err, scale)


def _traced(tracer, cfg, params, v0, st, pwr, direction):
    with fwAD.dual_level():
        p, v, w = _dual_inputs(params, v0, pwr, direction)
        return _parts(tracer(cfg, p, v, st, w))


@pytest.mark.parametrize("save", [True, False], ids=["trajectory", "summaries"])
@pytest.mark.parametrize("name", TANGENT_CASES)
def test_static_tangent_equals_forward_ad(setups, name, save):  # noqa: F811
    cfg, params, v0, st, pwr = _case(setups, name, save_trajectory=save)
    assert ttrace.route(cfg, False, "cuda", tangents=True) == "tangent"
    direction = _direction(params, v0, pwr)
    ref = _traced(ttrace.trace_batch, cfg, params, v0, st, pwr, direction)
    got = _traced(gt.trace_batch_static_tangent, cfg, params, v0, st, pwr, direction)
    rtol = F32_TANGENT_RTOL if v0.dtype == torch.float32 else TANGENT_RTOL
    _assert_same_tangents(got, ref, rtol, name)
    # the primal is the graph route's, bit for bit
    plain = graphed.trace_batch_static(cfg, params, v0, st, pwr)
    for field, t in zip(ttrace.RayResults._fields, plain):
        if t is not None:
            assert torch.equal(got[field][0], t), field
    # the rays go somewhere, and the tangents are not all zero
    assert int(ref["npoints"][0].max()) > 10
    assert float(ref["end_ray_vec"][1].abs().max()) > 0


# --- against jax.jvp ------------------------------------------------------------


def _assert_matches_jax(port, ref, what, rtol=JAX_RTOL):
    """Each floating field's primal and tangent against the JAX package's
    (``ref``: {field: (primal, tangent)} as numpy), within ``rtol`` of the
    JAX field's scale (the residuals: within ``rtol``, and their tangents'
    magnitudes but max_residuals'); integer fields equal."""
    for name, (jp, jt) in ref.items():
        p, t = port[name]
        if not np.issubdtype(jp.dtype, np.floating):
            np.testing.assert_array_equal(p.numpy(), jp, err_msg=f"{what} {name}")
            continue
        t = _tangent(p, t)
        if name in RESIDUAL_FIELDS:
            t, jt = t.abs(), np.abs(jt)
        parts = [("primal", p, jp), ("tangent", t, jt)]
        for part, g, r in parts[:1] if name == "max_residuals" else parts:
            scale = np.abs(r).max() if r.size else 0.0
            if name in RESIDUAL_FIELDS and part == "primal":
                scale = 1.0
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=rtol * scale,
                                       err_msg=f"{what} {name} {part}")


def _jax_and_port(text, seed, **cfg_changes):
    """(JAX {field: (primal, tangent)}, port case, port direction): jax.jvp
    of the JAX package's trace_batch along a numpy-seeded direction on
    every floating Params leaf, v0 and pwr_wt, and the same direction for
    the port, carried leaf by leaf."""
    cfg, params, v0, st, pwr = tp.jax_case(text, **cfg_changes)
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    dleaves = [np.asarray(leaf) * rng.standard_normal(np.shape(leaf)) for leaf in leaves]
    dv = np.asarray(v0) * rng.standard_normal(np.shape(v0))
    dw = np.asarray(pwr) * rng.standard_normal(np.shape(pwr))
    jres, jtan = jax.jit(lambda p, v, w, dp, dv_, dw_: jax.jvp(
        lambda p_, v_, w_: jtrace.trace_batch(cfg, p_, v_, st, w_), (p, v, w), (dp, dv_, dw_)))(
            params, v0, pwr, jax.tree_util.tree_unflatten(tree, dleaves), dv, dw)
    ref = {name: (np.asarray(r), np.asarray(t))
           for name, r, t in zip(jres._fields, jres, jtan) if r is not None}
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    assert len(tree_leaves(pp)) == len(dleaves)
    it = iter(dleaves)
    dp = tree_map(lambda t: torch.as_tensor(next(it), dtype=t.dtype), pp)
    direction = (dp, torch.from_numpy(dv), torch.from_numpy(dw))
    return ref, (pcfg, pp, tv0, tst, tpw), direction


@pytest.mark.parametrize("case", ["damped_slab", "slab_sg_loop"])
def test_tangents_match_jax_jvp(case):
    """The damped slab of ``__graft_entry__.py`` (its rays absorbed or run
    out within the steps) and the slab under SG_ODE in its loop form, at a
    few steps: eager forward AD and the static twin against jax.jvp."""
    if case == "damped_slab":
        ref, port, direction = _jax_and_port(jex.SLAB_ECH_DAMPED, 3, ds=GRAFT_DS,
                                             nstep_max=GRAFT_STEPS, save_trajectory=True)
    else:
        text = jex.SLAB_ECH_90GHZ.replace("ode_solver_name='RK4_ODE'", "ode_solver_name='SG_ODE'")
        ref, port, direction = _jax_and_port(text, 4, nstep_max=12, save_trajectory=True)
        assert port[0].ode_solver_name == "SG_ODE" and port[0].sg_scan_substeps == 0
    assert ttrace.route(port[0], False, "cuda", tangents=True) == "tangent"
    for tracer in (ttrace.trace_batch, gt.trace_batch_static_tangent):
        _assert_matches_jax(_traced(tracer, *port, direction), ref, f"{case} {tracer.__name__}")
    if case == "damped_slab":
        assert {21, 31} <= set(ref["stop_flag"][0].tolist())   # absorbed and run out


@pytest.fixture(scope="module")
def inverse_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_inverse_demo_tangent", os.path.join(ROOT, "tools", "inverse_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inverse_demo_columns_match_jax_jvp(inverse_tool, monkeypatch):
    """The inverse demo's two forward-mode columns at its start, eager and
    through the static twin, against jax.jvp of the JAX package's
    residual (scripts/inverse_demo.py:125-131)."""
    cfg, params, v0, st, pwr = jex.setup_example(inverse_tool.demo_text())
    cfg = dataclasses.replace(cfg, nstep_max=INVERSE_STEPS, save_trajectory=True,
                              ode_solver_name="RK4_ODE")

    def trajectories(eq):
        return jtrace.trace_batch(cfg, params._replace(eq=eq), v0, st, pwr).ray_vec[:, :, 0:3]

    target = jax.jit(trajectories)(params.eq)

    def resid(th):
        return (trajectories(params.eq._replace(kappa=th[0], iota0=th[1])) - target).ravel()

    theta = jnp.asarray([float(params.eq.kappa) * 1.15, float(params.eq.iota0) * 0.85])
    jvp = jax.jit(lambda th, t: jax.jvp(resid, (th,), (t,)))
    r, j0 = jvp(theta, jnp.asarray([1.0, 0.0]))
    _, j1 = jvp(theta, jnp.asarray([0.0, 1.0]))

    prob = inverse_tool.InverseProblem(INVERSE_STEPS, "cpu")
    assert ttrace.route(prob.cfg, False, "cuda", tangents=True) == "tangent"
    eager = prob.jvp_columns(prob.start)
    monkeypatch.setattr(inverse_tool, "trace_rays", gt.trace_batch_static_tangent)
    static = prob.jvp_columns(prob.start)
    for what, got in (("eager", eager), ("static twin", static)):
        for name, g, ref in zip(("residual", "j0", "j1"), got, (r, j0, j1)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                       atol=JAX_RTOL * np.abs(ref).max(), err_msg=f"{what} {name}")
    for a, b in zip(eager, static):
        assert torch.equal(a, b)


# --- what the pieces issue --------------------------------------------------------


@pytest.mark.parametrize("name", TANGENT_CASES)
def test_jvp_pieces_read_nothing_on_the_host(setups, name):  # noqa: F811
    cfg, params, v0, st, pwr = _case(setups, name, save_trajectory=True, nstep_max=3)
    direction = _direction(params, v0, pwr)
    audits = collections.defaultdict(lambda: (PieceAudit(), BackwardAudit()))
    launched = collections.Counter()
    with fwAD.dual_level(), torch.no_grad():
        p, v, w = _dual_inputs(params, v0, pwr, direction)
        loop = gt.StaticTangent(cfg, p, v, st)
        pieces = loop.functions()

        def launch(piece):
            launched[piece] += 1
            audit, backward = audits[piece]
            with backward, audit:
                pieces[piece]()

        res = _parts(loop.trace(p, v, st, w, launch))
    if name in LOOP_FORM:
        assert launched["head"] == launched["tail"] == 3
    else:
        assert dict(launched) == {"step": 3}
    for piece, (audit, backward) in audits.items():
        assert not audit.reads and not audit.crossings, (piece, audit.reads, audit.crossings)
        # forward mode builds no autograd node
        assert not backward.nodes, (piece, dict(backward.nodes))
    assert float(res["end_ray_vec"][1].abs().max()) > 0


def test_a_reused_loop_answers_each_call(setups):  # noqa: F811
    """Two calls with other Params, rays and tangents of the same shapes
    through one StaticTangent, as through one cached entry: each gets its
    own eager tangents."""
    cfg, params, v0, st, pwr = _case(setups, "solovev_sg", save_trajectory=True, nstep_max=20)
    other = params._replace(eq=tree_map(lambda t: t * 1.01 if t.is_floating_point() else t,
                                        params.eq))
    v1 = v0.flip(0).contiguous()
    calls = [(params, v0, _direction(params, v0, pwr, seed=1)),
             (other, v1, _direction(other, v1, pwr, seed=2))]
    with fwAD.dual_level():
        p, v, w = _dual_inputs(params, v0, pwr, calls[0][2])
        loop = gt.StaticTangent(cfg, p, v, st)
    got = [_traced(lambda *a: gt.trace_batch_static_tangent(*a, loop=loop), cfg, pp, vv, st, pwr, d)
           for pp, vv, d in calls]
    for (pp, vv, d), g in zip(calls, got):
        _assert_same_tangents(g, _traced(ttrace.trace_batch, cfg, pp, vv, st, pwr, d),
                              TANGENT_RTOL, "reused loop")
    assert not torch.equal(got[0]["end_ray_vec"][1], got[1]["end_ray_vec"][1])


# --- the dispatch -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_route_of_each_tangent_config(setups, name):  # noqa: F811
    cfg = _case(setups, name)[0]
    if name == "slab_rk4_autodiff":
        assert ttrace.route(cfg, False, "cuda", tangents=True) == "plain"
        assert "autodiff" in gt.refusal(cfg)
        with pytest.raises(ValueError, match="autodiff"):
            gt.check_capturable(cfg)
    else:
        assert gt.refusal(cfg) is None
        assert ttrace.route(cfg, False, "cuda", tangents=True) == \
            ttrace.route(cfg, False, torch.device("cuda", 0), tangents=True) == "tangent"
    # tangents with reverse mode, and the CPU, stay plain
    assert ttrace.route(cfg, True, "cuda", tangents=True) == "plain"
    assert ttrace.route(cfg, False, "cpu", tangents=True) == "plain"


def test_tangent_graph_refuses_what_it_cannot_capture(setups):  # noqa: F811
    """No fallback: on the CPU, with reverse-mode gradients or for the
    autodiff derivatives the tangent graph raises; trace_rays on the CPU
    takes trace_batch and captures nothing."""
    cfg, params, v0, st, pwr = _case(setups, "solovev_rk4", nstep_max=3)
    direction = _direction(params, v0, pwr)
    with fwAD.dual_level():
        p, v, w = _dual_inputs(params, v0, pwr, direction)
        with pytest.raises(ValueError, match="CUDA device"):
            gt.trace_batch_graphed_tangent(cfg, p, v, st, w)
        with pytest.raises(ValueError, match="reverse-mode"):
            gt.trace_batch_graphed_tangent(cfg, p, v.detach().clone().requires_grad_(True), st, w)
        with pytest.raises(ValueError, match="autodiff"):
            gt.trace_batch_graphed_tangent(_case(setups, "slab_rk4_autodiff")[0], p, v, st, w)
    before = (gt.CAPTURES, gt.REPLAYS, len(graphed._CACHE))
    got = _traced(ttrace.trace_rays, cfg, params, v0, st, pwr, direction)
    _assert_same_tangents(got, _traced(ttrace.trace_batch, cfg, params, v0, st, pwr, direction),
                          0.0, "trace_rays on the CPU")
    assert (gt.CAPTURES, gt.REPLAYS, len(graphed._CACHE)) == before
