"""rays_tpu_torch's graphed tracer (tracing/graphed.py) on the CPU.

The graphs themselves are captured only on a CUDA device; here the same
static-buffer loop runs with its pieces called directly
(``graphed.trace_batch_static``, or ``StaticLoop.trace`` without a
launcher), which is what the graphs replay.  Held:

* bit for bit equal to ``trace.trace_batch`` on every RayResults field,
  on every built-in path that the graph route takes, with trajectories on
  and off, and in the SG loop form also with three passes per read;
* one case against the JAX package (1e-9 of trajectory scale, the
  tolerance of tests/test_torch_adaptive.py);
* no host read and no copy across devices inside a piece (the one read
  of the SG loop form's flag lies between pieces), and no autograd node
  whose backward reads the host (the autodiff derivatives' backward pass
  runs inside a piece);
* no library product (mm, bmm, addmm, matmul) in an outer step, except
  the equilibrium-gradient einsum, one per RHS evaluation;
* a reused loop answers each call with its own inputs;
* the dispatch: the graph route on the card without gradients, the
  graphed adjoint for reverse-mode gradients (tests/test_torch_graphed_adjoint.py)
  but plain for the SG loop form and the autodiff derivatives, the
  tangent graph for forward-mode tangents (tests/test_torch_graphed_tangent.py)
  but plain for the autodiff derivatives, plain on the CPU; a registered
  model takes the same routes, never the kernel.

The audits themselves (``PieceAudit``, ``BackwardAudit``) live in
``rays_tpu_torch/tracing/capture_audit.py``, which also runs them on a
registered model before its first capture.
"""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu_torch import examples as tex, run as trun
from rays_tpu_torch.core.types import has_tangent, tree_map
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.tracing import fused_slab, graphed, rhs as trhs, rk45 as trk45
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.tracing.capture_audit import HOST_READING_BACKWARDS, BackwardAudit, PieceAudit

N_RAYS = 24
TRAJ_RTOL = 1e-9

SLAB_SG = tex.SLAB_ECH_90GHZ.replace("ode_solver_name='RK4_ODE'", "ode_solver_name='SG_ODE'")
MIRROR_DAMPED = tex.MIRROR_ECH_56GHZ.replace("damping_model='no_damp'",
                                             "damping_model='damp_fund_ECH'")
EQ_GRAD = "integrate_eq_gradients=.false."

# name: (how the case is set up, Config changes, outer steps)
CASES = {
    "slab_rk4_eq_gradients": ("slab_eq_grad", {}, 40),
    "slab_rk4_autodiff": ("slab", dict(ray_deriv_name="autodiff"), 40),
    "slab_sg_fixed_budget": ("slab_sg", dict(sg_scan_substeps=2), 60),
    "slab_sg_loop": ("slab_sg", {}, 60),
    "solovev_sg": ("solovev", {}, 60),
    "solovev_rk4": ("solovev", dict(ode_solver_name="RK4_ODE"), 60),
    "eqdsk_rk4": ("eqdsk", {}, 120),
    "mirror_damped_rk4": ("mirror_damped", {}, 60),
    "slab_compensated_f32": ("slab_f32", dict(compensated_sum=True), 40),
}
LOOP_FORM = ("slab_sg_loop", "solovev_sg")


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """{setup name: (cfg, params, v0, status0, pwr)} on the CPU at N_RAYS
    rays (examples.replicate_rays); the spline files on small grids."""
    d = tmp_path_factory.mktemp("graphed")
    (d / "eqdsk").mkdir()
    (d / "mirror").mkdir()
    made = {
        "slab": tex.setup_example(device="cpu"),
        "slab_eq_grad": tex.setup_example(
            tex.SLAB_ECH_90GHZ.replace(EQ_GRAD, EQ_GRAD.replace("false", "true")), device="cpu"),
        "slab_sg": tex.setup_example(SLAB_SG, device="cpu"),
        "solovev": tex.setup_example(tex.SOLOVEV_ECH_90GHZ, device="cpu"),
        "eqdsk": trun.setup(tex.write_eqdsk_toroid_example(d / "eqdsk", n=33), device="cpu"),
        "mirror_damped": trun.setup(tex.write_mirror_example(
            d / "mirror", n_r=17, n_z=41, text=MIRROR_DAMPED), device="cpu"),
        "slab_f32": tex.setup_example(device="cpu", dtype=torch.float32),
    }
    return {name: (cfg, params, *tex.replicate_rays(v0, st, pwr, N_RAYS))
            for name, (cfg, params, v0, st, pwr) in made.items()}


def _case(setups, name, **changes):
    which, cfg_changes, steps = CASES[name]
    cfg, params, v0, st, pwr = setups[which]
    cfg = dataclasses.replace(cfg, **{**cfg_changes, "nstep_max": steps, **changes})
    return cfg, params, v0, st, pwr


def _assert_equal_results(got, ref):
    for name, g, r in zip(ttrace.RayResults._fields, got, ref):
        if r is None:
            assert g is None, name
            continue
        assert g.dtype == r.dtype and torch.equal(g, r), name


@pytest.mark.parametrize("save", [True, False], ids=["trajectory", "summaries"])
@pytest.mark.parametrize("name", list(CASES))
def test_static_loop_equals_trace_batch(setups, name, save):
    cfg, params, v0, st, pwr = _case(setups, name, save_trajectory=save)
    assert ttrace.route(cfg, False, "cuda") == "graph"
    ref = ttrace.trace_batch(cfg, params, v0, st, pwr)
    got = graphed.trace_batch_static(cfg, params, v0, st, pwr)
    _assert_equal_results(got, ref)
    # the rays go somewhere: not every ray stops at its first step
    assert int(ref.npoints.max()) > 10


@pytest.mark.parametrize("name", LOOP_FORM)
def test_loop_form_chunks_and_counts(setups, name):
    """Three passes per read: the passes after the last live ray change
    nothing, and the substep counts (loops, attempts, rejected) are the
    eager loop's; the reads fall to about one per outer step."""
    cfg, params, v0, st, pwr = _case(setups, name, save_trajectory=True)
    trk45.stats = trk45.SubstepStats()
    try:
        ref = ttrace.trace_batch(cfg, params, v0, st, pwr)
        eager = trk45.stats.totals()
        runs = {}
        for chunk in (1, 3):
            trk45.stats = trk45.SubstepStats()
            _assert_equal_results(graphed.trace_batch_static(cfg, params, v0, st, pwr,
                                                             chunk=chunk), ref)
            runs[chunk] = trk45.stats.totals()
    finally:
        trk45.stats = None
    loops, reads, attempts, rejected = eager
    assert reads == loops + cfg.nstep_max
    for chunk, (g_loops, g_reads, g_attempts, g_rejected) in runs.items():
        assert (g_loops, g_attempts, g_rejected) == (loops, attempts, rejected), chunk
        assert cfg.nstep_max <= g_reads < reads
    assert runs[3][1] <= runs[1][1]
    if name == "solovev_sg":
        assert loops > cfg.nstep_max and rejected > 0     # the controller subdivided


def test_eq_gradient_trace_matches_jax():
    text = jex.SLAB_ECH_90GHZ.replace(EQ_GRAD, EQ_GRAD.replace("false", "true"))
    cfg, params, v0, st, pwr = tp.jax_case(text, nstep_max=40)
    ref = jax.tree_util.tree_map(np.asarray, tp.jax_trace(cfg, params, v0, st, pwr))
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    assert pcfg.integrate_eq_gradients and ttrace.route(pcfg, False, "cuda") == "graph"
    got = graphed.trace_batch_static(pcfg, pp, tv0, tst, tpw)
    np.testing.assert_array_equal(got.npoints.numpy(), ref.npoints)
    np.testing.assert_array_equal(got.stop_flag.numpy(), ref.stop_flag)
    assert ref.npoints.tolist() == [41] * 3
    tp.assert_scaled_close(got.ray_vec, ref.ray_vec, TRAJ_RTOL, axis=1, what="trajectory")
    g = pcfg.grad_diag_slot
    np.testing.assert_allclose(got.ray_vec[:, :, g:].numpy(), ref.ray_vec[:, :, g:],
                               rtol=TRAJ_RTOL, atol=TRAJ_RTOL * np.abs(ref.ray_vec[:, :, g:]).max())


# --- what the pieces issue --------------------------------------------------

def _audit(cfg, params, v0, st, pwr, monkeypatch):
    """Run the static loop with every piece under a PieceAudit and a
    BackwardAudit: (audit, backward audit, pieces launched, right-hand-side
    evaluations inside the pieces)."""
    loop = graphed.StaticLoop(cfg, params, v0, st)
    pieces = loop.functions()
    audit, backward, launched = PieceAudit(), BackwardAudit(), collections.Counter()
    evals, inside = [0], [False]
    inner = trhs._eqn_ray_from_eq

    def counted(*a, **k):
        evals[0] += inside[0]
        return inner(*a, **k)

    monkeypatch.setattr(trhs, "_eqn_ray_from_eq", counted)

    def launch(name):
        launched[name] += 1
        inside[0] = True
        with backward, audit:
            pieces[name]()
        inside[0] = False

    with torch.no_grad():
        loop.trace(params, v0, st, pwr, launch)
    return audit, backward, launched, evals[0]


@pytest.mark.parametrize("name", list(CASES))
def test_pieces_read_nothing_on_the_host(setups, name, monkeypatch):
    cfg, params, v0, st, pwr = _case(setups, name, save_trajectory=True, nstep_max=3)
    audit, backward, launched, _ = _audit(cfg, params, v0, st, pwr, monkeypatch)
    assert not audit.reads and not audit.crossings, (audit.reads, audit.crossings)
    assert not set(backward.nodes) & HOST_READING_BACKWARDS, dict(backward.nodes)
    # the autodiff derivatives alone build a backward pass inside a step
    assert bool(backward.nodes) == (cfg.ray_deriv_name == "autodiff")
    if name in LOOP_FORM:
        # the flag is read between the pieces, once per head and chunk
        assert launched["head"] == launched["tail"] == 3
    else:
        assert dict(launched) == {"step": 3}
    # ... and the eager loop's reads are where the audit would see them
    if name in LOOP_FORM:
        with PieceAudit() as eager:
            ttrace.trace_batch(cfg, params, v0, st, pwr)
        assert eager.reads["_local_scalar_dense"] >= 2 * cfg.nstep_max


@pytest.mark.parametrize("name", list(CASES))
def test_no_library_product_in_a_step(setups, name, monkeypatch):
    cfg, params, v0, st, pwr = _case(setups, name, save_trajectory=False, nstep_max=2)
    audit, _, _, evals = _audit(cfg, params, v0, st, pwr, monkeypatch)
    assert evals > 0
    if cfg.integrate_eq_gradients:
        # the einsum of tracing/rhs.py, as the JAX package's @ (rhs.py:103)
        assert dict(audit.products) == {"bmm": evals}
    else:
        assert not audit.products, dict(audit.products)


def test_a_reused_loop_answers_each_call(setups):
    """Two calls with other Params values (and other rays) of the same
    shapes through one StaticLoop, as through one cached graph: each gets
    its own trace_batch result, and the same cache key."""
    cfg, params, v0, st, pwr = _case(setups, "solovev_sg", save_trajectory=True)
    other = params._replace(eq=tree_map(lambda t: t * 1.01 if t.is_floating_point() else t,
                                        params.eq))
    v1 = v0.flip(0).contiguous()
    assert graphed.cache_key(cfg, params, v0) == graphed.cache_key(cfg, other, v1)
    assert graphed.cache_key(cfg, params, v0) != graphed.cache_key(cfg, params, v0[:-1])
    loop = graphed.StaticLoop(cfg, params, v0, st)
    with torch.no_grad():
        runs = [loop.trace(p, v, st, pwr) for p, v in ((params, v0), (other, v1), (params, v0))]
    _assert_equal_results(runs[0], ttrace.trace_batch(cfg, params, v0, st, pwr))
    _assert_equal_results(runs[1], ttrace.trace_batch(cfg, other, v1, st, pwr))
    _assert_equal_results(runs[2], runs[0])
    assert not torch.equal(runs[0].end_ray_vec, runs[1].end_ray_vec)


# --- the dispatch -------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_route_of_each_graphed_config(setups, name):
    cfg, params, v0, st, pwr = _case(setups, name)
    assert not fused_slab.supported(cfg)
    assert ttrace.route(cfg, False, "cuda") == ttrace.route(cfg, False, torch.device("cuda", 0)) \
        == "graph"
    # reverse-mode gradients take the graphed adjoint, but for the SG loop
    # form and the autodiff derivatives, which stay plain; the CPU stays plain
    differentiable = name not in LOOP_FORM and name != "slab_rk4_autodiff"
    assert ttrace.route(cfg, True, "cuda") == ("adjoint" if differentiable else "plain")
    assert ttrace.route(cfg, False, "cpu") == ttrace.route(cfg, True, "cpu") == "plain"
    # tangents take the tangent graph, but for the autodiff derivatives
    tangent = "plain" if name == "slab_rk4_autodiff" else "tangent"
    assert ttrace.route(cfg, False, "cuda", tangents=True) == tangent
    # a model of the caller's own, even under the built-in name, takes the
    # same compiled routes
    tbase.register_eq_model(cfg.equilib_model, tbase.get_eq_model(cfg.equilib_model))
    try:
        assert ttrace.route(cfg, False, "cuda") == "graph"
        assert ttrace.route(cfg, True, "cuda") == ("adjoint" if differentiable else "plain")
        assert ttrace.route(cfg, False, "cuda", tangents=True) == tangent
        if name == "slab_rk4_autodiff":
            # ... and never the kernel: its physics is the built-in slab's
            cold = dataclasses.replace(cfg, ray_deriv_name="cold")
            assert ttrace.route(cold, False, "cuda") == "graph"
            assert not fused_slab.supported(cold)
    finally:
        tbase.EQ_MODELS.pop(cfg.equilib_model)
    assert ttrace.route(cfg, False, "cuda") == "graph"
    # the kernel's own configs keep the kernel
    if name == "slab_rk4_autodiff":
        assert ttrace.route(dataclasses.replace(cfg, ray_deriv_name="cold"), False,
                            "cuda") == "kernel"


def test_graphed_tracer_refuses_what_it_cannot_capture(setups):
    """No fallback: on the CPU, or with gradients, the graphed tracer
    raises instead of running the eager loop; trace_rays on the CPU takes
    the plain tracer."""
    cfg, params, v0, st, pwr = _case(setups, "solovev_rk4", nstep_max=3)
    with pytest.raises(ValueError, match="CUDA device"):
        graphed.trace_batch_graphed(cfg, params, v0, st, pwr)
    with pytest.raises(ValueError, match="no derivatives"):
        graphed.trace_batch_graphed(cfg, params, v0.clone().requires_grad_(True), st, pwr)
    # forward-mode tangents are derivatives too: refused here, and routed
    # to the plain tracer by trace_rays
    with fwAD.dual_level():
        dual = params._replace(eq=params.eq._replace(kappa=fwAD.make_dual(
            params.eq.kappa, torch.ones_like(params.eq.kappa))))
        assert has_tangent(dual, v0) and not has_tangent(params, v0)
        with pytest.raises(ValueError, match="no derivatives"):
            graphed.trace_batch_graphed(cfg, dual, v0, st, pwr)
        tangent = fwAD.unpack_dual(ttrace.trace_rays(cfg, dual, v0, st, pwr).end_ray_vec).tangent
    assert tangent is not None and bool(tangent.abs().max() > 0)
    before = (graphed.CAPTURES, graphed.REPLAYS, len(graphed._CACHE))
    res = ttrace.trace_rays(cfg, params, v0, st, pwr)
    _assert_equal_results(res, ttrace.trace_batch(cfg, params, v0, st, pwr))
    assert (graphed.CAPTURES, graphed.REPLAYS, len(graphed._CACHE)) == before
    assert graphed.CACHE_SIZE >= 2 and graphed.CHUNK >= 1
