"""rays_tpu_torch's graphed adjoint (tracing/graphed_adjoint.py) on the CPU.

The graphs are captured only on a CUDA device; here the same pieces
("step" and "vjp") run on the same static buffers, called directly
(``graphed_adjoint.trace_batch_static_adjoint``), which is what the
graphs replay.  Held:

* against eager autograd through ``trace.trace_batch``: the loss bit for
  bit, and the gradient of every floating Params leaf, v0 and pwr_wt
  within GRAD_RTOL of the leaf's largest eager gradient in float64
  (F32_GRAD_RTOL in float32).  The accumulators sum the steps in another
  order than the autograd engine, so the gradients are not bit-equal;
  every RayResults field that a loss can read is in the loss, with
  weights from a numpy seed.  Every differentiable configuration of the
  graph route, the kernel's two configs (the slab and the damped slab of
  ``__graft_entry__.py``) and Solovev under SG with a fixed budget, each
  with and without trajectories;
* the forward bit for bit equal to ``graphed.trace_batch_static``;
* the graft loss, the slab SG loss (``sg_scan_substeps=2``), the EQDSK
  loss and the mirror loss (``bench.py:294``, ``:356``, ``:498``,
  ``:395``) against ``jax.grad`` on the same inputs, carried across by
  ``convert``, at JAX_RTOL of each leaf's scale;
* the "vjp" piece: no host read, no copy across devices, no autograd
  node whose backward reads the host (test_torch_graphed.py's audits);
  and the "step" and "vjp" pieces of the slab kernels (tracing/slab_vjp.py,
  on their host build) and the EQDSK step kernel's "step" piece
  (tracing/eqdsk_step.py, on its host build) alike;
* one reused loop answers two forwards with other Params, whose
  backwards run after both, each with its own gradients;
* the dispatch: the adjoint graph on the card with reverse-mode
  gradients, a registered model's too; the tangent graph for tangents;
  plain for tangents with gradients, the SG loop form, the autodiff
  derivatives and the CPU.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.config import schema as jschema
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch import convert, examples as tex, run as trun
from rays_tpu_torch.config import schema as tschema
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.tracing import eqdsk_step, fused_slab, graphed, graphed_adjoint as ga
from rays_tpu_torch.tracing import slab_vjp
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.tracing.capture_audit import HOST_READING_BACKWARDS, BackwardAudit, PieceAudit
from test_axisym import AXISYM_TMPL
from test_torch_adaptive import _adjoint_case as _sg_adjoint_case
from test_torch_adjoint import GRAFT_DS, GRAFT_STEPS, _jax_graft_loss, _torch_graft_loss
from test_torch_graphed import EQ_GRAD, MIRROR_DAMPED, SLAB_SG

N_RAYS = 8
GRAD_RTOL = 1e-12       # float64: of each leaf's largest eager gradient
F32_GRAD_RTOL = 2e-6    # float32: 16 ulp of the leaf's scale
JAX_RTOL = 1e-10        # against jax.grad (tests/test_torch_adjoint.py)

# name: (how the case is set up, Config changes, outer steps)
CASES = {
    "slab_rk4": ("slab", {}, 20),
    "slab_damped_graft": ("slab_damped", {}, 20),
    "slab_rk4_eq_gradients": ("slab_eq_grad", {}, 20),
    "slab_sg_fixed_budget": ("slab_sg", dict(sg_scan_substeps=2), 20),
    "solovev_sg_fixed_budget": ("solovev", dict(sg_scan_substeps=3), 8),
    "solovev_rk4": ("solovev", dict(ode_solver_name="RK4_ODE"), 20),
    "eqdsk_rk4": ("eqdsk", {}, 12),
    "mirror_damped_rk4": ("mirror_damped", {}, 12),
    "slab_compensated_f32": ("slab_f32", dict(compensated_sum=True), 20),
}
KERNEL_CONFIGS = ("slab_rk4", "slab_damped_graft")
# what stays plain with gradients: (case, Config changes)
PLAIN = {
    "slab_sg_loop": ("slab_sg", {}),
    "solovev_sg_loop": ("solovev", {}),
    "slab_rk4_autodiff": ("slab", dict(ray_deriv_name="autodiff")),
}


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """{setup name: (cfg, params, v0, status0, pwr)} on the CPU at N_RAYS
    rays (examples.replicate_rays); the spline files on small grids."""
    d = tmp_path_factory.mktemp("graphed_adjoint")
    (d / "eqdsk").mkdir()
    (d / "mirror").mkdir()
    made = {
        "slab": tex.setup_example(device="cpu"),
        "slab_damped": tex.setup_example(tex.SLAB_ECH_DAMPED, device="cpu"),
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


def _case(setups, spec, **changes):
    which, cfg_changes, steps = spec
    cfg, params, v0, st, pwr = setups[which]
    cfg = dataclasses.replace(cfg, **{**cfg_changes, "nstep_max": steps, **changes})
    return cfg, params, v0, st, pwr


def _with_grad(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)


def _weighted_loss(res, seed=7):
    """A weighted sum of every floating RayResults field, the weights
    N(0, 1) from a numpy seed."""
    rng = np.random.default_rng(seed)
    loss = 0.0
    for t in res:
        if t is not None and t.is_floating_point():
            w = torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=t.dtype)
            loss = loss + (t * w).sum()
    return loss


def _loss_and_grads(tracer, cfg, params, v0, st, pwr, loss_of=_weighted_loss):
    """(loss, RayResults, gradients of the floating Params leaves, v0 and
    pwr_wt) of ``loss_of`` through ``tracer``."""
    p = _with_grad(params)
    v, w = v0.clone().requires_grad_(True), pwr.clone().requires_grad_(True)
    res = tracer(cfg, p, v, st, w)
    loss = loss_of(res)
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()] + [v, w]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), res, grads


def _assert_grads_close(got, ref, rtol, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = float(r.abs().max()) if r.numel() else 0.0
        assert bool(torch.isfinite(g).all()), (what, i)
        err = float((g - r).abs().max()) if r.numel() else 0.0
        assert err <= rtol * scale, (what, i, err, scale)


def _assert_equal_results(got, ref):
    for name, g, r in zip(ttrace.RayResults._fields, got, ref):
        if r is None:
            assert g is None, name
            continue
        assert g.dtype == r.dtype and torch.equal(g.detach(), r.detach()), name


@pytest.mark.parametrize("save", [True, False], ids=["trajectory", "summaries"])
@pytest.mark.parametrize("name", list(CASES))
def test_static_adjoint_equals_eager_autograd(setups, name, save):
    cfg, params, v0, st, pwr = _case(setups, CASES[name], save_trajectory=save)
    ref_loss, ref, ref_grads = _loss_and_grads(ttrace.trace_batch, cfg, params, v0, st, pwr)
    loss, got, grads = _loss_and_grads(ga.trace_batch_static_adjoint, cfg, params, v0, st, pwr)
    assert torch.equal(loss, ref_loss)
    _assert_equal_results(got, ref)
    rtol = F32_GRAD_RTOL if v0.dtype == torch.float32 else GRAD_RTOL
    _assert_grads_close(grads, ref_grads, rtol, name)
    # the forward is the graph route's, bit for bit
    with torch.no_grad():
        _assert_equal_results(got, graphed.trace_batch_static(cfg, params, v0, st, pwr))
    # the rays go somewhere, and the gradients are not all zero
    assert int(ref.npoints.max()) > cfg.nstep_max // 2 >= 4
    assert sum(bool(g.abs().max() > 0) for g in ref_grads if g.numel()) >= 5


# --- against jax.grad ---------------------------------------------------------


def _jax_endpoint_loss(cfg, v0, st, pwr):
    def loss(params):
        res = jtrace.trace_batch(cfg, params, v0, st, pwr)
        return jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * pwr[:, None])
    return loss


def _assert_matches_jax(jcfg, jparams, v0, st, pwr, pcfg=None, pparams=None):
    """The endpoint loss of bench.py's adjoint rows through the static
    adjoint against jax.grad, every Params leaf at JAX_RTOL of its scale."""
    ref_loss, ref = jax.jit(jax.value_and_grad(_jax_endpoint_loss(jcfg, v0, st, pwr)))(jparams)
    cfg, pp, tv0, tst, tpw = tp.to_port(jcfg, jparams, v0, st, pwr)
    cfg, pp = pcfg or cfg, pparams or pp
    p = _with_grad(pp)
    res = ga.trace_batch_static_adjoint(cfg, p, tv0, tst, tpw)
    loss = (res.end_ray_vec[:, 0:3] ** 2 * tpw[:, None]).sum()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-12)
    leaves = tree_leaves(p)
    jleaves = jax.tree_util.tree_leaves(ref)
    assert len(leaves) == len(jleaves)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    live = 0
    for i, (g, r) in enumerate(zip(grads, jleaves)):
        r = np.asarray(r)
        scale = np.abs(r).max() if r.size else 0.0
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=JAX_RTOL * scale, err_msg=str(i))
        live += bool(scale > 0)
    assert live >= 4
    return res


def test_graft_loss_matches_jax_grad():
    """``__graft_entry__.py``'s training loss (the damped slab with
    trajectories and the Ptotal_x profile) through the static adjoint
    against jax.grad of the JAX package's, every leaf, v0 and pwr_wt."""
    cfg, params, v0, st, pwr = tp.jax_case(jex.SLAB_ECH_DAMPED, ds=GRAFT_DS,
                                           nstep_max=GRAFT_STEPS, save_trajectory=True)
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
    (jl, jflags), (gp, gv, gw) = jax.jit(jax.value_and_grad(
        _jax_graft_loss(cfg, xmin, xmax), argnums=(0, 1, 2), has_aux=True))(
            params, v0, pwr, st)
    assert {21, 31} <= set(np.asarray(jflags).tolist())   # absorbed and run out
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    assert ttrace.route(pcfg, True, "cuda") == "adjoint"
    p = _with_grad(pp)
    tv0.requires_grad_(True)
    tpw.requires_grad_(True)
    loss = _torch_graft_loss(pcfg, p, tv0, tst, tpw, xmin, xmax,
                             tracer=ga.trace_batch_static_adjoint)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-12)
    leaves = tree_leaves(p) + [tv0, tpw]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    ref = jax.tree_util.tree_leaves(gp) + [gv, gw]
    assert len(grads) == len(ref)
    for i, (g, r) in enumerate(zip(grads, ref)):
        r = np.asarray(r)
        scale = np.abs(r).max() if r.size else 0.0
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=JAX_RTOL * scale, err_msg=str(i))


def test_slab_sg_loss_matches_jax_grad():
    """bench.py's SG adjoint row (``sg_scan_substeps=2``) on the case of
    tests/test_torch_adaptive.py (tolerance 1e-6, 8 outer steps)."""
    cfg, params, v0, st, pwr = _sg_adjoint_case()
    res = _assert_matches_jax(cfg, params, v0, st, pwr)
    assert res.npoints.tolist() == [cfg.nstep_max + 1] * 3     # the budget of 2 sufficed


def test_eqdsk_loss_matches_jax_grad(tmp_path):
    """bench.py's EQDSK adjoint row (the psi cell table among the leaves)
    on the launch rays of tests/test_axisym.py's namelist."""
    text = AXISYM_TMPL.format(MAG="eqdsk_magnetics_spline_interp",
                              EQDSK=tp.write_solovev_geqdsk(tmp_path / "solovev.geqdsk"))
    (jcfg, jparams), (pcfg, _) = tp.both_from_text(text)
    jcfg = dataclasses.replace(jcfg, nstep_max=40, save_trajectory=False)
    pcfg = dataclasses.replace(pcfg, nstep_max=40, save_trajectory=False)
    pparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    v0, st, pwr = tp.jax_launch(jcfg, jparams)
    _assert_matches_jax(jcfg, jparams, v0, st, pwr, pcfg, pparams)


def test_mirror_loss_matches_jax_grad(tmp_path):
    """bench.py's mirror adjoint row on the four-coil mirror (the field
    cells among the leaves), float64; the damped mirror is held to eager
    autograd above."""
    path = tp.write_mirror_inputs(tmp_path, NSTEP=30)
    jcfg, jparams = jschema.from_file(path)
    pcfg, _ = tschema.from_file(path)
    jcfg = dataclasses.replace(jcfg, save_trajectory=False)
    pcfg = dataclasses.replace(pcfg, save_trajectory=False)
    pparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    v0, st, pwr = tp.jax_launch(jcfg, jparams)
    _assert_matches_jax(jcfg, jparams, v0, st, pwr, pcfg, pparams)


# --- what the pieces issue ----------------------------------------------------


@pytest.mark.parametrize("name", list(CASES) + ["slab_rk4_kernels", "eqdsk_rk4_kernel"])
def test_vjp_piece_reads_nothing_on_the_host(setups, name):
    kernels = name == "slab_rk4_kernels"
    base_case = {"slab_rk4_kernels": "slab_rk4", "eqdsk_rk4_kernel": "eqdsk_rk4"}.get(name, name)
    cfg, params, v0, st, pwr = _case(setups, CASES[base_case], save_trajectory=True, nstep_max=3)
    loop = ga.StaticAdjoint(cfg, params, v0, st)
    # the card's pieces, on the host build of their library
    if kernels:
        loop.kernels = slab_vjp.SlabVJP(slab_vjp.load_host_library(), loop)
    if name == "eqdsk_rk4_kernel":
        loop.kernels = eqdsk_step.EqdskStep(eqdsk_step.load_host_library(), loop)
    pieces = loop.functions()
    side = loop.kernels
    assert pieces == ({"step": loop.step, "vjp": loop.vjp} if side is None else
                      {"step": side.step, "vjp": side.vjp if kernels else loop.vjp})
    audits = {n: (PieceAudit(), BackwardAudit()) for n in pieces}
    launched = collections.Counter()

    def launch(piece):
        launched[piece] += 1
        audit, backward = audits[piece]
        with backward, audit:
            pieces[piece]()

    p = _with_grad(params)
    res = ga.trace_adjoint(cfg, p, v0, st, pwr, lambda: (loop, launch))
    grads = torch.autograd.grad(_weighted_loss(res), [t for t in tree_leaves(p)
                                                      if t.is_floating_point()])
    assert dict(launched) == {"step": 3, "vjp": 3}
    for piece, (audit, backward) in audits.items():
        assert not audit.reads and not audit.crossings, (piece, audit.reads, audit.crossings)
        assert not set(backward.nodes) & HOST_READING_BACKWARDS, (piece, dict(backward.nodes))
    # the forward builds no autograd node; the generic VJP's recompute does
    assert not audits["step"][1].nodes and bool(audits["vjp"][1].nodes) != kernels
    assert any(bool(g.abs().max() > 0) for g in grads)


def test_a_reused_loop_answers_each_call(setups):
    """Two forwards with other Params values (and other rays) of the same
    shapes through one StaticAdjoint, as through one cached entry, then
    both backwards: each gets its own eager gradients."""
    cfg, params, v0, st, pwr = _case(setups, CASES["solovev_rk4"], save_trajectory=True)
    other = params._replace(eq=tree_map(lambda t: t * 1.01 if t.is_floating_point() else t,
                                        params.eq))
    v1 = v0.flip(0).contiguous()
    assert graphed.cache_key(cfg, params, v0) == graphed.cache_key(cfg, other, v1)
    loop = ga.StaticAdjoint(cfg, params, v0, st)
    runs = []
    for p, v in ((params, v0), (other, v1)):
        pg = _with_grad(p)
        res = ga.trace_batch_static_adjoint(cfg, pg, v, st, pwr, loop=loop)
        runs.append((pg, _weighted_loss(res)))
    run_ids = loop.run_id
    got = [torch.autograd.grad(loss, tree_leaves(pg)) for pg, loss in runs]
    # each backward replayed its forward first: the other call's stack
    # was on the loop
    assert loop.run_id == run_ids + 2
    for (p, v), g in zip(((params, v0), (other, v1)), got):
        _, _, ref = _loss_and_grads(ttrace.trace_batch, cfg, p, v, st, pwr)
        _assert_grads_close(g, ref[:len(g)], GRAD_RTOL, "reused loop")
    assert any(not torch.equal(a, b) for a, b in zip(*got))


def test_a_loop_takes_a_second_backward(setups):
    """retain_graph: a second backward of one forward gives the same
    gradients (the sweep starts again from the last step)."""
    cfg, params, v0, st, pwr = _case(setups, CASES["slab_sg_fixed_budget"], nstep_max=10)
    p = _with_grad(params)
    loss = _weighted_loss(ga.trace_batch_static_adjoint(cfg, p, v0, st, pwr))
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()]
    first = torch.autograd.grad(loss, leaves, retain_graph=True)
    second = torch.autograd.grad(loss, leaves)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# --- the dispatch ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES) + list(PLAIN))
def test_route_of_each_adjoint_config(setups, name):
    if name in PLAIN:
        which, changes = PLAIN[name]
        cfg = _case(setups, (which, changes, 10))[0]
        assert ttrace.route(cfg, True, "cuda") == "plain"
        with pytest.raises(ValueError, match="graphed adjoint"):
            ga.check_capturable(cfg)
        return
    cfg = _case(setups, CASES[name])[0]
    assert ttrace.route(cfg, True, "cuda") == ttrace.route(cfg, True, torch.device("cuda", 0)) \
        == "adjoint"
    # without gradients the kernel or the graph, as before
    assert ttrace.route(cfg, False, "cuda") == ("kernel" if name in KERNEL_CONFIGS else "graph")
    assert fused_slab.supported(cfg) == (name in KERNEL_CONFIGS)
    # tangents take the tangent graph; tangents with reverse mode, and the
    # CPU, stay plain
    assert ttrace.route(cfg, False, "cuda", tangents=True) == "tangent"
    assert ttrace.route(cfg, True, "cuda", tangents=True) == "plain"
    assert ttrace.route(cfg, True, "cpu") == "plain"
    # remat_steps sets only the plain route's memory
    assert ttrace.route(dataclasses.replace(cfg, remat_steps=False), True, "cuda") == "adjoint"
    # a model of the caller's own, even under the built-in name, takes the
    # adjoint graph too
    tbase.register_eq_model(cfg.equilib_model, tbase.get_eq_model(cfg.equilib_model))
    try:
        assert ttrace.route(cfg, True, "cuda") == "adjoint"
    finally:
        tbase.EQ_MODELS.pop(cfg.equilib_model)


def test_graphed_adjoint_refuses_what_it_cannot_capture(setups):
    """No fallback: on the CPU, with tangents, or for the SG loop form the
    graphed adjoint raises; trace_rays on the CPU takes trace_batch and
    captures nothing."""
    cfg, params, v0, st, pwr = _case(setups, CASES["solovev_rk4"], nstep_max=3)
    p = _with_grad(params)
    with pytest.raises(ValueError, match="CUDA device"):
        ga.trace_batch_graphed_adjoint(cfg, p, v0, st, pwr)
    with fwAD.dual_level():
        dual = params._replace(eq=params.eq._replace(kappa=fwAD.make_dual(
            params.eq.kappa, torch.ones_like(params.eq.kappa))))
        with pytest.raises(ValueError, match="tangents"):
            ga.trace_batch_graphed_adjoint(cfg, dual, v0, st, pwr)
    with pytest.raises(ValueError, match="sg_scan_substeps"):
        ga.trace_batch_graphed_adjoint(_case(setups, ("solovev", {}, 3))[0], p, v0, st, pwr)
    before = (ga.CAPTURES, ga.REPLAYS, len(graphed._CACHE))
    loss = _weighted_loss(ttrace.trace_rays(cfg, p, v0, st, pwr))
    ref_loss = _weighted_loss(ttrace.trace_batch(cfg, _with_grad(params), v0, st, pwr))
    assert torch.equal(loss.detach(), ref_loss.detach())
    assert (ga.CAPTURES, ga.REPLAYS, len(graphed._CACHE)) == before
    assert ga.WARMUP >= 1
