"""The slab step's hand-written VJP (csrc/slab_rk4_vjp.cuh) on the CPU:
the kernel body built by g++ (csrc/slab_rk4_vjp_host.cpp) as the adjoint
graph's "vjp" piece, held to the generic piece it replaces on the card
(``StaticAdjoint.vjp``: ``trace.step`` recomputed under autograd), which is
its plain version.

Held, in float64 within GRAD_RTOL and in float32 within F32_GRAD_RTOL of
each gradient's largest magnitude:

* one step, through the pieces: every cotangent of the float carry and
  the accumulator of every floating Params leaf, with random cotangents
  on the carry, the trajectory row and the residual row, at a step where
  every ray steps and at one where some have stopped; with max_res tied
  to the step's residual (torch.maximum splits the cotangent evenly);
* whole runs through ``trace_batch_static_adjoint``: the loss bit for bit
  and the gradient of every floating Params leaf, v0 and pwr_wt of a loss
  that reads every floating result, on rays that stop at the x bound, at
  s_max and that never start, with and without trajectories, one and two
  species, every profile model of the slab kernel, and ray_param time
  and arcl;
* whole runs of the deck, with trajectories in time and without in arc
  length, against ``jax.value_and_grad`` of the JAX package's
  ``trace_batch`` on the same inputs: the loss and the gradient of every
  floating Params leaf, v0 and pwr_wt within JAX_RTOL of its scale;
* one loop answering two forwards with other Params values, each
  backward its own gradients;
* the gate: the slab kernel's configurations without damping take the
  kernel on CUDA, and nothing else does (the damped slab, the slab under
  SG, the compensated carry, Solovev, the CPU).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch import examples as tex
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.tracing import graphed_adjoint as ga, slab_vjp
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.tracing.stop import StopCode
from test_torch_graphed import EQ_GRAD, SLAB_SG
from test_torch_graphed_adjoint import JAX_RTOL

N_RAYS = 8
STEPS = 40
GRAD_RTOL = 1e-11       # float64: of each gradient's largest magnitude
# float32: the gradients of these losses are ill-conditioned in float32
# (the generic piece's own are 0.1-17 % from the float64 answer), so each
# float32 gradient is held to the float64 answer within F32_FACTOR times
# the generic piece's float32 error, plus F32_FLOOR of its scale
F32_FACTOR = 3.0
F32_FLOOR = 1e-6

# the slab kernel's profile models: with tp.KERNEL_COMBOS, every by, bz,
# density and temperature model it takes
COMBOS = tp.KERNEL_COMBOS + [("toroid", "linear", "Gaussian", ("parabolic", "linear"))]

# name: (Config changes, what else changes)
RUNS = {
    "time": ({}, None),
    "time_summaries": (dict(save_trajectory=False), None),
    "arcl": (dict(ray_param="arcl"), "arcl_ds"),
    "x_bounds": ({}, "x_bounds"),
    "s_max": (dict(save_trajectory=False), "s_max"),
    "not_started": ({}, "not_started"),
    "one_species": ({}, "electrons"),
    **{"-".join((c[0], c[1], c[2], *c[3])): ({}, c) for c in COMBOS},
}


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the slab VJP needs it")
    return slab_vjp.load_host_library()


def _case(name, dtype=torch.float64):
    changes, extra = RUNS[name]
    cfg, params, v0, st, pwr = tex.setup_example(device="cpu", dtype=dtype)
    v0, st, pwr = tex.replicate_rays(v0, st, pwr, N_RAYS)
    cfg = dataclasses.replace(cfg, **{"nstep_max": STEPS, "save_trajectory": True, **changes})

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype)

    if isinstance(extra, tuple):
        by, bz, dens, tm = extra
        cfg = dataclasses.replace(cfg, eq_static=dataclasses.replace(
            cfg.eq_static, by_prof_model=by, bz_prof_model=bz, dens_prof_model=dens,
            t_prof_model=tuple(tm)))
        # under a lax residual limit: the rays solve the deck's dispersion
        params = params._replace(
            eq=params.eq._replace(**{k: scalar(v) for k, v in tp.SLAB_OVERRIDES.items()}),
            limits=params.limits._replace(dispersion_resid_limit=scalar(1e3)))
    elif extra == "arcl_ds":
        params = params._replace(ode=params.ode._replace(ds=scalar(2.5e-3)))
    elif extra == "x_bounds":
        # the three rays reach it at 21-27 steps of the 40
        params = params._replace(eq=params.eq._replace(xmax=scalar(-0.07)))
    elif extra == "s_max":
        params = params._replace(ode=params.ode._replace(s_max=scalar(1.2e-9)))
    elif extra == "not_started":
        st = st.clone()
        st[1] = int(StopCode.DID_NOT_START)
    elif extra == "electrons":
        # the deuterium taken out after the launch (S = 1), under a lax
        # residual limit: the rays solve the two-species dispersion
        sp, eq = params.species, params.eq
        params = params._replace(
            species=sp._replace(**{f: getattr(sp, f)[:1] for f in sp._fields
                                   if getattr(sp, f).dim()}),
            eq=eq._replace(alphat1=eq.alphat1[:1], alphat2=eq.alphat2[:1], t_min=eq.t_min[:1]),
            limits=params.limits._replace(dispersion_resid_limit=scalar(1e3)))
        cfg = dataclasses.replace(cfg, nspec=0, eq_static=dataclasses.replace(
            cfg.eq_static, t_prof_model=cfg.eq_static.t_prof_model[:1]))
    return cfg, params, v0, st, pwr


def _with_grad(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)


def _weights(res, seed=7):
    """N(0, 1) weights for every floating RayResults field (None for the
    others), from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(t.shape)) if t is not None and t.is_floating_point()
            else None for t in res]


def _weighted_loss(res, seed=7):
    loss = 0.0
    for t, w in zip(res, _weights(res, seed)):
        if w is not None:
            loss = loss + (t * torch.as_tensor(w, dtype=t.dtype)).sum()
    return loss


def _loop(cfg, params, v0, st, lib):
    """A StaticAdjoint on the CPU, whose gate gives it the generic piece;
    with a library, its "vjp" piece is that library's slab VJP instead."""
    loop = ga.StaticAdjoint(cfg, params, v0, st)
    if lib is not None:
        loop.slab = slab_vjp.SlabVJP(lib, loop)
    return loop


def _run(cfg, params, v0, st, pwr, slab_lib, loop=None):
    """(loss, results, gradients of the floating Params leaves, v0 and
    pwr_wt) through a StaticAdjoint whose "vjp" piece is ``slab_lib``'s
    kernel (None: the generic piece)."""
    p = _with_grad(params)
    v, w = v0.clone().requires_grad_(True), pwr.clone().requires_grad_(True)
    loop = loop or _loop(cfg, p, v, st, slab_lib)
    res = ga.trace_batch_static_adjoint(cfg, p, v, st, w, loop=loop)
    loss = _weighted_loss(res)
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()] + [v, w]
    return loss.detach(), res, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                   materialize_grads=True)


def _assert_close(got, ref, rtol, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = float(r.abs().max()) if r.numel() else 0.0
        assert bool(torch.isfinite(g).all()), (what, i)
        err = float((g - r).abs().max()) if r.numel() else 0.0
        assert err <= rtol * scale, (what, i, err, scale)
        # a leaf the step does not read gets exactly zero, as from autograd
        if scale == 0.0:
            assert not bool(g.any()), (what, i)


@pytest.mark.parametrize("name,dtype", [(n, torch.float64) for n in RUNS] + [
    (n, torch.float32) for n in ("time", "arcl", "x_bounds")],
    ids=[f"{n}-f64" for n in RUNS] + [f"{n}-f32" for n in ("time", "arcl", "x_bounds")])
def test_whole_run_matches_generic_vjp(host_lib, name, dtype):
    cfg, params, v0, st, pwr = _case(name, dtype)
    ref_loss, ref, ref_grads = _run(cfg, params, v0, st, pwr, None)
    loss, got, grads = _run(cfg, params, v0, st, pwr, host_lib)
    assert torch.equal(loss, ref_loss)
    for field, g, r in zip(ttrace.RayResults._fields, got, ref):
        assert (g is None and r is None) or torch.equal(g.detach(), r.detach()), field
    if dtype == torch.float64:
        _assert_close(grads, ref_grads, GRAD_RTOL, name)
    else:
        exact = _run(*_case(name), None)[2]
        for i, (g, r, e) in enumerate(zip(grads, ref_grads, exact)):
            scale = float(e.abs().max()) if e.numel() else 0.0
            assert bool(torch.isfinite(g).all()), (name, i)
            err, ref_err = (float((t.double() - e).abs().max()) if e.numel() else 0.0
                            for t in (g, r))
            assert err <= F32_FACTOR * ref_err + F32_FLOOR * scale, (name, i, err, ref_err)
    # the rays step, and the gradients are not all zero
    assert int(ref.npoints.max()) > STEPS // 4
    assert sum(bool(g.abs().max() > 0) for g in ref_grads if g.numel()) >= 5
    stops = set(ref.stop_flag.tolist())
    want = {"x_bounds": StopCode.X_OUT_OF_BOUNDS, "s_max": StopCode.SOUT_GT_SMAX,
            "not_started": StopCode.DID_NOT_START}.get(name)
    if want is not None:
        assert int(want) in stops
    if name in ("x_bounds", "not_started"):
        assert len(set(ref.npoints.tolist())) > 1


def _stepped_loops(host_lib, name, dtype=torch.float64):
    """A generic and a kernel StaticAdjoint that have both run one forward
    of the case, and the rays' npoints."""
    cfg, params, v0, st, pwr = _case(name, dtype)
    carry = ttrace.initial_carry(cfg, params, v0, st)
    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    loops = []
    for lib in (None, host_lib):
        loop = _loop(cfg, params, v0, st, lib)
        loop.forward(carry, leaves)
        loops.append(loop)
    return loops


@pytest.mark.parametrize("where", ["all_live", "some_stopped", "tie", "last"])
def test_one_step_matches_generic_vjp(host_lib, where):
    """The VJP of one step k through the pieces, on random cotangents."""
    name = "x_bounds" if where == "some_stopped" else "time"
    generic, kernel = _stepped_loops(host_lib, name)
    n = generic.cfg.nstep_max
    nstep = torch.cat([generic.stack[5], generic.carry[5][None]])    # (n + 1, B)
    if where == "last":
        k = n - 1
    else:
        steps = (nstep[1:] - nstep[:-1]).sum(1)
        live = steps == N_RAYS if where != "some_stopped" else (steps > 0) & (steps < N_RAYS)
        k = int(torch.nonzero(live)[len(torch.nonzero(live)) // 2])
    stepped = nstep[k + 1] != nstep[k]
    if where == "tie":
        # max_res before the step equal to the step's residual (end_res after)
        for loop in (generic, kernel):
            loop.stack[7][k] = torch.where(stepped, loop.stack[6][k + 1], loop.stack[7][k])
    gen = torch.Generator().manual_seed(k)
    cots = [torch.randn(c.shape, generator=gen, dtype=c.dtype) for c in generic.cot]
    traj = torch.randn(generic.traj_cot.shape, generator=gen, dtype=generic.traj_cot.dtype)
    resid = torch.randn(generic.resid_cot.shape, generator=gen, dtype=generic.resid_cot.dtype)
    for loop in (generic, kernel):
        with torch.no_grad():
            for buf, c in zip(loop.cot, cots):
                buf.copy_(c)
            loop.traj_cot.copy_(traj)
            loop.resid_cot.copy_(resid)
            for a in loop.acc:
                a.zero_()
            loop.k.fill_(k + 1)
        if loop.slab is not None:
            loop.slab.acc.zero_()
        loop.functions()["vjp"]()
        if loop.slab is not None:
            loop.slab.reduce(loop.acc)
    assert bool(stepped.any()) and (where != "some_stopped") == bool(stepped.all())
    assert int(kernel.k) == int(generic.k) == k
    _assert_close(kernel.cot, generic.cot, GRAD_RTOL, where)
    _assert_close(kernel.acc, generic.acc, GRAD_RTOL, where)
    # rays that did not step pass their cotangents through untouched
    for got, c in zip(kernel.cot, cots):
        assert torch.equal(got[~stepped], c[~stepped])
    if where == "tie":
        # the cotangent of max_res split evenly between the two branches
        assert torch.equal(kernel.cot[4][stepped], cots[4][stepped] / 2)


@pytest.mark.parametrize("name", ["time", "arcl_summaries"])
def test_whole_run_matches_jax_grad(host_lib, name):
    """The deck's rays through the kernel's piece against jax.value_and_grad
    of the JAX package's trace_batch, on the same inputs and loss."""
    changes = dict(nstep_max=STEPS, save_trajectory=name == "time")
    if name == "arcl_summaries":
        changes.update(ray_param="arcl")
    jcfg, jparams, jv0, jst, jpwr = tp.jax_case(
        ds=2.5e-3 if name == "arcl_summaries" else None, **changes)
    cfg, params, v0, st, pwr = tp.to_port(jcfg, jparams, jv0, jst, jpwr)
    loss, res, grads = _run(cfg, params, v0, st, pwr, host_lib)
    weights = _weights(res)

    def jax_loss(p, v, w):
        out = jtrace.trace_batch(jcfg, p, v, jst, w)
        return sum(jnp.sum(t * c) for t, c in zip(out, weights) if c is not None)

    ref_loss, (gp, gv, gw) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2)))(
        jparams, jv0, jpwr)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-12)
    ref = [r for r in jax.tree_util.tree_leaves(gp) if np.issubdtype(r.dtype, np.floating)]
    ref += [gv, gw]
    assert len(grads) == len(ref)
    live = 0
    for i, (g, r) in enumerate(zip(grads, ref)):
        r = np.asarray(r)
        scale = np.abs(r).max() if r.size else 0.0
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=JAX_RTOL * scale, err_msg=str(i))
        live += bool(scale > 0)
    assert live >= 5
    assert int(res.npoints.max()) > STEPS // 2


def test_a_reused_loop_answers_each_params(host_lib):
    """Two forwards with other Params values through one kernel loop, then
    both backwards (each replays its own forward first): each gets the
    generic piece's gradients of its own Params."""
    cfg, params, v0, st, pwr = _case("time")
    other = params._replace(
        eq=params.eq._replace(bz0=params.eq.bz0 * 1.01, ln_scale=params.eq.ln_scale * 0.98),
        rf=params.rf._replace(k0=params.rf.k0 * 1.001))
    loop = _loop(cfg, _with_grad(params), v0, st, host_lib)
    runs = []
    for p in (params, other):
        pg = _with_grad(p)
        res = ga.trace_batch_static_adjoint(cfg, pg, v0, st, pwr, loop=loop)
        runs.append((pg, _weighted_loss(res)))
    got = [torch.autograd.grad(loss, tree_leaves(pg)) for pg, loss in runs]
    for p, g in zip((params, other), got):
        ref = _run(cfg, p, v0, st, pwr, None)[2]
        _assert_close(g, ref[:len(g)], GRAD_RTOL, "reused loop")
    assert any(not torch.equal(a, b) for a, b in zip(*got))


# --- the gate -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["slab", "slab_arcl", "slab_f32", "slab_damped", "slab_sg",
                                  "slab_compensated", "solovev", "slab_eq_grad"])
def test_gate(name):
    takes = name in ("slab", "slab_arcl", "slab_f32")
    text = {"slab_damped": tex.SLAB_ECH_DAMPED, "slab_sg": SLAB_SG,
            "solovev": tex.SOLOVEV_ECH_90GHZ,
            "slab_eq_grad": tex.SLAB_ECH_90GHZ.replace(EQ_GRAD, EQ_GRAD.replace("false", "true"))
            }.get(name, tex.SLAB_ECH_90GHZ)
    dtype = torch.float32 if name == "slab_f32" else torch.float64
    cfg, params, v0, st, pwr = tex.setup_example(text, device="cpu", dtype=dtype)
    cfg = dataclasses.replace(cfg, nstep_max=3, **{
        "slab_arcl": dict(ray_param="arcl"), "slab_compensated": dict(compensated_sum=True),
        "slab_sg": dict(sg_scan_substeps=2), "solovev": dict(sg_scan_substeps=3)
    }.get(name, {}))
    assert slab_vjp.takes(cfg, "cuda") == slab_vjp.takes(cfg, torch.device("cuda", 0)) == takes
    assert not slab_vjp.takes(cfg, "cpu")
    # on the CPU the piece is the generic one, and a run launches nothing
    before = slab_vjp.LAUNCHES
    p = _with_grad(params)
    loop = ga.StaticAdjoint(cfg, p, v0, st)
    assert loop.slab is None and loop.functions()["vjp"] == loop.vjp
    loss = _weighted_loss(ga.trace_batch_static_adjoint(cfg, p, v0, st, pwr, loop=loop))
    torch.autograd.grad(loss, [t for t in tree_leaves(p) if t.is_floating_point()])
    assert slab_vjp.LAUNCHES == before
    if not takes:
        with pytest.raises(ValueError, match="slab VJP"):
            slab_vjp.SlabVJP(None, loop)
