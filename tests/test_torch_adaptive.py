"""rays_tpu_torch's adaptive stepper (SG_ODE -> DP5(4), tracing/rk45.py)
against the JAX package: one trial step, one outer step with all its
outputs, whole traces on the slab and on the Solovev fan, the mirrors of
tests/test_adaptive.py (h carried, lockstep equals solo, both
ODE_TOTAL_ERROR exits), the fixed-budget form and its adjoint against
``jax.grad`` and central differences, the RHS options (the
equilibrium-gradient slots, the autodiff derivatives) and the dispatch.

Tolerances: 1e-12 on one step (rounding order only); 1e-9 of trajectory
scale on traces with equal npoints and flags.  No case here sits within
rounding of an accept/reject decision (err_ratio == 1), so the substep
sequences of the two packages are the same and nothing is held at the
looser requested tolerance.  Each JAX tracer is compiled once per file."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.rayinit import vector as jvector
from rays_tpu.tracing import rhs as jrhs, rk45 as jrk45, trace as jtrace
from rays_tpu_torch import examples as tex
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.rayinit import vector as tvector
from rays_tpu_torch.tracing import fused_slab, rhs as trhs, rk45 as trk45, trace as ttrace
from rays_tpu_torch.tracing.stop import StopCode

STEP_RTOL = 1e-12
TRAJ_RTOL = 1e-9
F64 = torch.float64

SLAB_SG = jex.SLAB_ECH_90GHZ.replace("ode_solver_name='RK4_ODE'", "ode_solver_name='SG_ODE'")
# eight times the example's ds: the controller has to subdivide
# (tests/test_adaptive.py::test_sg_solovev_tolerance_ladder)
SOLOVEV_COARSE = jex.SOLOVEV_ECH_90GHZ.replace("ds=2.e-3", "ds=1.6e-2")


def close(got, ref, what="", rtol=STEP_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-14 * max(np.abs(ref).max(), 1e-300), err_msg=what)


def _with_tol(params, rel):
    """params with rel_err = abs_err = rel, JAX or the port's."""
    like = params.ode.rel_err
    val = jnp.float64(rel) if isinstance(like, jax.Array) else torch.tensor(rel, dtype=F64)
    return params._replace(ode=params.ode._replace(rel_err=val, abs_err=val))


@functools.lru_cache(maxsize=None)
def _jax_tracer(cfg):
    """One compiled JAX tracer per config; params are traced arguments."""
    return jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))


def _jax_trace(cfg, params, v0, st, pwr):
    res = _jax_tracer(cfg)(params, v0, st, pwr)
    return jax.tree_util.tree_map(np.asarray, jax.block_until_ready(res))


def _assert_traces_match(got, ref):
    np.testing.assert_array_equal(got.npoints.numpy(), ref.npoints)
    np.testing.assert_array_equal(got.stop_flag.numpy(), ref.stop_flag)
    assert got.ray_vec.shape == ref.ray_vec.shape
    tp.assert_scaled_close(got.ray_vec, ref.ray_vec, TRAJ_RTOL, axis=1, what="trajectory")
    for i, n in enumerate(ref.npoints):
        assert not got.ray_vec[i, n:].any()
    np.testing.assert_allclose(got.residual.numpy(), ref.residual, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.max_residuals.numpy(), ref.max_residuals,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.end_residuals.numpy(), ref.end_residuals,
                               rtol=1e-6, atol=1e-12)


@pytest.fixture(scope="module")
def slab():
    """The slab example under SG_ODE, 40 outer steps, in both packages."""
    cfg, params, v0, st, pwr = tp.jax_case(SLAB_SG, nstep_max=40)
    return (cfg, params, v0, st, pwr), tp.to_port(cfg, params, v0, st, pwr)


@pytest.fixture(scope="module")
def solovev_coarse():
    cfg, params, v0, st, pwr = tp.jax_case(SOLOVEV_COARSE, nstep_max=20)
    return (cfg, params, v0, st, pwr), tp.to_port(cfg, params, v0, st, pwr)


def _step_inputs(v0, ds, seed):
    """Per-ray trial step sizes and carried step sizes around ds."""
    rng = np.random.default_rng(seed)
    return ds * rng.uniform(0.2, 1.0, v0.shape[0]), ds * rng.uniform(0.3, 4.0, v0.shape[0])


@pytest.mark.parametrize("which", ["slab", "solovev"])
def test_dopri_step_matches_jax(which, slab, solovev_coarse):
    """One trial DP5 step from the launch points with a different h per
    ray: the 5th-order state, its increment, the error vector, the
    statuses, the FSAL stage and the endpoint check."""
    (cfg, params, v0, *_), (pcfg, pp, tv0, *_) = slab if which == "slab" else solovev_coarse
    h, _ = _step_inputs(v0, float(params.ode.ds), 3)

    def one(v, hh):
        f = lambda ss, vv: jrhs.eqn_ray(cfg, params, ss, vv)
        fc = lambda ss, vv: jrhs.eqn_ray_and_check(cfg, params, ss, vv)
        k1, st1 = f(0.0, v)
        return jrk45._dopri_step(f, fc, jnp.float64(0.0), v, hh, k1, st1)

    ref = jax.jit(jax.vmap(one))(v0, jnp.asarray(h))
    t0 = torch.zeros(tv0.shape[0], dtype=F64)
    k1, st1 = trhs.eqn_ray(pcfg, pp, t0, tv0)
    got = trk45._dopri_step(lambda ss, vv: trhs.eqn_ray(pcfg, pp, ss, vv),
                            lambda ss, vv: trhs.eqn_ray_and_check(pcfg, pp, ss, vv),
                            t0, tv0, torch.from_numpy(h), k1, st1)
    names = ("v5", "dv5", "err", "status", "k7", "k7_status", "resid", "check_status")
    for g, r, name in zip(got, ref, names):
        if name == "err":
            # a sum that cancels from the size of dv5 down to about h^5:
            # its rounding floor is that of dv5
            floor = 1e-14 * np.abs(np.asarray(ref[1])).max(axis=0)
            assert np.all(np.abs(g.numpy() - np.asarray(r))
                          <= STEP_RTOL * np.abs(np.asarray(r)) + floor), name
        elif name == "resid":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-12)
        else:
            close(g, r, what=name)


@pytest.mark.parametrize("which,rel", [("slab", 1e-4), ("slab", 1e-10), ("solovev", 1e-5),
                                       ("solovev", 1e-7)])
def test_rk45_step_carried_full_matches_jax(which, rel, slab, solovev_coarse):
    """One outer step from the launch points, each ray with its own carried
    h0: all seven outputs.  h_next comes from err_ratio^(-1/5), and the
    error estimate is a cancellation whose own relative accuracy is about
    1e-16 |dv| / |err|; so h_next is held to 1e-12 where the factor is
    clipped and to 1e-6 where it is not."""
    (cfg, params, v0, *_), (pcfg, pp, tv0, *_) = slab if which == "slab" else solovev_coarse
    params, pp = _with_tol(params, rel), _with_tol(pp, rel)
    ds = float(params.ode.ds)
    _, h0 = _step_inputs(v0, ds, 5)

    def one(v, hh):
        f1, st1 = jrhs.eqn_ray(cfg, params, 0.0, v)
        return jrk45.rk45_step_carried_full(cfg, params, jnp.float64(0.0), v, hh, f1, st1)

    ref = jax.jit(jax.vmap(one))(v0, jnp.asarray(h0))
    s0 = torch.zeros((), dtype=F64)
    f1, st1 = trhs.eqn_ray(pcfg, pp, s0, tv0)
    trk45.stats = trk45.SubstepStats()
    try:
        got = trk45.rk45_step_carried_full(pcfg, pp, s0, tv0, torch.from_numpy(h0), f1, st1)
        loops, reads, attempts, rejected = trk45.stats.totals()
    finally:
        trk45.stats = None
    assert reads == loops + 1 and attempts >= tv0.shape[0] and rejected <= attempts
    if which == "solovev":
        assert attempts > tv0.shape[0]        # the controller subdivided
    names = ("v_new", "status", "h_next", "f_end", "f_end_status", "resid", "check_status")
    for g, r, name in zip(got, ref, names):
        if name == "resid":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-12)
        elif name == "h_next":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
        else:
            close(g, r, what=name)
    assert np.asarray(ref[1]).tolist() == [0] * v0.shape[0]
    # the three-output forms are the same step
    short = trk45.rk45_step(pcfg, pp, s0, tv0, torch.from_numpy(h0))
    for g, r in zip(short, got[:3]):
        assert torch.equal(g, r)
    step = ttrace.get_step_fn(pcfg)(pcfg, pp, s0, tv0, torch.from_numpy(h0))
    carried = ttrace.get_carried_step_fn(pcfg)(pcfg, pp, s0, tv0, torch.from_numpy(h0), f1, st1)
    for a, b, c in zip(step, carried, got[:3]):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.parametrize("rel", [1e-4, 1e-7])
def test_trace_slab_sg_matches_jax(rel, slab):
    (cfg, params, v0, st, pwr), (pcfg, pp, tv0, tst, tpw) = slab
    ref = _jax_trace(cfg, _with_tol(params, rel), v0, st, pwr)
    assert ref.npoints.tolist() == [41] * 3
    _assert_traces_match(ttrace.trace_batch(pcfg, _with_tol(pp, rel), tv0, tst, tpw), ref)


def test_trace_solovev_example_matches_jax():
    """The whole example, as shipped: 5 rays, 200 outer steps, tol 1e-7."""
    cfg, params, v0, st, pwr = tp.jax_case(jex.SOLOVEV_ECH_90GHZ)
    assert cfg.ode_solver_name == "SG_ODE" and cfg.nstep_max == 200
    ref = _jax_trace(cfg, params, v0, st, pwr)
    tcfg, tparams, tv0, tst, tpw = tex.setup_example(tex.SOLOVEV_ECH_90GHZ, device="cpu")
    got = ttrace.trace_rays(tcfg, tparams, tv0, tst, tpw)
    assert got.npoints.tolist() == [201] * 5
    assert got.stop_flag.tolist() == [int(StopCode.NSTEP_MAX)] * 5
    assert float(got.max_residuals.max()) < 1e-5
    _assert_traces_match(got, ref)


def test_trace_solovev_coarse_matches_jax(solovev_coarse):
    """The fan at 8 ds, where every outer step takes several substeps."""
    (cfg, params, v0, st, pwr), (pcfg, pp, tv0, tst, tpw) = solovev_coarse
    ref = _jax_trace(cfg, params, v0, st, pwr)
    trk45.stats = trk45.SubstepStats()
    try:
        got = ttrace.trace_batch(pcfg, pp, tv0, tst, tpw)
        loops, _, attempts, _ = trk45.stats.totals()
    finally:
        trk45.stats = None
    assert loops > cfg.nstep_max and attempts > cfg.nstep_max * tv0.shape[0]
    _assert_traces_match(got, ref)


def test_trace_nosave_and_stops_match_jax(slab):
    """Summaries only, a ray that never starts and a ray parameter limit."""
    (cfg, params, v0, st, pwr), (pcfg, pp, tv0, tst, tpw) = slab
    cfg = dataclasses.replace(cfg, save_trajectory=False)
    pcfg = dataclasses.replace(pcfg, save_trajectory=False)
    st = np.asarray(st).copy()
    st[1] = int(StopCode.DID_NOT_START)
    s_max = 20.5 * float(params.ode.ds)
    params = params._replace(ode=params.ode._replace(s_max=jnp.float64(s_max)))
    pp = pp._replace(ode=pp.ode._replace(s_max=torch.tensor(s_max, dtype=F64)))
    ref = _jax_trace(cfg, params, v0, st, pwr)
    got = ttrace.trace_batch(pcfg, pp, tv0, torch.from_numpy(st), tpw)
    assert ref.npoints.tolist() == [21, 1, 21]
    np.testing.assert_array_equal(got.npoints.numpy(), ref.npoints)
    np.testing.assert_array_equal(got.stop_flag.numpy(), ref.stop_flag)
    assert got.ray_vec.shape == ref.ray_vec.shape == (3, 1, 7)
    tp.assert_scaled_close(got.end_ray_vec, ref.end_ray_vec, TRAJ_RTOL, axis=-1, what="end")


def test_h_carries_across_outer_steps(slab):
    """The converged substep h persists to the next outer step
    (tests/test_adaptive.py::test_h_carries_across_outer_steps)."""
    _, (pcfg, pp, tv0, *_) = slab
    pp = _with_tol(pp, 1e-10)
    ds = pp.ode.ds
    v = tv0[0:1]
    s0 = torch.zeros((), dtype=F64)
    v1, st1, h1 = trk45.rk45_step(pcfg, pp, s0, v, ds.expand(1))
    assert st1.tolist() == [0]
    # the controller moved h away from the seed
    assert abs(float(h1) - float(ds)) > 0.5 * float(ds)
    v2_carry, st2, _ = trk45.rk45_step(pcfg, pp, s0 + ds, v1, h1)
    v2_fresh, _, _ = trk45.rk45_step(pcfg, pp, s0 + ds, v1, ds.expand(1))
    assert st2.tolist() == [0]
    np.testing.assert_allclose(v2_carry[:, :6].numpy(), v2_fresh[:, :6].numpy(), rtol=1e-9)
    # an unachievable tolerance forces subdivision: h shrinks below ds
    _, _, h_tight = trk45.rk45_step(pcfg, _with_tol(pp, 1e-16), s0, v, ds.expand(1))
    assert float(h_tight) < float(ds)
    # and the tracer carries it: the traced end state equals the steps above
    res = ttrace.trace_batch(dataclasses.replace(pcfg, nstep_max=2), pp, v,
                             torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=F64))
    assert torch.equal(res.end_ray_vec, v2_carry)


def test_lockstep_equals_solo(solovev_coarse):
    """Every ray of a heterogeneous batch gets the result it gets alone:
    a ray that is done keeps its whole carry while the others go on
    (tests/test_adaptive.py::test_vmap_lockstep_equals_solo, atol 1e-13)."""
    _, (pcfg, pp, tv0, tst, tpw) = solovev_coarse
    trk45.stats = trk45.SubstepStats()
    try:
        batch = ttrace.trace_batch(pcfg, pp, tv0, tst, tpw)
        batch_loops = trk45.stats.loops
        solo_loops = []
        for i in range(tv0.shape[0]):
            trk45.stats.reset()
            solo = ttrace.trace_batch(pcfg, pp, tv0[i:i + 1], tst[i:i + 1], tpw[i:i + 1])
            solo_loops.append(trk45.stats.loops)
            assert solo.npoints[0] == batch.npoints[i]
            np.testing.assert_allclose(solo.ray_vec[0].numpy(), batch.ray_vec[i].numpy(),
                                       rtol=0, atol=1e-13)
    finally:
        trk45.stats = None
    # the rays do not all need the same number of substeps
    assert len(set(solo_loops)) > 1 and batch_loops >= max(solo_loops)


def test_ode_total_error_on_h_underflow(slab):
    """Unachievable tolerance: h shrinks to its floor, ODE_TOTAL_ERROR, and
    the failed step is not recorded; as the JAX package."""
    (cfg, params, v0, st, pwr), (pcfg, pp, tv0, tst, tpw) = slab
    ref = _jax_trace(cfg, _with_tol(params, 1e-30), v0, st, pwr)
    got = ttrace.trace_batch(pcfg, _with_tol(pp, 1e-30), tv0, tst, tpw)
    assert got.stop_flag.tolist() == [int(StopCode.ODE_TOTAL_ERROR)] * 3
    assert got.npoints.tolist() == [1] * 3
    np.testing.assert_array_equal(got.stop_flag.numpy(), ref.stop_flag)
    np.testing.assert_array_equal(got.npoints.numpy(), ref.npoints)
    assert torch.equal(got.end_ray_vec, tv0)


def test_ode_total_error_on_substep_exhaustion(slab):
    """rel 1e-18 is below the rounding floor, so every substep rejects and h
    decays 0.2x per try; 4 tries cannot reach h_min, so the loop dies on the
    budget: the other exit."""
    _, (pcfg, pp, tv0, tst, tpw) = slab
    pcfg = dataclasses.replace(pcfg, max_substeps=4, nstep_max=10)
    trk45.stats = trk45.SubstepStats()
    try:
        got = ttrace.trace_batch(pcfg, _with_tol(pp, 1e-18), tv0, tst, tpw)
        loops, _, attempts, rejected = trk45.stats.totals()
    finally:
        trk45.stats = None
    assert got.stop_flag.tolist() == [int(StopCode.ODE_TOTAL_ERROR)] * 3
    assert got.npoints.tolist() == [1] * 3
    assert (loops, attempts) == (4, 12) and rejected > 0     # later outer steps take none


@pytest.mark.parametrize("which", ["slab", "solovev"])
def test_sg_scan_substeps_equals_loop(which, slab, solovev_coarse):
    """The fixed budget of masked substeps gives the loop's result where
    the budget suffices (atol 1e-13 on the end state, as
    tests/test_adaptive.py::test_sg_scan_substeps_equals_while_loop), and
    ODE_TOTAL_ERROR where it does not."""
    _, (pcfg, pp, tv0, tst, tpw) = slab if which == "slab" else solovev_coarse
    budget = 2 if which == "slab" else 32     # one outer step needs 25
    loop = ttrace.trace_batch(pcfg, pp, tv0, tst, tpw)
    scan = ttrace.trace_batch(dataclasses.replace(pcfg, sg_scan_substeps=budget),
                              pp, tv0, tst, tpw)
    assert torch.equal(loop.npoints, scan.npoints) and torch.equal(loop.stop_flag, scan.stop_flag)
    assert scan.npoints.tolist() == [pcfg.nstep_max + 1] * tv0.shape[0]
    np.testing.assert_allclose(scan.end_ray_vec.numpy(), loop.end_ray_vec.numpy(),
                               rtol=0, atol=1e-13)
    if which == "solovev":
        short = ttrace.trace_batch(dataclasses.replace(pcfg, sg_scan_substeps=1),
                                   pp, tv0, tst, tpw)
        assert int(StopCode.ODE_TOTAL_ERROR) in short.stop_flag.tolist()


ADJ_STEPS = 8


def _adjoint_case():
    cfg, params, v0, st, pwr = tp.jax_case(SLAB_SG, nstep_max=ADJ_STEPS, sg_scan_substeps=2,
                                           save_trajectory=False)
    return cfg, _with_tol(params, 1e-6), v0, st, pwr


def _port_loss(pcfg, pp, tv0, tst, tpw):
    r = ttrace.trace_rays(pcfg, pp, tv0, tst, tpw)
    return (r.end_ray_vec[:, 0:3] ** 2 * tpw[:, None]).sum(), r


def test_sg_adjoint_matches_jax_grad():
    """Gradients of the training loss of bench.py's SG step through the
    fixed-budget form, every Params leaf against jax.grad (rtol 1e-7; the
    controller is cut out of both backward passes)."""
    cfg, params, v0, st, pwr = _adjoint_case()

    def jloss(p):
        r = jtrace.trace_batch(cfg, p, v0, st, pwr)
        return jnp.sum(r.end_ray_vec[:, 0:3] ** 2 * pwr[:, None])

    ref_loss, ref = jax.jit(jax.value_and_grad(jloss))(params)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    pg = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    loss, res = _port_loss(pcfg, pg, tv0, tst, tpw)
    assert res.npoints.tolist() == [ADJ_STEPS + 1] * 3
    close(loss, ref_loss, what="loss")
    grads = torch.autograd.grad(loss, tree_leaves(pg), allow_unused=True, materialize_grads=True)
    names = [f"{g}.{f}" for g, sub in zip(pp._fields, pp) for f in sub._fields]
    live = 0
    for name, g, r in zip(names, grads, jax.tree_util.tree_leaves(ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-7,
                                   atol=1e-12 * max(np.abs(r).max(), 1e-300), err_msg=name)
        live += bool(np.abs(r).max() > 0)
    assert live >= 8
    # the controller receives no gradient: the tolerances steer only h
    by_name = dict(zip(names, grads))
    for name in ("ode.rel_err", "ode.abs_err", "limits.sg_error_limit"):
        assert not by_name[name].any(), name


def test_sg_adjoint_matches_finite_differences():
    """The adjoint of the frozen substep sequence against central
    differences of the full primal, controller included (rel 2e-5, the bar
    of tests/test_adaptive.py::test_sg_adjoint_matches_finite_differences)."""
    cfg, params, v0, st, pwr = _adjoint_case()
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    pg = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    loss, _ = _port_loss(pcfg, pg, tv0, tst, tpw)
    leaves = {"rf.omgrf": pg.rf.omgrf, "eq.bz0": pg.eq.bz0, "species.n_ref": pg.species.n_ref,
              "eq.ln_scale": pg.eq.ln_scale}
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                 allow_unused=True, materialize_grads=True)))
    checked = 0
    for name, g in grads.items():
        group, field = name.split(".")
        base = float(getattr(getattr(pp, group), field))
        eps = max(abs(base), 1.0) * 1e-6

        def at(val):
            sub = getattr(pp, group)._replace(**{field: torch.tensor(val, dtype=F64)})
            with torch.no_grad():
                return float(_port_loss(pcfg, pp._replace(**{group: sub}), tv0, tst, tpw)[0])

        fd = (at(base + eps) - at(base - eps)) / (2 * eps)
        assert float(g) == pytest.approx(fd, rel=2e-5, abs=1e-12), f"{name}: {float(g)} {fd}"
        checked += abs(fd) > 0
    assert checked >= 2


def test_gradients_need_sg_scan_substeps(slab):
    _, (pcfg, pp, tv0, tst, tpw) = slab
    assert pcfg.sg_scan_substeps == 0
    pg = pp._replace(rf=pp.rf._replace(omgrf=pp.rf.omgrf.clone().requires_grad_(True)))
    with pytest.raises(ValueError, match="sg_scan_substeps"):
        ttrace.trace_rays(pcfg, pg, tv0, tst, tpw)
    with pytest.raises(ValueError, match="sg_scan_substeps"):
        ttrace.trace_batch(pcfg, pp, tv0.clone().requires_grad_(True), tst, tpw)
    with torch.no_grad():     # no gradients asked: the loop runs
        assert ttrace.trace_rays(pcfg, pg, tv0, tst, tpw).npoints.tolist() == [41] * 3


# --- the RHS options ------------------------------------------------------


@pytest.mark.parametrize("text,damped", [(jex.SLAB_ECH_90GHZ, False), (jex.SLAB_ECH_DAMPED, True),
                                         (jex.SOLOVEV_ECH_90GHZ, False)],
                         ids=["slab", "slab_damped", "solovev"])
def test_eq_gradient_slots_match_jax(text, damped):
    """integrate_eq_gradients: the five trailing slots of the initial
    vector and of the RHS (d/ds of B, ne, Te along the ray)."""
    text = text.replace("integrate_eq_gradients=.false.", "integrate_eq_gradients=.true.")
    cfg, params, v0, st, pwr = tp.jax_case(text)
    pcfg, pp, tv0, *_ = tp.to_port(cfg, params, v0, st, pwr)
    assert pcfg.integrate_eq_gradients and pcfg.grad_diag_slot == cfg.grad_diag_slot
    assert pcfg.nv == cfg.nv == v0.shape[1] == (7 + 5 + (3 if damped else 0))
    # the port's own initial vector from the same launch points
    rvec0, rindex0 = tv0[:, 0:3], tv0[:, 3:6] / pp.rf.k0
    mine = tvector.initial_ode_vectors(pcfg, pp, rvec0, rindex0)
    ref0 = jvector.initial_ode_vectors(cfg, params, jnp.asarray(v0)[:, 0:3],
                                       jnp.asarray(rindex0.numpy()))
    close(mine, ref0, what="initial vector")
    g = pcfg.grad_diag_slot
    assert mine[:, g:g + 3].abs().amax(dim=1).amin() > 0 and mine[:, g + 3].amin() > 0
    for ray_param in ("arcl", "time"):
        jc = dataclasses.replace(cfg, ray_param=ray_param)
        pc = dataclasses.replace(pcfg, ray_param=ray_param)
        ref = jax.vmap(lambda vv: jrhs.eqn_ray(jc, params, 0.0, vv))(jnp.asarray(v0))
        got = trhs.eqn_ray(pc, pp, 0.0, tv0)
        close(got[0], ref[0], what=f"dvds {ray_param}")
        close(got[1], ref[1], what="status")
        assert got[0][:, g:g + 5].abs().amax() > 0


def test_eq_gradient_slots_integrate_the_fields():
    """What the slots are for: along a trace the integrated gradients stay
    on the local B, ne and Te (the fixed-step error is of order ds^4)."""
    text = jex.SOLOVEV_ECH_90GHZ.replace("integrate_eq_gradients=.false.",
                                         "integrate_eq_gradients=.true.")
    cfg, params, v0, st, pwr = tex.setup_example(text, device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=40)
    res = ttrace.trace_rays(cfg, params, v0, st, pwr)
    assert res.npoints.tolist() == [41] * 5
    from rays_tpu_torch.models import base

    eq = base.equilibrium(cfg, params, res.end_ray_vec[:, 0:3])
    g = cfg.grad_diag_slot
    local = torch.cat([eq.bvec, eq.ns[:, 0:1], eq.ts[:, 0:1]], dim=1)
    moved = (res.end_ray_vec[:, g:g + 5] - v0[:, g:g + 5]).abs()
    assert (moved[:, 0:4].amax(dim=0) > 1e-4 * local[:, 0:4].abs().amax(dim=0)).all()
    np.testing.assert_allclose(res.end_ray_vec[:, g:g + 5].numpy(), local.numpy(), rtol=1e-6)


@pytest.mark.parametrize("text", [jex.SLAB_ECH_90GHZ, jex.SLAB_ECH_DAMPED,
                                  jex.SOLOVEV_ECH_90GHZ], ids=["slab", "slab_damped", "solovev"])
@pytest.mark.parametrize("ray_param", ["arcl", "time"])
def test_autodiff_derivatives_match_deriv_cold(text, ray_param):
    """ray_deriv_name='autodiff' (torch.func.grad of dispersion_D) against
    the closed-form chain rule, rtol 1e-8.  The JAX package's autodiff path
    reads an undefined name and raises NameError, so the port is held to
    deriv_cold, in both packages."""
    cfg, params, v0, st, pwr = tp.jax_case(text, ray_param=ray_param)
    pcfg, pp, tv0, *_ = tp.to_port(cfg, params, v0, st, pwr)
    # off the launch points too, where nothing is special
    rng = np.random.default_rng(4)
    tv = tv0.clone()
    tv[:, 0:3] += torch.from_numpy(rng.uniform(-0.01, 0.01, (tv.shape[0], 3)))
    tv[:, 3:6] *= torch.from_numpy(rng.uniform(0.9, 1.1, (tv.shape[0], 3)))
    cold = trhs.eqn_ray_and_check(pcfg, pp, 0.0, tv)
    auto = trhs.eqn_ray_and_check(dataclasses.replace(pcfg, ray_deriv_name="autodiff"),
                                  pp, 0.0, tv)
    np.testing.assert_allclose(auto[0].numpy(), cold[0].numpy(), rtol=1e-8,
                               atol=1e-14 * float(cold[0].abs().max()))
    for a, c in zip(auto[1:], cold[1:]):
        assert torch.equal(a, c)
    ref = jax.vmap(lambda vv: jrhs.eqn_ray(cfg, params, 0.0, vv))(jnp.asarray(tv.numpy()))
    np.testing.assert_allclose(auto[0].numpy(), np.asarray(ref[0]), rtol=1e-8,
                               atol=1e-14 * float(cold[0].abs().max()))
    with pytest.raises(NameError):
        jrhs.eqn_ray(dataclasses.replace(cfg, ray_deriv_name="autodiff"), params, 0.0,
                     jnp.asarray(tv.numpy())[0])


def test_autodiff_trace_and_its_gradient():
    """A whole trace on the autodiff derivatives stays on the cold trace,
    and differentiates (the second derivative through torch.func.grad)."""
    cfg, params, v0, st, pwr = tex.setup_example(tex.SLAB_ECH_90GHZ, device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=10)
    auto_cfg = dataclasses.replace(cfg, ray_deriv_name="autodiff")
    cold = ttrace.trace_rays(cfg, params, v0, st, pwr)
    auto = ttrace.trace_rays(auto_cfg, params, v0, st, pwr)
    assert torch.equal(cold.npoints, auto.npoints)
    tp.assert_scaled_close(auto.ray_vec, cold.ray_vec.numpy(), 1e-9, axis=1, what="autodiff")
    grads = []
    for c in (cfg, auto_cfg):
        pg = params._replace(eq=params.eq._replace(bz0=params.eq.bz0.clone().requires_grad_(True)))
        loss = (ttrace.trace_rays(c, pg, v0, st, pwr).end_ray_vec[:, 0:3] ** 2).sum()
        grads.append(float(torch.autograd.grad(loss, pg.eq.bz0)[0]))
    assert grads[0] != 0 and grads[1] == pytest.approx(grads[0], rel=1e-7)


# --- the dispatch ---------------------------------------------------------


@pytest.mark.parametrize("name,on_cuda", [("SLAB_ECH_90GHZ", "kernel"),
                                          ("SLAB_ECH_DAMPED", "kernel"),
                                          ("SOLOVEV_ECH_90GHZ", "graph")])
def test_route_of_every_example(name, on_cuda):
    """Every example on both devices, with and without gradients; the
    choice is made from the config alone."""
    cfg, *_ = tex.setup_example(getattr(tex, name), device="cpu")
    assert ttrace.route(cfg, False, "cuda") == on_cuda
    assert fused_slab.supported(cfg) == (on_cuda == "kernel")
    # reverse-mode gradients take the graphed adjoint (Solovev's SG loop
    # form stays plain: it has no reverse rule)
    assert ttrace.route(cfg, True, "cuda") == ("plain" if cfg.ode_solver_name == "SG_ODE"
                                               else "adjoint")
    for grad in (False, True):
        assert ttrace.route(cfg, grad, "cpu") == ttrace.route(cfg, grad, torch.device("cpu")) \
            == "plain"
    # off the kernel's gate the slab takes the graph route on the card
    for change in (dict(ode_solver_name="SG_ODE"), dict(integrate_eq_gradients=True),
                   dict(ray_deriv_name="autodiff")):
        assert ttrace.route(dataclasses.replace(cfg, **change), False, "cuda") == "graph"
    # the spline geometries have no kernel: the graph on the card, plain on
    # the CPU; a model the port does not know raises on every device
    for dev in ("cpu", "cuda"):
        for model in ("axisym_toroid", "multiple_mirror"):
            spline = dataclasses.replace(cfg, equilib_model=model)
            assert ttrace.route(spline, False, dev) == ("graph" if dev == "cuda" else "plain")
            assert not fused_slab.supported(spline)
        with pytest.raises(NotImplementedError, match="stellarator"):
            ttrace.route(dataclasses.replace(cfg, equilib_model="stellarator"), False, dev)
        with pytest.raises(ValueError, match="invalid ode solver"):
            ttrace.route(dataclasses.replace(cfg, ode_solver_name="EULER"), False, dev)
    with pytest.raises(ValueError, match="unsupported device"):
        ttrace.route(cfg, False, "meta")
