"""The adjoint of rays_tpu_torch (autograd through ``trace_batch``) against
``jax.grad`` of the same losses through the JAX package's scan.

* The training loss of ``__graft_entry__.py`` (the damped slab with
  trajectories on, the Ptotal_x deposition profile in 32 bins, loss
  sum |x_end|^2 P + sum profile^2), differentiated with respect to every
  floating Params leaf, v0 and pwr_wt.  60 steps of 1.3e-2 reach the
  resonance: one ray runs out of steps, two stop by total absorption.
  Bound: 1e-10 of each leaf's largest gradient (measured about 6e-15
  on the CPU).
* The README's adjoint (undamped, the endpoint's x against ln_scale),
  against jax.grad (1e-10) and a central difference (rtol 2e-4, the
  bound of tests/test_trace.py).
* Per-step rematerialization on and off give the same gradients, and
  trace_rays with a grad-carrying leaf is trace_batch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.post import deposition as jdep
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.post import deposition as tdep
from rays_tpu_torch.tracing import trace as ttrace

GRAD_RTOL = 1e-10
FD_RTOL = 2e-4
N_BINS = 32
GRAFT_STEPS, GRAFT_DS = 60, 1.3e-2


def _named_leaves(tree, prefix="params"):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for name, sub in zip(tree._fields, tree)
                for item in _named_leaves(sub, f"{prefix}.{name}")]
    return [(prefix, tree)]


def _with_grad(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


def _assert_grads_close(got, ref, what):
    """Leaf by leaf, within GRAD_RTOL of the leaf's largest JAX gradient
    (exactly zero where JAX's is)."""
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max() if ref.size else 0.0
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_RTOL * scale, err_msg=what)


@pytest.fixture(scope="module")
def graft_case():
    return tp.jax_case(jex.SLAB_ECH_DAMPED, ds=GRAFT_DS, nstep_max=GRAFT_STEPS,
                       save_trajectory=True)


def _jax_graft_loss(cfg, xmin, xmax):
    def loss(params, v0, pwr, st):
        res = jtrace.trace_batch(cfg, params, v0, st, pwr)
        prof = jdep.calculate_deposition_profile(cfg, params, res, "Ptotal_x",
                                                 n_bins=N_BINS, xmin=xmin, xmax=xmax)
        return (jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * pwr[:, None])
                + jnp.sum(prof.profile ** 2)), res.stop_flag
    return loss


def _torch_graft_loss(cfg, params, v0, st, pwr, xmin, xmax, tracer=ttrace.trace_batch):
    res = tracer(cfg, params, v0, st, pwr)
    prof = tdep.calculate_deposition_profile(cfg, params, res, "Ptotal_x", n_bins=N_BINS,
                                             xmin=xmin, xmax=xmax)
    return (res.end_ray_vec[:, 0:3] ** 2 * pwr[:, None]).sum() + (prof.profile ** 2).sum()


def test_graft_loss_gradients_match_jax(graft_case):
    cfg, params, v0, st, pwr = graft_case
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
    (jl, jflags), (gp, gv, gw) = jax.jit(jax.value_and_grad(
        _jax_graft_loss(cfg, xmin, xmax), argnums=(0, 1, 2), has_aux=True))(
            params, v0, pwr, st)
    assert {21, 31} <= set(np.asarray(jflags).tolist())   # absorbed and run out

    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    pp = _with_grad(pp)
    tv0.requires_grad_(True)
    tpw.requires_grad_(True)
    loss = _torch_graft_loss(pcfg, pp, tv0, tst, tpw, xmin, xmax)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-12)
    named = _named_leaves(pp)
    grads = torch.autograd.grad(loss, [t for _, t in named] + [tv0, tpw],
                                allow_unused=True, materialize_grads=True)
    ref = jax.tree_util.tree_leaves(gp) + [gv, gw]
    assert len(grads) == len(ref)
    for (name, _), g, r in zip(named + [("v0", None), ("pwr_wt", None)], grads, ref):
        _assert_grads_close(g, r, name)
    # the physics leaves that the damped slab reads carry gradient
    nonzero = {name for (name, _), g in zip(named, grads) if g.abs().max() > 0}
    assert {"params.species.ms", "params.species.t0s", "params.rf.omgrf",
            "params.eq.bz0", "params.ode.ds"} <= nonzero


@pytest.fixture(scope="module")
def readme_case():
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=40, save_trajectory=False)
    return cfg, params, v0, st, pwr


def _torch_readme_loss(cfg, pp, tv0, tst, tpw, ln_scale):
    p = pp._replace(eq=pp.eq._replace(ln_scale=ln_scale))
    return ttrace.trace_batch(cfg, p, tv0, tst, tpw).end_ray_vec[:, 0].sum()


def test_readme_adjoint_matches_jax_and_fd(readme_case):
    cfg, params, v0, st, pwr = readme_case

    def jloss(ln):
        p = params._replace(eq=params.eq._replace(ln_scale=ln))
        return jtrace.trace_batch(cfg, p, v0, st, pwr).end_ray_vec[:, 0].sum()

    jg = float(jax.jit(jax.grad(jloss))(params.eq.ln_scale))
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    ln = pp.eq.ln_scale.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_torch_readme_loss(pcfg, pp, tv0, tst, tpw, ln), ln)
    assert g.item() != 0.0
    np.testing.assert_allclose(g.item(), jg, rtol=GRAD_RTOL)
    eps = 1e-5
    with torch.no_grad():
        lp = _torch_readme_loss(pcfg, pp, tv0, tst, tpw, pp.eq.ln_scale + eps)
        lm = _torch_readme_loss(pcfg, pp, tv0, tst, tpw, pp.eq.ln_scale - eps)
    np.testing.assert_allclose(g.item(), (lp - lm).item() / (2 * eps), rtol=FD_RTOL)


def test_remat_on_and_off_give_equal_gradients(graft_case):
    cfg, params, v0, st, pwr = graft_case
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    grads = {}
    for remat in (True, False):
        p = _with_grad(pp)
        c = dataclasses.replace(pcfg, remat_steps=remat, nstep_max=30)
        loss = _torch_graft_loss(c, p, tv0, tst, tpw, xmin, xmax)
        grads[remat] = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                           materialize_grads=True)
    for a, b in zip(grads[True], grads[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14, atol=0)


def test_trace_rays_with_grad_is_trace_batch(graft_case):
    """The adjoint route of trace_rays: the same forward and gradients as
    trace_batch, and no grad path when grad mode is off."""
    cfg, params, v0, st, pwr = graft_case
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    pcfg = dataclasses.replace(pcfg, nstep_max=20)
    out = {}
    for tracer in (ttrace.trace_rays, ttrace.trace_batch):
        p = _with_grad(pp)
        loss = _torch_graft_loss(pcfg, p, tv0, tst, tpw, xmin, xmax, tracer=tracer)
        out[tracer] = (loss.detach(), torch.autograd.grad(
            loss, tree_leaves(p), allow_unused=True, materialize_grads=True))
    (la, ga), (lb, gb) = out[ttrace.trace_rays], out[ttrace.trace_batch]
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    with torch.no_grad():
        res = ttrace.trace_rays(pcfg, _with_grad(pp), tv0, tst, tpw)
    assert not res.end_ray_vec.requires_grad
