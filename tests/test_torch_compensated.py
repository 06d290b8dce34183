"""The compensated carry of rays_tpu_torch (``cfg.compensated_sum``,
tracing/compensated.py) against its own plain float32 run and against the
JAX package under the same mode, for RK4 and for the adaptive stepper, on
the slab example at float32 and 100 steps.

* Mechanics (after tests/test_precision.py:62-94): the state is bit for
  bit the plain float32 run's (TwoSum's primary sum is v + dv), npoints
  too; the carry is finite, nonzero and ulp-scale, under 100 x 1.2e-7 of
  each slot's end scale.
* Against JAX: the port's float32 end state under the mode within the
  float32 bounds of tests/test_precision.py (positions 1e-3, k 5e-4 of
  each ray's scale) of the JAX package's, and the resolved state v + c
  likewise; npoints and flags equal.
* Dispatch: the kernel has no carry, so its gate refuses the mode and
  ``route`` sends a compensated slab RK4 run on a CUDA device to the plain
  tracer; decided from the config and the device type, so no card is
  needed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.tracing import compensated as jcomp
from rays_tpu_torch import convert, examples as tex
from rays_tpu_torch.tracing import compensated, fused_slab
from rays_tpu_torch.tracing.trace import route, trace_batch, trace_rays

STEPS = 100
ULP_F32 = 1.2e-7
RTOL_X, RTOL_K = 1e-3, 5e-4
SOLVERS = ["RK4_ODE", "SG_ODE"]


def _text(solver):
    return jex.SLAB_ECH_90GHZ.replace("ode_solver_name='RK4_ODE'",
                                      f"ode_solver_name='{solver}'")


def _port_case(solver, **changes):
    cfg, params, v0, st, pwr = tex.setup_example(_text(solver), device="cpu",
                                                 dtype=torch.float32)
    cfg = dataclasses.replace(cfg, nstep_max=STEPS, save_trajectory=False, **changes)
    return cfg, params, v0, st, pwr


@pytest.mark.parametrize("solver", SOLVERS)
def test_carry_mechanics(solver):
    case = _port_case(solver)
    plain = trace_rays(*case)
    comp = trace_rays(dataclasses.replace(case[0], compensated_sum=True), *case[1:])
    assert plain.end_ray_comp is None
    assert torch.equal(comp.end_ray_vec, plain.end_ray_vec)
    assert torch.equal(comp.npoints, plain.npoints)
    assert torch.equal(comp.stop_flag, plain.stop_flag)
    assert comp.end_ray_comp.shape == comp.end_ray_vec.shape
    assert comp.end_ray_comp.dtype == torch.float32
    c = comp.end_ray_comp.double()
    v = comp.end_ray_vec.double()
    assert torch.isfinite(c).all()
    assert c.abs().max() > 0
    scale = v.abs().amax(dim=0) + 1e-300
    assert float((c.abs().amax(dim=0) / scale).max()) < 100 * ULP_F32
    r = compensated.resolved(comp.end_ray_vec, comp.end_ray_comp)
    assert r.dtype == torch.float64 and torch.equal(r, v + c)


def test_two_sum_add_is_exact():
    """t + e is the exact sum of v and dv: checked in float64 on float32
    operands of every magnitude order, against JAX's two_sum_add."""
    rng = np.random.default_rng(7)
    v = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    dv = (rng.standard_normal(4096) * 10.0 ** rng.integers(-12, 6, 4096)).astype(np.float32)
    c = np.zeros(4096, np.float32)
    t, e = compensated.two_sum_add(torch.from_numpy(v), torch.from_numpy(c), torch.from_numpy(dv))
    exact = v.astype(np.float64) + dv.astype(np.float64)
    np.testing.assert_array_equal(t.double().numpy() + e.double().numpy(), exact)
    jt, je = jcomp.two_sum_add(jnp.asarray(v), jnp.asarray(c), jnp.asarray(dv))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def _jax_f32(cfg, params, v0, st, pwr):
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
    return tp.jax_trace(cfg, cast(params), cast(v0), st, cast(pwr))


def _assert_f32_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    for sl, rtol in ((slice(0, 3), RTOL_X), (slice(3, 6), RTOL_K)):
        scale = np.maximum(np.abs(ref[:, sl]).max(axis=1, keepdims=True), 1e-12)
        err = np.abs(got[:, sl] - ref[:, sl]) / scale
        assert err.max() <= rtol, f"{what}: {err.max():.3e} > {rtol}"


@pytest.mark.parametrize("solver", SOLVERS)
def test_port_matches_jax_under_the_mode(solver):
    jcfg, jparams, jv0, jst, jpwr = tp.jax_case(_text(solver), nstep_max=STEPS,
                                                save_trajectory=False, compensated_sum=True)
    jres = _jax_f32(jcfg, jparams, jv0, jst, jpwr)
    pcfg, pp, tv0, tst, tpw = tp.to_port(jcfg, jparams, jv0, jst, jpwr, dtype=torch.float32)
    assert pcfg.compensated_sum
    res = trace_rays(pcfg, pp, tv0, tst, tpw)
    np.testing.assert_array_equal(res.npoints.numpy(), np.asarray(jres.npoints))
    np.testing.assert_array_equal(res.stop_flag.numpy(), np.asarray(jres.stop_flag))
    _assert_f32_close(res.end_ray_vec.numpy(), jres.end_ray_vec, "end_ray_vec")
    _assert_f32_close(compensated.resolved(res.end_ray_vec, res.end_ray_comp).numpy(),
                      np.asarray(jcomp.resolved(jres.end_ray_vec, jres.end_ray_comp)),
                      "resolved state")
    # the JAX results carried across keep their carry
    carried = convert.results_from_numpy(jax.tree_util.tree_map(np.asarray, jres),
                                         dtype=torch.float32)
    np.testing.assert_array_equal(carried.end_ray_comp.numpy(), np.asarray(jres.end_ray_comp))


def test_compensated_slab_takes_the_plain_route_on_cuda():
    """The kernel's gate refuses the carry: on the card the compensated
    slab takes the graphed tracer (its name is older than that route),
    on the CPU the plain one."""
    cfg, params, v0, st, pwr = tex.setup_example(device="cpu", dtype=torch.float32)
    comp = dataclasses.replace(cfg, compensated_sum=True)
    assert fused_slab.supported(cfg) and route(cfg, False, "cuda") == "kernel"
    assert not fused_slab.supported(comp)
    assert route(comp, False, "cuda") == route(comp, False, torch.device("cuda", 0)) == "graph"
    assert route(comp, False, "cpu") == "plain"
    # and the damped slab likewise
    dcfg = tex.setup_example(tex.SLAB_ECH_DAMPED, device="cpu")[0]
    assert route(dataclasses.replace(dcfg, compensated_sum=True), False, "cuda") == "graph"


def test_mode_under_gradients_and_trajectories():
    """The carry runs under autograd and with trajectories on: the rows
    and the end state are the plain run's, and a gradient flows."""
    cfg, params, v0, st, pwr = tex.setup_example(device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=20)
    comp = dataclasses.replace(cfg, compensated_sum=True)
    bz0 = params.eq.bz0.clone().requires_grad_(True)
    p = params._replace(eq=params.eq._replace(bz0=bz0))
    res = trace_batch(comp, p, v0, st, pwr)
    plain = trace_batch(cfg, params, v0, st, pwr)
    assert torch.equal(res.ray_vec.detach(), plain.ray_vec)
    g, = torch.autograd.grad(res.end_ray_vec[:, 0].sum(), bz0)
    assert torch.isfinite(g) and g != 0
