"""The slab step kernel (csrc/slab_rk4_step.cuh, tracing/slab_vjp.py) on
the CPU: the kernel body built by g++ (csrc/slab_rk4_vjp_host.cpp) as the
adjoint graph's "step" piece, held to the generic piece it replaces on the
card (``StaticAdjoint.step``: the carry into the stack, then
``trace.step``), which is its plain version, and to the slab kernel (B1,
csrc/slab_rk4.cuh), whose arithmetic it runs.

Held:

* one step k through the pieces, from the same carry, where every ray
  steps, where some have stopped and at the last step: npoints and the
  stop codes equal, the float carry within the slab kernel's tolerances
  of tests/test_torch_fused.py, and bit for bit what did no arithmetic:
  the stack row written at k, and the carry and trajectory row of the
  rays that did not step;
* whole runs through ``trace_batch_static_adjoint`` with both kernel
  pieces, on every case of tests/test_torch_slab_vjp.py (stops at the x
  bound, at s_max and before the start, one and two species, every
  profile model of the slab kernel, time and arc length, with and
  without trajectories): npoints, stop codes, end states and residuals
  bit for bit those of the slab kernel's host build on the same deck
  (``fused_slab.run_library``: B1's loop and the step kernel do the same
  operations in the same order), the trajectories within its tolerances;
  the loss and the
  gradient of every floating Params leaf, v0 and pwr_wt against the
  generic pieces within GRAD_RTOL of each gradient's scale (float64; in
  float32 as tests/test_torch_slab_vjp.py holds the VJP kernel).

The JAX comparison of a whole run with both kernel pieces is a case of
tests/test_torch_slab_vjp.py::test_whole_run_matches_jax_grad; the gate,
of its test_gate; the host-read audit of the kernel's piece, of
tests/test_torch_graphed_adjoint.py::test_vjp_piece_reads_nothing_on_the_host.
"""

import shutil

import numpy as np
import pytest
import torch

import _torch_parity as tp
from rays_tpu_torch.core.types import tree_leaves
from rays_tpu_torch.tracing import fused_slab, slab_vjp, trace as ttrace
from test_torch_kernel_host import RTOL as SLAB_RTOL, _compare
from test_torch_slab_vjp import (F32_FACTOR, F32_FLOOR, GRAD_RTOL, N_RAYS, RUNS, _assert_close,
                                 _case, _loop, _run)


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the slab step needs it")
    return slab_vjp.load_host_library()


@pytest.fixture(scope="module")
def slab_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the slab kernel needs it")
    return fused_slab.load_host_libraries()[0]


def _forwarded(lib, name):
    """A generic StaticAdjoint that has run one forward of the case, and a
    kernel one (both kernel pieces on ``lib``) of the same shapes."""
    cfg, params, v0, st, pwr = _case(name)
    generic, kernel = _loop(cfg, params, v0, st, None), _loop(cfg, params, v0, st, lib, True)
    carry = ttrace.initial_carry(cfg, params, v0, st)
    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    generic.forward(carry, leaves)
    kernel.load_inputs(carry, leaves)
    return generic, kernel


@pytest.mark.parametrize("where", ["all_live", "some_stopped", "last"])
def test_one_step_matches_generic_step(host_lib, where):
    """Step k of both pieces from the carry the generic forward had before
    it (its stack row k)."""
    generic, kernel = _forwarded(host_lib, "x_bounds" if where == "some_stopped" else "time")
    n = generic.cfg.nstep_max
    nstep = torch.cat([generic.stack[5], generic.carry[5][None]])    # (n + 1, B)
    if where == "last":
        k = n - 1
    else:
        steps = (nstep[1:] - nstep[:-1]).sum(1)
        live = steps == N_RAYS if where != "some_stopped" else (steps > 0) & (steps < N_RAYS)
        k = int(torch.nonzero(live)[len(torch.nonzero(live)) // 2])
    before = [buf[k].clone() for buf in generic.stack]
    traj0 = torch.randn(generic.traj.shape, dtype=generic.traj.dtype,
                        generator=torch.Generator().manual_seed(k))
    with torch.no_grad():
        for loop in (generic, kernel):
            for buf, t in zip(loop.carry, before):
                buf.copy_(t)
            for buf in loop.stack:
                buf.zero_()
            loop.traj.copy_(traj0)
            loop.resid.copy_(traj0[..., 0])
            loop.k.fill_(k)
            loop.functions()["step"]()
    assert kernel.functions()["step"] == kernel.kernels.step
    assert int(kernel.k) == int(generic.k) == k + 1
    stepped = kernel.carry[5] != before[5]
    assert bool(stepped.any()) and (where != "some_stopped") == bool(stepped.all())
    # the stack row k is the carry before the step, bit for bit; the
    # other rows are untouched
    for g, got, t in zip(generic.stack, kernel.stack, before):
        assert torch.equal(got[k], t) and torch.equal(g[k], t)
        assert not bool(got[:k].any()) and not bool(got[k + 1:].any())
    v, f1, st1, hstate, status, nstep1, end_res, max_res = kernel.carry
    ref = generic.carry
    assert torch.equal(nstep1, ref[5]) and torch.equal(status, ref[4])
    assert torch.equal(st1, ref[2]) and torch.equal(hstate, ref[3])
    tp.assert_scaled_close(v, ref[0], SLAB_RTOL, axis=-1, what="v")
    tp.assert_scaled_close(f1, ref[1], SLAB_RTOL, axis=-1, what="f1")
    for got, r in ((end_res, ref[6]), (max_res, ref[7])):
        np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=1e-6, atol=1e-12)
    # the rays that did not step: their carry bit for bit as it was, but
    # for a stop code
    for i, (got, t) in enumerate(zip(kernel.carry, before)):
        if i != 4:
            assert torch.equal(got[~stepped], t[~stepped]), i
    # the trajectory row k + 1: the step's state, zero where it did not
    # step; every other row untouched
    row = kernel.traj[:, k + 1]
    assert torch.equal(row[~stepped], torch.zeros_like(row[~stepped]))
    assert torch.equal(kernel.resid[~stepped, k + 1], torch.zeros_like(end_res[~stepped]))
    tp.assert_scaled_close(row, generic.traj[:, k + 1], SLAB_RTOL, axis=-1, what="row")
    assert torch.equal(kernel.resid[stepped, k + 1], end_res[stepped])
    others = [j for j in range(n + 1) if j != k + 1]
    assert torch.equal(kernel.traj[:, others], traj0[:, others])


@pytest.mark.parametrize("name,dtype", [(n, torch.float64) for n in RUNS] + [
    (n, torch.float32) for n in ("time", "arcl", "x_bounds")],
    ids=[f"{n}-f64" for n in RUNS] + [f"{n}-f32" for n in ("time", "arcl", "x_bounds")])
def test_whole_run_matches_slab_kernel_and_generic_pieces(host_lib, slab_lib, name, dtype):
    cfg, params, v0, st, pwr = _case(name, dtype)
    loss, got, grads = _run(cfg, params, v0, st, pwr, host_lib, step=True)
    ref_loss, ref, ref_grads = _run(cfg, params, v0, st, pwr, None)
    with torch.no_grad():
        b1 = fused_slab.run_library(slab_lib, cfg, params, v0, st, pwr)
    detached = ttrace.RayResults(*(None if t is None else t.detach() for t in got))
    # the forward: the slab kernel's npoints, stops, end states and
    # residuals bit for bit (its loop and the step kernel do the same
    # operations in the same order), its trajectories within its tolerances
    # (the first step starts from trace.initial_carry's f1, the generic
    # evaluation's, an ulp or so from the slab kernel's own, which a few rows
    # show); the generic pieces' within the same
    for field in ("npoints", "stop_flag", "end_ray_vec", "end_residuals", "max_residuals"):
        assert torch.equal(getattr(detached, field), getattr(b1, field)), field
    assert detached.npoints.tolist() == ref.npoints.tolist()
    assert detached.stop_flag.tolist() == ref.stop_flag.tolist()
    if dtype == torch.float64:
        _compare(detached, b1, SLAB_RTOL, trajectory=cfg.save_trajectory)
        _compare(detached, ttrace.RayResults(*(None if t is None else t.detach() for t in ref)),
                 SLAB_RTOL, trajectory=cfg.save_trajectory)
        np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=1e-12)
        _assert_close(grads, ref_grads, GRAD_RTOL, name)
    else:
        exact = _run(*_case(name), None)[2]
        for i, (g, r, e) in enumerate(zip(grads, ref_grads, exact)):
            scale = float(e.abs().max()) if e.numel() else 0.0
            assert bool(torch.isfinite(g).all()), (name, i)
            err, ref_err = (float((t.double() - e).abs().max()) if e.numel() else 0.0
                            for t in (g, r))
            assert err <= F32_FACTOR * ref_err + F32_FLOOR * scale, (name, i, err, ref_err)
    assert int(ref.npoints.max()) > 10
    assert sum(bool(g.abs().max() > 0) for g in ref_grads if g.numel()) >= 5
