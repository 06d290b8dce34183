"""The EQDSK step kernel (csrc/eqdsk_rk4.cuh, tracing/eqdsk_step.py) on the
CPU: the kernel body built by g++ (csrc/eqdsk_rk4_host.cpp) as the adjoint
graph's "step" piece on the G-EQDSK spline toroid, held to the generic
piece it replaces on the card (``StaticAdjoint.step``: the carry into the
stack, then ``trace.step``), which is its plain version, and through the
generic VJP to ``jax.value_and_grad`` of the JAX package.

Held:

* one step k through the pieces, from the same carry, in float64 and
  float32, in arc length and time, where every ray steps, where some have
  stopped (out of the plasma, out of the box, at the residual limit), at
  the last step, and on a cell table whose R*Bphi rows q > 0 are nonzero: npoints, the stop codes and st1 equal, the float
  carry within the slab kernels' tolerance of scale (tests/
  test_torch_kernel_host.py; F32_RTOL in float32), and bit for bit what
  did no arithmetic: the stack row written at k, and the carry and
  trajectory row of the rays that did not step;
* whole runs through ``trace_batch_static_adjoint`` with the kernel's
  step and the generic VJP, against the generic pieces: npoints and stops
  equal, end states and residuals within the same tolerance, the loss and
  every gradient within GRAD_RTOL of scale (float64; in float32 each
  gradient held to the float64 answer as tests/test_torch_slab_vjp.py
  holds the slab kernels);
* whole runs of the deck against ``jax.value_and_grad`` of the JAX
  package's ``trace_batch`` on the same inputs: the loss and the gradient
  of every floating Params leaf (the cell table's and psib's among them),
  v0 and pwr_wt within JAX_RTOL of each leaf's scale;
* the gate: taken exactly for the spline toroid's RK4 configs with a cell
  table, cold and undamped, with the profile models the kernel holds, on
  CUDA; refused for the Solovev analytic toroid, the bilinear EQDSK, a
  missing cell table, damping, SG, the equilibrium-gradient slots, the
  compensated carry, the autodiff derivatives, a density spline, a model
  of the caller's own and the CPU; never open together with the slab
  kernels' gate.  Where it opens (the host build standing for the card's
  library) the loop's "step" piece is the kernel's and its "vjp" the
  generic one.

The host-read audit of the kernel's piece is a case of
tests/test_torch_graphed_adjoint.py::test_vjp_piece_reads_nothing_on_the_host.
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
from rays_tpu_torch import convert, examples as tex, run as trun
from rays_tpu_torch.core.types import tree_leaves, tree_map, tree_to
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.tracing import eqdsk_step, graphed_adjoint as ga, slab_vjp
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.tracing.stop import StopCode
from test_axisym import AXISYM_TMPL
from test_torch_graphed_adjoint import JAX_RTOL
from test_torch_kernel_host import RTOL
from test_torch_slab_vjp import (F32_FACTOR, F32_FLOOR, GRAD_RTOL, _assert_close, _weighted_loss,
                                 _weights)

N_RAYS = 8
STEPS = 40
# float32, one step: the kernel and the generic piece each round in float32
# (the carry's k is about 1.7e3 and the step differences lie at a few ulp of
# it)
F32_RTOL = 2e-6
# float32, the residual: |det| over the sum of terms of order one, whose
# float32 rounding is about 1e-6 absolute (float64: rtol 1e-6)
F32_RESID_ATOL = 4e-6

# the deck of ``examples.EQDSK_TOROID_ECH_90GHZ`` launched from the
# benchmark cell's point (R 1.2, Z 0.3) with four n_theta, under the cell's
# profiles (parabolic temperatures with the density's exponents, no
# scrape-off floors): the rays run inward through the core
INWARD = (tex.EQDSK_TOROID_ECH_90GHZ
          .replace("R_launch0=1.5", "R_launch0=1.2").replace("Z_launch0=0.0", "Z_launch0=0.3")
          .replace("n_rindex_theta=2, rindex_theta0=0.0, delta_rindex_theta=0.2",
                   "n_rindex_theta=4, rindex_theta0=0.0, delta_rindex_theta=0.1")
          .replace("d_scrape_off=0.05,\n temperature_prof_model=2*'zero'",
                   "\n temperature_prof_model=2*'parabolic', alphat1=2*1.0, alphat2=2*2.0"))
# the example's own: launched from R 1.5, zero temperatures, a density
# floor; its rays leave the plasma at the 40th step
OUTWARD = tex.EQDSK_TOROID_ECH_90GHZ


def _rbphi_rows(cells):
    """The cell table with R*Bphi's rows q = 1..3 nonzero, a thousandth of
    its row q = 0's scale: build_cell_spline_2d writes zeros there, but a
    gradient step on the table does not keep them, and the plain chain
    evaluates all 16 coefficients of the channel."""
    out = cells.clone()
    rows = out[:, :, 1, 1:]
    rows.copy_(1e-3 * float(cells[:, :, 1, 0].abs().max()) * torch.randn(
        rows.shape, dtype=cells.dtype, generator=torch.Generator().manual_seed(3)))
    return out


# name: (deck, Config changes, Params changes by path (a value, or a
# function of the old one), how the rays change, the stop it shows).  "reverse": the inward deck's wavevectors
# reversed, so that the rays run outward from the launch point and their
# residual grows; "spread": reversed too, and the four launch points moved
# out in R by 1.5 cm apiece (under a lax residual limit: they are then off
# the dispersion surface), so that they cross a flux surface steps apart.
CASES = {
    "arcl": (INWARD, {}, {}, None, None),
    "time": (INWARD, dict(ray_param="time"), {"ode.ds": 6.67e-12}, None, None),
    "outward": (OUTWARD, {}, {}, None, None),
    "box": (INWARD, {}, {"eq.box_rmin": 1.185}, None, StopCode.R_OUT_OF_BOX),
    "resid": (INWARD, {}, {"limits.dispersion_resid_limit": 1e-8}, "reverse",
              StopCode.DISPERSION_RESIDUAL),
    "plasma": (INWARD, {}, {"eq.plasma_psi_limit": 0.35,
                            "limits.dispersion_resid_limit": 1e3}, "spread",
               StopCode.OUT_OF_PLASMA),
    # the temperatures' own exponents; a constant density (under a lax
    # residual limit: the launch solves the parabolic deck's dispersion)
    "profiles": (INWARD, {}, {"eq.alphat1": (1.5, 2.0), "eq.alphat2": (2.0, 3.0)}, None, None),
    "constant": (INWARD, {"eq_static.density_prof_model": "constant",
                          "eq_static.temperature_prof_model": ("constant", "parabolic")},
                 {"limits.dispersion_resid_limit": 1e3}, None, None),
    # R*Bphi varying in Z within a cell (under a lax residual limit: the
    # launch solves the table as built)
    "rbphi_rows": (INWARD, {}, {"eq.mag.psi_cells.cells": _rbphi_rows,
                                "limits.dispersion_resid_limit": 1e3}, None, None),
}


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the EQDSK step needs it")
    return eqdsk_step.load_host_library()


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """{deck text: (cfg, float64 CPU params, v0, status0, pwr)} at N_RAYS
    rays (the launch's rays tiled, unmoved: a move of a micron lifts their
    residual by 1e-8), on a 33 x 33 G-EQDSK of the Solovev equilibrium."""
    made = {}
    for i, text in enumerate((INWARD, OUTWARD)):
        d = tmp_path_factory.mktemp(f"eqdsk_step{i}")
        cfg, params, v0, st, pwr = trun.setup(tex.write_eqdsk_toroid_example(d, n=33, text=text),
                                              device="cpu")
        made[text] = (cfg, params, *tex.replicate_rays(v0, st, pwr, N_RAYS, jitter=0.0))
    return made


def _replace_path(obj, path, value):
    head, _, rest = path.partition(".")
    if rest:
        value = _replace_path(getattr(obj, head), rest, value)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{head: value})
    return obj._replace(**{head: value})


def _case(decks, name, dtype=torch.float64, **changes):
    text, cfg_changes, param_changes, rays, _ = CASES[name]
    cfg, params, v0, st, pwr = decks[text]
    if rays is not None:
        v0 = v0.clone()
        v0[:, 3:6] = -v0[:, 3:6]
        if rays == "spread":
            v0[:, 0] += 1.5e-2 * (torch.arange(N_RAYS) % 4)
    cfg = dataclasses.replace(cfg, nstep_max=STEPS, save_trajectory=True, **changes)
    for path, value in cfg_changes.items():
        cfg = _replace_path(cfg, path, value)
    for path, value in param_changes.items():
        if callable(value):
            old = params
            for name in path.split("."):
                old = getattr(old, name)
            value = value(old)
        params = _replace_path(params, path, torch.as_tensor(value, dtype=torch.float64))
    params, v0, pwr = tree_to(params, dtype=dtype), v0.to(dtype), pwr.to(dtype)
    assert eqdsk_step.supported(cfg, params), name
    return cfg, params, v0, st, pwr


def _loop(cfg, params, v0, st, lib):
    """A StaticAdjoint on the CPU, whose gate gives it the generic pieces;
    with a library, its "step" piece that library's EQDSK step instead."""
    loop = ga.StaticAdjoint(cfg, params, v0, st)
    if lib is not None:
        loop.kernels = eqdsk_step.EqdskStep(lib, loop)
    return loop


def _with_grad(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)


def _run(cfg, params, v0, st, pwr, lib):
    """(loss, results, gradients of the floating Params leaves, v0 and
    pwr_wt) through a StaticAdjoint whose "step" piece is ``lib``'s kernel
    (None: the generic piece)."""
    p = _with_grad(params)
    v, w = v0.clone().requires_grad_(True), pwr.clone().requires_grad_(True)
    res = ga.trace_batch_static_adjoint(cfg, p, v, st, w, loop=_loop(cfg, p, v, st, lib))
    loss = _weighted_loss(res)
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()] + [v, w]
    return loss.detach(), res, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                   materialize_grads=True)


# --- one step -----------------------------------------------------------------------


ONE_STEP = [("arcl", "all_live", torch.float64), ("time", "all_live", torch.float64),
            ("outward", "all_live", torch.float64), ("profiles", "all_live", torch.float64),
            ("constant", "all_live", torch.float64), ("rbphi_rows", "all_live", torch.float64),
            ("box", "some_stopped", torch.float64), ("resid", "some_stopped", torch.float64),
            ("plasma", "some_stopped", torch.float64), ("arcl", "last", torch.float64),
            ("arcl", "all_live", torch.float32), ("time", "all_live", torch.float32),
            ("box", "some_stopped", torch.float32)]


@pytest.mark.parametrize("name,where,dtype", ONE_STEP,
                         ids=[f"{n}-{w}-{str(d)[6:]}" for n, w, d in ONE_STEP])
def test_one_step_matches_generic_step(host_lib, decks, name, where, dtype):
    """Step k of both pieces from the carry the generic forward had before
    it (its stack row k)."""
    cfg, params, v0, st, pwr = _case(decks, name, dtype)
    generic, kernel = _loop(cfg, params, v0, st, None), _loop(cfg, params, v0, st, host_lib)
    carry = ttrace.initial_carry(cfg, params, v0, st)
    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    generic.forward(carry, leaves)
    kernel.load_inputs(carry, leaves)
    n = cfg.nstep_max
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
    assert kernel.functions() == {"step": kernel.kernels.step, "vjp": kernel.vjp}
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
    rtol = RTOL if dtype == torch.float64 else F32_RTOL
    tp.assert_scaled_close(v, ref[0], rtol, axis=-1, what="v")
    tp.assert_scaled_close(f1, ref[1], rtol, axis=-1, what="f1")
    for got, r in ((end_res, ref[6]), (max_res, ref[7])):
        if dtype == torch.float64:
            np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=1e-6, atol=1e-12)
        else:
            np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=0, atol=F32_RESID_ATOL)
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
    tp.assert_scaled_close(row, generic.traj[:, k + 1], rtol, axis=-1, what="row")
    assert torch.equal(kernel.resid[stepped, k + 1], end_res[stepped])
    others = [j for j in range(n + 1) if j != k + 1]
    assert torch.equal(kernel.traj[:, others], traj0[:, others])


def test_count_ops_takes_the_launch_step(host_lib, decks):
    """count_ops (the body on the counting type, for the kernel's bound)
    takes the step a launch takes, bit for bit, and counts the arithmetic
    of the rays still running (a ray that stops in the step did its
    evaluations too): once none runs, it counts nothing."""
    cfg, params, v0, st, pwr = _case(decks, "plasma")
    cfg = dataclasses.replace(cfg, nstep_max=2 * STEPS)
    launched, counted = _loop(cfg, params, v0, st, host_lib), _loop(cfg, params, v0, st, host_lib)
    carry = ttrace.initial_carry(cfg, params, v0, st)
    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    for loop in (launched, counted):
        loop.load_inputs(carry, leaves)
    per_live, idle = [], 0
    for k in range(cfg.nstep_max):
        running = int((counted.carry[4] == 0).sum())
        launched.kernels.launch("step")
        counted.k.fill_(k)
        ops, live = eqdsk_step.count_ops(counted)
        launched.k.add_(1)
        for got, want in zip(counted.carry + tuple(b[:k + 1] for b in counted.stack),
                             launched.carry + tuple(b[:k + 1] for b in launched.stack)):
            assert torch.equal(got, want), k
        assert bool(running) == any(ops.values()) and live <= running, k
        if live == running and live:
            per_live.append(sum(ops.values()) / live)
        idle += not running
    # a live ray step does four evaluations' arithmetic, the same on every
    # step whose rays all stepped; the rays stop before the end
    assert len(per_live) > STEPS // 2 and idle > 0
    assert 1000 < min(per_live) and max(per_live) < 1.01 * min(per_live)
    with pytest.raises(ValueError, match="count_ops"):
        eqdsk_step.count_ops(_loop(cfg, params, v0, st, None))


# --- whole runs ---------------------------------------------------------------------


WHOLE = [(n, torch.float64) for n in CASES] + [
    (n, torch.float32) for n in ("arcl", "time", "box")]


@pytest.mark.parametrize("name,dtype", WHOLE, ids=[f"{n}-{str(d)[6:]}" for n, d in WHOLE])
def test_whole_run_matches_generic_pieces(host_lib, decks, name, dtype):
    cfg, params, v0, st, pwr = _case(decks, name, dtype)
    loss, got, grads = _run(cfg, params, v0, st, pwr, host_lib)
    ref_loss, ref, ref_grads = _run(cfg, params, v0, st, pwr, None)
    got, ref = (ttrace.RayResults(*(None if t is None else t.detach() for t in r))
                for r in (got, ref))
    assert got.npoints.tolist() == ref.npoints.tolist()
    assert got.stop_flag.tolist() == ref.stop_flag.tolist()
    if dtype == torch.float64:
        tp.assert_scaled_close(got.end_ray_vec, ref.end_ray_vec, RTOL, axis=-1, what="end")
        tp.assert_scaled_close(got.ray_vec, ref.ray_vec, RTOL, axis=(0, 1), what="trajectory")
        np.testing.assert_allclose(got.max_residuals.numpy(), ref.max_residuals.numpy(),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=1e-12)
        _assert_close(grads, ref_grads, GRAD_RTOL, name)
    else:
        exact = _run(*_case(decks, name), None)[2]
        for i, (g, r, e) in enumerate(zip(grads, ref_grads, exact)):
            scale = float(e.abs().max()) if e.numel() else 0.0
            assert bool(torch.isfinite(g).all()), (name, i)
            err, ref_err = (float((t.double() - e).abs().max()) if e.numel() else 0.0
                            for t in (g, r))
            assert err <= F32_FACTOR * ref_err + F32_FLOOR * scale, (name, i, err, ref_err)
    # the rays step, the case shows its stop, and the gradients are not all zero
    assert int(ref.npoints.max()) > STEPS // 2
    want = CASES[name][4]
    if want is not None:
        assert int(want) in set(ref.stop_flag.tolist()) and len(set(ref.npoints.tolist())) > 1
    assert sum(bool(g.abs().max() > 0) for g in ref_grads if g.numel()) >= 5


@pytest.mark.parametrize("name", ["arcl", "arcl_summaries"])
def test_whole_run_matches_jax_grad(host_lib, tmp_path, name):
    """The inward deck's rays through the kernel's step piece and the
    generic VJP against jax.value_and_grad of the JAX package's trace_batch
    on the same inputs (its launch carried across, C13) and loss, with and
    without trajectories."""
    text = INWARD.format(EQDSK=tp.write_solovev_geqdsk(tmp_path / "solovev.geqdsk", n=33))
    (jcfg, jparams), (pcfg, _) = tp.both_from_text(text)
    changes = dict(nstep_max=STEPS, save_trajectory=name == "arcl")
    jcfg, pcfg = dataclasses.replace(jcfg, **changes), dataclasses.replace(pcfg, **changes)
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    jv0, jst, jpwr = tp.jax_launch(jcfg, jparams)
    _, _, v0, st, pwr = tp.to_port(jcfg, jparams, jv0, jst, jpwr)
    assert eqdsk_step.supported(pcfg, params)
    loss, res, grads = _run(pcfg, params, v0, st, pwr, host_lib)
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
    cells = [i for i, t in enumerate(tree_leaves(params))
             if t is params.eq.mag.psi_cells.cells or t is params.eq.mag.psib]
    live = 0
    for i, (g, r) in enumerate(zip(grads, ref)):
        r = np.asarray(r)
        scale = np.abs(r).max() if r.size else 0.0
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=JAX_RTOL * scale, err_msg=str(i))
        live += bool(scale > 0)
    # the cell table's and psib's gradients are among those held, and live
    assert len(cells) == 2 and all(np.abs(np.asarray(ref[i])).max() > 0 for i in cells)
    assert live >= 5
    assert int(res.npoints.max()) > STEPS // 2


# --- the gate -------------------------------------------------------------------


GATE_CASES = ["eqdsk", "eqdsk_f32", "eqdsk_time", "eqdsk_constant", "solovev_toroid",
              "eqdsk_bilinear", "no_cell_table", "damped", "sg", "eq_gradients", "compensated",
              "autodiff", "density_spline", "registered", "slab"]
# cases whose Config alone changed, which a StaticAdjoint of the deck's
# Params and rays cannot run
CONFIG_ONLY = ("damped", "sg", "eq_gradients", "compensated", "autodiff", "density_spline")


def _gate_case(decks, tmp_path, name):
    """(whether the gate takes it, cfg, params, v0, status0) of a gate
    case, on the CPU at 3 steps."""
    takes = name in ("eqdsk", "eqdsk_f32", "eqdsk_time", "eqdsk_constant")
    if name == "slab":
        cfg, params, v0, st, _ = tex.setup_example(device="cpu")
        return takes, dataclasses.replace(cfg, nstep_max=3), params, v0, st
    if name in ("solovev_toroid", "eqdsk_bilinear"):
        mag = "solovev_magnetics" if name == "solovev_toroid" else "eqdsk_magnetics_lin_interp"
        cfg, params, v0, st, _ = trun.setup(tex.write_eqdsk_toroid_example(
            tmp_path, n=33, text=AXISYM_TMPL.replace("{MAG}", mag)), device="cpu")
        return takes, dataclasses.replace(cfg, nstep_max=3), params, v0, st
    base_name = {"eqdsk_time": "time", "eqdsk_constant": "constant"}.get(name, "arcl")
    cfg, params, v0, st, _ = _case(decks, base_name,
                                   torch.float32 if name == "eqdsk_f32" else torch.float64)
    cfg = dataclasses.replace(cfg, nstep_max=3, **{
        "damped": dict(damping_model="damp_fund_ECH"), "sg": dict(ode_solver_name="SG_ODE",
                                                                   sg_scan_substeps=2),
        "eq_gradients": dict(integrate_eq_gradients=True),
        "compensated": dict(compensated_sum=True), "autodiff": dict(ray_deriv_name="autodiff"),
        "density_spline": dict(eq_static=dataclasses.replace(
            cfg.eq_static, density_prof_model="density_spline_interp")),
    }.get(name, {}))
    if name == "no_cell_table":
        params = params._replace(eq=params.eq._replace(mag=params.eq.mag._replace(
            psi_cells=None)))
    return takes, cfg, params, v0, st


@pytest.mark.parametrize("name", GATE_CASES)
def test_gate(decks, tmp_path, monkeypatch, name):
    takes, cfg, params, v0, st = _gate_case(decks, tmp_path, name)
    if name == "registered":
        # a model of the caller's own under the toroid's name
        from rays_tpu_torch.models import axisym_toroid

        monkeypatch.setitem(tbase.EQ_MODELS, "axisym_toroid", axisym_toroid)
    for dev in ("cuda", torch.device("cuda", 0)):
        assert eqdsk_step.takes(cfg, params, dev) == takes
    assert not eqdsk_step.takes(cfg, params, "cpu")
    # never both: the slab kernels' gate takes slab configs only
    assert not (takes and slab_vjp.takes(cfg, "cuda"))
    if name in CONFIG_ONLY:
        return      # the Config alone changed: the Params and rays do not fit it
    # on the CPU the pieces are the generic ones, and nothing is launched
    before = eqdsk_step.STEP_LAUNCHES
    loop = ga.StaticAdjoint(cfg, params, v0, st)
    assert loop.kernels is None and loop.functions() == {"step": loop.step, "vjp": loop.vjp}
    with torch.no_grad():
        loop.forward(ttrace.initial_carry(cfg, params, v0, st),
                     [t for t in tree_leaves(params) if t.is_floating_point()])
    assert eqdsk_step.STEP_LAUNCHES == before
    if not takes:
        with pytest.raises(ValueError, match="EQDSK step"):
            eqdsk_step.EqdskStep(None, loop)


@pytest.mark.parametrize("name", ["eqdsk", "eqdsk_f32", "solovev_toroid", "eqdsk_bilinear",
                                  "no_cell_table", "slab"])
def test_opened_gate_takes_the_kernel(host_lib, decks, tmp_path, monkeypatch, name):
    """Where the gate opens (here the host build standing for the card's
    library), the loop's "step" piece is the kernel's and its "vjp" the
    generic one; where it does not, both are the generic pieces."""
    takes, cfg, params, v0, st = _gate_case(decks, tmp_path, name)
    gate = eqdsk_step.takes
    monkeypatch.setattr(eqdsk_step, "takes", lambda cfg_, p_, dev: gate(cfg_, p_, "cuda"))
    monkeypatch.setattr(eqdsk_step, "load_library", lambda dtype, ns: (host_lib, ""))
    opened = ga.StaticAdjoint(cfg, params, v0, st)
    assert isinstance(opened.kernels, eqdsk_step.EqdskStep) == takes
    assert takes or opened.kernels is None
    assert opened.functions() == (
        {"step": opened.kernels.step, "vjp": opened.vjp} if takes
        else {"step": opened.step, "vjp": opened.vjp})
