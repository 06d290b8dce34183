"""rays_tpu_torch's entry points and tools against the JAX package's:
``entry.entry`` against ``__graft_entry__.entry``, ``tools/validate_all.py``
against ``scripts/validate_all.py`` and ``tools/inverse_demo.py`` against
the same computation built from the JAX package's public API.

* ``entry()``: one batched RK4 step on the same Params and rays, within
  1e-12 of each ray's scale, statuses equal.
* ``validate_all``: every stage passes on the CPU at its full depth; the
  slab, damped and Solovev stages trace what the JAX script's stages trace
  and both scripts PASS them, with npoints equal and the maximum residual
  within 1e-9 (the residual is normalized to 1).  The axisym and mirror
  stages run the port's own input files (the JAX script's read a test
  template and the reference's MPEX directory).
* The inverse demo at its starting point (20 RK4 steps): the misfit, its
  gradient and the two forward-mode Jacobian columns within 1e-9 of the
  JAX values' scale (the two traces agree to rounding; the misfit sums
  squares of 10^3 trajectory differences).
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch import entry as tentry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL = 1e-12
RESID_ATOL = 1e-9
INVERSE_STEPS = 20
INVERSE_RTOL = 1e-9


def _load(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {"validate": _load("tools/validate_all.py", "torch_validate_all"),
            "inverse": _load("tools/inverse_demo.py", "torch_inverse_demo")}


def test_entry_step_matches_jax():
    graft = _load("__graft_entry__.py", "graft_entry")
    jfn, (jparams, jv0) = graft.entry()
    jv1, jst = jax.jit(jfn)(jparams, jv0)
    fn, (params, v0) = tentry.entry(device="cpu")
    assert v0.device.type == "cpu"
    tp.assert_scaled_close(v0.numpy(), np.asarray(jv0), STEP_RTOL, axis=-1, what="example rays")
    pcfg, pp, tv0 = tp.to_port(jex.setup_example()[0], jparams, jv0)
    v1, st = fn(pp, tv0)
    assert v1.shape == jv1.shape and st.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    tp.assert_scaled_close(v1.numpy(), np.asarray(jv1), STEP_RTOL, axis=-1, what="one step")
    # the example's own Params give the same step
    v1b, _ = fn(params, v0)
    tp.assert_scaled_close(v1b.numpy(), np.asarray(jv1), STEP_RTOL, axis=-1, what="own Params")


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    with pytest.raises((RuntimeError, AssertionError)):
        tentry.entry()


@pytest.mark.parametrize("stage", ["slab", "damped", "solovev", "axisym", "mirror"])
def test_validate_all_stage(stage, tools, monkeypatch, capsys):
    rep = tools["validate"].STAGES[stage]("cpu")
    assert rep["ok"], rep
    assert rep["route"] == "plain" and rep["launches"] == 0
    if stage in ("axisym", "mirror"):
        assert min(rep["npoints"]) > 5 and all(f == 9 for f in rep["flags"])   # out_of_plasma
        return
    jv = _load("scripts/validate_all.py", "jax_validate_all")
    seen = {}

    def recording(text=None, **kw):
        out = trace_example(text, **kw)
        seen["res"] = out[2]
        return out

    trace_example = jv.trace_example
    monkeypatch.setattr(jv, "trace_example", recording)
    assert jv.STAGES[stage]()
    res = seen["res"]
    assert rep["npoints"] == np.asarray(res.npoints).tolist()
    assert rep["flags"] == sorted(set(np.asarray(res.stop_flag).tolist()))
    np.testing.assert_allclose(rep["max_residual"], float(np.asarray(res.max_residuals).max()),
                               rtol=0, atol=RESID_ATOL)
    if stage == "damped":
        out = capsys.readouterr().out
        jsum = float(re.search(r"deposition sum=([0-9.]+)", out).group(1))
        assert abs(rep["deposition_sum"] - jsum) < 1e-6


def test_validate_all_cli(tools, capsys):
    """The script's own entry point: a PASS line per stage, the summary and
    the JSON line; an unknown stage is refused."""
    assert tools["validate"].main(["slab", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "  slab: PASS" in out[-2] and out[-1].startswith('{"device": "cpu"')
    with pytest.raises(SystemExit):
        tools["validate"].main(["mpex", "--device", "cpu"])


def _jax_start_point(text, nstep_max):
    """The JAX script's misfit, gradient and Jacobian columns at its
    starting point (scripts/inverse_demo.py:95-130), from the JAX
    package's public API."""
    cfg, params, v0, st, pwr = jex.setup_example(text)
    cfg = dataclasses.replace(cfg, nstep_max=nstep_max, save_trajectory=True,
                              ode_solver_name="RK4_ODE")

    def trajectories(eq):
        return jtrace.trace_batch(cfg, params._replace(eq=eq), v0, st, pwr).ray_vec[:, :, 0:3]

    target = jax.jit(trajectories)(params.eq)

    def resid(th):
        return (trajectories(params.eq._replace(kappa=th[0], iota0=th[1])) - target).ravel()

    theta = jnp.asarray([float(params.eq.kappa) * 1.15, float(params.eq.iota0) * 0.85])
    loss, grad = jax.jit(jax.value_and_grad(lambda th: jnp.sum(resid(th) ** 2)))(theta)
    jvp = jax.jit(lambda th, t: jax.jvp(resid, (th,), (t,)))
    r, j0 = jvp(theta, jnp.asarray([1.0, 0.0]))
    _, j1 = jvp(theta, jnp.asarray([0.0, 1.0]))
    return {"theta": theta, "loss": loss, "grad": grad, "residual": r, "j0": j0, "j1": j1,
            "target": target}


def test_inverse_demo_start_point_matches_jax(tools):
    inv = tools["inverse"]
    got = inv.start_point(nstep_max=INVERSE_STEPS, device="cpu")
    ref = _jax_start_point(inv.demo_text(), INVERSE_STEPS)
    # 11 of the fan's 16 candidates launch, in both packages
    assert got["target"].shape == ref["target"].shape == (11, INVERSE_STEPS + 1, 3)
    for k in ("theta", "loss", "grad", "residual", "j0", "j1", "target"):
        r = np.asarray(ref[k], np.float64)
        g = got[k].detach().numpy()
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, rtol=0, atol=INVERSE_RTOL * np.abs(r).max(), err_msg=k)
    # the reverse-mode gradient is J^T 2r, from the forward-mode columns
    jtr = np.array([got["j0"] @ got["residual"], got["j1"] @ got["residual"]]) * 2
    np.testing.assert_allclose(got["grad"].numpy(), jtr, rtol=1e-9)


def test_inverse_demo_runs(tools, tmp_path):
    """A short run of the whole demo: Adam with the cosine schedule, then
    Gauss-Newton steps that lower the misfit; no convergence is promised
    (the JAX package's own full run ends FAIL)."""
    lines = []
    out = tools["inverse"].run_demo(n_iters=2, nstep_max=10, n_newton=1, log=lines.append,
                                    device="cpu")
    losses = [h[0] for h in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out["start"] == pytest.approx((1.5 * 1.15, 0.3 * 0.85))
    # the Gauss-Newton step is taken only where it lowers the misfit
    assert any(ln.startswith("  gauss-newton 0: loss=") for ln in lines)
    assert losses[2] < float(tools["inverse"].InverseProblem(10, "cpu").loss(
        torch.tensor(out["history"][1][1:], dtype=torch.float64)))
