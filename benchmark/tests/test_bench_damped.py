"""The configuration ``slab_ech_90ghz_damped`` and its damped reference on
the CPU, at the cells' fan cut to a few rays and 40 steps, launched at
x = 0.2 m instead of -0.45 m so that the rays meet the resonance within
them (some absorbed, stop 21, the rest still live at 40 steps): the
reference's Dawson function against scipy's; its k_i against the NumPy
oracle's ``damp_fund_ech``; its trace and deposition against the
program's; the float32 control refused; both cells' drivers through
``run_cell``; and a perturbed damping limit or bin edge in the program
comes out not correct."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.lib import common, compare, inputs
from benchmark.reference import rays_damped
from benchmark.tests.sizes import shrink

SEED = 2147483743
FWD, TRAIN = "slab_damped.fwd", "slab_damped.train"


def _cut(cell, counts, steps=40, x0="0.2"):
    """``cell`` cut to ``counts`` rays on its scan axes and ``steps`` steps,
    launched at x = ``x0`` m, with no warm-up call."""
    shrink(cell, counts, steps)
    assert "x_launch0=-0.45" in cell.namelist
    cell.namelist = cell.namelist.replace("x_launch0=-0.45", f"x_launch0={x0}")
    cell.spec = dict(cell.spec, warmup_calls=0)
    return cell


def _cell(name, counts):
    return _cut(common.Cell(name), counts)


def _null(_):
    return contextlib.nullcontext()


def test_dawsn_matches_scipy():
    special = pytest.importorskip("scipy.special")
    x = torch.linspace(-6.0, 6.0, 24001, dtype=torch.float64)
    want = torch.from_numpy(special.dawsn(x.numpy()))
    got = rays_damped.dawsn(x)
    inside = want != 0
    assert torch.equal(got[~inside], want[~inside])
    assert float(((got - want).abs()[inside] / want.abs()[inside]).max()) <= 1e-13
    far = torch.tensor([6.6, 10.0, 40.0, -25.0], dtype=torch.float64)
    np.testing.assert_allclose(rays_damped.dawsn(far).numpy(), special.dawsn(far.numpy()),
                               rtol=1e-13)


def _reference_run(counts=(8, 8)):
    cell = _cell(FWD, counts)
    drv = common.load_module(common.HERE / "drivers" / "forward_damped.py")
    case, _, v0, pwr = drv.reference_inputs(cell, SEED, "cpu", torch.float64)
    with torch.no_grad():
        return cell, case, v0, pwr, rays_damped.trace(case, v0, trajectory=True)


def test_ki_matches_the_oracle():
    """k_i at every point of 16 reference trajectories, and at the same
    states moved back to the deck's launch at x = -0.45 m (far from the
    resonance: |xi| > 5), against ``tests/_oracle.py::damp_fund_ech``
    (scipy's wofz for Z), the live points and the early returns alike."""
    pytest.importorskip("scipy.special")
    oracle = common.load_module(common.ROOT / "tests" / "_oracle.py")
    _, case, _, _, run_ = _reference_run((4, 4))
    pts = run_["traj"].reshape(-1, case.static["nv"])
    far = pts.clone()
    far[:, 0] = -0.45
    pts = torch.cat([pts, far])
    with torch.no_grad():
        dv, _, e = rays_damped.rays_plain.eqn_ray(case, pts[:, 0:7])
        vg = dv[:, 0:3] / dv[:, 0:3].norm(dim=-1, keepdim=True)
        ksi, ki = rays_damped.damp_fund_ech(case, e, pts[:, 3:6], vg)
    want = []
    for i in range(pts.shape[0]):
        eq = type("Eq", (), {k: getattr(e, k)[i].numpy() for k in
                             ("alpha", "gamma", "bunit", "ts", "omgc")})
        want.append(oracle.damp_fund_ech(eq, pts[i, 0:6].numpy(), vg[i].numpy(),
                                         float(case["rf.omgrf"]), float(case["rf.k0"]),
                                         case["species.ms"].numpy())[1])
    want = torch.tensor(want, dtype=torch.float64)
    live = want != 0
    assert 0 < int(live.sum()) < live.numel()
    assert torch.equal(ki[~live], want[~live])
    assert float((ki - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(ksi[:, 0], ki) and not ksi[:, 1:].any()


def test_trace_and_deposition_match_the_program():
    """64 rays x 40 steps: the same points and stops (absorbed and still
    live), the end states (absorption slots included) and the
    Ptotal_x profile to rounding."""
    from rays_tpu_torch.post import deposition
    from rays_tpu_torch.tracing import trace

    cell, case, v0, pwr, ref = _reference_run()
    cfg, params, _, pv0, st, ppwr = inputs.program(cell, SEED, "cpu", _null)
    cfg = dataclasses.replace(cfg, save_trajectory=True)
    with torch.no_grad():
        res = trace.trace_rays(cfg, params, pv0, st, ppwr)
    assert compare.state_gap(pv0, v0) == 0.0
    assert torch.equal(res.npoints, ref["npoints"]) and torch.equal(res.stop_flag, ref["stop"])
    assert set(res.stop_flag.tolist()) == {21, 31}
    assert compare.state_gap(res.end_ray_vec, ref["end"]) <= 1e-12
    assert float(ref["end"][:, 7].min()) > 0.3
    g = cell.config["deposition"]
    prog = deposition.calculate_deposition_profile(cfg, params, res, "Ptotal_x", g["n_bins"],
                                                   g["xmin"], g["xmax"]).profile
    want = rays_damped.deposition_profile(ref, pwr, g["n_bins"], g["xmin"], g["xmax"])
    assert int((want > 0).sum()) >= 4
    assert float((prog - want).abs().max() / want.abs().max()) <= 1e-12


def test_gradient_matches_the_program():
    """16 rays x 40 steps of the training step: the loss and every leaf's
    gradient, the damping's own leaves among those that move."""
    cell = _cell(TRAIN, (4, 4))
    drv = cell.driver.Driver(cell, SEED, "cpu", _null)
    prog = drv.answer(drv.keep(drv.call()))
    ref = cell.driver.reference(cell, SEED, "cpu", torch.float64)
    values = compare.numbers(prog, ref, cell.spec["limits"])
    assert values["npoints_diff"] == values["stop_diff"] == 0
    assert values["end_gap"] <= 1e-12 and values["loss_gap"] <= 1e-12
    assert values["grad_gap"] <= 1e-10
    moved = {k for k, g in ref["grads"].items() if float(g.abs().sum()) > 0}
    assert {"species.t0s", "species.ms", "eq.bz0", "eq.lbz_scale", "ode.ds"} <= moved


def test_float32_control_is_refused():
    """The reference computed in float32 in the program's place, held to
    the float64 reference by the forward cell's numbers at 64 rays x 40
    steps: refused, its launch alone 1e-8 off or more."""
    readings = control.readings(FWD, SEED, device="cpu", adjust=lambda c: _cut(c, (8, 8)))
    correct, _ = compare.judge(readings, common.Cell(FWD).spec["limits"])
    assert not correct
    assert readings["launch_gap"] > 1e-8


def _result(name):
    """A run of the cell on 4 x 4 rays (the forward) or 2 x 2 (the
    derivative step) x 25 steps from x = 0.3 m, where about half the rays
    are absorbed."""
    counts = (4, 4) if name == FWD else (2, 2)
    return run.run_cell(name, SEED, 0.0, False, "cpu",
                        adjust=lambda c: _cut(c, counts, 25, "0.3"), log=lambda line: None)


@pytest.mark.parametrize("name", [FWD, TRAIN])
def test_cell_runs_correct(name):
    result = _result(name)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", common.Cell(name).driver.METRIC}


def _lower_limit(trace_rays):
    """The program's trace with its total_damping_limit lowered to 0.9."""
    def traced(cfg, params, v0, status0, pwr):
        limits = params.limits._replace(total_damping_limit=params.limits.total_damping_limit
                                        * (0.9 / 0.99))
        return trace_rays(cfg, params._replace(limits=limits), v0, status0, pwr)

    return traced


def _shifted_edges(bin_to_uniform_grid):
    """The program's binning on a grid shifted by a third of a bin."""
    def binned(Q, xQ, xmin, xmax, n_bins):
        shift = (xmax - xmin) / n_bins / 3.0
        return bin_to_uniform_grid(Q, xQ, xmin + shift, xmax + shift, n_bins)

    return binned


@pytest.mark.parametrize("fault,name", [("damping_limit", FWD), ("bin_edge", TRAIN)])
def test_fault_is_not_correct(fault, name, monkeypatch):
    from rays_tpu_torch.ops import binning
    from rays_tpu_torch.tracing import trace

    if fault == "damping_limit":
        monkeypatch.setattr(trace, "trace_rays", _lower_limit(trace.trace_rays))
    else:
        monkeypatch.setattr(binning, "bin_to_uniform_grid",
                            _shifted_edges(binning.bin_to_uniform_grid))
    result = _result(name)
    assert result["correct"] is False
    failed = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
    assert failed <= {"npoints_diff", "stop_diff", "end_gap", "resid_gap", "loss_gap",
                      "grad_gap"} and failed
    if fault == "bin_edge":
        assert failed <= {"loss_gap", "grad_gap"}
