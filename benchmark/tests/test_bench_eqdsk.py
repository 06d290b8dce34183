"""The configuration ``solovev_minus_root_eqdsk`` and its reference on the
CPU: the frozen converter writes the committed G-EQDSK byte for byte; the
reference's splined field is the analytic Solovev field to the spline's
accuracy (RAYS's compare_analyt_2_interp); the program matches the
reference at 16 rays x 60 steps of the cell's fan, loss and every leaf's
gradient included, and the float32 control does not; and the program on
the file traces the analytic deck's own two rays from the same point to
the same stops, its ends within the spline's accuracy."""

import contextlib
import math

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.lib import common, compare, inputs
from benchmark.reference import model_eqdsk, rays_plain, solovev_geqdsk
from benchmark.tests.sizes import shrink

CELL = "solovev_eqdsk.grad"
SEED = 3000000019


@pytest.fixture(autouse=True)
def at_the_root(monkeypatch):
    """The program reads the G-EQDSK by its path relative to the checkout."""
    monkeypatch.chdir(common.ROOT)


def _cell(counts, steps):
    cell = common.Cell(CELL)
    shrink(cell, counts, steps)
    return cell


def test_converter_writes_the_committed_file():
    assert solovev_geqdsk.geqdsk_text().encode() == solovev_geqdsk.PATH.read_bytes()
    eq = model_eqdsk.read_geqdsk(solovev_geqdsk.PATH)
    assert eq["nr"] == eq["nz"] == 129 and eq["psiaxis"] == 0.0
    # psi falls outward: the file's PSIBOUND is the analytic psib negated
    assert eq["psibound"] == pytest.approx(-solovev_geqdsk.psi_boundary(**solovev_geqdsk.DECK),
                                           rel=1e-9)
    assert eq["psi"].max() <= 0.0


def _analytic(pts, rmaj, kappa, bphi0, iota0, outer_bound):
    """B, dB_j/dx_i and psiN of the closed-form Solovev field
    (solovev_eq_m.f90) at points of the y = 0 plane."""
    R, z = pts[:, 0], pts[:, 2]
    bp0, a2 = bphi0 * iota0, (rmaj * kappa) ** 2
    br, bz = -bp0 * R * z / a2, bp0 * (z * z / a2 + 0.5 * ((R / rmaj) ** 2 - 1.0))
    bphi = bphi0 * rmaj / R
    grad = np.zeros((len(R), 3, 3))
    grad[:, 0] = np.stack([-bp0 * z / a2, -bphi0 * rmaj / R**2, bp0 * R / rmaj**2], -1)
    grad[:, 1] = np.stack([-bphi / R, br / R, 0.0 * R], -1)
    grad[:, 2] = np.stack([-bp0 * R / a2, 0.0 * R, 2.0 * bp0 * z / a2], -1)
    psin = (solovev_geqdsk.solovev_psi(R, z, rmaj, kappa, bphi0, iota0)
            / solovev_geqdsk.psi_boundary(rmaj, bphi0, iota0, outer_bound))
    return np.stack([br, bphi, bz], -1), grad, psin


def test_spline_field_matches_the_analytic_field():
    """compare_analyt_2_interp on the committed file: B within 1e-5 of its
    scale, grad B within 2e-3 (the tolerances that hold the program's
    splined field to its closed form, tests/test_torch_axisym.py), psiN
    and the density to 1e-5."""
    case = rays_plain.build_case(inputs.namelist_text(common.Cell(CELL), SEED),
                                 fields=model_eqdsk.builder)
    rng = np.random.default_rng(5)
    pts = np.concatenate([[[1.45, 0.0, 0.1], [1.2, 0.0, 0.3], [0.9, 0.0, 0.4],
                           [1.5, 0.0, 0.0], [1.2, 0.0, -0.45]],
                          np.stack([rng.uniform(0.8, 1.5, 16), np.zeros(16),
                                    rng.uniform(-0.5, 0.5, 16)], -1)])
    b, grad, psin = _analytic(pts, **solovev_geqdsk.DECK)
    sb, sgrad, sn, _, _, _, err = case.fields(torch.from_numpy(pts))
    np.testing.assert_allclose(sb.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(sgrad.numpy(), grad, rtol=0, atol=2e-3 * np.abs(grad).max())
    inside = psin < 1.0
    np.testing.assert_allclose(sn[:, 0].numpy(), np.where(inside, 1.0 - psin**2, 0.0),
                               rtol=0, atol=1e-5)
    assert (err.numpy() == np.where(inside, 0, rays_plain.OUT_OF_PLASMA)).all()


def test_program_matches_the_reference():
    """16 rays of the cell's fan x 60 steps: launch and end states to
    rounding, the same points and stops, the loss and every leaf's
    gradient (the psi cell table's, its grid's and PSIBOUND's among them)
    far inside the cell's limits."""
    cell = _cell((4, 4), 60)
    drv = cell.driver.Driver(cell, SEED, "cpu", lambda _: contextlib.nullcontext())
    prog = drv.answer(drv.keep(drv.call()))
    ref = cell.driver.reference(cell, SEED, "cpu", torch.float64)
    values = compare.numbers(prog, ref, cell.spec["limits"])
    correct, _ = compare.judge(values, cell.spec["limits"])
    assert correct
    assert values["launch_gap"] <= 1e-13 and values["end_gap"] <= 1e-12
    assert values["loss_gap"] <= 1e-13 and values["grad_gap"] <= 1e-11
    moved = {k for k, g in ref["grads"].items() if float(g.abs().sum()) > 0}
    assert {"eq.mag.psi_cells.cells", "eq.mag.psi_cells.dx", "eq.mag.psib",
            "eq.alphan2", "species.alpha_coef", "ode.ds"} <= moved
    assert set(prog["grads"]) >= set(ref["grads"])


def test_float32_control_is_refused():
    readings = control.readings(CELL, SEED, device="cpu", adjust=lambda c: shrink(c, (4, 4), 60))
    correct, _ = compare.judge(readings, common.Cell(CELL).spec["limits"])
    assert not correct
    assert readings["launch_gap"] > 1e-8


DECK_RAYS = {"n_theta_launch=4, theta_launch0=0.0, dtheta_launch=0.7854":
             f"n_theta_launch=1, theta_launch0={math.pi / 2!r}, dtheta_launch=0.0",
             "ode_solver_name='SG_ODE', nstep_max=200": "ode_solver_name='RK4_ODE', nstep_max=500"}


def test_the_file_traces_the_analytic_decks_rays():
    """The analytic deck (rays_tpu_torch.examples.SOLOVEV_ECH_90GHZ, RK4 at
    its ds, launched at theta = 90 degrees: R 1.2, Z 0.3) and the
    configuration with the deck's two rays there (n_theta 0 and 0.2, n_phi
    0.3): the same points and stops, the launch and the end states within
    the spline's accuracy (8.3e-9 and 4.8e-7 of scale found)."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.tracing.trace import trace_rays

    text = examples.SOLOVEV_ECH_90GHZ
    for old, new in DECK_RAYS.items():
        assert old in text, old
        text = text.replace(old, new)
    analytic = trace_rays(*examples.setup_example(text, device="cpu"))
    twin = trace_rays(*examples.setup_example(common.Cell(CELL).namelist, device="cpu"))
    assert analytic.npoints.tolist() == twin.npoints.tolist() == [393, 442]
    assert analytic.stop_flag.tolist() == twin.stop_flag.tolist() == [20, 20]
    assert compare.state_gap(twin.start_ray_vec, analytic.start_ray_vec) <= 1e-7
    assert compare.state_gap(twin.end_ray_vec, analytic.end_ray_vec) <= 1e-5
