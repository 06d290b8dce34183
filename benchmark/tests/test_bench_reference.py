"""The plain reference against the program's plain route on the CPU, at
a few rays of the cells' fan: the launch, the trace to the cell's steps,
and the derivative step's loss and gradients."""

import torch

from benchmark.lib import common, compare, inputs
from benchmark.reference import rays_plain
from benchmark.tests.sizes import shrink


def _cell(counts, steps, name="slab_ech.scan"):
    cell = common.Cell(name)
    shrink(cell, counts, steps)
    return cell


def test_launch_matches_the_program():
    from rays_tpu_torch import examples

    cell = _cell((8, 4), 500)
    text = inputs.namelist_text(cell, 2147483711)
    _, _, v0, _, _ = examples.setup_example(text, device="cpu")
    ref, pwr = rays_plain.launch_slab(rays_plain.build_case(text))
    assert v0.shape[0] == 32
    assert compare.state_gap(v0, ref) <= 1e-15
    assert torch.allclose(pwr, torch.full((32,), 1.0 / 32, dtype=torch.float64))


def test_forward_matches_the_program():
    from rays_tpu_torch.tracing import trace

    cell = _cell((3, 2), 500)
    cfg, params, v_base, v0, st, pwr = inputs.program(cell, 5, "cpu", lambda _: _Null())
    res = trace.trace_rays(cfg, params, v0, st, pwr)
    ref = cell.driver.reference(cell, 5, "cpu", torch.float64)
    assert torch.equal(res.npoints, ref["npoints"]) and torch.equal(res.stop_flag, ref["stop"])
    # 500 steps through the cutoff's turning point: rounding grows to ~1e-12
    assert compare.state_gap(res.end_ray_vec, ref["end"]) <= 1e-11
    assert float((res.max_residuals - ref["max_res"]).abs().max()) <= 1e-12


def test_gradient_matches_the_program():
    cell = _cell((2, 2), 60, "slab_ech.grad")
    drv = cell.driver.Driver(cell, 9, "cpu", lambda _: _Null())
    prog = drv.answer(drv.keep(drv.call()))
    ref = cell.driver.reference(cell, 9, "cpu", torch.float64)
    values = compare.numbers(prog, ref, ["loss_gap", "grad_gap", "end_gap"])
    assert values["loss_gap"] <= 1e-13 and values["grad_gap"] <= 1e-11
    assert values["end_gap"] <= 1e-13
    assert sum(float(g.abs().sum()) > 0 for g in ref["grads"].values()) >= 8


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
