"""The control, the plain reference in float32 put in the program's
place, fails each cell's limits at a size a test run can hold; the
float64 reference passes them."""

import pytest

from benchmark import control
from benchmark.lib import common, compare

from benchmark.tests.sizes import shrink

SIZES = {"slab_ech.scan": ((4, 2), 500), "slab_ech.grad": ((2, 2), 60)}


@pytest.mark.parametrize("cell", list(SIZES))
def test_float32_control_fails_the_limits(cell):
    counts, steps = SIZES[cell]
    values = control.readings(cell, 2147483693, "cpu", lambda c: shrink(c, counts, steps))
    ok, checks = compare.judge(values, common.Cell(cell).spec["limits"])
    assert not ok, checks
