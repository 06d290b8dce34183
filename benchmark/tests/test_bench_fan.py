"""The traffic's fan: both sides read it from the same namelist text, and
every seed gives other rays over the same range, with the same count and
spacing."""

import numpy as np

from benchmark.lib import common, inputs
from benchmark.reference import namelist


def _scan(seed):
    cell = common.Cell("slab_ech.scan")
    return namelist.parse(inputs.namelist_text(cell, seed)), cell.traffic


def test_the_fan_covers_the_range():
    nml, traffic = _scan(2147483729)
    assert nml["ray_init_list"]["nray_max"] == traffic["rays"]
    rays = 1
    for axis in traffic["scan"]:
        g = nml[axis["group"]]
        n, start, step = g[axis["count"]], g[axis["start"]], g[axis["step"]]
        lo, hi = axis["range"]
        assert n == axis["n"] and step == (hi - lo) / n
        assert lo <= start < lo + step and start + (n - 1) * step < hi
        rays *= n
    assert rays == traffic["rays"]


def test_seeds_give_other_rays_of_the_same_spacing():
    a, traffic = _scan(1)
    b, _ = _scan(2)
    c, _ = _scan(1)
    for axis in traffic["scan"]:
        ga, gb, gc = a[axis["group"]], b[axis["group"]], c[axis["group"]]
        assert ga[axis["start"]] != gb[axis["start"]]
        assert ga[axis["start"]] == gc[axis["start"]]
        assert np.isclose(ga[axis["step"]], gb[axis["step"]], rtol=0, atol=0)
