"""Each per-layer metric reader's arithmetic on a fabricated trace."""

import pytest
import torch

from benchmark.lib import common
from benchmark.lib.device import Trace


class W:
    pass


def window(route, driver, ops, window_s, calls=2, outer=10, counters=None, event_ms=(),
           peak=0, spec=None, npoints=None):
    w = W()
    w.trace = Trace(ops=ops, host=[("aten::add", 0.0, 50.0)], t0_us=0.0, window_s=window_s)
    w.info = dict(route=route, calls=calls, work=1, outer_steps=outer, rays=4,
                  dtype="float64", counters=counters or {}, event_ms=list(event_ms),
                  peak_bytes=peak, spec=dict(spec or {}, driver=driver),
                  npoints=npoints if npoints is not None else torch.tensor([11, 11, 6, 1]))
    return w


def reader(name):
    return common.load_module(common.HERE / "metrics" / f"{name}.py")


def test_busy_is_a_union():
    tr = Trace(ops=[("a", 0.0, 10.0, False), ("b", 5.0, 10.0, False), ("c", 30.0, 5.0, True)],
               host=[("aten::mul", 14.0, 20.0)], t0_us=0.0, window_s=45e-6)
    assert tr.busy_s == pytest.approx(20e-6)
    assert [[n, round(s * 1e6)] for n, s in tr.idle_gaps()] == [
        ["aten::mul", 15], ["host, no operation", 10]]
    assert tr.top_ops(1) == [["a", pytest.approx(10e-6)]]


def test_roofline_from_profiler_and_from_events():
    count = common.count("slab_rk4_time")
    peaks = common.count("peaks.h100_sxm")
    live = 10 + 10 + 5 + 0
    bound = max(live * count["ops_per_live_step"] / peaks["flops"]["float64"],
                4 * count["bytes_per_ray"]["float64"] / peaks["bytes_per_s"])
    spec = {"kernel_count": "slab_rk4_time"}
    seen = [("slab_rk4_kernel<double>", 0.0, 2 * bound * 1e6 * 2, False)]
    w = window("kernel", "forward", seen, 1.0, calls=2, spec=spec)
    assert reader("slab_rk4_roofline").read(w) == pytest.approx(50.0)
    # the profiler missed the kernel: CUDA events per call, added to the busy time
    w = window("kernel", "forward", [], 1.0, calls=2, spec=spec,
               event_ms=[1e3 * bound * 5, 1e3 * bound * 5])
    assert reader("slab_rk4_roofline").read(w) == pytest.approx(20.0)
    assert reader("device.idle_share.fwd").read(w) == pytest.approx(100 * (1 - 10 * bound))
