"""The four span readers' arithmetic on a fabricated window: hand-made
device intervals and span records (``rays_tpu_torch/utils/spans.py``'s
``Record``), the idle time inside and outside the spans, clipping to the
window, and nothing off the route or from a program without the record."""

import sys

import pytest
import torch

import rays_tpu_torch.utils
from benchmark.lib import common
from benchmark.lib.device import Trace
from rays_tpu_torch.utils import spans

R = spans.Record
US = 1000   # ns


class W:
    pass


def window(route, driver, ops, t0_us, window_s, outer=10, spec=None):
    w = W()
    w.trace = Trace(ops=ops, host=[], t0_us=t0_us, window_s=window_s)
    w.info = dict(route=route, calls=1, work=1, outer_steps=outer, rays=4, dtype="float64",
                  counters={}, event_ms=[], peak_bytes=0, spec=dict(spec or {}, driver=driver),
                  npoints=torch.tensor([11, 11, 6, 1]))
    return w


def reader(name):
    return common.load_module(common.HERE / "metrics" / f"{name}.py")


def rec(name, call, id_, parent, start_us, end_us, device_ms=None):
    return R(name, call, id_, parent, int(start_us * US), int(end_us * US), device_ms)


@pytest.fixture
def recorded(monkeypatch):
    """Set the records the readers find."""
    def put(recs):
        monkeypatch.setattr(spans, "records", lambda: list(recs))
    return put


def _scan(recs, recorded, route="kernel", kernel="slab_rk4_kernel<double>"):
    recorded(recs)
    ops = [(kernel, 1300.0, 500.0, False),
           ("Memcpy DtoH (Device -> Pageable)", 1100.0, 20.0, True)]
    return window(route, "forward", ops, 1000.0, 1e-3, spec={"kernel_count": "slab_rk4_time"})


SCAN = [rec("rays.trace_rays.kernel", 1, 1, None, 900, 1040),     # clipped to 1000-1040
        rec("rays.trace_rays.kernel", 2, 2, None, 1050, 1310),
        rec("rays.kernel.prepare", 2, 3, 2, 1060, 1305),
        rec("rays.kernel.launch", 2, 4, 3, 1290, 1300),
        rec("rays.trace_rays.kernel", 3, 5, None, 2100, 2200)]    # after the window


def test_dispatch_idle_inside_the_spans(recorded):
    w = _scan(SCAN, recorded)
    # spans 1000-1040 and 1050-1310 (300 us); the device ran 1100-1120 and 1300-1310
    assert reader("dispatch.idle_share.fwd").read(w) == pytest.approx(27.0)
    assert reader("device.idle_share.fwd").read(w) == pytest.approx(48.0)
    note = w.notes[0]
    assert "2 rays.trace_rays.kernel spans" in note
    assert "rays.kernel.prepare 117.5 us" in note and "rays.kernel.launch 5.0 us" in note


def test_dispatch_nothing_off_the_route_or_without_the_kernel(recorded):
    assert reader("dispatch.idle_share.fwd").read(_scan(SCAN, recorded, route="graph")) is None
    assert reader("dispatch.idle_share.fwd").read(_scan(SCAN, recorded, kernel="other")) is None
    assert reader("dispatch.idle_share.fwd").read(_scan(SCAN[4:], recorded)) is None


ADJ = [rec("rays.trace_rays.adjoint", 1, 1, None, 5000, 5400),
       rec("rays.adjoint.forward", 1, 2, 1, 5100, 5300, 0.18),
       rec("rays.adjoint.reforward", 1, 3, None, 5500, 5590, 0.07),
       rec("rays.adjoint.forward", 1, 4, 3, 5510, 5580, 0.06),
       rec("rays.adjoint.backward", 1, 5, None, 5600, 6200, 0.55),
       rec("rays.adjoint.backward", 2, 6, None, 4000, 4900, 0.5)]   # before the window
ADJ_OPS = [("k", 5120.0, 170.0, False), ("k", 5520.0, 50.0, False), ("k", 5610.0, 540.0, False)]


def _grad(recs, recorded, route="adjoint"):
    recorded(recs)
    return window(route, "endpoint_grad", ADJ_OPS, 5000.0, 2e-3, outer=10)


def test_adjoint_ms_per_step(recorded):
    w = _grad(ADJ, recorded)
    # the reforward's forward counts: (0.18 + 0.06) ms over 2 x 10 steps
    assert reader("adjoint.forward_ms_per_step").read(w) == pytest.approx(0.012)
    assert reader("adjoint.backward_ms_per_step").read(w) == pytest.approx(0.055)
    assert "2 rays.adjoint.forward spans" in w.notes[0]


def test_adjoint_replay_idle_and_gaps(recorded):
    w = _grad(ADJ, recorded)
    # loops 5100-5300, 5500-5590, 5600-6200 (890 us), 760 us of them busy
    assert reader("adjoint.replay_idle_share").read(w) == pytest.approx(6.5)
    assert reader("device.idle_share.train").read(w) == pytest.approx(62.0)
    gaps = w.notes[-1]
    assert "0.130 ms idle" in gaps and "0 captures" in gaps
    assert ("0.850 ms in rays.adjoint.backward; 0.230 ms in rays.adjoint.forward; "
            "0.120 ms in rays.trace_rays.adjoint") in gaps
    assert "1 reforwards, 0.070 ms of device" in w.notes[0]


def test_adjoint_nothing_off_the_route_or_without_device_times(recorded):
    for name in ("adjoint.forward_ms_per_step", "adjoint.backward_ms_per_step",
                 "adjoint.replay_idle_share"):
        assert reader(name).read(_grad(ADJ, recorded, route="kernel")) is None
        assert reader(name).read(_grad(ADJ[:1], recorded)) is None
    host_only = [rec(r.name, r.call, r.id, r.parent, r.start_ns / US, r.end_ns / US)
                 for r in ADJ]
    assert reader("adjoint.forward_ms_per_step").read(_grad(host_only, recorded)) is None


def test_a_program_without_the_record(monkeypatch, recorded):
    """The parent program has no span record: every reader gives nothing."""
    scan, grad = _scan(SCAN, recorded), _grad(ADJ, recorded)
    monkeypatch.delattr(rays_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "rays_tpu_torch.utils.spans", None)
    assert reader("dispatch.idle_share.fwd").read(scan) is None
    for name in ("adjoint.forward_ms_per_step", "adjoint.backward_ms_per_step",
                 "adjoint.replay_idle_share"):
        assert reader(name).read(grad) is None
