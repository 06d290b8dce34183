"""The reader of ``deposition.ms_per_call.train`` on a fabricated window:
the device milliseconds of the deposition's forward and backward spans
over the traced calls, clipped to the window, with each span's device and
host time in the notes; nothing without both spans or without their
device times (a program without the spans)."""

import pytest

from benchmark.tests.test_bench_span_readers import W, rec, reader, recorded  # noqa: F401
from benchmark.lib.device import Trace

DEP = [rec("rays.trace_rays.adjoint", 1, 1, None, 5000, 5400),
       rec("rays.post.deposition", 1, 2, None, 5400, 5460, 0.05),
       rec("rays.adjoint.backward", 1, 4, None, 5600, 6200, 0.55),
       rec("rays.post.deposition.backward", 1, 3, None, 5470, 5590, 0.11),
       rec("rays.post.deposition", 2, 5, None, 6300, 6350, 0.04),
       rec("rays.post.deposition.backward", 2, 6, None, 6360, 6480, 0.12),
       rec("rays.post.deposition", 3, 7, None, 9000, 9050, 0.9)]     # after the window


def _window(recs, recorded, calls=2):  # noqa: F811
    recorded(recs)
    w = W()
    w.trace = Trace(ops=[("k", 5120.0, 170.0, False)], host=[], t0_us=5000.0, window_s=2e-3)
    w.info = dict(route="adjoint", calls=calls, outer_steps=10, spec={})
    return w


def test_deposition_ms_per_call(recorded):  # noqa: F811
    w = _window(DEP, recorded)
    # (0.05 + 0.04) + (0.11 + 0.12) ms over 2 calls
    assert reader("deposition.ms_per_call.train").read(w) == pytest.approx(0.16)
    note = w.notes[0]
    assert "rays.post.deposition: 2 spans, 0.045 ms of device and 0.055 ms of host" in note
    assert "rays.post.deposition.backward: 2 spans, 0.115 ms of device and 0.120 ms" in note


def test_deposition_nothing_without_both_spans_or_device_times(recorded):  # noqa: F811
    r = reader("deposition.ms_per_call.train")
    assert r.read(_window(DEP[:3], recorded)) is None
    assert r.read(_window([], recorded)) is None
    host_only = [rec(x.name, x.call, x.id, x.parent, x.start_ns / 1000, x.end_ns / 1000)
                 for x in DEP]
    assert r.read(_window(host_only, recorded)) is None
