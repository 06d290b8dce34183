"""The step kernel reader on a fabricated window: the share of outer steps
whose forward a hand-written step kernel ran, from the program's counters,
with a module the program lacks counted as 0 and nothing off the route or
before a replay."""

import sys
import types

import pytest

from benchmark.tests.test_bench_span_readers import ADJ, reader, recorded, window  # noqa: F401
from benchmark.tests.test_bench_spline_readers import OPS

GA = "rays_tpu_torch.tracing.graphed_adjoint"
SLAB = "rays_tpu_torch.tracing.slab_vjp"
EQDSK = "rays_tpu_torch.tracing.eqdsk_step"


def _w(recorded, route="adjoint"):
    recorded(ADJ)
    return window(route, "endpoint_grad", OPS, 4900.0, 2e-3, outer=10)


def test_step_kernel_share(monkeypatch, recorded):
    r = reader("adjoint.step_kernel_share")
    monkeypatch.setitem(sys.modules, GA, types.SimpleNamespace(REPLAYS=1000, WARMUP=3,
                                                              CAPTURES=1))
    monkeypatch.setitem(sys.modules, SLAB, types.SimpleNamespace(STEP_LAUNCHES=0))
    # a kernel run: 500 outer steps (a step and a VJP replay each) after one
    # capture's 3 warm-up steps, each forward step one launch of the EQDSK
    # step: exactly 100
    monkeypatch.setitem(sys.modules, EQDSK, types.SimpleNamespace(STEP_LAUNCHES=503))
    w = _w(recorded)
    assert r.read(w) == 100.0
    assert "eqdsk_step 503" in w.notes[-1] and "slab_vjp 0" in w.notes[-1]
    assert "503 outer steps" in w.notes[-1] and "3 warm-up steps" in w.notes[-1]
    # the slab step's launches count alike
    monkeypatch.setitem(sys.modules, SLAB, types.SimpleNamespace(STEP_LAUNCHES=503))
    monkeypatch.setitem(sys.modules, EQDSK, types.SimpleNamespace(STEP_LAUNCHES=0))
    assert r.read(_w(recorded)) == 100.0
    # a run whose forward fell back to the generic piece on half its steps
    # reads below 100
    monkeypatch.setitem(sys.modules, SLAB, types.SimpleNamespace(STEP_LAUNCHES=253))
    assert r.read(_w(recorded)) == pytest.approx(100.0 * 253 / 503)
    # a program without the warm-up counters: the replays alone
    monkeypatch.setitem(sys.modules, GA, types.SimpleNamespace(REPLAYS=1000))
    monkeypatch.setitem(sys.modules, SLAB, types.SimpleNamespace(STEP_LAUNCHES=500))
    assert r.read(_w(recorded)) == 100.0


def test_step_kernel_share_without_the_module(monkeypatch, recorded):
    """A program without the EQDSK step (the generic forward): 0."""
    r = reader("adjoint.step_kernel_share")
    monkeypatch.setitem(sys.modules, GA, types.SimpleNamespace(REPLAYS=1000, WARMUP=3,
                                                              CAPTURES=1))
    monkeypatch.setitem(sys.modules, SLAB, types.SimpleNamespace(STEP_LAUNCHES=0))
    monkeypatch.delitem(sys.modules, EQDSK, raising=False)
    w = _w(recorded)
    assert r.read(w) == 0.0
    assert "eqdsk_step 0" in w.notes[-1]
    # nor a slab module, nor a counter in it
    monkeypatch.setitem(sys.modules, SLAB, types.SimpleNamespace())
    assert r.read(_w(recorded)) == 0.0


def test_step_kernel_share_off_the_route(monkeypatch, recorded):
    r = reader("adjoint.step_kernel_share")
    monkeypatch.setitem(sys.modules, GA, types.SimpleNamespace(REPLAYS=1000))
    monkeypatch.setitem(sys.modules, EQDSK, types.SimpleNamespace(STEP_LAUNCHES=500))
    assert r.read(_w(recorded, route="kernel")) is None
    assert r.read(_w(recorded, route="graph")) is None
    # before any replay, and without the adjoint module
    monkeypatch.setitem(sys.modules, GA, types.SimpleNamespace(REPLAYS=0))
    assert r.read(_w(recorded)) is None
    monkeypatch.delitem(sys.modules, GA)
    assert r.read(_w(recorded)) is None
