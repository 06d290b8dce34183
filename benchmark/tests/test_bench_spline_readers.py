"""The two spline readers on a fabricated window: the evaluations a step
from the program's counters, and the device time of the table's gathers
and scatter-adds inside the adjoint's replay loops, with nothing off the
route, without the counter, the spans or the kernels."""

import sys
import types

import pytest

from benchmark.tests.test_bench_span_readers import ADJ, R, US, reader, rec, window

# the kernels' names on the card (PyTorch 2.11, as profiled on one H100)
GATHER = "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long)"
GATHER_ROWS = ("void at::native::(anonymous namespace)::indexSelectLargeIndex<double, long, "
               "unsigned int, 2, 2, -2, true>(at::cuda::detail::TensorInfo<double, unsigned int>)")
SCATTER = ("void at::native::indexFuncLargeIndex<double, long, unsigned int, 2, 2, -2, true, "
           "at::native::(anonymous namespace)::ReduceAdd>(at::cuda::detail::TensorInfo<double>)")
STACK = ("void at::native::(anonymous namespace)::indexSelectSmallIndex<double, long, unsigned int, "
         "2, 2, -2>(at::cuda::detail::TensorInfo<double, unsigned int>)")
OPS = [(GATHER, 4990.0, 7.0, False),            # before the first replay loop: the initial carry's
       (GATHER, 5120.0, 20.0, False), (STACK, 5150.0, 1.0, False),
       (GATHER_ROWS, 5520.0, 10.0, False), ("k", 5530.0, 40.0, False),
       (SCATTER, 5610.0, 30.0, False), (SCATTER, 6300.0, 4.0, False),   # after the backward
       ("Memcpy DtoD (Device -> Device) index", 5700.0, 5.0, True)]


@pytest.fixture
def recorded(monkeypatch):
    from rays_tpu_torch.utils import spans

    def put(recs):
        monkeypatch.setattr(spans, "records", lambda: list(recs))
    return put


def _w(recs, recorded, route="adjoint", ops=OPS):
    recorded(recs)
    return window(route, "endpoint_grad", ops, 4900.0, 2e-3, outer=10)


def test_gather_ms_per_step(recorded):
    build = R("rays.eq.build", 9, 99, None, 100 * US, 2600 * US)
    w = _w(ADJ + [build], recorded)
    # gathers 20 + 10 us, scatter-adds 30 + 4 us, from 5100 us on (not the
    # one-row stack read); the
    # forward spans (one of them a reforward's) took 2 x 10 steps
    assert reader("spline.gather_ms_per_step.train").read(w) == pytest.approx(0.064 / 20)
    note = w.notes[-1]
    assert "vectorized_gather_kernel 1 kernels 0.020 ms" in note
    assert "indexSelectLargeIndex 1 kernels 0.010 ms" in note
    assert "indexFuncLargeIndex 2 kernels 0.034 ms" in note
    assert "indexSelectSmallIndex" in note and "20 steps" in note
    assert "rays.eq.build host ms: 2.500" in note


def test_gather_nothing_off_the_route_or_without_spans_or_kernels(recorded):
    r = reader("spline.gather_ms_per_step.train")
    assert r.read(_w(ADJ, recorded, route="kernel")) is None
    assert r.read(_w(ADJ[:1], recorded)) is None
    w = _w(ADJ, recorded, ops=[o for o in OPS if o[0] == STACK or o[0] == "k" or o[3]])
    assert r.read(w) is None
    assert "not recorded" in w.notes[-1] and "indexSelectSmallIndex 1 kernels" in w.notes[-1]


def test_evals_per_step(monkeypatch, recorded):
    sp = types.SimpleNamespace(REPLAYED_EVALS=2500, EVALS=31)
    ga = types.SimpleNamespace(REPLAYS=1000)
    monkeypatch.setitem(sys.modules, "rays_tpu_torch.ops.splines", sp)
    monkeypatch.setitem(sys.modules, "rays_tpu_torch.tracing.graphed_adjoint", ga)
    r = reader("spline.evals_per_step.train")
    w = _w(ADJ, recorded)
    # 500 outer steps (a step and a VJP replay each), 2,500 evaluations
    assert r.read(w) == pytest.approx(5.0)
    assert "2500 cell-spline evaluations" in w.notes[-1]
    assert r.read(_w(ADJ, recorded, route="graph")) is None
    ga.REPLAYS = 0
    assert r.read(_w(ADJ, recorded)) is None
    monkeypatch.setitem(sys.modules, "rays_tpu_torch.ops.splines", types.SimpleNamespace())
    ga.REPLAYS = 1000
    assert r.read(_w(ADJ, recorded)) is None
