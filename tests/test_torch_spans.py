"""rays_tpu_torch's span record (utils/spans.py) on the CPU.

* Off (no profiler, no ``recording()``) a span is the shared no-op and a
  ``trace_rays`` call leaves the record empty.
* Under ``recording()`` the dispatch, the graph route's loop, the
  adjoint's forward and backward, a capture, the build of a G-EQDSK's
  splines and the deposition profile's forward and backward give their
  spans: nested
  under the span open on the thread, one call id per call (the backward
  takes its forward's), self times never negative; a reused loop's two
  backwards each replay their forward under ``rays.adjoint.reforward``.
* A ``torch.profiler`` session turns the record on, and each span starts
  within 1 ms of the profiler's event of the same name (one clock).
* Results are bit for bit the same with the record on and off.
* The record keeps at most ``LIMIT`` spans and counts the rest.

The CUDA events of a device stamp are recorded only on the card
(``benchmark/`` reads them there).
"""

import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rays_tpu_torch import examples as tex
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.post import deposition
from rays_tpu_torch.tracing import fused_slab, graphed, graphed_adjoint as ga
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.utils import spans

STEPS = 10


@pytest.fixture(autouse=True)
def empty_record():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def slab():
    cfg, params, v0, st, pwr = tex.setup_example(tex.SLAB_ECH_90GHZ, device="cpu")
    return dataclasses.replace(cfg, nstep_max=STEPS), params, v0, st, pwr


@pytest.fixture(scope="module")
def damped():
    """The damped slab at ten times its step: its rays reach the resonance
    and deposit power within 40 steps."""
    text = tex.SLAB_ECH_DAMPED.replace("ds=2.5e-3", "ds=2.5e-2")
    cfg, params, v0, st, pwr = tex.setup_example(text, device="cpu")
    return dataclasses.replace(cfg, nstep_max=40, save_trajectory=True), params, v0, st, pwr


def _deposition_step(case):
    """(profile, loss, gradients of the floating leaves) of the training
    step's deposition loss on the plain route."""
    cfg, params, v0, st, pwr = case
    p = _with_grad(params)
    res = ttrace.trace_rays(cfg, p, v0, st, pwr)
    prof = deposition.calculate_deposition_profile(cfg, p, res, "Ptotal_x", n_bins=32,
                                                   xmin=-0.5, xmax=0.5)
    loss = _loss(res, pwr) + (prof.profile ** 2).sum()
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()]
    return prof.profile, loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                   materialize_grads=True)


def _with_grad(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)


def _loss(res, pwr):
    return (res.end_ray_vec[:, 0:3] ** 2 * pwr[:, None]).sum()


def _adjoint(case, loop=None):
    """(loss, results, gradients of the floating leaves) through the
    adjoint's pieces called directly."""
    cfg, params, v0, st, pwr = case
    p = _with_grad(params)
    res = ga.trace_batch_static_adjoint(cfg, p, v0, st, pwr, loop=loop)
    loss = _loss(res, pwr)
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()]
    return loss, res, torch.autograd.grad(loss, leaves)


def _named(recs, name):
    return [r for r in recs if r.name == name]


def test_off_is_the_shared_noop(slab):
    assert spans.span("rays.test") is spans.NOOP
    ttrace.trace_rays(*slab)
    assert spans.records() == [] and spans.current_call() is None


def test_plain_route_span(slab):
    with spans.recording():
        ttrace.trace_rays(*slab)
    (rec,) = spans.records()
    assert rec.name == "rays.trace_rays.plain" and rec.parent is None
    assert rec.end_ns > rec.start_ns and rec.device_ms is None
    # records() reads again without clearing
    assert spans.records() == [rec]


def test_graph_loop_span_nests(slab):
    cfg, params, v0, st, pwr = slab
    with spans.recording(), spans.span("rays.test.call"):
        graphed.trace_batch_static(cfg, params, v0, st, pwr)
    outer, loop = spans.records()
    assert loop.name == "rays.graph.replays"
    assert loop.parent == outer.id and loop.call == outer.call
    assert outer.start_ns <= loop.start_ns <= loop.end_ns <= outer.end_ns


def test_adjoint_spans_share_the_call(slab):
    with spans.recording(), spans.span("rays.test.call"):
        _adjoint(slab)
    recs = spans.records()
    (outer,) = _named(recs, "rays.test.call")
    (fwd,) = _named(recs, "rays.adjoint.forward")
    (bwd,) = _named(recs, "rays.adjoint.backward")
    assert fwd.parent == outer.id and fwd.call == outer.call
    assert bwd.call == outer.call and bwd.start_ns >= fwd.end_ns
    assert not _named(recs, "rays.adjoint.reforward")
    own = spans.self_ns(recs)
    assert all(v >= 0 for v in own.values())
    assert own[outer.id] < outer.end_ns - outer.start_ns


def test_reused_loop_reforwards_each_backward(slab):
    """Two forwards through one StaticAdjoint, then both backwards: each
    backward finds the other run's stack and replays its own forward."""
    cfg, params, v0, st, pwr = slab
    other = params._replace(eq=tree_map(lambda t: t * 1.01 if t.is_floating_point() else t,
                                        params.eq))
    loop = ga.StaticAdjoint(cfg, params, v0, st)
    with spans.recording():
        runs = []
        for p in (params, other):
            pg = _with_grad(p)
            runs.append((pg, _loss(ga.trace_batch_static_adjoint(cfg, pg, v0, st, pwr,
                                                                   loop=loop), pwr)))
        for pg, loss in runs:
            torch.autograd.grad(loss, [t for t in tree_leaves(pg) if t.is_floating_point()])
    recs = spans.records()
    re = _named(recs, "rays.adjoint.reforward")
    assert len(re) == 2
    fwd = _named(recs, "rays.adjoint.forward")
    assert len(fwd) == 4 and sum(f.parent in {r.id for r in re} for f in fwd) == 2
    assert len(_named(recs, "rays.adjoint.backward")) == 2


def test_profiler_turns_spans_on_one_clock(slab):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            ttrace.trace_rays(*slab)
    recs = spans.records()
    assert [r.name for r in recs] == ["rays.trace_rays.plain"] * 3
    assert len({r.call for r in recs}) == 3
    starts = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        starts[e.name()].append(e.start_ns())
    assert len(starts["rays.trace_rays.plain"]) == 3
    for rec, start in zip(recs, sorted(starts["rays.trace_rays.plain"])):
        assert abs(start - rec.start_ns) < 1_000_000, (start, rec.start_ns)


@pytest.mark.parametrize("path", ["plain", "graph_loop", "adjoint"])
def test_results_equal_on_and_off(slab, path):
    cfg, params, v0, st, pwr = slab

    def run():
        if path == "plain":
            return tuple(ttrace.trace_rays(cfg, params, v0, st, pwr))
        if path == "graph_loop":
            return tuple(graphed.trace_batch_static(cfg, params, v0, st, pwr))
        loss, res, grads = _adjoint(slab)
        return (loss, *res, *grads)

    off = run()
    with spans.recording():
        on = run()
    assert spans.records()
    for a, b in zip(off, on):
        assert (a is None and b is None) or torch.equal(a, b)


def test_deposition_spans_share_the_call(damped):
    """The profile's forward is ``rays.post.deposition`` under the span open
    around it; its backward ``rays.post.deposition.backward``, with the
    forward's call id, after the forward and before the gradient returns;
    the profile, the loss and every gradient bit for bit those with the
    record off."""
    off = _deposition_step(damped)
    with spans.recording(), spans.span("rays.test.call"):
        on = _deposition_step(damped)
    recs = spans.records()
    (outer,) = _named(recs, "rays.test.call")
    (fwd,) = _named(recs, "rays.post.deposition")
    (bwd,) = _named(recs, "rays.post.deposition.backward")
    (trace_span,) = _named(recs, "rays.trace_rays.plain")
    assert fwd.parent == outer.id and fwd.call == outer.call
    assert trace_span.end_ns <= fwd.start_ns < fwd.end_ns <= bwd.start_ns < bwd.end_ns
    assert bwd.call == outer.call and bwd.end_ns <= outer.end_ns
    assert spans.current_call() is None
    assert float(off[0].detach().abs().sum()) > 0.0
    for a, b in zip([off[0], off[1], *off[2]], [on[0], on[1], *on[2]]):
        assert torch.equal(a, b)


def test_deposition_off_adds_no_node(damped):
    """With the record off the profile is the chunk sum itself (no span
    node in its graph) and nothing is recorded; without gradients the
    forward span alone is recorded."""
    cfg, params, v0, st, pwr = damped
    res = ttrace.trace_rays(cfg, _with_grad(params), v0, st, pwr)
    prof = deposition.calculate_deposition_profile(cfg, params, res, "Ptotal_x", n_bins=32,
                                                   xmin=-0.5, xmax=0.5)
    assert "Gradient" not in type(prof.profile.grad_fn).__name__
    assert spans.records() == []
    with torch.no_grad():
        res = ttrace.trace_rays(*damped)
    with spans.recording():
        deposition.calculate_deposition_profile(cfg, params, res, "Ptotal_x", n_bins=32,
                                                xmin=-0.5, xmax=0.5)
    assert [r.name for r in spans.records()] == ["rays.post.deposition"]


def test_kernel_launch_span(slab):
    """The library call of ``run_library`` (here the host build of the
    kernel body) is the span ``rays.kernel.launch``, results unchanged."""
    cfg, params, v0, st, pwr = slab
    lib = fused_slab.load_host_libraries()[fused_slab._variant(cfg)]
    off = fused_slab.run_library(lib, cfg, params, v0, st, pwr)
    with spans.recording():
        on = fused_slab.run_library(lib, cfg, params, v0, st, pwr)
    assert [r.name for r in spans.records()] == ["rays.kernel.launch"]
    for a, b in zip(off, on):
        assert (a is None and b is None) or torch.equal(a, b)


def test_capture_span_on_a_miss_only(monkeypatch):
    monkeypatch.setattr(graphed, "_CACHE", collections.OrderedDict())

    class Entry:
        def release(self):
            pass

    with spans.recording():
        first = graphed.get_or_capture(("test",), Entry)
        assert graphed.get_or_capture(("test",), Entry) is first
    assert [r.name for r in spans.records()] == ["rays.graph.capture"]


def test_eq_build_span(tmp_path):
    """The G-EQDSK read and the spline and cell-table builds run inside
    ``rays.eq.build``, one span a build; the tables are the same with the
    record on and off."""
    from rays_tpu_torch.models import axisym_toroid as tat

    tex.write_eqdsk_toroid_example(tmp_path, n=17)
    path = tmp_path / "solovev.geqdsk"
    off, _ = tat.build_eqdsk_mag_params(path)
    assert spans.records() == []
    with spans.recording(), spans.span("rays.test.setup"):
        on, _ = tat.build_eqdsk_mag_params(path)
    outer, rec = spans.records()
    assert rec.name == "rays.eq.build" and rec.parent == outer.id and rec.device_ms is None
    assert outer.start_ns <= rec.start_ns < rec.end_ns <= outer.end_ns
    assert torch.equal(on.psi_cells.cells, off.psi_cells.cells)


def test_call_ids_and_parents():
    with spans.recording():
        with spans.span("a") as a:
            assert spans.current_call() == a.call
            with spans.span("b") as b:
                pass
            with spans.span("c", call=-7) as c:
                pass
        with spans.span("d") as d:
            pass
    assert (b.parent, b.call) == (a.id, a.call)
    assert (c.parent, c.call) == (a.id, -7)
    assert d.parent is None and d.call != a.call
    assert spans.current_call() is None


def test_a_span_closes_when_its_body_raises():
    with spans.recording():
        with pytest.raises(ValueError):
            with spans.span("a"):
                raise ValueError("inside")
    (rec,) = spans.records()
    assert rec.end_ns >= rec.start_ns and spans.current_call() is None


def test_record_stops_at_its_bound(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    with spans.recording():
        with spans.span("top") as top:
            for _ in range(4):
                with spans.span("child") as child:
                    pass
    recs = spans.records()
    assert [r.name for r in recs] == ["top", "child", "child"]
    assert spans.dropped == 2
    # a span not kept still passes its call on
    assert child.call == top.call
    spans.clear()
    assert spans.records() == [] and spans.dropped == 0


def test_self_time_takes_the_union_of_children():
    R = spans.Record
    recs = [R("p", 1, 1, None, 0, 100), R("a", 1, 2, 1, 10, 30), R("b", 1, 3, 1, 20, 40),
            R("c", 1, 4, 1, 90, 120), R("d", 1, 5, 2, 12, 14)]
    own = spans.self_ns(recs)
    assert own == {1: 100 - 30 - 10, 2: 18, 3: 20, 4: 30, 5: 2}
