"""The captured tracers' shared cache (``graphed.get_or_capture``) on the
CPU, with stand-in entries in place of captured graphs.

* Eviction: the cache keeps CACHE_SIZE entries; a hit marks its entry most
  recently used and builds nothing; a miss evicts and releases the least
  recently used entry first; a build that raises leaves no entry.
* The graphed adjoint's backward never finds its entry gone: a backward
  after five other entries went in, and one loss summed over five
  configurations (five cache keys for four places), ask the cache again
  and capture the evicted entry anew.  Their gradients equal eager
  autograd's through ``trace_batch`` (GRAD_RTOL of each leaf's scale).
  Here an entry's loop runs its pieces directly, as the static twin does;
  on the card ``chip_smoke.py`` phase 33 runs the same programs through
  the captured graphs.
* The key names the equilibrium model object: a module registered anew
  under an old name gets a key of its own.
* An entry keeps the cell-spline evaluations that each piece's capture
  ran, and a replay adds them to ``ops/splines.REPLAYED_EVALS`` without
  running one.
"""

import collections
import dataclasses
import types

import pytest
import torch

from rays_tpu_torch import examples as tex
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.models import slab as tslab
from rays_tpu_torch.tracing import graphed, graphed_adjoint as ga
from rays_tpu_torch.tracing import trace as ttrace

N_RAYS = 6
STEPS = 12
GRAD_RTOL = 1e-12       # float64: of each leaf's largest eager gradient


class StandIn:
    """A cache entry without graphs: a loop whose pieces are called
    directly, and a record of its release."""

    def __init__(self, loop=None):
        self.loop, self.released = loop, False

    def release(self):
        self.loop, self.released = None, True


@pytest.fixture
def cache(monkeypatch):
    """A fresh, empty cache for the test."""
    fresh = collections.OrderedDict()
    monkeypatch.setattr(graphed, "_CACHE", fresh)
    return fresh


@pytest.fixture(scope="module")
def case():
    cfg, params, v0, st, pwr = tex.setup_example(tex.SLAB_ECH_DAMPED, device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=STEPS, save_trajectory=True)
    return (cfg, params, *tex.replicate_rays(v0, st, pwr, N_RAYS))


def test_eviction_order(cache):
    made = []

    def make(name):
        def build():
            made.append(name)
            return StandIn()
        return build

    entries = {k: graphed.get_or_capture(k, make(k)) for k in range(graphed.CACHE_SIZE)}
    assert list(cache) == list(range(graphed.CACHE_SIZE)) and made == list(entries)
    # a hit builds nothing and marks its entry most recently used
    assert graphed.get_or_capture(0, make("again")) is entries[0]
    assert made == list(entries) and list(cache)[-1] == 0
    # a miss evicts the least recently used entry (now 1) and releases it
    graphed.get_or_capture("new", make("new"))
    assert len(cache) == graphed.CACHE_SIZE and 1 not in cache and "new" in cache
    assert entries[1].released and not any(e.released for k, e in entries.items() if k != 1)
    # an evicted key is built anew on its next use
    graphed.get_or_capture(1, make(1))
    assert made[-1] == 1 and entries[2].released


def test_a_failing_build_leaves_no_entry(cache):
    def refuse():
        raise ValueError("refused")

    with pytest.raises(ValueError, match="refused"):
        graphed.get_or_capture("bad", refuse)
    assert "bad" not in cache
    graphed.get_or_capture("good", StandIn)
    assert list(cache) == ["good"]


def _cached_adjoint(cfg, params, v0, st, pwr, made):
    """trace_rays' adjoint route on the CPU: GraphedSteps asks the cache
    for its entry in the forward and again in the backward, and a missing
    entry is built anew (a StaticAdjoint behind a stand-in entry)."""
    key = ("adjoint", *graphed.cache_key(cfg, params, v0))
    held = (tree_map(torch.Tensor.detach, params), v0.detach(), st)

    def make():
        made.append(cfg.nstep_max)
        return StandIn(ga.StaticAdjoint(cfg, *held))

    return ga.trace_adjoint(cfg, params, v0, st, pwr,
                            lambda: (graphed.get_or_capture(key, make).loop, None))


def _with_grad(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)


def _loss(res):
    return (res.end_ray_vec[:, :6] ** 2).sum() + res.ray_vec.sum() + res.max_residuals.sum()


def _grads(loss, params):
    return torch.autograd.grad(loss, [t for t in tree_leaves(params) if t.is_floating_point()],
                               allow_unused=True, materialize_grads=True)


def _assert_grads_close(got, ref):
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = float(r.abs().max()) if r.numel() else 0.0
        err = float((g - r).abs().max()) if r.numel() else 0.0
        assert err <= GRAD_RTOL * scale, (i, err, scale)
    assert sum(bool(r.abs().max() > 0) for r in ref if r.numel()) >= 5


def test_backward_after_five_other_entries(cache, case):
    """A forward with gradients, five other entries (no-grad runs of other
    configs), then the backward: the evicted entry is built anew, replays
    its forward from the saved inputs, and the gradients are eager's."""
    cfg, params, v0, st, pwr = case
    made = []
    p = _with_grad(params)
    loss = _loss(_cached_adjoint(cfg, p, v0, st, pwr, made))
    first = graphed._CACHE[next(iter(cache))]
    for i in range(5):
        graphed.get_or_capture(("graph", i), StandIn)
    assert made == [STEPS] and first.released and len(cache) == graphed.CACHE_SIZE
    grads = _grads(loss, p)
    assert made == [STEPS, STEPS]       # built anew by the backward
    q = _with_grad(params)
    ref_loss = _loss(ttrace.trace_batch(cfg, q, v0, st, pwr))
    assert torch.equal(loss.detach(), ref_loss.detach())
    _assert_grads_close(grads, _grads(ref_loss, q))


def test_loss_summed_over_five_configs(cache, case):
    """One loss over five step counts (five keys for CACHE_SIZE places):
    the first forward's entry is evicted by the fifth, and the backward,
    last run first, builds it anew once."""
    cfg, params, v0, st, pwr = case
    steps = [STEPS + i for i in range(5)]
    assert len(steps) > graphed.CACHE_SIZE
    made = []
    p, q = _with_grad(params), _with_grad(params)
    loss = sum(_loss(_cached_adjoint(dataclasses.replace(cfg, nstep_max=n), p, v0, st, pwr,
                                     made)) for n in steps)
    ref = sum(_loss(ttrace.trace_batch(dataclasses.replace(cfg, nstep_max=n), q, v0, st, pwr))
              for n in steps)
    grads = _grads(loss, p)
    assert made == steps + [steps[0]]
    assert torch.equal(loss.detach(), ref.detach())
    _assert_grads_close(grads, _grads(ref, q))


def test_the_key_names_the_model_object(case):
    """A module registered under a name (even a built-in one) keys its own
    entries: registering another module under the same name never finds
    the old one's graphs; the same module finds them again."""
    cfg, params, v0, _, _ = case
    builtin = graphed.cache_key(cfg, params, v0)
    first = types.SimpleNamespace(fields=tslab.fields, geom_err=tslab.geom_err, err=tslab.err)
    second = types.SimpleNamespace(fields=tslab.fields, geom_err=tslab.geom_err, err=tslab.err)
    keys = []
    try:
        for model in (first, second, first, tslab):
            tbase.register_eq_model("slab", model)
            keys.append(graphed.cache_key(cfg, params, v0))
    finally:
        tbase.EQ_MODELS.pop("slab")
    assert keys[0] != keys[1] and keys[0] == keys[2] and keys[0] != builtin
    assert len({hash(k) for k in keys[:2]}) == 2
    # the built-in module under its own name is the same model
    assert keys[3] == builtin == graphed.cache_key(cfg, params, v0)


def test_the_adjoint_captures_without_autograd_history(monkeypatch, case):
    """``graphed_adjoint.capture`` makes its entry under no_grad, as a run's
    forward runs: a warm-up step under grad mode would record autograd
    history into the static buffers, and the VJP piece after it would
    find its saved views overwritten.  A stand-in for ``graphed.Captured``
    runs the warm-up (step and VJP, twice) as the real one does."""
    cfg, params, v0, st, _ = case
    seen = []

    class WarmUp:
        def __init__(self, loop, load, warmup=1):
            seen.append(torch.is_grad_enabled())
            load()
            for _ in range(2):
                for fn in loop.functions().values():
                    fn()
            load()
            self.loop = loop

    monkeypatch.setattr(graphed, "Captured", WarmUp)
    before = ga.CAPTURES
    entry = ga.capture(cfg, _with_grad(params), v0, st)
    assert seen == [False] and ga.CAPTURES == before + 1
    assert not any(t.requires_grad for t in (*entry.loop.carry, *entry.loop.stack))


def test_a_replay_adds_the_spline_evaluations_its_capture_ran(tmp_path):
    """``ops/splines.EVALS`` counts the cell-spline evaluations that Python
    runs.  The EQDSK adjoint's pieces, called once as a capture calls them,
    run 4 each: the step's three RK4 stages and its new point, and the
    VJP's recompute of that step.  An entry whose graphs are stand-ins
    (``graphed.Captured`` with those counts) adds them to
    ``REPLAYED_EVALS`` at each replay and runs no evaluation."""
    from rays_tpu_torch import run as trun
    from rays_tpu_torch.ops import splines

    cfg, params, v0, st, _ = trun.setup(tex.write_eqdsk_toroid_example(tmp_path, n=17),
                                        device="cpu")
    cfg = dataclasses.replace(cfg, nstep_max=3, save_trajectory=False)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()),
                      params)
    loop = ga.StaticAdjoint(cfg, params, v0, st)
    with torch.no_grad():
        carry = ttrace.initial_carry(cfg, params, v0, st)
        loop.load_inputs(carry, [t for t in tree_leaves(params) if t.is_floating_point()])
        counts = {}
        for name, fn in loop.functions().items():
            before = splines.EVALS
            fn()
            counts[name] = splines.EVALS - before
    assert counts == {"step": 4, "vjp": 4}

    entry = graphed.Captured.__new__(graphed.Captured)
    entry.device = -1                       # no CUDA device to switch to
    entry.graphs = {name: types.SimpleNamespace(replay=lambda: None) for name in counts}
    entry.spline_evals = counts
    evals, replayed = splines.EVALS, splines.REPLAYED_EVALS
    for name in ("step", "step", "step", "vjp", "vjp", "vjp"):
        entry.launch(name)
    assert splines.EVALS == evals
    assert splines.REPLAYED_EVALS == replayed + 3 * (4 + 4)
