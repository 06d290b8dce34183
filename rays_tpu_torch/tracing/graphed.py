"""The graphed tracer: ``trace_batch``'s outer step captured once per
configuration as a CUDA graph and replayed, the counterpart of the JAX
package's compiled tracer (``rays_tpu/tracing/trace.py:113-122``: one
``jax.jit`` per config in an ``lru_cache``, the step loop a device
``lax.scan``, the substeps a device ``lax.while_loop``).

Eager PyTorch issues every operation of a step from the host: 1,200 to
3,100 small kernels per outer step at 32,768 rays, each a few
microseconds of device work behind 10-19 microseconds of host work, so
the card idles most of a step.  A CUDA graph holds the step's kernels
and launches them with one call.

``trace_rays`` sends here every config that the slab kernel's gate
refuses, on a CUDA device without derivatives (``trace.route``): Solovev
under RK4 and SG, the EQDSK tokamak, the mirror, the slab under SG, the
equilibrium-gradient slots, the autodiff derivatives, the compensated
carry, in float32 and float64, and a model of the caller's own
(``models.base.register_eq_model``).  With reverse-mode gradients the
same step goes to the graphed adjoint (tracing/graphed_adjoint.py), with
forward-mode tangents to the tangent graph (tracing/graphed_tangent.py);
both build on ``StaticLoop`` and share this module's cache.  A capture or
a replay that fails raises; nothing falls back to the eager loop.

How a run goes (``StaticLoop``):

* Static buffers hold everything a graph reads: every ``Params`` leaf
  (the spline tables included), the carry, the step index (a 0-d float
  tensor: ``step`` computes s = k ds from it) and, with
  ``cfg.save_trajectory``, the (B, nstep_max + 1, nv) trajectory and
  (B, nstep_max + 1) residual, written at the device index k + 1.  Each
  call copies the caller's tensors in, so a call with other values of the
  same shapes gets its own answer; the results are copied out.
* The initial check (``trace.initial_carry``) and the results assembly
  run eagerly, once per call.
* RK4 and the SG stepper's fixed budget (``sg_scan_substeps > 0``): one
  graph holds one whole outer step (``trace.step``); it is replayed
  ``nstep_max`` times with no host read.
* The SG substep loop (``sg_scan_substeps == 0``) runs until no ray is
  live, which the host must read.  Three graphs: the head of the step
  with the first ``CHUNK`` masked passes, a chunk of ``CHUNK`` passes,
  and the tail.  After the head and after each chunk the host reads one
  "any ray live" flag.  A pass in which no ray is live changes nothing
  (``rk45.substep_pass`` keeps the old carry of every ray whose
  condition is false), so the result is bit for bit the eager loop's.

``CHUNK`` is 1: most outer steps need one pass, and a pass is 3.3-5.0 ms
of device work at 32,768 rays in float64 on an H100, where a read and the
next graph's launch leave the card idle for 0.7-1.6 ms, so a pass wasted
at the end of a step costs more than the reads it saves.

The cache (``get_or_capture``) is keyed by the kind of entry, the config,
the equilibrium model object itself (so that a module registered anew
under an old name is captured anew), the batch shape, dtype and device,
the shapes and dtypes of the Params leaves, and whether ``rk45.stats`` is
counting.  Each entry pins a private memory pool and its static buffers
(with trajectories about 1 GB at 32,768 rays x 500 steps in float64), so
the cache holds ``CACHE_SIZE`` entries of the three kinds together, not
the JAX package's 64; the least recently used entry is evicted, its
graphs reset and its pool returned to the card.  Nothing keeps an
evicted entry: a graphed adjoint's backward whose entry went is captured
again through the cache (tracing/graphed_adjoint.py).  Each process keeps
its own cache (``parallel/sharded.py`` calls ``trace_rays`` in each).

Before the first capture of an entry whose model is the caller's own,
each piece runs once eagerly under the audits of
tracing/capture_audit.py; a piece that reads the host, copies across
devices or makes an autograd node whose backward reads the host is
refused with a ValueError naming the model, and nothing is captured.

``CAPTURES`` counts the configurations captured, ``REPLAYS`` the graph
replays; plain ints, like ``fused_slab.LAUNCHES``.  A cache entry keeps
the spline evaluations that each piece's capture ran
(``ops/splines.EVALS``), and each replay adds them to
``splines.REPLAYED_EVALS``.  The spans of
utils/spans.py: ``rays.graph.capture`` around each capture (warm-up and
audit included), ``rays.graph.replays`` around a run's loop of replays.
``trace_batch_static`` runs the same static-buffer loop with its
functions called directly instead of captured, on any device: the tests
hold it to ``trace_batch`` bit for bit on the CPU.
"""

from __future__ import annotations

import collections

import torch

from rays_tpu_torch.core.types import has_tangent, needs_grad, tree_leaves, tree_map
from rays_tpu_torch.models import base
from rays_tpu_torch.ops import splines
from rays_tpu_torch.tracing import capture_audit, rk45, trace
from rays_tpu_torch.utils import spans

CACHE_SIZE = 4      # captured configurations kept per process
CHUNK = 1           # masked substep passes per host read in the SG loop form
CAPTURES = 0
REPLAYS = 0

_CACHE: collections.OrderedDict = collections.OrderedDict()


def _copy(buf, t):
    buf.copy_(t)


def _first_row(buf, t):
    buf[:, 0].copy_(t)


class StaticLoop:
    """``trace_batch``'s loop on static buffers, for one configuration
    and one set of input shapes.  ``functions()`` are the pieces a run
    calls in turn (each reads and writes the static buffers only);
    ``run`` calls them directly, ``Captured`` replays them as graphs.
    The pieces read their inputs through ``_inputs`` and write through
    ``_put``, which the tangent graph's loop widens to dual tensors."""

    def __init__(self, cfg, params, v0, status0, chunk=CHUNK):
        self.cfg, self.chunk = cfg, chunk
        self.loop_form = cfg.ode_solver_name == "SG_ODE" and int(cfg.sg_scan_substeps) == 0
        self.counting = rk45.stats is not None
        self.stats = rk45.SubstepStats().bind(v0.device) if self.counting else None
        B, nv = v0.shape
        self.params = tree_map(torch.empty_like, params)
        self.carry = tuple(torch.empty_like(t) for t in trace.initial_carry(
            cfg, params, v0, status0))
        self.k = trace.step_index(0, v0)
        n = cfg.nstep_max + 1
        self.traj = (torch.empty((B, n, nv), dtype=v0.dtype, device=v0.device)
                     if cfg.save_trajectory else None)
        self.resid = (torch.empty((B, n), dtype=v0.dtype, device=v0.device)
                      if cfg.save_trajectory else None)
        self.sub = ()
        if self.loop_form:
            ctx = rk45.substep_context(params, self.k, B, v0.device)
            v, f1, st1, hstate = self.carry[:4]
            cvec = self.carry[8] if cfg.compensated_sum else None
            self.sub = tuple(torch.empty_like(t) for t in rk45.substep_start(
                params, ctx, self.k, v, hstate, f1, st1, cvec))
            self.status = torch.empty_like(self.carry[4])
            self.active = torch.empty((B,), dtype=torch.bool, device=v0.device)
            self.flag = torch.zeros((), dtype=torch.bool, device=v0.device)

    # --- the pieces -------------------------------------------------------

    def functions(self):
        """{name: function} of the pieces a run calls."""
        if self.loop_form:
            return {"head": self.head, "chunk": self.chunk_passes, "tail": self.tail}
        return {"step": self.step}

    def _inputs(self):
        """(Params, carry, substep state) as the pieces read them."""
        return self.params, self.carry, self.sub

    def _put(self, buf, t, how=_copy):
        """Write ``t`` into the static buffer ``buf`` by ``how(buf, t)``."""
        how(buf, t)

    def step(self):
        """One whole outer step (RK4, or SG with a fixed substep budget)."""
        p, carry, _ = self._inputs()
        self._end_step(trace.step(self.cfg, p, self.k, *carry))

    def head(self):
        """The head of an SG outer step and its first chunk of passes."""
        cfg, (p, carry, _) = self.cfg, self._inputs()
        v, f1, st1, hstate, status = carry[:5]
        cvec = carry[8] if cfg.compensated_sum else None
        s, _, status, active = trace.step_start(p, self.k, status)
        self.status.copy_(status)
        self.active.copy_(active)
        ctx = rk45.substep_context(p, s, v.shape[0], v.device, self.active)
        self._passes(p, ctx, rk45.substep_start(p, ctx, s, v, hstate, f1, st1, cvec))

    def chunk_passes(self):
        """``chunk`` more masked passes of the substep loop."""
        p, _, sub = self._inputs()
        self._passes(p, self._context(p), sub)

    def tail(self):
        """The end of the substep loop and of the outer step."""
        p, carry, sub = self._inputs()
        out = rk45.substep_end(self._context(p), sub)
        self._end_step(trace.step_end(self.cfg, carry, self.status, self.active, out))

    def _context(self, p):
        s = self.k * p.ode.ds     # as trace.step_start computes it
        return rk45.substep_context(p, s, self.active.shape[0], self.active.device, self.active)

    def _passes(self, p, ctx, sub):
        for _ in range(self.chunk):
            sub = rk45.substep_pass(self.cfg, p, ctx, sub, rk45.substep_live(self.cfg, ctx, sub))
        for buf, t in zip(self.sub, sub):
            self._put(buf, t)
        self.flag.copy_(rk45.substep_live(self.cfg, ctx, sub).any())

    def _end_step(self, out):
        row, res_row = out[0], out[1]
        for buf, t in zip(self.carry, out[2:]):
            self._put(buf, t)
        if self.traj is not None:
            at = (self.k + 1).to(torch.int64).reshape(1)
            self._put(self.traj, row, lambda b, t: b.index_copy_(1, at, t[:, None, :]))
            self._put(self.resid, res_row, lambda b, t: b.index_copy_(1, at, t[:, None]))
        self.k.add_(1)

    # --- a run ------------------------------------------------------------

    def load(self, params, v0, status0):
        """Copy the caller's inputs in and set the carry to its start."""
        for buf, leaf in zip(tree_leaves(self.params), tree_leaves(params)):
            self._put(buf, leaf)
        for buf, t in zip(self.carry, trace.initial_carry(self.cfg, params, v0, status0)):
            self._put(buf, t)
        self.k.zero_()
        if self.traj is not None:
            self._put(self.traj, v0, _first_row)
            self._put(self.resid, torch.zeros_like(v0[:, 0]), _first_row)
        if self.counting:
            # in place: the captured passes add into these very counts
            self.stats.counts.zero_()
            self.stats.host_reads = 0

    def run(self, launch):
        """The outer steps, each piece started by ``launch(name)``; the
        flag of the SG loop form read once after the head and each
        chunk.  Returns the host reads made."""
        reads = 0
        for _ in range(self.cfg.nstep_max):
            if not self.loop_form:
                launch("step")
                continue
            launch("head")
            reads += 1
            while bool(self.flag):
                launch("chunk")
                reads += 1
            launch("tail")
        return reads

    def outputs(self, v0):
        """(final carry, trajectory, residual): copies of the static
        buffers (zeros of one point without trajectories)."""
        B, nv = v0.shape
        if self.traj is not None:
            ray_vec, residual = self.traj.clone(), self.resid.clone()
        else:
            ray_vec = torch.zeros((B, 1, nv), dtype=v0.dtype, device=v0.device)
            residual = torch.zeros((B, 1), dtype=v0.dtype, device=v0.device)
        return tuple(t.clone() for t in self.carry), ray_vec, residual

    def trace(self, params, v0, status0, pwr_wt, launch=None):
        """One run on the caller's inputs: load, the outer steps (each
        piece called directly unless ``launch(name)`` starts it), and the
        RayResults copied out of the static buffers.  The substep counts
        and reads are added to ``rk45.stats`` when it is counting."""
        self.load(params, v0, status0)
        with spans.span("rays.graph.replays", self.k.device):
            if launch is None:
                pieces = self.functions()
                reads = self.with_own_stats(lambda: self.run(lambda name: pieces[name]()))
            else:
                reads = self.run(launch)
        if self.counting and rk45.stats is not None:
            self.stats.host_reads = reads
            rk45.stats.merge(self.stats)
        carry, ray_vec, residual = self.outputs(v0)
        return trace.results(self.cfg, carry, v0, pwr_wt, ray_vec, residual)

    def with_own_stats(self, fn):
        """Call ``fn`` with ``rk45.stats`` set to this loop's own record
        (or to None when it does not count)."""
        saved = rk45.stats
        rk45.stats = self.stats
        try:
            return fn()
        finally:
            rk45.stats = saved


def trace_batch_static(cfg, params, v0, status0, pwr_wt, chunk=CHUNK) -> trace.RayResults:
    """The graphed tracer's static-buffer loop with its pieces called
    directly, on any device: what the graphs replay, step for step."""
    trace.check_supported(cfg)
    with torch.no_grad():
        return StaticLoop(cfg, params, v0, status0, chunk).trace(params, v0, status0, pwr_wt)


class Captured:
    """One cache entry: the pieces of ``loop`` (a StaticLoop or one of its
    kinds) captured as CUDA graphs that share one private memory pool, on
    the device of the loop's buffers.  ``load()`` sets the buffers to a
    run's start.  A model of the caller's own is audited first
    (``capture_audit.require_capturable``), before anything touches the
    card.  The pieces are warmed up ``warmup`` times on the capture
    stream (library handles, the allocator, the autograd engine's device
    thread); this steps the static buffers only, which every run loads
    again, so the caller's state is stepped by the replays alone."""

    def __init__(self, loop, load, warmup=1):
        cfg = loop.cfg
        if cfg.equilib_model in base.EQ_MODELS:
            load()
            capture_audit.require_capturable(loop)
        self.loop, self.device = loop, loop.k.device
        pieces = loop.functions()
        # a run of no steps launches no piece: nothing to capture
        if not cfg.nstep_max:
            pieces = {}
        load()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            scratch = rk45.SubstepStats().bind(self.device) if loop.counting else None
            held, rk45.stats = rk45.stats, scratch
            try:
                for _ in range(warmup):
                    for fn in pieces.values():
                        fn()
            finally:
                rk45.stats = held
        torch.cuda.current_stream(self.device).wait_stream(side)
        load()
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs, self.spline_evals = {}, {}
        for name, fn in pieces.items():
            g = torch.cuda.CUDAGraph()
            before = splines.EVALS
            with torch.cuda.graph(g, pool=self.pool, stream=side):
                loop.with_own_stats(fn)
            self.graphs[name] = g
            self.spline_evals[name] = splines.EVALS - before

    def launch(self, name):
        with torch.cuda.device(self.device):
            self.graphs[name].replay()
        # a replay runs no Python: the evaluations its capture ran
        splines.REPLAYED_EVALS += self.spline_evals[name]

    def release(self):
        """Reset the graphs and drop the loop: the pool and the static
        buffers go back to the card once nothing else holds them."""
        for g in self.graphs.values():
            g.reset()
        self.graphs.clear()
        self.loop = None


def get_or_capture(key, make):
    """The cache entry under ``key``, marked most recently used; on a miss
    ``make()`` builds it, after the least recently used entries are
    evicted and released (``release()``) down to ``CACHE_SIZE - 1``,
    inside the span ``rays.graph.capture``."""
    entry = _CACHE.get(key)
    if entry is not None:
        _CACHE.move_to_end(key)
        return entry
    while len(_CACHE) >= CACHE_SIZE:
        _CACHE.popitem(last=False)[1].release()
        torch.cuda.empty_cache()
    with spans.span("rays.graph.capture"):
        entry = _CACHE[key] = make()
    return entry


class _Same:
    """A key part equal only to a part that holds the very same object (a
    model's module or namespace, which need not be hashable).  It holds
    the object, so no other object takes its id while the key lives."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj


def _shape_of(t):
    return (tuple(t.shape), t.dtype, t.device)


def cache_key(cfg, params, v0):
    return (cfg, _Same(base.get_eq_model(cfg.equilib_model)), tuple(v0.shape), v0.dtype,
            v0.device, tree_map(_shape_of, params), rk45.stats is not None)


def require_card(what, params, v0, status0, pwr_wt):
    """Raise unless every input lies on v0's device and that is a CUDA
    device."""
    dev = v0.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on a CUDA device, not {dev}")
    for t in (status0, pwr_wt, *tree_leaves(params)):
        if t.device != dev:
            raise ValueError(f"{what} needs every input on {dev}, found {t.device}")


def trace_batch_graphed(cfg, params, v0, status0, pwr_wt) -> trace.RayResults:
    """``trace_batch`` on a CUDA device through the configuration's
    captured step (captured at the first call with these shapes).  Every
    tensor must lie on v0's device; derivatives, reverse or forward mode,
    are not taken (``route`` sends them to the graphed adjoint and the
    tangent graph)."""
    trace.check_supported(cfg)
    if needs_grad(params, v0) or has_tangent(params, v0):
        raise ValueError("the graphed tracer takes no derivatives; trace_batch does")
    require_card("the graphed tracer", params, v0, status0, pwr_wt)

    def make():
        global CAPTURES
        loop = StaticLoop(cfg, params, v0, status0)
        entry = Captured(loop, lambda: loop.load(params, v0, status0))
        CAPTURES += 1
        return entry

    def launch(name):
        global REPLAYS
        entry.launch(name)
        REPLAYS += 1

    # graphs capture and replay on the current device's streams
    with torch.cuda.device(v0.device), torch.no_grad():
        entry = get_or_capture(("graph", *cache_key(cfg, params, v0)), make)
        return entry.loop.trace(params, v0, status0, pwr_wt, launch)
