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
carry, in float32 and float64.  With reverse-mode gradients the same
step goes to the graphed adjoint (tracing/graphed_adjoint.py), which
builds on ``StaticLoop`` and shares this module's cache.  A capture or a
replay that fails raises; nothing falls back to the eager loop.

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

The cache is keyed by the config, the batch shape, dtype and device, the
shapes and dtypes of the Params leaves, and whether ``rk45.stats`` is
counting.  Each entry pins a private memory pool and its static buffers
(with trajectories about 1 GB at 32,768 rays x 500 steps in float64), so
the cache holds ``CACHE_SIZE`` entries, not the JAX package's 64; an
evicted entry's graphs are reset and its pool returned to the card.
Each process keeps its own cache (``parallel/sharded.py`` calls
``trace_rays`` in each).

``CAPTURES`` counts the configurations captured, ``REPLAYS`` the graph
replays; plain ints, like ``fused_slab.LAUNCHES``.
``trace_batch_static`` runs the same static-buffer loop with its
functions called directly instead of captured, on any device: the tests
hold it to ``trace_batch`` bit for bit on the CPU.
"""

from __future__ import annotations

import collections

import torch

from rays_tpu_torch.core.types import has_tangent, needs_grad, tree_leaves, tree_map
from rays_tpu_torch.tracing import rk45, trace

CACHE_SIZE = 4      # captured configurations kept per process
CHUNK = 1           # masked substep passes per host read in the SG loop form
CAPTURES = 0
REPLAYS = 0

_CACHE: collections.OrderedDict = collections.OrderedDict()


class StaticLoop:
    """``trace_batch``'s loop on static buffers, for one configuration
    and one set of input shapes.  ``functions()`` are the pieces a run
    calls in turn (each reads and writes the static buffers only);
    ``run`` calls them directly, ``Captured`` replays them as graphs."""

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

    def step(self):
        """One whole outer step (RK4, or SG with a fixed substep budget)."""
        self._end_step(trace.step(self.cfg, self.params, self.k, *self.carry))

    def head(self):
        """The head of an SG outer step and its first chunk of passes."""
        cfg, p = self.cfg, self.params
        v, f1, st1, hstate, status = self.carry[:5]
        cvec = self.carry[8] if cfg.compensated_sum else None
        s, _, status, active = trace.step_start(p, self.k, status)
        self.status.copy_(status)
        self.active.copy_(active)
        ctx = rk45.substep_context(p, s, v.shape[0], v.device, self.active)
        self._passes(ctx, rk45.substep_start(p, ctx, s, v, hstate, f1, st1, cvec))

    def chunk_passes(self):
        """``chunk`` more masked passes of the substep loop."""
        self._passes(self._context(), self.sub)

    def tail(self):
        """The end of the substep loop and of the outer step."""
        out = rk45.substep_end(self._context(), self.sub)
        self._end_step(trace.step_end(self.cfg, self.carry, self.status, self.active, out))

    def _context(self):
        s = self.k * self.params.ode.ds     # as trace.step_start computes it
        return rk45.substep_context(self.params, s, self.active.shape[0],
                                    self.active.device, self.active)

    def _passes(self, ctx, sub):
        for _ in range(self.chunk):
            sub = rk45.substep_pass(self.cfg, self.params, ctx, sub,
                                    rk45.substep_live(self.cfg, ctx, sub))
        for buf, t in zip(self.sub, sub):
            buf.copy_(t)
        self.flag.copy_(rk45.substep_live(self.cfg, ctx, sub).any())

    def _end_step(self, out):
        row, res_row = out[0], out[1]
        for buf, t in zip(self.carry, out[2:]):
            buf.copy_(t)
        if self.traj is not None:
            at = (self.k + 1).to(torch.int64).reshape(1)
            self.traj.index_copy_(1, at, row[:, None, :])
            self.resid.index_copy_(1, at, res_row[:, None])
        self.k.add_(1)

    # --- a run ------------------------------------------------------------

    def load(self, params, v0, status0):
        """Copy the caller's inputs in and set the carry to its start."""
        for buf, leaf in zip(tree_leaves(self.params), tree_leaves(params)):
            buf.copy_(leaf)
        for buf, t in zip(self.carry, trace.initial_carry(self.cfg, self.params, v0, status0)):
            buf.copy_(t)
        self.k.zero_()
        if self.traj is not None:
            self.traj[:, 0].copy_(v0)
            self.resid[:, 0].zero_()
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

    def trace(self, params, v0, status0, pwr_wt, launch=None):
        """One run on the caller's inputs: load, the outer steps (each
        piece called directly unless ``launch(name)`` starts it), and the
        RayResults copied out of the static buffers.  The substep counts
        and reads are added to ``rk45.stats`` when it is counting."""
        self.load(params, v0, status0)
        if launch is None:
            pieces = self.functions()
            reads = self.with_own_stats(lambda: self.run(lambda name: pieces[name]()))
        else:
            reads = self.run(launch)
        if self.counting and rk45.stats is not None:
            self.stats.host_reads = reads
            rk45.stats.merge(self.stats)
        B, nv = v0.shape
        if self.traj is not None:
            ray_vec, residual = self.traj.clone(), self.resid.clone()
        else:
            ray_vec = torch.zeros((B, 1, nv), dtype=v0.dtype, device=v0.device)
            residual = torch.zeros((B, 1), dtype=v0.dtype, device=v0.device)
        carry = tuple(t.clone() for t in self.carry)
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
    """One cache entry: a StaticLoop and its pieces captured as CUDA graphs
    that share one private memory pool.  Made and used under no_grad on
    the device of its tensors (``trace_batch_graphed``)."""

    def __init__(self, cfg, params, v0, status0):
        global CAPTURES
        self.loop = loop = StaticLoop(cfg, params, v0, status0)
        loop.load(params, v0, status0)
        pieces = loop.functions()
        side = torch.cuda.Stream(device=v0.device)
        side.wait_stream(torch.cuda.current_stream(v0.device))
        # warm up on the capture stream (library handles, the allocator).
        # It steps the static buffers, which are copies of the caller's
        # inputs and are loaded again at every run: the caller's state is
        # stepped by the replays alone
        with torch.cuda.stream(side):
            scratch = rk45.SubstepStats().bind(v0.device) if loop.counting else None
            held, rk45.stats = rk45.stats, scratch
            try:
                for fn in pieces.values():
                    fn()
            finally:
                rk45.stats = held
        torch.cuda.current_stream(v0.device).wait_stream(side)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}
        for name, fn in pieces.items():
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=self.pool, stream=side):
                loop.with_own_stats(fn)
            self.graphs[name] = g
        CAPTURES += 1

    def trace(self, params, v0, status0, pwr_wt):
        def launch(name):
            global REPLAYS
            self.graphs[name].replay()
            REPLAYS += 1

        return self.loop.trace(params, v0, status0, pwr_wt, launch)

    def release(self):
        for g in self.graphs.values():
            g.reset()
        self.graphs.clear()
        self.loop = None


def _shape_of(t):
    return (tuple(t.shape), t.dtype, t.device)


def cache_key(cfg, params, v0):
    return (cfg, tuple(v0.shape), v0.dtype, v0.device, tree_map(_shape_of, params),
            rk45.stats is not None)


def trace_batch_graphed(cfg, params, v0, status0, pwr_wt) -> trace.RayResults:
    """``trace_batch`` on a CUDA device through the configuration's
    captured step (captured at the first call with these shapes).  Every
    tensor must lie on v0's device; derivatives, reverse or forward mode,
    are not taken (``route`` sends them to ``trace_batch``)."""
    trace.check_supported(cfg)
    if needs_grad(params, v0) or has_tangent(params, v0):
        raise ValueError("the graphed tracer takes no derivatives; trace_batch does")
    dev = v0.device
    if dev.type != "cuda":
        raise ValueError(f"the graphed tracer runs on a CUDA device, not {dev}")
    for t in (status0, pwr_wt, *tree_leaves(params)):
        if t.device != dev:
            raise ValueError(f"the graphed tracer needs every input on {dev}, found {t.device}")
    key = cache_key(cfg, params, v0)
    # graphs capture and replay on the current device's streams
    with torch.cuda.device(dev), torch.no_grad():
        entry = _CACHE.get(key)
        if entry is None:
            while len(_CACHE) >= CACHE_SIZE:
                _CACHE.popitem(last=False)[1].release()
                torch.cuda.empty_cache()
            entry = _CACHE[key] = Captured(cfg, params, v0, status0)
        else:
            _CACHE.move_to_end(key)
        return entry.trace(params, v0, status0, pwr_wt)
