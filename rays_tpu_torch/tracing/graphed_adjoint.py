"""The graphed adjoint: reverse-mode gradients through ``trace_batch``'s
outer step, with the step and its vector-Jacobian product (VJP) each
captured once per configuration as a CUDA graph.  The forward replays
the step ``nstep_max`` times; the backward replays the VJP ``nstep_max``
times, last step first.  It is the counterpart of the JAX package's
``jax.jit(jax.value_and_grad(loss))`` (``__graft_entry__.py:88-99``,
``bench.py:294``, ``:356``, ``:395``, ``:498``), whose scan keeps the
carry of each step and recomputes the step's insides on the backward
pass (``jax.checkpoint(body)``, ``rays_tpu/tracing/trace.py:233-239``).

Eager autograd issues every operation of a step and of its backward from
the host, which leaves the card idle most of a training step.  Here a
step's backward is one graph launch.

``trace.route`` sends here, on a CUDA device with reverse-mode gradients,
every configuration whose outer step is one graph: RK4 on every geometry
(damping, per-species slots and the equilibrium-gradient slots
included), SG with a fixed substep budget (``sg_scan_substeps > 0``), the
compensated carry, in float32 and float64, and a model of the caller's
own (audited before its first capture, tracing/graphed.py).  Forward-mode
tangents go to the tangent graph (tracing/graphed_tangent.py).  A capture
or a replay that fails raises; nothing falls back to the eager loop.

How a run goes (``StaticAdjoint``, which keeps ``graphed.StaticLoop``'s
static buffers and adds its own):

* ``trace.initial_carry`` runs eagerly under autograd, so autograd itself
  differentiates the initial check's evaluation.  Its carry and the
  floating Params leaves are the inputs of ``GraphedSteps``, an
  ``autograd.Function``.
* Forward: the inputs are copied into the static buffers, and the
  ``"step"`` piece is replayed ``nstep_max`` times.  It writes the carry
  before step k into a stack at the device index k (the carry that
  ``jax.checkpoint`` keeps), then runs ``trace.step`` as the graph route
  does.  So the forward results are bit for bit those of the graph route
  without gradients, except on the card for the slab kernel's
  configurations without damping and for the spline toroid's with a cell
  table (below).  The stack takes (2 nv + 3) 8 + 12 bytes per ray and
  step in float64.
* Backward: the incoming cotangents are copied into static buffers (zeros
  where none came) and the ``"vjp"`` piece is replayed ``nstep_max``
  times.  It steps the device index down by one, reads that step's carry
  from the stack, recomputes ``trace.step`` under autograd on the static
  Params leaves (which require grad) and calls ``torch.autograd.grad`` of
  (trajectory row, residual row, float carry out) with respect to (float
  carry in, Params leaves), with the cotangents of row k + 1 and of the
  carry.  The carry cotangent is written back in place; each leaf's
  gradient is added into its accumulator.  Recomputing inside the piece
  keeps the backward of each operation on the stream of its forward,
  which is the capture stream.
* On the card a config that a hand-written kernel's gate takes has a
  kernel side (tracing/kernel_side.py, ``StaticAdjoint.kernels``), whose
  pieces replace the generic ones.  The slab kernel's configurations
  without damping (``slab_vjp.takes``) take another ``"vjp"`` piece: one
  launch of the hand-written VJP of the slab step (tracing/slab_vjp.py),
  which reads the same stack and the Params values packed on the device at
  each run's load, writes the carry cotangent in place and adds the Params
  cotangents into a per-ray accumulator that the backward sums into the
  leaves' accumulators once, after the sweep.  They take another ``"step"``
  piece too: one launch of the hand-written slab step (the same library),
  which writes the stack and steps the carry in place with the slab
  kernel's arithmetic, and the step index's increment.  Their forward is
  then what the no-gradient route (the slab kernel, tracing/fused_slab.py)
  computes, at rounding level from ``trace.step``'s, and the VJP
  differentiates that arithmetic.  The generic pieces are their plain
  versions; every other configuration, and the CPU, keep them.
* On the card, the axisymmetric toroid whose psi spline has a cell table
  (``eqdsk_step.takes``: RK4, cold, undamped, the profile models the kernel
  holds) takes another ``"step"`` piece: one launch of the hand-written
  EQDSK step (tracing/eqdsk_step.py), which writes the stack and steps the
  carry in place, reading the Params packed on the device at each run's
  load and the cell table in place, and the step index's increment.  Its
  ``"vjp"`` piece stays the generic one, which recomputes ``trace.step``
  at the carries the kernel wrote.  Their forward is then the kernel's
  arithmetic, at rounding level from ``trace.step``'s.
* ``cfg.remat_steps`` changes only the plain route's memory: the VJP
  always recomputes its step.

A cache entry holds the stack, the trajectory and its cotangent, and one
step's saved activations in its graphs' pool.  It shares the graph
route's cache (``graphed.get_or_capture``) under keys of its own.  The
autograd node keeps the run's inputs and the way to its entry, not the
entry: its backward asks the cache again, and an entry that was evicted
since is captured again (one capture, paid only by such a program; the
card's memory holds ``graphed.CACHE_SIZE`` entries and the one being
rebuilt).  Each forward on a loop takes a run id unique in the process:
when the backward finds another run's stack on its loop (another
forward on the same entry came in between, or the entry is a new
capture), it first replays its own forward from its saved inputs.

``CAPTURES`` counts the configurations captured, ``REPLAYS`` the step
and VJP replays; a replay adds to a kernel side's counters the launches
captured into its graph (``slab_vjp.LAUNCHES`` the slab VJP's,
``slab_vjp.STEP_LAUNCHES`` the slab step's, ``eqdsk_step.STEP_LAUNCHES``
the EQDSK step's).  The spans of utils/spans.py,
each stamped with CUDA events: ``rays.adjoint.forward`` around the step
replays, ``rays.adjoint.backward`` around the VJP replays and
``rays.adjoint.reforward`` around a forward that a backward replays.
``trace_batch_static_adjoint`` runs the same pieces called directly, on
any device: the tests hold it to eager autograd through ``trace_batch``
on the CPU.
"""

from __future__ import annotations

import functools
import itertools

import torch
from torch.autograd.function import once_differentiable

from rays_tpu_torch.core.types import has_tangent, tree_leaves, tree_map
from rays_tpu_torch.tracing import eqdsk_step, graphed, rk45, slab_vjp, trace
from rays_tpu_torch.utils import spans

WARMUP = 3          # warm-up iterations (step and VJP) before the capture
CAPTURES = 0
REPLAYS = 0

_RUN_IDS = itertools.count(1)   # one per forward, unique across loops


def refusal(cfg):
    """Why the adjoint graph does not take this config's reverse mode
    (``trace.route`` then sends it to ``trace_batch``), or None: the SG
    loop form has no reverse rule, as in the JAX package
    (``rays_tpu/tracing/rk45.py:196-201``); the autodiff derivatives'
    gradient is a second derivative through the autograd call inside the
    step."""
    if cfg.ode_solver_name == "SG_ODE" and int(cfg.sg_scan_substeps) == 0:
        return "the graphed adjoint needs cfg.sg_scan_substeps > 0 under SG_ODE"
    if cfg.ray_deriv_name == "autodiff":
        return "the graphed adjoint does not take ray_deriv_name='autodiff'"
    return None


def check_capturable(cfg):
    """Raise for a config the port cannot trace or the adjoint graph does
    not take."""
    trace.check_supported(cfg)
    why = refusal(cfg)
    if why is not None:
        raise ValueError(why)


class StaticAdjoint(graphed.StaticLoop):
    """``trace_batch``'s loop and its reverse sweep on static buffers, for
    one configuration and one set of input shapes: the pieces ``"step"``
    and ``"vjp"``.  Each reads and writes the static buffers only.

    The pieces are fixed here from the config, the Params and the device:
    on CUDA, the slab kernel's configurations without damping
    (``slab_vjp.takes``) take the hand-written kernels, the slab step and
    the slab VJP (tracing/slab_vjp.py); the spline toroid's configurations
    with a cell table (``eqdsk_step.takes``) take the hand-written EQDSK
    step (tracing/eqdsk_step.py) and the generic VJP; every other
    configuration, and the CPU, the generic ``trace.step`` and its
    recompute under autograd, which are the kernels' plain versions.
    ``kernels`` holds the side of the first gate that takes the config
    (tracing/kernel_side.py), or None."""

    def __init__(self, cfg, params, v0, status0):
        check_capturable(cfg)
        with torch.no_grad():
            super().__init__(cfg, params, v0, status0)
        n = cfg.nstep_max
        self.floats = [i for i, t in enumerate(self.carry) if t.is_floating_point()]
        self.stack = tuple(torch.empty((max(n, 1), *t.shape), dtype=t.dtype, device=t.device)
                           for t in self.carry)
        self.cot = tuple(torch.zeros_like(self.carry[i]) for i in self.floats)
        self.traj_cot = None if self.traj is None else torch.zeros_like(self.traj)
        self.resid_cot = None if self.resid is None else torch.zeros_like(self.resid)
        self.leaves = [t.requires_grad_(True) for t in tree_leaves(self.params)
                       if t.is_floating_point()]
        self.acc = [torch.zeros_like(t) for t in self.leaves]
        self.run_id = 0     # no forward yet
        self.kernels = None
        if slab_vjp.takes(cfg, v0.device):
            self.kernels = slab_vjp.SlabVJP(slab_vjp.load_library(v0.dtype, cfg.ns)[0], self)
        elif eqdsk_step.takes(cfg, self.params, v0.device):
            self.kernels = eqdsk_step.EqdskStep(eqdsk_step.load_library(v0.dtype, cfg.ns)[0],
                                                self)

    def functions(self):
        pieces = {"step": self.step, "vjp": self.vjp}
        if self.kernels is not None:
            pieces.update({name: getattr(self.kernels, name) for name in self.kernels.PIECES})
        return pieces

    def step(self):
        """The carry into the stack at k, then one whole outer step."""
        at = self.k.to(torch.int64).reshape(1)
        for buf, t in zip(self.stack, self.carry):
            buf.index_copy_(0, at, t[None])
        super().step()

    def vjp(self):
        """The VJP of outer step k - 1 (k the device index, stepped down):
        its carry cotangent written back in place, its Params gradient
        added into the accumulators.  The recompute is not counted in
        ``rk45.stats``."""
        held, rk45.stats = rk45.stats, None
        try:
            self.k.sub_(1)
            at = self.k.to(torch.int64).reshape(1)
            carry = [buf.index_select(0, at)[0] for buf in self.stack]
            with torch.enable_grad():
                for i in self.floats:
                    carry[i].requires_grad_(True)
                out = trace.step(self.cfg, self.params, self.k, *carry)
                outs = [out[2 + i] for i in self.floats]
                cots = list(self.cot)
                if self.traj is not None:
                    nxt = at + 1
                    outs += [out[0], out[1]]
                    cots += [self.traj_cot.index_select(1, nxt)[:, 0],
                             self.resid_cot.index_select(1, nxt)[:, 0]]
                pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
                grads = torch.autograd.grad(
                    [o for o, _ in pairs], [carry[i] for i in self.floats] + self.leaves,
                    [c for _, c in pairs], allow_unused=True, materialize_grads=True)
            n = len(self.floats)
            # a carry entry that the step passes through unchanged gets
            # its own cotangent back: copy before any buffer is written
            new = [g.clone() if any(g is c for c in self.cot) else g for g in grads[:n]]
            for buf, g in zip(self.cot, new):
                buf.copy_(g)
            for acc, g in zip(self.acc, grads[n:]):
                acc.add_(g)
        finally:
            rk45.stats = held

    # --- a run ------------------------------------------------------------

    def load_inputs(self, carry, leaves):
        """Copy the caller's initial carry and floating Params leaves in;
        the step index to 0 and the trajectory's first row to v0."""
        with torch.no_grad():
            for buf, t in zip(self.carry, carry):
                buf.copy_(t)
            for buf, t in zip(self.leaves, leaves):
                buf.copy_(t)
            if self.kernels is not None:
                self.kernels.pack()
            self.k.zero_()
            if self.traj is not None:
                self.traj[:, 0].copy_(carry[0])
                self.resid[:, 0].zero_()
            if self.counting:
                self.stats.counts.zero_()
                self.stats.host_reads = 0

    def forward(self, carry, leaves, launch=None):
        """The outer steps on the caller's inputs: (trajectory, residual,
        *final carry), copies of the static buffers (the trajectory pair
        only with ``cfg.save_trajectory``).  Returns the run's id."""
        self.load_inputs(carry, leaves)
        with torch.no_grad():
            with spans.span("rays.adjoint.forward", self.k.device):
                if launch is None:
                    pieces = self.functions()
                    self.with_own_stats(lambda: self.run(lambda name: pieces[name]()))
                else:
                    self.run(launch)
            if self.counting and rk45.stats is not None:
                rk45.stats.merge(self.stats)
            self.run_id = next(_RUN_IDS)
            out = tuple(t.clone() for t in self.carry)
            if self.traj is not None:
                out = (self.traj.clone(), self.resid.clone(), *out)
        return out, self.run_id

    def backward(self, cot_carry, cot_traj, cot_resid, launch=None, call=None):
        """The reverse sweep from the incoming cotangents (None: zero):
        (cotangents of the float carry in, gradients of the floating
        Params leaves), fresh tensors.  The stack must hold this run's
        forward.  ``call``: the call id of its span (utils/spans.py)."""
        with torch.no_grad():
            pairs = list(zip(self.cot, cot_carry))
            if self.traj is not None:
                pairs += [(self.traj_cot, cot_traj), (self.resid_cot, cot_resid)]
            for buf, c in pairs:
                if c is None:
                    buf.zero_()
                else:
                    buf.copy_(c)
            for acc in self.acc:
                acc.zero_()
            if self.kernels is not None:
                self.kernels.start_backward()
            self.k.fill_(self.cfg.nstep_max)
        vjp = self.functions()["vjp"] if launch is None else (lambda: launch("vjp"))
        with spans.span("rays.adjoint.backward", self.k.device, call):
            for _ in range(self.cfg.nstep_max):
                vjp()
        with torch.no_grad():
            if self.kernels is not None:
                self.kernels.finish_backward(self.acc)
            grads = [c.clone() for c in self.cot]
            if self.traj is not None:
                # the trajectory's first row is v0, which enters as carry v
                grads[0] += self.traj_cot[:, 0]
            return grads, [a.clone() for a in self.acc]


class GraphedSteps(torch.autograd.Function):
    """The outer steps of a run as one autograd node: inputs (entry,
    *initial carry, *floating Params leaves), outputs ([trajectory,
    residual,] *final carry).  ``entry()`` gives (loop, launch): a
    ``StaticAdjoint`` and ``launch(name)``, which starts its pieces (a
    cache entry's replays), or None, which calls them directly.  The node
    keeps ``entry`` and asks it again in the backward, and keeps the call
    id of the spans open at its forward for the backward's spans, which
    run on the autograd engine's thread."""

    @staticmethod
    def forward(ctx, entry, *inputs):
        loop, launch = entry()
        n_carry = len(loop.carry)
        out, ctx.run_id = loop.forward(inputs[:n_carry], inputs[n_carry:], launch)
        ctx.entry, ctx.n_carry, ctx.floats = entry, n_carry, loop.floats
        ctx.call = spans.current_call()
        ctx.n_traj = 0 if loop.traj is None else 2
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(t for t in out if not t.is_floating_point()))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *cots):
        loop, launch = ctx.entry()
        n_carry, n_traj = ctx.n_carry, ctx.n_traj
        inputs = ctx.saved_tensors
        if loop.run_id != ctx.run_id:
            # another run's stack is on the loop: put this one back
            with spans.span("rays.adjoint.reforward", loop.k.device, ctx.call):
                _, ctx.run_id = loop.forward(inputs[:n_carry], inputs[n_carry:], launch)
        cot_traj, cot_resid = cots[:2] if n_traj else (None, None)
        cot_carry = [cots[n_traj + i] for i in ctx.floats]
        g_carry, g_leaves = loop.backward(cot_carry, cot_traj, cot_resid, launch, ctx.call)
        grads = [None] * n_carry
        for i, g in zip(ctx.floats, g_carry):
            grads[i] = g
        return (None, *grads, *g_leaves)


def trace_adjoint(cfg, params, v0, status0, pwr_wt, entry) -> trace.RayResults:
    """RayResults of a run through ``GraphedSteps`` on ``entry()``'s
    (loop, launch): a StaticAdjoint of these shapes whose pieces
    ``launch(name)`` starts or, when it is None, are called directly; the
    initial carry and the results assembly eagerly, under autograd."""
    carry = trace.initial_carry(cfg, params, v0, status0)
    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    out = GraphedSteps.apply(entry, *carry, *leaves)
    B, nv = v0.shape
    if cfg.save_trajectory:
        ray_vec, residual, out = out[0], out[1], out[2:]
    else:
        ray_vec = torch.zeros((B, 1, nv), dtype=v0.dtype, device=v0.device)
        residual = torch.zeros((B, 1), dtype=v0.dtype, device=v0.device)
    return trace.results(cfg, out, v0, pwr_wt, ray_vec, residual)


def trace_batch_static_adjoint(cfg, params, v0, status0, pwr_wt, loop=None) -> trace.RayResults:
    """``trace_batch`` with the graphed adjoint's pieces called directly,
    on any device: what the graphs replay, forward and backward.
    ``loop``: a StaticAdjoint of these shapes to reuse, as a cache entry
    is reused."""
    loop = StaticAdjoint(cfg, params, v0, status0) if loop is None else loop
    return trace_adjoint(cfg, params, v0, status0, pwr_wt, lambda: (loop, None))


def capture(cfg, params, v0, status0):
    """A cache entry (``graphed.Captured``) of the step and VJP pieces of
    a StaticAdjoint of these shapes."""
    global CAPTURES
    loop = StaticAdjoint(cfg, params, v0, status0)
    # under no_grad, as a run's forward: the step piece must not record
    # autograd history into the static buffers (the VJP piece turns grad
    # mode on for its own recompute)
    with torch.no_grad():
        carry = trace.initial_carry(cfg, params, v0, status0)
        leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
        entry = graphed.Captured(loop, lambda: loop.load_inputs(carry, leaves), WARMUP)
    CAPTURES += 1
    return entry


def trace_batch_graphed_adjoint(cfg, params, v0, status0, pwr_wt) -> trace.RayResults:
    """``trace_batch`` on a CUDA device whose backward replays the
    configuration's captured VJP (step and VJP captured at the first call
    with these shapes, and again by a backward that finds them evicted).
    Every tensor must lie on v0's device; forward-mode tangents are not
    taken (``route`` sends them to the tangent graph)."""
    check_capturable(cfg)
    if has_tangent(params, v0):
        raise ValueError("the graphed adjoint takes no forward-mode tangents; trace_batch does")
    graphed.require_card("the graphed adjoint", params, v0, status0, pwr_wt)
    key = ("adjoint", *graphed.cache_key(cfg, params, v0))
    # the inputs of a capture again, without their autograd history
    held = (tree_map(torch.Tensor.detach, params), v0.detach(), status0)
    dev = v0.device

    def entry():
        with torch.cuda.device(dev):
            found = graphed.get_or_capture(key, lambda: capture(cfg, *held))
        return found.loop, functools.partial(_replay, found)

    entry()     # the capture, at the first call with these shapes
    return trace_adjoint(cfg, params, v0, status0, pwr_wt, entry)


def _replay(entry, name):
    global REPLAYS
    entry.launch(name)
    REPLAYS += 1
    if entry.loop.kernels is not None:
        # the launches that the kernels made into the captured graph
        entry.loop.kernels.replayed(name)
