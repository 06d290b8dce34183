"""The tangent graph: forward-mode tangents through ``trace_batch``'s outer
step, the step's Jacobian-vector product (JVP) captured once per
configuration as a CUDA graph and replayed ``nstep_max`` times.  It is
the counterpart of the JAX package's ``jax.jit`` around ``jax.jvp``
(``scripts/inverse_demo.py:125-131``: the Gauss-Newton columns of the
inverse demo), whose tangents ride through the step scan and through the
adaptive stepper's ``lax.while_loop``.

``trace.route`` sends here, on a CUDA device with forward-mode tangents
and no reverse-mode gradients, every configuration that ``refusal``
accepts: RK4 on every geometry (B1's configs too: the kernel has no
tangents), the adaptive stepper with a fixed substep budget and in its
loop form, the compensated carry, in float32 and float64, and a model
of the caller's own (audited before its first capture,
tracing/graphed.py).  A capture or a replay that fails raises; nothing
falls back to the eager loop.

How a run goes (``StaticTangent``, a ``graphed.StaticLoop`` with a static
tangent buffer beside each floating buffer: every floating Params leaf,
carry entry and substep entry, the trajectory and the residual):

* ``trace.initial_carry`` runs eagerly on the caller's dual tensors, so
  the initial check's tangent is forward AD's own.  The primal and
  tangent parts of the caller's inputs and of the initial carry are
  copied into the static buffers (a tangent that is absent is zero).
* Each piece makes dual tensors of its static inputs at the caller's dual
  level (``forward_ad.make_dual``: views of the buffers, no copy), runs
  the graph route's piece on them, and copies the primal and tangent
  parts of its outputs into their buffers.  So the primal is bit for bit
  the graph route's, and the tangents are forward AD's through the same
  operations.  RK4 and SG with a fixed budget: one piece per outer step;
  the SG loop form: the graph route's head, chunk and tail, the "any ray
  live" flag read from the primal only.
* The RayResults fields come back as dual tensors at the caller's level
  (primal and tangent copied out of the buffers), so ``trace_rays`` stays
  the only entry: a caller unpacks them as it would ``trace_batch``'s.

One tangent direction goes per call, as in the JAX demo.  The pieces run
inside the caller's dual level (the caller has one: its tensors carry
tangents).  PyTorch's forward AD does not nest levels, so inside it a
model whose jacobians come by forward mode (``core.eq_point.value_and_jacfwd``)
takes them by reverse mode instead, one batched backward pass per
evaluation under autograd, recorded inside the capture as the adjoint
graph's VJP piece is; its tangents are those of ``jax.jvp`` over
``jax.jacfwd``, and the results keep no autograd history.

``CAPTURES`` counts the configurations captured, ``REPLAYS`` the piece
replays.  ``trace_batch_static_tangent`` runs the same pieces called
directly, on any device: the tests hold it to eager forward AD through
``trace_batch`` on the CPU.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from rays_tpu_torch.core.types import needs_grad, tree_leaves, tree_map
from rays_tpu_torch.tracing import graphed, trace

CAPTURES = 0
REPLAYS = 0


def refusal(cfg):
    """Why the tangent graph does not take this config's tangents
    (``trace.route`` then sends them to ``trace_batch``), or None: the
    autodiff derivatives call ``torch.autograd.grad`` inside the step, and
    the JAX package's autodiff derivative raises (ROADMAP C1)."""
    if cfg.ray_deriv_name == "autodiff":
        return "the tangent graph does not take ray_deriv_name='autodiff'"
    return None


def check_capturable(cfg):
    """Raise for a config the port cannot trace or the tangent graph does
    not take."""
    trace.check_supported(cfg)
    why = refusal(cfg)
    if why is not None:
        raise ValueError(why)


def _primal(t):
    return fwAD.unpack_dual(t).primal


class StaticTangent(graphed.StaticLoop):
    """``trace_batch``'s loop with its tangents on static buffers, for one
    configuration and one set of input shapes.  Its pieces are the graph
    route's, run on dual tensors; they are called inside a dual level."""

    def __init__(self, cfg, params, v0, status0):
        check_capturable(cfg)
        with torch.no_grad():
            super().__init__(cfg, tree_map(_primal, params), _primal(v0), status0)
        floating = [t for t in (*tree_leaves(self.params), *self.carry, *self.sub,
                                self.traj, self.resid)
                    if t is not None and t.is_floating_point()]
        self.tangent_of = {id(t): torch.zeros_like(t) for t in floating}

    def _dual(self, buf):
        tangent = self.tangent_of.get(id(buf))
        return buf if tangent is None else fwAD.make_dual(buf, tangent)

    def _inputs(self):
        return (tree_map(self._dual, self.params), tuple(map(self._dual, self.carry)),
                tuple(map(self._dual, self.sub)))

    def _put(self, buf, t, how=graphed._copy):
        primal, tangent = fwAD.unpack_dual(t)
        how(buf, primal)
        into = self.tangent_of.get(id(buf))
        if into is not None:
            how(into, torch.zeros_like(primal) if tangent is None else tangent)

    def outputs(self, v0):
        carry, ray_vec, residual = super().outputs(v0)

        def dual(buf, t):
            tangent = self.tangent_of.get(id(buf))
            return t if tangent is None else fwAD.make_dual(t, tangent.clone())

        carry = tuple(dual(b, t) for b, t in zip(self.carry, carry))
        if self.traj is not None:
            ray_vec, residual = dual(self.traj, ray_vec), dual(self.resid, residual)
        return carry, ray_vec, residual


def trace_batch_static_tangent(cfg, params, v0, status0, pwr_wt, loop=None) -> trace.RayResults:
    """The tangent graph's static-buffer loop with its pieces called
    directly, on any device, inside the caller's dual level: what the
    graphs replay, step for step.  ``loop``: a StaticTangent of these
    shapes to reuse, as a cache entry is reused."""
    with torch.no_grad():
        loop = StaticTangent(cfg, params, v0, status0) if loop is None else loop
        return loop.trace(params, v0, status0, pwr_wt)


def trace_batch_graphed_tangent(cfg, params, v0, status0, pwr_wt) -> trace.RayResults:
    """``trace_batch`` with forward-mode tangents on a CUDA device through
    the configuration's captured JVP pieces (captured at the first call
    with these shapes), inside the caller's dual level.  Every tensor must
    lie on v0's device; reverse-mode gradients are not taken (``route``
    sends tangents with gradients to ``trace_batch``)."""
    check_capturable(cfg)
    if needs_grad(params, v0):
        raise ValueError("the tangent graph takes no reverse-mode gradients; trace_batch does")
    graphed.require_card("the tangent graph", params, v0, status0, pwr_wt)

    def make():
        global CAPTURES
        loop = StaticTangent(cfg, params, v0, status0)
        entry = graphed.Captured(loop, lambda: loop.load(params, v0, status0))
        CAPTURES += 1
        return entry

    def launch(name):
        global REPLAYS
        entry.launch(name)
        REPLAYS += 1

    with torch.cuda.device(v0.device), torch.no_grad():
        entry = graphed.get_or_capture(("tangent", *graphed.cache_key(cfg, params, v0)), make)
        return entry.loop.trace(params, v0, status0, pwr_wt, launch)
