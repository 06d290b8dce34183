"""adjoint.backward_ms_per_step (ms/step): the device milliseconds of the
program's ``rays.adjoint.backward`` spans in the traced window (the CUDA
events around ``StaticAdjoint.backward``'s VJP replays,
``rays_tpu_torch/tracing/graphed_adjoint.py``), over the outer steps they
replayed, ``nstep_max`` each: what a hand-written VJP would move.
Nothing off the adjoint route, nor from a program without the span
record."""

from benchmark.lib import common

_FORWARD = common.load_module(common.HERE / "metrics" / "adjoint.forward_ms_per_step.py")


def read(w):
    return _FORWARD.per_step(w, "adjoint.backward_ms_per_step", "rays.adjoint.backward")
