"""adjoint.forward_ms_per_step (ms/step): the device milliseconds of the
program's ``rays.adjoint.forward`` spans in the traced window (the CUDA
events around ``StaticAdjoint.forward``'s step replays,
``rays_tpu_torch/tracing/graphed_adjoint.py``), over the outer steps they
replayed, ``nstep_max`` each.  A forward that a backward replays again
(``rays.adjoint.reforward``) is one of them.  Nothing off the adjoint
route, nor from a program without the span record.

``adjoint.backward_ms_per_step`` is the same reading of
``rays.adjoint.backward`` (``per_step``).
"""

from benchmark.lib import common

_SPANS = common.load_module(common.HERE / "metrics" / "dispatch.idle_share.fwd.py")


def per_step(w, metric, name):
    if w.info["route"] != "adjoint" or w.info["outer_steps"] <= 0:
        return None
    recs = _SPANS.program_spans(w)
    if not recs:
        return None
    found = [(r, s, e) for r, s, e in recs if r.name == name and r.device_ms is not None]
    if not found:
        return None
    device_ms = sum(r.device_ms for r, _, _ in found)
    host_ms = sum(e - s for _, s, e in found) * 1e-3
    steps = len(found) * w.info["outer_steps"]
    w.notes = getattr(w, "notes", []) + [
        f"{metric}: {len(found)} {name} spans over {w.info['calls']} calls, {steps} steps; "
        f"{device_ms:.3f} ms of device, {host_ms:.3f} ms of host"]
    return device_ms / steps


def read(w):
    return per_step(w, "adjoint.forward_ms_per_step", "rays.adjoint.forward")
