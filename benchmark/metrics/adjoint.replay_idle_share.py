"""adjoint.replay_idle_share (%): 100 x the device's idle time inside the
union of the host intervals of the program's ``rays.adjoint.forward``,
``rays.adjoint.backward`` and ``rays.adjoint.reforward`` spans
(``rays_tpu_torch/tracing/graphed_adjoint.py``) over the traced window:
the device starved while the host launched graphs.
``device.idle_share.train`` less this is the idle in the eager glue
around the replays (the initial carry, the results, the loss, the
autograd engine's walk) and in the harness.  Nothing off the adjoint
route, nor from a program without the span record.

Its notes give, per call, each span's host time, the reforwards' count
and device time and the captures, and the three longest idle gaps of
the window, each named by the innermost program span open at its start.
"""

from benchmark.lib import common

_SPANS = common.load_module(common.HERE / "metrics" / "dispatch.idle_share.fwd.py")
REPLAYS = ("rays.adjoint.forward", "rays.adjoint.backward", "rays.adjoint.reforward")


def _innermost(recs, t):
    """The name of the innermost span open at ``t`` (us), or None."""
    open_ = [(s, i, r.name) for i, (r, s, e) in enumerate(recs) if s <= t < e]
    return max(open_)[2] if open_ else None


def read(w):
    if w.info["route"] != "adjoint" or w.trace.window_s <= 0:
        return None
    recs = _SPANS.program_spans(w)
    if not recs:
        return None
    loops = [(s, e) for r, s, e in recs if r.name in REPLAYS]
    if not loops:
        return None
    idle = _SPANS.idle_inside(w, loops)
    notes = []
    for call in sorted({r.call for r, _, _ in recs}):
        mine = [(r, s, e) for r, s, e in recs if r.call == call]
        host = {}
        for r, s, e in mine:
            host[r.name] = host.get(r.name, 0.0) + (e - s) * 1e-3
        re = [r for r, _, _ in mine if r.name == "rays.adjoint.reforward"]
        re_ms = sum(r.device_ms or 0.0 for r in re)
        notes.append(f"adjoint spans, call {call}: host ms " + ", ".join(
            f"{n} {v:.3f}" for n, v in host.items())
            + f"; {len(re)} reforwards, {re_ms:.3f} ms of device")
    captures = sum(r.name == "rays.graph.capture" for r, _, _ in recs)
    top = [f"{(e - s) * 1e-3:.3f} ms in {_innermost(recs, s) or 'no program span'}"
           for s, e in _SPANS.gaps(w)[:3]]
    notes.append(f"adjoint.replay_idle_share: {idle * 1e3:.3f} ms idle inside the replay "
                 f"loops; {captures} captures in the window; longest idle gaps: "
                 + "; ".join(top))
    w.notes = getattr(w, "notes", []) + notes
    return 100.0 * idle / w.trace.window_s
