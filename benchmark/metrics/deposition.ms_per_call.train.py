"""deposition.ms_per_call.train (ms/call): the device milliseconds of the
program's deposition spans in the traced window, over the traced calls:
``rays.post.deposition``, the CUDA events around the profile's forward in
``post/deposition.calculate_deposition_profile`` (the chunked binning of
``ops/binning.py``), plus ``rays.post.deposition.backward``, from the
profile's gradient arriving to the gradient into the trajectory complete.
The notes give each span's device and host milliseconds a call.  Nothing
from a program without these spans.
"""

from benchmark.lib import common

_SPANS = common.load_module(common.HERE / "metrics" / "dispatch.idle_share.fwd.py")

NAMES = ("rays.post.deposition", "rays.post.deposition.backward")


def read(w):
    calls = w.info["calls"]
    recs = _SPANS.program_spans(w)
    if not recs or calls <= 0:
        return None
    found = {n: [(r, s, e) for r, s, e in recs if r.name == n and r.device_ms is not None]
             for n in NAMES}
    if not all(found.values()):
        return None
    notes = []
    for n, spans in found.items():
        device_ms = sum(r.device_ms for r, _, _ in spans)
        host_ms = sum(e - s for _, s, e in spans) * 1e-3
        notes.append(f"{n}: {len(spans)} spans, {device_ms / calls:.3f} ms of device and "
                     f"{host_ms / calls:.3f} ms of host a call")
    w.notes = getattr(w, "notes", []) + [
        f"deposition.ms_per_call.train over {calls} calls: " + "; ".join(notes)]
    return sum(r.device_ms for spans in found.values() for r, _, _ in spans) / calls
