"""dispatch.idle_share.fwd (%): 100 x the device's idle time inside the
program's ``rays.trace_rays.kernel`` spans (``rays_tpu_torch/utils/spans.py``:
``trace_rays`` -> ``route`` -> ``fused_slab.trace_batch_fused`` -> the
library call) over the traced window, in a forward cell on the kernel
route.  Idle is the complement of the union of the profiler's device
intervals; where the profiler's events hold no slab kernel, those
intervals are unknown and the reader gives nothing.
``device.idle_share.fwd`` less this is the idle outside the program: the
harness's synchronize and loop.

The spans are stamped with ``time.time_ns()``, the clock of the
profiler's events, and clipped to the window.  A program without the
span record gives nothing.  The other span readers take their interval
arithmetic from here (``program_spans``, ``union``, ``idle_inside``,
``gaps``).
"""

from benchmark.lib import common


def program_spans(w):
    """[(record, start us, end us)] of the program's closed spans that
    overlap the traced window, clipped to it, by start; None where the
    program has no span record."""
    try:
        from rays_tpu_torch.utils import spans
    except ImportError:
        return None
    lo = w.trace.t0_us
    hi = lo + w.trace.window_s * 1e6
    out = []
    for r in spans.records():
        s, e = r.start_ns * 1e-3, r.end_ns * 1e-3
        if e > lo and s < hi:
            out.append((r, max(s, lo), min(e, hi)))
    out.sort(key=lambda x: x[1])
    return out


def self_us(recs):
    """{id: self time in us} of the window's records (``spans.self_ns``)."""
    from rays_tpu_torch.utils import spans

    return {k: v * 1e-3 for k, v in spans.self_ns([r for r, _, _ in recs]).items()}


def union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap(a, b):
    """The length both sorted, merged interval lists cover."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(w, intervals):
    """Seconds of the host ``intervals`` (us) in which the device ran
    nothing the profiler saw."""
    host = union(intervals)
    return (sum(e - s for s, e in host) - _overlap(host, w.trace.intervals())) * 1e-6


def gaps(w):
    """[(start us, end us)] of the window's stretches with no device work,
    longest first."""
    lo = w.trace.t0_us
    hi = lo + w.trace.window_s * 1e6
    out, prev = [], lo
    for s, e in w.trace.intervals():
        if s > prev:
            out.append((prev, min(s, hi)))
        prev = max(prev, e)
    if hi > prev:
        out.append((prev, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


def read(w):
    spec = w.info["spec"]
    if (w.info["route"] != "kernel" or "kernel_count" not in spec
            or w.trace.window_s <= 0):
        return None
    name = common.count(spec["kernel_count"])["kernel_name"]
    if not any(name in op[0] for op in w.trace.ops):
        return None
    recs = program_spans(w)
    if not recs:
        return None
    calls = [x for x in recs if x[0].name == "rays.trace_rays.kernel"]
    if not calls:
        return None
    idle = idle_inside(w, [(s, e) for _, s, e in calls])
    own = self_us(recs)
    per = {n: sum(own[r.id] for r, _, _ in recs if r.name == n) / len(calls)
           for n in ("rays.trace_rays.kernel", "rays.kernel.prepare", "rays.kernel.launch")}
    host = sum(e - s for _, s, e in calls) / len(calls)
    w.notes = getattr(w, "notes", []) + [
        f"dispatch.idle_share.fwd: {len(calls)} rays.trace_rays.kernel spans, "
        f"{host:.1f} us of host a call, {idle * 1e6 / len(calls):.1f} us of it with the "
        "device idle; self time a call: " + ", ".join(f"{n} {v:.1f} us" for n, v in per.items())]
    return 100.0 * idle / w.trace.window_s
