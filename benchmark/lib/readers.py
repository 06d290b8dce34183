"""What the per-layer metric readers share: the device time of the slab
kernel in a traced window, and the device's busy time with it.

The profiler does not always see a kernel that a ctypes library launches
(the program's B1, ``csrc/slab_rk4.cu``).  Where the trace holds no kernel
of the name the cell's count gives, the kernel's time is the CUDA events
recorded around each traced call instead, and is added to the busy time
(the calls run on one stream, so it overlaps nothing the trace holds).
"""

from __future__ import annotations


def kernel_seconds(w, name):
    """(seconds of the named kernel per call, 'profiler' or 'events')."""
    cached = getattr(w, "_kernel", None)
    if cached is None:
        found = [d for n, _, d, _ in w.trace.ops if name in n]
        calls = max(1, w.info["calls"])
        if found:
            cached = (sum(found) * 1e-6 / calls, "profiler")
        else:
            cached = (sum(w.info["event_ms"]) * 1e-3 / calls, "events")
            w.extra_busy_s = sum(w.info["event_ms"]) * 1e-3
        w._kernel = cached
        w.notes = getattr(w, "notes", []) + [
            f"kernel {name}: {cached[0]:.9f} s per call, timed by {cached[1]}"]
    return cached


def busy_s(w):
    """The device's busy seconds in the window, the kernel's event time
    added where the profiler missed it."""
    spec = w.info["spec"]
    if w.info["route"] == "kernel" and "kernel_count" in spec:
        from benchmark.lib import common

        kernel_seconds(w, common.count(spec["kernel_count"])["kernel_name"])
    return w.trace.busy_s + getattr(w, "extra_busy_s", 0.0)
