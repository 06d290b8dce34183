"""The card and its trace: nvidia-smi's reading of the card, the device's
work in a traced window as ``torch.profiler`` gives it, and the arithmetic
of busy time, idle gaps and the heaviest operations.

The profiler arithmetic follows the program's own ``utils/measure.py``
(kernels and copies from the profiler's CUDA events), read from the raw
event list, with the busy time taken as the union of the device
intervals, so that operations that overlap on two streams count once, and
the profiler's own range around the window left out of them.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time

import torch

WINDOW = "benchmark.window"


def card():
    """{name, sm clock, memory clock, power limit, power draw} of the card
    that runs this process, as nvidia-smi reads them."""
    fields = "name,clocks.sm,clocks.mem,power.limit,power.draw"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"unavailable: {exc}"}
    index = torch.cuda.current_device()
    row = [x.strip() for x in out.splitlines()[index].split(",")]
    return dict(zip(fields.split(","), row))


@dataclasses.dataclass
class Trace:
    """The device's work in one traced window.  ``ops``: (name, start us,
    duration us, is_copy) of every kernel, copy and set; ``host``: (name,
    start us, duration us) of the host's operations, by start; the window
    runs from ``t0_us`` for ``window_s`` on the profiler's clock."""

    ops: list
    host: list
    t0_us: float
    window_s: float

    @property
    def kernels(self):
        return [o for o in self.ops if not o[3]]

    def intervals(self):
        spans = sorted((s, s + d) for _, s, d, _ in self.ops)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.intervals()) * 1e-6

    def top_ops(self, n=10):
        tot = {}
        for name, _, d, _ in self.ops:
            tot[name] = tot.get(name, 0.0) + d
        return [[k, v * 1e-6] for k, v in sorted(tot.items(), key=lambda r: -r[1])[:n]]

    def idle_gaps(self, n=10):
        """The longest stretches with no device work, each named by the
        innermost host operation running at its start (or 'host, no
        operation')."""
        spans, gaps, prev = self.intervals(), [], self.t0_us
        for s, e in spans:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        end = self.t0_us + self.window_s * 1e6
        if end > prev:
            gaps.append((prev, end))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for s, e in gaps[:n]:
            names = [h[0] for h in self.host if h[1] <= s < h[1] + h[2]]
            out.append([names[-1] if names else "host, no operation", (e - s) * 1e-6])
        return out


def traced(fn):
    """Run ``fn()`` (which synchronizes) under ``torch.profiler`` with CPU
    and CUDA activity; returns (fn's result, Trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        t_stop = time.perf_counter()
    t_parse = time.perf_counter()
    # the raw events: building the profiler's FunctionEvent tree for the
    # millions of kernels of a derivative step takes minutes
    ops, host, t0_us = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                low = name.lower()
                ops.append((name, start, dur, "memcpy" in low or "memset" in low))
        elif name == WINDOW:
            t0_us = start
        elif not e.is_user_annotation():
            host.append((name, start, dur))
    if t0_us is None:
        t0_us = min((s for _, s, _, _ in ops), default=0.0)
    host.sort(key=lambda h: h[1])
    tr = Trace(ops, host, t0_us, window)
    tr.cost_s = {"profiler stop": t_parse - t_stop, "event read": time.perf_counter() - t_parse}
    return out, tr
