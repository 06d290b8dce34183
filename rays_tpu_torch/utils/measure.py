"""What the measurement tools share (``tools/step_profile.py``,
``op_roofline.py``, ``precision_probe.py``, ``profile_mirror.py``): the
device they run on, the card's name and power
limit beside every number, timing by CUDA events, and the device's work
as ``torch.profiler`` traces it.

A tool runs on the card unless it is asked for the CPU; there its times
are the host's clock around the plain PyTorch code and are labelled so,
never as a device metric.  Without a card, asking for one raises.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time

import numpy as np
import torch


def open_device(device) -> torch.device:
    """The torch device of ``device``; a device that is not there raises
    here, before any work."""
    torch.zeros((), device=device)
    return torch.device(device)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, for a
    CUDA device; for the CPU a label that says no device metric follows."""
    if torch.device(device).type != "cuda":
        return "cpu (host clock; no device metric)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.splitlines()[0].strip()


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps=1):
    """(milliseconds per call of ``fn`` over ``reps`` calls back to back,
    the last result): CUDA events on a card, the host clock on the CPU.
    Warm up first."""
    synchronize(device)
    if torch.device(device).type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


# clock cycles of spin per queued call: covers ~1 ms of host work per call
SPIN_CYCLES_PER_CALL = 2_000_000


def device_ms(fn, device, reps):
    """Milliseconds of device time per call of ``fn`` over ``reps`` calls
    back to back, by CUDA events, with the host's enqueue hidden: a spin
    kernel holds the stream while the host queues the calls, so the
    events time the launches and not the host's Python between them (a
    short kernel outruns its wrapper).  Warm up first."""
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps, out


def host_s(fn, device):
    """Seconds on the host's clock around ``fn()`` and a synchronize."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return time.perf_counter() - t0, out


@dataclasses.dataclass
class DeviceTrace:
    """The device's work in one profiled window: ``kernels`` are (name,
    start us, duration us) of every kernel (memory copies and sets are in
    ``copies``); ``wall_us`` the host's clock around the window."""

    kernels: list
    copies: list
    wall_us: float

    @property
    def busy_us(self) -> float:
        return float(sum(d for _, _, d in self.kernels + self.copies))

    def quantiles(self, qs=(0.0, 0.5, 0.9, 1.0)):
        d = np.array([x for _, _, x in self.kernels], dtype=np.float64)
        return [float(np.quantile(d, q)) for q in qs] if d.size else []

    def top(self, n=8):
        """[(name, total us, calls)] of the n kernels with the most time."""
        tot, cnt = {}, {}
        for name, _, d in self.kernels:
            tot[name] = tot.get(name, 0.0) + d
            cnt[name] = cnt.get(name, 0) + 1
        return sorted(((k, tot[k], cnt[k]) for k in tot), key=lambda r: -r[1])[:n]


def profile(fn, device) -> DeviceTrace:
    """Run ``fn()`` once under ``torch.profiler`` (CPU and, on a card,
    CUDA activity) and return its device events.  Warm up first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        wall = (time.perf_counter() - t0) * 1e6
    kernels, copies = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = (e.name, float(e.time_range.start), float(e.time_range.elapsed_us()))
            low = e.name.lower()
            (copies if ("memcpy" in low or "memset" in low) else kernels).append(row)
    return DeviceTrace(kernels, copies, wall)


def write_report(lines, path):
    """Write the report's lines to ``path`` (its directory made); returns
    the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
