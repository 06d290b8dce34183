#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: the cell is found by name (``BENCHMARK.json`` and its files,
``lib/common.py``), the program builds its inputs from the seed and the
cell's warm-up calls run (all of this is ``setup_s``, from the start of
the process to the first timed call); then the window drives the cell's
call in a closed loop, each call synchronized, whole calls only, for
``--seconds``; once the window has closed and the peak memory is read,
the program's state is dropped and the plain reference computes the same
answer, and the sampled call's answer is held to it.

``--trace 0`` reports the cell's end-to-end metrics.  ``--trace 1`` runs
the cell's traced calls under ``torch.profiler`` instead of the window
and reports its per-layer metrics, each read by its own reader in
``metrics/``, with the device's busy time and a breakdown.

Standard error carries the route, the live steps, the card, the set-up's
parts and, last, each number compared beside its limit; the last line of
standard output is the result.  Without a CUDA device (or with fewer than
the cell asks for) it prints no result and exits 2; if JAX or the JAX
package was loaded, 3; if the answer is not correct, the result says so
and the exit code is 0.
"""

from __future__ import annotations

import time

_T_FILE = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every build and kernel cache of the run lives at a fixed path in the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / "build" / _dir)

FORBIDDEN = ("jax", "jaxlib", "flax", "rays_tpu")


def process_start():
    """The time this process started (/proc), else when this file began."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return _T_FILE


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Parts:
    """Seconds spent in each named part of the set-up: ``with parts(name):``."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def _counters():
    """The program's module counters of launches, captures and replays."""
    out = {}
    for mod in ("graphed", "graphed_adjoint", "graphed_tangent", "fused_slab"):
        m = sys.modules.get(f"rays_tpu_torch.tracing.{mod}")
        for name in ("CAPTURES", "REPLAYS", "LAUNCHES"):
            if m is not None and hasattr(m, name):
                out[f"{mod}.{name}"] = getattr(m, name)
    return out


class Window:
    """What the metric readers get of a traced window."""


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None, log=None, adjust=None):
    """Run the cell once and return its result.  ``adjust(cell)``, for the
    harness's own tests, changes the cell before anything runs."""
    import torch

    from benchmark.lib import common, compare, device as devmod

    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    t_start = time.time() if t_start is None else t_start
    cuda = device != "cpu"
    parts = Parts()
    parts.seconds["imports"] = time.time() - t_start
    cell = common.Cell(name)
    if adjust is not None:
        adjust(cell)
    readers = cell.metrics(trace)
    limits = cell.spec["limits"]

    drv = cell.driver.Driver(cell, seed, device, parts)
    log(f"cell {name}: route {drv.route}, {cell.traffic['rays']} rays x {drv.outer_steps} "
        f"steps, {cell.spec['dtype']}, driver {cell.spec['driver']}")
    warm = []
    with parts("warm-up"):
        for _ in range(int(cell.spec["warmup_calls"])):
            t0 = time.perf_counter()
            drv.call()
            warm.append(time.perf_counter() - t0)
    log("warm-up calls s: " + " ".join(f"{w:.4f}" for w in warm))

    setup_s = time.time() - t_start
    if trace:
        n_calls = int(cell.spec["trace_calls"])
    else:
        n_calls = max(1, int(seconds / (max(warm[-1], 1e-3) * 1.25)) if warm else 1)
    k = common.sample_index(seed, n_calls)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = _counters()
    kept, calls, event_ms, call_s = None, 0, [], []

    def one():
        nonlocal kept, calls
        t_call = time.perf_counter()
        if cuda and trace:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        out = drv.call()
        if cuda and trace:
            ev[1].record()
            torch.cuda.synchronize()
            event_ms.append(ev[0].elapsed_time(ev[1]))
        call_s.append(time.perf_counter() - t_call)
        if calls == k:
            kept = drv.keep(out)
        calls += 1

    if trace:
        if not cuda:
            raise RuntimeError("a traced run needs the card")

        def window():
            for _ in range(n_calls):
                one()

        _, tr = devmod.traced(window)
        elapsed = tr.window_s
        log(f"CUDA-kernel census: torch.profiler, {len(tr.kernels)} kernels and "
            f"{len(tr.ops) - len(tr.kernels)} copies and sets on the device, {len(tr.host)} "
            "host operations; " + ", ".join(f"{k} {v:.3f} s" for k, v in tr.cost_s.items()))
    else:
        t0 = time.perf_counter()
        while True:
            one()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
    after = _counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    prog = drv.answer(kept)
    info = dict(route=drv.route, calls=calls, work=drv.work, outer_steps=drv.outer_steps,
                rays=cell.traffic["rays"], dtype=cell.spec["dtype"],
                counters={c: after[c] - before.get(c, 0) for c in after},
                npoints=prog["npoints"], peak_bytes=peak, spec=cell.spec, event_ms=event_ms)
    live = prog["npoints"].double() - 1
    log(f"live steps per ray (npoints - 1): min {int(live.min())} median "
        f"{statistics.median(live.tolist()):.1f} max {int(live.max())}; {calls} calls in "
        f"{elapsed:.6f} s (a call: min {min(call_s):.6f} median {statistics.median(call_s):.6f} "
        f"max {max(call_s):.6f} s); counters {info['counters']}")
    del drv, kept
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    metrics, result = {}, {}
    if trace:
        w = Window()
        w.trace, w.info = tr, info
        for row, reader in readers:
            value = reader.read(w)
            if value is not None:
                metrics[row["name"]] = {"value": value, "unit": row["unit"]}
        for line in getattr(w, "notes", []):
            log(line)
        busy = tr.busy_s + getattr(w, "extra_busy_s", 0.0)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        for row, _ in readers:
            if row["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": row["unit"]}
            elif row["name"] == "rays_per_s":
                metrics["rays_per_s"] = {"value": calls * info["work"] / elapsed,
                                         "unit": row["unit"]}
            elif row["name"] == "grad_step_s":
                metrics["grad_step_s"] = {"value": elapsed / calls, "unit": row["unit"]}

    t_ref = time.perf_counter()
    ref = cell.driver.reference(cell, seed, device, torch.float64)
    values = compare.numbers(prog, ref, limits)
    correct, checks = compare.judge(values, limits)
    log(f"reference s: {time.perf_counter() - t_ref:.3f}")
    log("set-up parts s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.seconds.items())
        + f"; setup_s {setup_s:.3f}")
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=busy, window_s=tr.window_s)
    if cuda:
        log("card: " + json.dumps(devmod.card()))
    result = dict(correct=bool(correct), attempted=calls, failed=0, metrics=metrics,
                  device=dev, **result, checks=checks)
    for k2, c in checks.items():
        log(f"check {k2}: {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    import torch

    from benchmark.lib import common

    chips = common.Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
