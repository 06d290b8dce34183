"""Parameter scans: step-size convergence and batch-size throughput
(``rays_tpu.utils.ray_scan``).

The reference's ray_scan application (RAYS_project/ray_scan/ray_scan.f90 +
scanner_m.f90) loops {update the scan parameter -> re-run the trace ->
aggregate end and max residuals and wall time} -> scan summary.  Scan
schedules follow scanner_m.f90:1-20: 'ds' with fixed_increment, pwr_of_2
and integer_divide; the reference's 'num_threads' scaling scan becomes a
sweep of the ray batch size, the GPU's counterpart of a thread count.

Both scans trace through ``trace.trace_rays``, so a run that the kernel
covers (the slab under RK4, no gradients, on a CUDA device) runs the slab
RK4 kernel, and every other run the plain tracer.  The device is
synchronized before and after each timed call.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def scan_values(start, n_runs, algorithm="fixed_increment", increment=None,
                factor=2.0):
    """Scan-parameter schedule (scanner_m.f90 algorithms)."""
    vals = []
    v = start
    for i in range(n_runs):
        vals.append(v)
        if algorithm == "fixed_increment":
            v = v + (increment if increment is not None else start)
        elif algorithm == "pwr_of_2":
            v = v * 2.0
        elif algorithm == "integer_divide":
            v = start / (i + 2)
        elif algorithm == "factor":
            v = v * factor
        else:
            raise ValueError(f"unknown scan algorithm {algorithm}")
    return vals


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_trace(cfg, params, v0, status0, pwr):
    """(RayResults, wall seconds of trace_rays between two synchronizations)."""
    from rays_tpu_torch.tracing.trace import trace_rays

    _sync(v0.device)
    t0 = time.perf_counter()
    res = trace_rays(cfg, params, v0, status0, pwr)
    _sync(v0.device)
    return res, time.perf_counter() - t0


def ds_scan(cfg, params, v0, status0, pwr, ds_values):
    """Step-size convergence scan: one trace per ds.  Returns one summary
    dict per run (``end_x`` is the (B, 3) end positions, as numpy)."""
    rows = []
    for ds in ds_values:
        p = params._replace(ode=params.ode._replace(
            ds=torch.as_tensor(ds, dtype=params.ode.ds.dtype, device=params.ode.ds.device)))
        res, wall = _timed_trace(cfg, p, v0, status0, pwr)
        rows.append({
            "ds": float(ds),
            "wall_s": wall,
            "max_residual": float(res.max_residuals.max()),
            "mean_end_residual": float(res.end_residuals.double().mean()),
            "min_npoints": int(res.npoints.min()),
            "end_x": res.end_ray_vec[:, 0:3].double().cpu().numpy(),
        })
    return rows


def batch_scan(cfg, params, v0, status0, pwr, batch_sizes):
    """Throughput against the ray batch size (the num_threads scan's
    counterpart): the example's rays grown to each size with
    ``examples.replicate_rays``, traced once to warm up, then timed."""
    from rays_tpu_torch import examples

    rows = []
    for B in batch_sizes:
        vb, sb, wb = examples.replicate_rays(v0, status0, pwr, B)
        _timed_trace(cfg, params, vb, sb, wb)  # warm-up (first launch, caches)
        _, wall = _timed_trace(cfg, params, vb, sb, wb)
        rows.append({"batch": B, "wall_s": wall, "rays_per_s": B / wall})
    return rows


def write_scan_summary(rows, path="scan_summary.txt"):
    keys = [k for k in rows[0] if not isinstance(rows[0][k], np.ndarray)]
    with open(path, "w") as f:
        f.write(" ".join(f"{k:>16s}" for k in keys) + "\n")
        for r in rows:
            f.write(" ".join(f"{r[k]:16.6g}" for k in keys) + "\n")
    return path
