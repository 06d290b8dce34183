"""Derive the frozen work count of the slab kernel B1's damped variant per
live ray step of a cell from the damped plain reference, and write
``counts/<name>.json``, the name being the cell's ``kernel_count``.

    python3 benchmark/counts/derive_slab_rk4_damped.py <cell>

The conventions are ``derive_slab_rk4.py``'s (its dispatch mode counts
every add, subtract, multiply, divide, square root, exponential and power
as one operation, none for an element with an operand exactly zero or a
factor or divisor exactly one, n - 1 for a sum of n nonzero terms), on
outer steps of ``reference/rays_damped.py``, along the reference's own
trajectories of ``SAMPLE`` rays spread over the cell's fan (seed 0),
every ``EVERY``-th step on the rays live before it.  What the damping
adds is counted where the reference computes it, which is where the
Fortran does (damp_fund_ECH.f90 returns early for k_par = 0 or |xi| > 5):
k_par, v_th and xi for every ray, the rest for the rays past those
tests, and the absorption slots for every ray.

Two parts of the damping are counted otherwise.  The Dawson function
counts one operation an evaluation, as an exponential does: it is a
special function of one argument, and the sum that evaluates it is the
implementation's (the reference's power series runs 130 terms, the
kernel's cut Rybicki sum about 2 (|xi| + 7) terms of two
exponentials each), not work the inputs need.  The complex arithmetic of
the warm factor xi + 1/Z(xi) and of delta = -D_warm / (dD . vg_unit),
which the reference writes in complex numbers as the Fortran does, is
not counted (about ten real operations an evaluation).  Both count less
than any implementation does, so the roofline share errs low.

Bytes per ray: the launch state and status read once, the end state,
stop code, points and two residuals written once, at the damped width.

Rerunning this script reproduces the file; the file, not the script, is
the yardstick.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.counts.derive_slab_rk4 import EVERY, SAMPLE, Count  # noqa: E402
from benchmark.reference import rays_damped  # noqa: E402


class DampedCount(Count):
    """``Count``, with the Dawson function's insides left out and one
    operation counted for each of its evaluations."""

    def __init__(self):
        super().__init__()
        self.paused = False
        self.dawsn = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.paused:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def main(name):
    from benchmark.lib import common, inputs

    cell = common.Cell(name)
    case = rays_damped.build_case(inputs.namelist_text(cell, 0), torch.float64, "cpu")
    case.static["nstep_max"] = inputs.nstep_max(cell, case.static["nstep_max"])
    v0, _ = rays_damped.rays_plain.launch_slab(case)
    v = v0[torch.linspace(0, v0.shape[0] - 1, SAMPLE).round().long()]

    dawsn = rays_damped.dawsn
    active = []

    def counted_dawsn(x):
        if not active:
            return dawsn(x)
        c = active[-1]
        c.paused = True
        try:
            out = dawsn(x)
            n = int(x.numel())
        finally:
            c.paused = False
        c.ops += n
        c.dawsn += n
        return out

    rays_damped.dawsn = counted_dawsn
    try:
        f1, st1, e0 = rays_damped.eqn_ray(case, v)
        _, status = rays_damped.check_save(case, v, e0)
        n = torch.zeros(v.shape[0], dtype=torch.int32)
        z = torch.zeros(v.shape[0], dtype=v.dtype)
        carry = (v, f1, st1, status, n, z, z)
        ops = live_steps = evaluations = 0
        for k in range(case.static["nstep_max"]):
            kk = torch.tensor(float(k), dtype=v.dtype)
            if k % EVERY == 0:
                live = carry[3] == 0
                if live.any():
                    with DampedCount() as c:
                        active.append(c)
                        try:
                            rays_damped._step(case, kk, *(t[live] for t in carry))
                        finally:
                            active.pop()
                    ops += c.ops
                    evaluations += c.dawsn
                    live_steps += int(live.sum())
            carry = rays_damped._step(case, kk, *carry)
    finally:
        rays_damped.dawsn = dawsn
    nv = case.static["nv"]
    out = {
        "kernel_name": "slab_rk4_kernel",
        "variant": f"damp_fund_ECH with per-species slots, ray_param {case.static['ray_param']}, "
                   f"{case.static['ns']} species, {nv} state slots",
        "ops_per_live_step": round(ops / live_steps, 3),
        "dawsn_per_live_step": round(evaluations / live_steps, 3),
        "bytes_per_ray": {"float64": 2 * nv * 8 + 4 + 4 + 4 + 2 * 8,
                          "float32": 2 * nv * 4 + 4 + 4 + 4 + 2 * 4},
        "derivation": f"benchmark/counts/derive_slab_rk4_damped.py {name}: {live_steps} live ray "
                      f"steps of {SAMPLE} rays spread over the fan, every {EVERY}th step of the "
                      "damped reference's own trajectories; each add, subtract, multiply, divide, "
                      "square root, exponential and power one operation unless an operand is "
                      "exactly zero or a factor or divisor exactly one, a sum of n nonzero terms "
                      "n - 1; the damping's k_par, v_th and xi on every ray, the rest only past "
                      "damp_fund_ECH.f90's early returns (k_par = 0, |xi| > 5); the Dawson "
                      "function one operation an evaluation, as an exponential, whatever sum "
                      "evaluates it; the complex arithmetic of xi + 1/Z and of delta not "
                      "counted; bytes: the launch state and status read, the end state, stop, "
                      "points and two residuals written, once each",
    }
    path = Path(__file__).resolve().parent / f"{cell.spec['kernel_count']}.json"
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main(sys.argv[1])
