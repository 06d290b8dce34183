"""Derive the frozen work count of the slab kernel B1 per live ray step
of a cell from the plain reference, and write ``counts/<name>.json``,
the name being the cell's ``kernel_count``.

    python3 benchmark/counts/derive_slab_rk4.py <cell>

The count is of the physics, not of any implementation of it: outer steps
of ``reference/rays_plain.py`` (three right-hand sides at the RK stages,
the sum, and the right-hand side and check at the new point) run under a
dispatch mode that counts every floating operation of the arithmetic
classes below.  Conventions: add, subtract, multiply, divide, square
root, exponential and power count one operation each (the published peak
counts an FMA as two, so an add and a multiply are one each), and an
element with an operand that is exactly zero, or a product or quotient by
exactly one, counts none (the reference's dense 3-vectors and 3 x 3
gradients hold the slab's structural zeros, and its masked products
factors of one, which no implementation needs to compute); a sum of n
nonzero terms counts n - 1; comparisons, selections, clamps, absolute
values and negations count none.

The count is taken along the reference's own trajectories: a sample of
``SAMPLE`` rays spread evenly over the cell's fan (seed 0) is traced for
the cell's steps, and every ``EVERY``-th step is counted on the rays
still live before it.  ``ops_per_live_step`` is the operations counted
over the live ray steps counted, so each regime of the physics weighs as
often as the rays meet it.  Bytes per ray: the launch state and status read once, the end
state, stop code, points and two residuals written once.

Rerunning this script reproduces the file; the file, not the script, is
the yardstick.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.reference import rays_plain  # noqa: E402

ELEMENTWISE = {"add", "sub", "mul", "div", "sqrt", "exp", "pow", "rsub", "reciprocal", "rsqrt"}
REDUCTIONS = {"sum"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        base = func.overloadpacket.__name__.rstrip("_")
        if torch.is_tensor(out) and out.is_floating_point():
            if base in ELEMENTWISE:
                # an element with a zero operand, or a product or quotient by
                # exactly one, is no work the inputs need
                needed = torch.ones(out.shape, dtype=torch.bool)
                operands = [torch.as_tensor(a) for a in args
                            if torch.is_tensor(a) or isinstance(a, (int, float))]
                for k, a in enumerate(operands):
                    needed &= a.ne(0).broadcast_to(out.shape)
                    if base == "mul" or (base == "div" and k == 1):
                        needed &= a.ne(1).broadcast_to(out.shape)
                self.ops += int(needed.sum())
            elif base in REDUCTIONS:
                terms = args[0].ne(0).sum(args[1] if len(args) > 1 else None)
                self.ops += int((terms - 1).clamp_min(0).sum())
        return out


SAMPLE = 64
EVERY = 10


def main(name):
    from benchmark.lib import common, inputs

    cell = common.Cell(name)
    case = rays_plain.build_case(inputs.namelist_text(cell, 0), torch.float64, "cpu")
    case.static["nstep_max"] = inputs.nstep_max(cell, case.static["nstep_max"])
    v0, _ = rays_plain.launch_slab(case)
    v = v0[torch.linspace(0, v0.shape[0] - 1, SAMPLE).round().long()]
    f1, st1, e0 = rays_plain.eqn_ray(case, v)
    _, status = rays_plain.check_save(case, v, e0)
    status = status.to(torch.int32)
    n = torch.zeros(v.shape[0], dtype=torch.int32)
    z = torch.zeros(v.shape[0], dtype=v.dtype)
    carry = (v, f1, st1, status, n, z, z)
    ops = live_steps = 0
    for k in range(case.static["nstep_max"]):
        kk = torch.tensor(float(k), dtype=v.dtype)
        if k % EVERY == 0:
            live = carry[3] == 0
            if live.any():
                with Count() as c:
                    rays_plain._step(case, kk, *(t[live] for t in carry))
                ops += c.ops
                live_steps += int(live.sum())
        carry = rays_plain._step(case, kk, *carry)
    nv = case.static["nv"]
    out = {
        "kernel_name": "slab_rk4_kernel",
        "variant": f"no damping, ray_param {case.static['ray_param']}, "
                   f"{case.static['ns']} species, {nv} state slots",
        "ops_per_live_step": round(ops / live_steps, 3),
        "bytes_per_ray": {"float64": 2 * nv * 8 + 4 + 4 + 4 + 2 * 8,
                          "float32": 2 * nv * 4 + 4 + 4 + 4 + 2 * 4},
        "derivation": f"benchmark/counts/derive_slab_rk4.py {name}: {live_steps} live ray steps "
                      f"of {SAMPLE} rays spread over the fan, every {EVERY}th step of the "
                      "reference's own trajectories; each add, subtract, multiply, divide, "
                      "square root, exponential and power one operation unless an operand is "
                      "exactly zero or a factor or divisor exactly one, a sum of n nonzero "
                      "terms n - 1; bytes: the launch state and "
                      "status read, the end state, stop, points and two residuals written, "
                      "once each",
    }
    path = Path(__file__).resolve().parent / f"{cell.spec['kernel_count']}.json"
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main(sys.argv[1])
