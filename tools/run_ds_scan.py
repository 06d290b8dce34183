"""Step-size convergence scan of the slab ECH example with rays_tpu_torch,
the counterpart of scripts/run_ds_scan.py (the reference's ray_scan ds
scan, scanner_m.f90:24-56).

The example's rays run over a ladder of five rungs, ds0 / 2**i with
60 * 2**i steps, so that every rung ends at the same ray parameter, under
both steppers:
  * RK4_ODE: the end-state error against the finest rung falls as ds**4
    (on a CUDA device these runs take the slab RK4 kernel);
  * SG_ODE (adaptive DP5(4)): the error stays at the tolerance whatever
    the outer ds (plain PyTorch on every device).

Writes the scan summary (default build/ds_scan_slab.txt), prints the
measured convergence orders and, last, one JSON line with the rows, the
orders and the kernel launches of each stepper.

    python tools/run_ds_scan.py                      # on the card
    python tools/run_ds_scan.py --device cpu --solvers RK4_ODE
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rays_tpu_torch import examples  # noqa: E402
from rays_tpu_torch.tracing import fused_slab  # noqa: E402
from rays_tpu_torch.utils import ray_scan  # noqa: E402

SOLVERS = ("RK4_ODE", "SG_ODE")
N_RUNGS = 5
N0 = 60
KEYS = ["solver", "ds", "nstep", "wall_s", "max_residual", "mean_end_residual",
        "min_npoints", "err_vs_finest"]


def ladder(ds0):
    """(ds, nstep_max) of each rung: halve ds, double the steps."""
    return [(ds0 / 2**i, N0 * 2**i) for i in range(N_RUNGS)]


def run(device="cuda", solvers=SOLVERS, log=print):
    """The scan: (rows, {solver: orders}, {solver: kernel launches})."""
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_90GHZ,
                                                      device=device)
    ds0 = float(params.ode.ds)
    rows, orders, launches = [], {}, {}
    for solver in solvers:
        ends = []
        fused_slab.LAUNCHES = 0
        for ds, nstep in ladder(ds0):
            c = dataclasses.replace(cfg, ode_solver_name=solver, nstep_max=nstep,
                                    save_trajectory=False)
            p = params._replace(ode=params.ode._replace(
                s_max=torch.full_like(params.ode.s_max, 1.0e9 * ds0)))
            out = ray_scan.ds_scan(c, p, v0, st, pwr, [ds])[0]
            out["solver"] = solver
            out["nstep"] = nstep
            ends.append(out["end_x"])
            rows.append(out)
        launches[solver] = fused_slab.LAUNCHES
        # error against the finest rung at the same ray parameter
        errs = [float(np.abs(e - ends[-1]).max()) for e in ends[:-1]]
        for r, e in zip(rows[-len(ends):], errs + [0.0]):
            r["err_vs_finest"] = e
        orders[solver] = [float(np.log2(errs[i] / errs[i + 1]))
                          for i in range(len(errs) - 1) if errs[i + 1] > 0]
        log(f"{solver}: errors {errs} orders {orders[solver]} kernel launches "
            f"{launches[solver]}")
    return rows, orders, launches


def write_summary(rows, path):
    with open(path, "w") as f:
        f.write(" ".join(f"{k:>18s}" for k in KEYS) + "\n")
        for r in rows:
            f.write(" ".join(
                f"{r.get(k, ''):>18}" if isinstance(r.get(k), (str, int))
                else f"{r.get(k, float('nan')):18.6g}" for k in KEYS) + "\n")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the plain tracer)")
    ap.add_argument("--solvers", default=",".join(SOLVERS),
                    help="comma-separated steppers (default RK4_ODE,SG_ODE)")
    ap.add_argument("--out", default=os.path.join("build", "ds_scan_slab.txt"),
                    help="summary file (default build/ds_scan_slab.txt)")
    args = ap.parse_args(argv)
    torch.zeros((), device=args.device)   # a device that is not there fails first
    rows, orders, launches = run(args.device, tuple(args.solvers.split(",")))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    print(f"wrote {write_summary(rows, args.out)}")
    print(json.dumps({"rows": [{k: r[k] for k in KEYS} for r in rows],
                      "orders": orders, "launches": launches, "device": args.device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
