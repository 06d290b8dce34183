#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--out file]

For each seed the control is held to the float64 reference by the cell's
own numbers (``lib/compare.py``), at the cell's own size.  The control is
the plain reference put in the program's place and computed in float32,
the precision below the configuration's float64.  A limit must lie below
the smallest of these readings, and above the largest reading that sound
runs of the program give (``run.py`` prints those).  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(name, seed, device="cuda", adjust=None):
    """{number: value} of the control against the float64 reference for
    one seed."""
    import torch

    from benchmark.lib import common, compare

    cell = common.Cell(name)
    if adjust is not None:
        adjust(cell)
    ref = cell.driver.reference(cell, seed, device, torch.float64)
    try:
        control = cell.driver.reference(cell, seed, device, torch.float32)
    except (RuntimeError, ValueError) as exc:
        return {"error": repr(exc)}
    return compare.numbers(control, ref, cell.spec["limits"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = dict(workload=args.workload, seed=seed, control="float32",
                   numbers=readings(args.workload, seed),
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


if __name__ == "__main__":
    main()
