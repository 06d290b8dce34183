"""Throughput against the ray batch size with rays_tpu_torch, the
counterpart of scripts/run_batch_scan.py (the reference's num_threads
scaling scan, scanner_m.f90:1-20 / openmp_m.f90).

The slab ECH example (500 RK4 steps, summaries only) is grown to each
batch size with ``examples.replicate_rays``, traced once to warm up and
then timed; on a CUDA device every run takes the slab RK4 kernel.  Both
float32 and float64 are swept, up to 524,288 rays, the batch that fills
an H100.  Writes one summary per precision (default
build/batch_scan_slab_f32.txt and _f64.txt) and prints rays/s at each
size with the card's name and power limit.

    python tools/run_batch_scan.py                   # on the card
    python tools/run_batch_scan.py --device cpu --sizes 256,1024
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rays_tpu_torch import examples  # noqa: E402
from rays_tpu_torch.core.types import tree_to  # noqa: E402
from rays_tpu_torch.utils import ray_scan  # noqa: E402

SIZES = (256, 1024, 4096, 16384, 65536, 262144, 524288)
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def card_line():
    """nvidia-smi's name and power limit of the card, or 'no card'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return out.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no card"


def run(device="cuda", sizes=SIZES):
    """{precision: rows of ray_scan.batch_scan} for the slab example."""
    cfg, params, v0, st, pwr = examples.setup_example(device=device)
    cfg = dataclasses.replace(cfg, nstep_max=500, save_trajectory=False)
    out = {}
    for name, dt in DTYPES.items():
        out[name] = ray_scan.batch_scan(cfg, tree_to(params, dtype=dt), v0.to(dt), st,
                                        pwr.to(dt), list(sizes))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the plain tracer)")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="comma-separated batch sizes")
    ap.add_argument("--out", default=os.path.join("build", "batch_scan_slab"),
                    help="summary path stem; _f32.txt / _f64.txt are appended "
                         "(default build/batch_scan_slab)")
    args = ap.parse_args(argv)
    torch.zeros((), device=args.device)   # a device that is not there fails first
    card = card_line() if torch.device(args.device).type == "cuda" else "cpu"
    rows = run(args.device, [int(s) for s in args.sizes.split(",")])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    for name, rs in rows.items():
        path = ray_scan.write_scan_summary(rs, f"{args.out}_{name}.txt")
        for r in rs:
            print(f"{name} batch {r['batch']:>7}: {r['rays_per_s']:>14,.0f} rays/s "
                  f"({r['wall_s'] * 1e3:.3f} ms; {card})")
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
