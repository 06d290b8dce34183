#!/usr/bin/env python3
"""Probe of the slab RK4 CUDA kernel on one NVIDIA GPU: the measurements
behind the kernel's launch shape and the kernel rows of PERF.md.

    python3 tools/slab_rk4_probe.py all [--parent DIR] [--out FILE]

Phases (each can be run alone by name instead of ``all``):

  time     the four kernel rows (undamped x 500 and damped x 400 steps, f64
           and f32) at 32,768 and 524,288 rays, CUDA events, through
           ``fused_slab.trace_batch_fused`` of the checkout given by
           ``--checkout`` (default: this one).  Prints one JSON line.
  compare  ``time`` in fresh processes in turns: parent, this, this, parent.
           ``--parent`` is another checkout of the repository (for example a
           ``git archive`` of the parent commit unpacked under ``build/``).
  sweep    register caps: csrc/slab_rk4.cu cut to S = 2 and built once per
           number of 64-thread blocks an SM must hold
           (``-DRAYS_MIN_BLOCKS_*``), all side by side; registers, spills,
           occupancy and the four rows' times for each.
  dawson   the damped rows with the Dawson sum cut to no terms
           (``-DRAYS_DAWSN_TERMS=0``; the results are then wrong and are not
           compared) against the full kernel: the loop's share of the step;
           and with all 84 terms at every live evaluation
           (``-DRAYS_DAWSN_ALL_TERMS``): what the cut-off saves.
  sass     instructions that nvcc emits for one exp, expf, division and
           square root (``cuobjdump -sass`` of one-line kernels).

Everything is printed and, with ``--out``, written as JSON.  The card's
name and power limit are printed first: compare numbers of one run only.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SIZES = (32768, 524288)
# min blocks of 64 threads per SM: registers are capped at 65,536 / (64 *
# blocks), rounded down to a multiple of 8; 1 leaves them to ptxas
MIN_BLOCKS = (1, 5, 6, 7, 8, 10, 12, 16)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def ms_of(fn, reps=3):
    """Milliseconds of fn() by CUDA events: (min, median) of reps, after a
    warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return min(out), statistics.median(out)


def rows(sizes=SIZES):
    """{row name: (launch(lib_or_None) -> results, rays)}: closures over the
    inputs of the four rows at each size, on the card."""
    import torch
    from rays_tpu_torch import examples
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.tracing import fused_slab
    dev = torch.device("cuda", 0)
    out = {}
    for name, text in (("undamped", examples.SLAB_ECH_90GHZ), ("damped", examples.SLAB_ECH_DAMPED)):
        cfg, params, v0, st0, pwr = examples.setup_example(text, device=dev, dtype=torch.float64)
        cfg = dataclasses.replace(cfg, save_trajectory=False)
        for n in sizes:
            v, st, w = examples.replicate_rays(v0, st0, pwr, n)
            for dt, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
                args = (cfg, tree_to(params, dtype=dt), v.to(dt), st, w.to(dt))

                def launch(lib=None, args=args):
                    if lib is None:
                        return fused_slab.trace_batch_fused(*args)
                    return fused_slab.run_library(lib, *args)
                out[f"{name}_{tag}_{n}"] = launch
    return out


def phase_time(args):
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    result = {k: ms_of(fn)[0] for k, fn in rows().items()}
    print(json.dumps(result))
    return result


def phase_compare(args):
    if not args.parent:
        raise SystemExit("compare needs --parent")
    turns = []
    for who in ("parent", "this", "this", "parent"):
        checkout = args.parent if who == "parent" else str(ROOT)
        proc = subprocess.run([sys.executable, __file__, "time", "--checkout", checkout],
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise RuntimeError(f"time in {checkout} failed:\n{proc.stdout}\n{proc.stderr}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append({"checkout": who, "ms": times})
        print(f"compare {who}: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return turns


def _s2_source(tmp):
    """csrc/slab_rk4.cu with only the S = 2 instantiations, beside a copy of
    the header."""
    from rays_tpu_torch import native
    text = (native.CSRC / "slab_rk4.cu").read_text()
    cut = re.sub(r"\n\s*case [13456]: [^\n]*", "", text)
    assert cut != text
    (tmp / "slab_rk4_s2.cu").write_text(cut)
    shutil.copy(native.CSRC / "slab_rk4.cuh", tmp / "slab_rk4.cuh")
    return tmp / "slab_rk4_s2.cu"


def _build(tmp, specs):
    """specs: [(name, variant, [-D flags])] -> {name: (bound library, ptxas log)}"""
    from rays_tpu_torch import native
    from rays_tpu_torch.tracing import fused_slab
    src = _s2_source(tmp)
    nvcc = native.nvcc()
    files = [src, tmp / "slab_rk4.cuh"]
    built = native.build_all([
        (f"probe_{name}", files,
         lambda out, v=variant, d=defs: [nvcc, *native.NVCC_FLAGS, f"-DRAYS_DAMPING={v}",
                                        *d, "-o", str(out), str(src)])
        for name, variant, defs in specs])
    return {name: (fused_slab.bind(ctypes.CDLL(str(path))), log)
            for (name, _, _), (path, log) in zip(specs, built)}


def _ptxas(log):
    """{f64|f32: (registers, spill store bytes)} of the S = 2 kernels of a log"""
    return {("f64" if m[1] == "d" else "f32"): (int(m[3]), int(m[2]))
            for m in re.finditer(r"slab_rk4_kernelI([fd])Li2ELi\dE.*?(\d+) bytes spill stores"
                                 r".*?Used (\d+) registers", log, re.S)}


def phase_sweep(args):
    import torch
    from rays_tpu_torch import native
    tmp = Path(tempfile.mkdtemp(prefix="probe_", dir=ROOT / "build"))
    specs = [(f"d{v}_b{b}", v, [f"-DRAYS_MIN_BLOCKS_F64={b}", f"-DRAYS_MIN_BLOCKS_F32={b}"])
             for v in (0, 2) for b in MIN_BLOCKS]
    libs = _build(tmp, specs)
    launches = rows()
    table = []
    for rep in range(2):          # two passes over all shapes, in turns
        for name, (lib, log) in libs.items():
            variant = lib.rays_slab_damping()
            regs = _ptxas(log)
            for key, fn in launches.items():
                kind, tag, n = key.split("_")
                if (kind == "undamped") != (variant == 0):
                    continue
                dt = torch.float64 if tag == "f64" else torch.float32
                occ = native.occupancy(lib.rays_slab_occupancy, int(dt == torch.float64), 2)
                lo, _ = ms_of(lambda: fn(lib), reps=2)
                table.append({"shape": name, "row": key, "pass": rep, "ms": lo,
                              "registers": regs[tag][0], "spill_bytes": regs[tag][1], **occ})
    best = {}
    for r in table:
        k = (r["shape"], r["row"])
        best[k] = min(best.get(k, 1e30), r["ms"])
    for row in launches:
        line = sorted((ms, shape) for (shape, rw), ms in best.items() if rw == row)
        print(f"sweep {row}: " + ", ".join(f"{s} {ms:.3f}" for ms, s in line))
    seen = set()
    for r in table:
        k = (r["shape"], r["row"].split("_")[1])
        if k not in seen:
            seen.add(k)
            print(f"sweep shape {k[0]} {k[1]}: {r['registers']} regs, {r['spill_bytes']} B "
                  f"spilled, {r['blocks_per_sm']} blocks x {r['threads']} threads = "
                  f"{r['warps_per_sm']} warps per SM, local {r['local_bytes']} B")
    shutil.rmtree(tmp, ignore_errors=True)
    return table


def phase_dawson(args):
    """Without its terms the sum is 0, the absorption differs and the rays
    stop elsewhere, so times are compared per step of the longest ray
    (every warp holds one: the batches tile three rays)."""
    import torch
    tmp = Path(tempfile.mkdtemp(prefix="probe_", dir=ROOT / "build"))
    libs = _build(tmp, [("full", 2, []), ("noterms", 2, ["-DRAYS_DAWSN_TERMS=0"]),
                         ("allterms", 2, ["-DRAYS_DAWSN_ALL_TERMS"])])
    launches = {k: fn for k, fn in rows().items() if k.startswith("damped")}
    out = {}
    for name, (lib, log) in libs.items():
        print(f"dawson {name} ptxas S=2: {_ptxas(log)}")
        for key, fn in launches.items():
            out[f"{name}:{key}"] = {"ms": 1e30, "steps": int(fn(lib).npoints.max()) - 1}
    for turn in range(2):
        for name, (lib, _) in libs.items():
            for key, fn in launches.items():
                cell = out[f"{name}:{key}"]
                cell["ms"] = min(cell["ms"], ms_of(lambda: fn(lib), reps=2)[0])
    torch.cuda.synchronize()
    for key in launches:
        full, none = out[f"full:{key}"], out[f"noterms:{key}"]
        per_full, per_none = full["ms"] / full["steps"], none["ms"] / none["steps"]
        print(f"dawson {key}: full {full['ms']:.3f} ms / {full['steps']} steps, no terms "
              f"{none['ms']:.3f} ms / {none['steps']} steps; per step {per_full * 1e3:.2f} and "
              f"{per_none * 1e3:.2f} us, loop share {1 - per_none / per_full:.3f}")
        print(f"dawson {key}: all 84 terms at every live evaluation "
              f"{out[f'allterms:{key}']['ms']:.3f} ms")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


SASS_KERNELS = {
    "exp_f64": ("double", "exp(x[i])"), "exp_f32": ("float", "expf(x[i])"),
    "div_f64": ("double", "y[i] / x[i]"), "div_f32": ("float", "y[i] / x[i]"),
    "sqrt_f64": ("double", "sqrt(x[i])"), "sqrt_f32": ("float", "sqrtf(x[i])"),
    "copy_f64": ("double", "x[i]"), "copy_f32": ("float", "x[i]"),
}


def phase_sass(args):
    """Instructions of each one-line kernel, less those of the copy kernel
    of its type (address arithmetic, load, store, exit)."""
    from rays_tpu_torch import native
    nvcc = native.nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (ctype, expr) in SASS_KERNELS.items():
            src = Path(tmp) / f"{name}.cu"
            src.write_text(f"extern \"C\" __global__ void k({ctype}* x, const {ctype}* y, "
                           f"{ctype}* o) {{ int i = threadIdx.x; o[i] = {expr}; }}\n")
            cubin = Path(tmp) / f"{name}.cubin"
            subprocess.run([nvcc, "-arch=sm_90a", "-O3", "-cubin", "-o", str(cubin), str(src)],
                           check=True, capture_output=True, timeout=300)
            sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                                  capture_output=True, text=True, timeout=300).stdout
            ops = re.findall(r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", sass, re.M)
            ops = [o for o in ops if not o.startswith(("NOP", "BRA"))]
            counts[name] = {"instructions": len(ops),
                            "fp": sum(o.startswith(("DFMA", "DADD", "DMUL", "FFMA", "FADD", "FMUL",
                                                    "MUFU", "DSETP", "FSETP")) for o in ops),
                            "mufu": sum(o.startswith("MUFU") for o in ops)}
    for name, c in counts.items():
        base = counts["copy_" + name.split("_")[1]]["instructions"]
        c["net"] = c["instructions"] - base
        print(f"sass {name}: {c['instructions']} instructions, {c['net']} beyond a copy, "
              f"{c['fp']} floating-point, {c['mufu']} MUFU")
    return counts


PHASES = {"time": phase_time, "compare": phase_compare, "sweep": phase_sweep,
          "dawson": phase_dawson, "sass": phase_sass}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=[*PHASES, "all"])
    ap.add_argument("--checkout", default=str(ROOT), help="checkout that `time` imports")
    ap.add_argument("--parent", help="another checkout, for `compare`")
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()
    if args.phase == "time":
        phase_time(args)
        return 0
    sys.path.insert(0, str(ROOT))
    result = {"card": card()}
    print(result["card"])
    names = ["sass", "compare", "sweep", "dawson"] if args.phase == "all" else [args.phase]
    for name in names:
        if name == "compare" and not args.parent:
            continue
        result[name] = PHASES[name](args)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
