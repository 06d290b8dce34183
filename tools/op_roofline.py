"""Op-class throughput of the H100 and the slab RK4 kernel (B1) priced
with it, the counterpart of scripts/vpu_roofline.py (the H100 has no
vector unit of the TPU's kind, hence the name).

1. The rates: each operation class of ``utils/op_rates.OPS`` (fma, mul,
   add, div, sqrt, rsqrt, exp, log, an integer cube) as one dependent
   chain per thread, 8 deep per iteration over N = 32,768 threads x W = 8
   chains, 300 iterations, float32 and float64 (CUDA kernels of
   ``csrc/op_rates.cu``, timed with CUDA events after a warm-up); the ILP
   sweep of the fma chain (W = 1 and 8, 8 and 64 deep); a 3x3
   matrix-vector product per thread.  Each kernel's output, at the full
   depth and one iteration short of it, is held to its plain PyTorch chain
   on the same inputs: within REL_TOL, and below the chain's resolution
   (``op_rates.resolution``: the change that one iteration, or a
   neighbouring chain, makes), so that a kernel that skipped work fails.
2. B1 priced: its operations per ray step by kind (``fused_slab.count_ops``
   on the example rays, undamped and damped) at the class rates, adds and
   multiplies paired into fmas where they can be, the kinds summed with no
   overlap (``op_rates.price``): the op-priced estimate, printed beside
   the published-peak bound of ``chip_smoke.py`` and B1's measured time at
   32,768 and 524,288 rays.  In float64 it is a lower bound if the kernel
   issues at least ``count_ops``' operations; in float32 it is not one
   (the special functions overlap the FMA pipe).
3. The plain slab path priced: the ``op_census`` of one RK4 outer step by
   class, at the same rates.

Writes build/op_roofline.txt and prints every number with the card's
name and power limit.  On the CPU (``--device cpu``) the chains are the
plain ones on the host's clock and B1 is not run.

    python tools/op_roofline.py
    python tools/op_roofline.py --device cpu --n 64 --iters 2 --rays 8,16
"""

import argparse
import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rays_tpu_torch import examples  # noqa: E402
from rays_tpu_torch.core.types import tree_to  # noqa: E402
from rays_tpu_torch.tracing import fused_slab  # noqa: E402
from rays_tpu_torch.utils import measure, op_census, op_rates  # noqa: E402

DTYPES = {"f32": torch.float32, "f64": torch.float64}
BATCHES = (32768, 524288)
REPS = 10               # kernel launches per timing
WARM_UP = 50            # launches of the fma chain before the first timing
CENSUS_RAYS = 32768
# a kernel against its plain chain, relative to the chain's values (the
# matvec's: to each column's largest component): both round alike, operation
# by operation, but for the last digit of the library's rsqrt, exp and log,
# which enter only each step's small increment.  Each kernel's error must
# also stay below its chain's resolution (op_rates.resolution), which is
# above 2e-5 but for the fma and mul chains' 5e-7 to 7e-6 in float32
REL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
B1_CASES = (("slab_rk4", examples.SLAB_ECH_90GHZ), ("slab_rk4_damped", examples.SLAB_ECH_DAMPED))


def _compare(got, ref, per_column=False):
    """(max abs error, max relative error) of got against ref, relative to
    each element, or to each column's largest magnitude."""
    d = (got.double() - ref.double()).abs()
    scale = ref.double().abs()
    if per_column:
        scale = scale.amax(0, keepdim=True)
    return float(d.max()), float((d / scale.clamp_min(1e-300)).max())


def _time_pair(kern, plain, device, reps, iters, per_column=False):
    """The row's timings and checks: kernel ms per launch (after a warm-up;
    on a card its device time with the host's enqueue hidden,
    ``measure.device_ms``), the plain chain's ms (run once, one iteration
    short and then the last), the kernel's errors against it at the full
    depth and one iteration short, and the chain's resolution.
    ``kern(i)`` and ``plain(i, start)`` run i iterations."""
    kern(iters)
    call = lambda: kern(iters)  # noqa: E731
    if torch.device(device).type == "cuda":
        ms, out = measure.device_ms(call, device, reps)
    else:
        ms, out = measure.time_ms(call, device, reps)
    def plain_run():
        prev = plain(iters - 1, None)
        return prev, plain(1, prev)

    plain_ms, (prev, ref) = measure.time_ms(plain_run, device, 1)
    abs_err, rel_err = _compare(out, ref, per_column)
    short_abs, short_rel = _compare(kern(iters - 1), prev, per_column)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max(abs_err, short_abs),
                max_rel_err=max(rel_err, short_rel),
                resolution=op_rates.resolution(prev, ref, per_column))


def measure_rates(device, n=op_rates.N, iters=op_rates.ITERS, reps=REPS):
    """({dtype: {class: operations per second}}, [row per kernel]).  On a
    card each row's kernel is held to its plain chain and raises beyond
    REL_TOL or at its chain's resolution."""
    rates, rows = {}, []
    warm = op_rates.chain_inputs(n=n, device=device)
    for _ in range(WARM_UP):            # the clocks up before the first timing
        op_rates.chain("fma", warm, iters=iters)
    cases = [(op, op_rates.W, op_rates.K) for op in op_rates.OPS]
    cases += [("fma", w, k) for w, k in op_rates.ILP]
    for dt in DTYPES.values():
        rates[dt] = {}
        for op, w, k in cases:
            x = op_rates.chain_inputs(w, n, dt, device)
            row = _time_pair(lambda i: op_rates.chain(op, x, k, i),  # noqa: B023
                             lambda i, y: op_rates.chain_reference(  # noqa: B023
                                 op, x if y is None else y, k, i), device, reps, iters)
            bound, by = op_rates.chain_bound(op, x, k, iters)
            rate = op_rates.chain_ops(x, k, iters) / (row["ms"] * 1e-3)
            if (w, k) == (op_rates.W, op_rates.K):
                rates[dt][op] = rate
            rows.append(dict(row, name=op_rates.kernel_name(op, w, k, dt), op=op, w=w, k=k,
                             dtype=dt, rate=rate, bound_ms=bound, bound_by=by,
                             ops=op_rates.chain_ops(x, k, iters)))
        m, x = op_rates.matvec_inputs(n, dt, device)
        row = _time_pair(lambda i: op_rates.matvec(m, x, i),
                         lambda i, y: op_rates.matvec_reference(m, x if y is None else y, i),
                         device, reps, iters, per_column=True)
        bound, by = op_rates.matvec_bound(m, x, iters)
        ops = op_rates.MATVEC_OPS * n * iters
        rates[dt]["matvec"] = ops / (row["ms"] * 1e-3)
        rows.append(dict(row, name=op_rates.matvec_name(dt), op="matvec", w=1, k=1, dtype=dt,
                         rate=rates[dt]["matvec"], bound_ms=bound, bound_by=by, ops=ops))
    if torch.device(device).type == "cuda":
        bad = [r for r in rows if not (r["max_rel_err"] <= REL_TOL[r["dtype"]]
                                       and r["max_rel_err"] < r["resolution"])]
        if bad:
            raise RuntimeError("op-rate kernels differ from their plain chains: " + ", ".join(
                f"{r['name']} {r['max_rel_err']:.3e} (resolution {r['resolution']:.3e})"
                for r in bad))
    return rates, rows


def price_b1(rates, device, batches=BATCHES, reps=3):
    """Rows of B1 priced: per case, dtype and batch, the operations per
    ray step by kind, the op-priced estimate, the published-peak bound and,
    on a card, the kernel's time (least of ``reps`` after a warm-up)."""
    cuda = torch.device(device).type == "cuda"
    rows = []
    for name, text in B1_CASES:
        ray_ops, npts = op_rates.example_ray_ops(text)
        per_step = op_rates.per_ray_step(ray_ops, npts)
        cfg, params, v0, st, pwr = examples.setup_example(text, device=device)
        cfg = dataclasses.replace(cfg, save_trajectory=False)
        for dt in DTYPES.values():
            for n in batches:
                total = op_rates.replicated_totals(ray_ops, n)
                op_s, parts = op_rates.price(total, rates[dt])
                pub_ms, pub_by, _ = op_rates.published_bound(total, n, cfg.nv, dt)
                ms = None
                if cuda:
                    v, s, w = examples.replicate_rays(v0, st, pwr, n)
                    p = tree_to(params, dtype=dt)
                    call = lambda: fused_slab.trace_batch_fused(cfg, p, v.to(dt), s,  # noqa: E731
                                                                w.to(dt))
                    call()
                    ms = min(measure.time_ms(call, device)[0] for _ in range(reps))
                rows.append(dict(name=name, dtype=dt, rays=n, per_step=per_step,
                                 op_ms=op_s * 1e3, op_parts={k: v * 1e3 for k, v in parts.items()},
                                 published_ms=pub_ms, published_by=pub_by, ms=ms))
    return rows


def price_census(rates, device, n_rays=CENSUS_RAYS):
    """The plain slab RK4 outer step (float64) by class at the float64
    rates: (census, {class: ns per ray per step}, ns per ray per step)."""
    cfg, params, v0, st, pwr = examples.setup_example(device=device)
    v, s, w = examples.replicate_rays(v0, st, pwr, n_rays)
    c = op_census.step_census(cfg, params, v, s, w)
    elements = {cls: e for cls, (_, e) in c.by_class().items() if e}
    total, parts = op_rates.price(elements, rates[torch.float64], op_rates.PRICE_OF_CLASS)
    return c, {k: v * 1e9 for k, v in parts.items()}, total * 1e9


def run(device="cuda", n=op_rates.N, iters=op_rates.ITERS, batches=BATCHES,
        census_rays=CENSUS_RAYS, log=print):
    """Every section; returns (report lines, {"rates", "kernels", "b1",
    "census"})."""
    dev = measure.open_device(device)
    card = measure.card_line(dev)
    lines = []

    def say(msg=""):
        log(msg)
        lines.append(msg)

    rates, rows = measure_rates(dev, n, iters)
    say(f"# Op-class throughput on {card}")
    say(f"# {n} threads x W chains, K deep per iteration, {iters} iterations; "
        f"kernel ms per launch by {'CUDA events' if dev.type == 'cuda' else 'the host clock'}"
        f" over {REPS} launches; plain = the PyTorch chain")
    for r in rows:
        fma = rates[r["dtype"]]["fma"]
        say(f"{r['name']:28s} {r['rate']:.4g} ops/s ({fma / r['rate']:.2f}x the fma "
            f"chain's time per op); {r['ms']:.4f} ms, published-peak bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.1f} ms, "
            f"max rel err {r['max_rel_err']:.2e} (at the full depth and one iteration "
            f"short; resolution {r['resolution']:.2e})")

    b1 = price_b1(rates, dev, batches)
    say()
    say(f"# B1 priced at the measured class rates (adds and multiplies paired into fmas, "
        f"no overlap; a lower bound in f64 only if the kernel issues count_ops' "
        f"operations, an estimate in f32) beside the published-peak bound "
        f"(34 / 67 TFLOP/s) and its measured time, on {card}")
    for r in b1:
        dt = "f32" if r["dtype"] == torch.float32 else "f64"
        per = ", ".join(f"{k} {v:.2f}" for k, v in r["per_step"].items() if v)
        meas = (f"kernel {r['ms']:.3f} ms: {r['op_ms'] / r['ms']:.3f} of the op-priced "
                f"estimate, {r['published_ms'] / r['ms']:.3f} of the published-peak bound"
                if r["ms"] is not None else "kernel not measured (no card)")
        say(f"{r['name']} {dt} {r['rays']} rays: per ray step {per}; op-priced estimate "
            f"{r['op_ms']:.4f} ms (" + ", ".join(f"{k} {v:.4f}" for k, v in
                                                 r["op_parts"].items() if v)
            + f"), published-peak bound {r['published_ms']:.4f} ms ({r['published_by']}); "
            + meas)

    c, parts, total = price_census(rates, dev, census_rays)
    say()
    say(f"# The plain slab RK4 outer step (f64, op_census at {census_rays} rays) at the f64 "
        f"class rates, on {card}")
    say(f"aten ops per step {c.n_ops} (views {c.n_views}, host reads {c.host_reads}); "
        f"elements per ray per step {sum(c.elements.values()):.1f}")
    for cls, (nops, e) in c.by_class().items():
        if nops:
            say(f"  {cls:8s} {nops:5d} ops, {e:8.1f} elements per ray -> "
                f"{parts.get(cls, 0.0):8.4f} ns per ray step")
    say(f"  (add and mul elements paired into fmas -> {parts['fma']:8.4f} ns per ray step; "
        f"the add and mul lines price the rest)")
    say(f"op-priced estimate: {total:.3f} ns per ray step, {total * census_rays * 1e-6:.3f} ms "
        f"per outer step of {census_rays} rays")
    return lines, {"rates": rates, "kernels": rows, "b1": b1,
                   "census": {"aten_ops": c.n_ops, "ns_per_ray_step": total}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs the plain chains)")
    ap.add_argument("--n", type=int, default=op_rates.N, help="threads (columns) per chain")
    ap.add_argument("--iters", type=int, default=op_rates.ITERS, help="iterations per chain")
    ap.add_argument("--rays", default=",".join(map(str, BATCHES)),
                    help="comma-separated batches at which B1 is priced")
    ap.add_argument("--census-rays", type=int, default=CENSUS_RAYS)
    ap.add_argument("--out", default=os.path.join("build", "op_roofline.txt"))
    args = ap.parse_args(argv)
    lines, _ = run(args.device, args.n, args.iters, [int(r) for r in args.rays.split(",")],
                   args.census_rays)
    print(f"wrote {measure.write_report(lines, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
