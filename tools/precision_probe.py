"""Where the float32 end error of the slab example comes from, on the H100:
the counterpart of scripts/precision_probe.py.

The slab ECH example (3 rays, 500 RK4 steps) through the plain tracer
(``trace_batch``) against its float64 trace, each error the largest end
difference of positions and wavevectors over the largest reference value:

1. amplification: the float64 end divergence after a relative
   perturbation of 1e-7 of v0 (normal deviates from a seeded
   ``torch.Generator``), over 1e-7;
2. the float32 end error, plain and with the compensated carry
   (``compensated_sum``: its ``end_ray_vec``, as the JAX script reads it,
   and the state resolved with its carry, ``compensated.resolved``);
3. the bisection: float32 with ``deriv_cold`` computed inside in float64,
   with ``equilibrium`` inside in float64, and with both, swapped in
   through the module attributes the right-hand side calls
   (``f64_inside``, undone on exit).

On the card it adds the slab RK4 kernel's (B1's) float32 end error on
the same rays, and every number again at 32,768 replicated rays
(``examples.replicate_rays``; the largest over rays).  Writes
build/precision_probe.txt with the card's name and power limit.

    python tools/precision_probe.py
    python tools/precision_probe.py --device cpu
"""

import argparse
import contextlib
import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rays_tpu_torch import examples  # noqa: E402
from rays_tpu_torch.core.types import tree_to  # noqa: E402
from rays_tpu_torch.models import base  # noqa: E402
from rays_tpu_torch.tracing import compensated, fused_slab  # noqa: E402
from rays_tpu_torch.tracing.trace import trace_batch  # noqa: E402
from rays_tpu_torch.utils import measure  # noqa: E402
from rays_tpu_torch.wave import deriv_cold as dc_mod  # noqa: E402

N_STEPS = 500
N_REPLICATED = 32768
PERTURBATION = 1e-7
F32, F64 = torch.float32, torch.float64
BISECTION = (("f32_deriv_cold_f64", True, False), ("f32_equilibrium_f64", False, True),
             ("f32_both_f64", True, True))
LABELS = {
    "divergence": "f64 end divergence from the 1e-7 v0 perturbation",
    "f32": "f32 plain",
    "f32_compensated": "f32 compensated (end_ray_vec)",
    "f32_compensated_resolved": "f32 compensated, resolved with its carry",
    "f32_deriv_cold_f64": "f32, deriv_cold internally f64",
    "f32_equilibrium_f64": "f32, equilibrium internally f64",
    "f32_both_f64": "f32, eq + deriv_cold f64",
    "b1_f32": "f32 through B1 (the CUDA kernel)",
}


@contextlib.contextmanager
def f64_inside(deriv_cold=False, equilibrium=False):
    """Within the block, ``wave.deriv_cold.deriv_cold`` and/or
    ``models.base.equilibrium`` compute in float64 behind float32
    interfaces (the right-hand side calls both through these module
    attributes); the originals are back on exit, however it is left."""
    orig_dc, orig_eq = dc_mod.deriv_cold, base.equilibrium

    def dc64(eq, nvec, omgrf, k0):
        out = orig_dc(tree_to(eq, dtype=F64), nvec.double(), omgrf.double(), k0.double())
        return tuple(o.float() for o in out)

    def eq64(cfg, params, rvec):
        return tree_to(orig_eq(cfg, tree_to(params, dtype=F64), rvec.double()), dtype=F32)

    try:
        if deriv_cold:
            dc_mod.deriv_cold = dc64
        if equilibrium:
            base.equilibrium = eq64
        yield
    finally:
        dc_mod.deriv_cold, base.equilibrium = orig_dc, orig_eq


def end_error(end, ref):
    """max |end - ref| over positions and wavevectors, over max |ref|."""
    end, ref = end[:, :6].double(), ref[:, :6].double()
    return float((end - ref).abs().max() / ref.abs().max())


def probe(cfg, params, v0, st, pwr, noise=None, seed=0, kernel=False):
    """The probe's numbers on (cfg, params, v0, st, pwr) (float64, any
    device): {"divergence", "amplification", "f32", "f32_compensated",
    "f32_compensated_resolved", the three of BISECTION[, "b1_f32"]}.
    ``noise`` (the deviates of the perturbation, v0's shape) defaults to
    a torch.Generator seeded with ``seed``; ``kernel`` adds B1's f32 error
    (CUDA tensors)."""
    cfg = dataclasses.replace(cfg, save_trajectory=False)
    ref = trace_batch(cfg, params, v0, st, pwr).end_ray_vec
    if noise is None:
        noise = torch.randn(v0.shape, generator=torch.Generator().manual_seed(seed),
                            dtype=F64)
    noise = torch.as_tensor(noise, dtype=F64).to(v0.device)
    pert = trace_batch(cfg, params, v0 * (1.0 + PERTURBATION * noise), st, pwr).end_ray_vec
    out = {"divergence": end_error(pert, ref)}
    out["amplification"] = out["divergence"] / PERTURBATION

    p32, v32, w32 = tree_to(params, dtype=F32), v0.float(), pwr.float()
    out["f32"] = end_error(trace_batch(cfg, p32, v32, st, w32).end_ray_vec, ref)
    comp = trace_batch(dataclasses.replace(cfg, compensated_sum=True), p32, v32, st, w32)
    out["f32_compensated"] = end_error(comp.end_ray_vec, ref)
    out["f32_compensated_resolved"] = end_error(
        compensated.resolved(comp.end_ray_vec, comp.end_ray_comp), ref)
    for key, dc, eq in BISECTION:
        with f64_inside(dc, eq):
            out[key] = end_error(trace_batch(cfg, p32, v32, st, w32).end_ray_vec, ref)
    if kernel:
        out["b1_f32"] = end_error(
            fused_slab.trace_batch_fused(cfg, p32, v32, st, w32).end_ray_vec, ref)
    return out


def run(device="cuda", steps=N_STEPS, n_replicated=N_REPLICATED, log=print):
    """The probe on the example's rays and, on a card, on ``n_replicated``
    rays, each at ``steps`` RK4 steps.  Returns (report lines, {"example":
    numbers, "replicated": numbers or None})."""
    dev = measure.open_device(device)
    cuda = dev.type == "cuda"
    card = measure.card_line(dev)
    lines = []

    def say(msg=""):
        log(msg)
        lines.append(msg)

    cfg, params, v0, st, pwr = examples.setup_example(device=dev)
    cfg = dataclasses.replace(cfg, nstep_max=steps)
    results = {"example": probe(cfg, params, v0, st, pwr, kernel=cuda), "replicated": None}
    runs = [(f"slab example, {v0.shape[0]} rays x {steps} RK4 steps", results["example"])]
    if cuda:
        v, s, w = examples.replicate_rays(v0, st, pwr, n_replicated)
        results["replicated"] = probe(cfg, params, v, s, w, kernel=True)
        runs.append((f"{n_replicated} replicated rays x {steps} RK4 steps (largest over rays)",
                     results["replicated"]))
    for title, r in runs:
        say(f"# {title}, plain tracer against its f64 trace, on {card}")
        say(f"{LABELS['divergence']}: {r['divergence']:.3e} (amplification "
            f"{r['amplification']:.2f}x)")
        for key in LABELS:
            if key != "divergence" and key in r:
                say(f"{LABELS[key]:42s} rel_end_err={r[key]:.3e}")
        say(f"with the whole right-hand side in f64 {r['f32_both_f64']:.2e} of {r['f32']:.2e} "
            f"remains")
        say()
    return lines, results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the example alone)")
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--out", default=os.path.join("build", "precision_probe.txt"))
    args = ap.parse_args(argv)
    lines, _ = run(args.device, args.steps)
    print(f"wrote {measure.write_report(lines, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
