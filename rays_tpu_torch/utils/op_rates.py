"""Op-class throughput on the card, and the bounds of the slab RK4
kernel priced with it: the counterpart of ``scripts/vpu_roofline.py``.

``csrc/op_rates.cu`` holds the CUDA microbenchmarks: per thread, W
independent chains of K dependent applications of one operation class
per iteration (``OPS``), in float32 and float64, and a per-thread 3x3
matrix-vector product in place of the script's tiny ``dot_general``.
``chain`` and ``matvec`` are their wrappers: on CUDA tensors they build the
library at first use (nvcc, ``native.py``), launch the kernel on the
current stream and count the launch in ``LAUNCHES[name]``; on CPU tensors
they run the plain PyTorch chains, ``chain_reference`` and
``matvec_reference``, which compute the same values operation by
operation (the kernels are built with ``-fmad=false`` so that only the
fma chain fuses, and the plain fma rounds once, as the fused one does).
A failed build or launch raises; nothing falls back.

No chain reaches a fixed point: each output depends on its chain's start
value and on every iteration, so a kernel that skipped iterations, or
wrote one chain into every slot, differs from the plain chain.
``resolution`` says by how much: the least relative change that one
iteration less, or a neighbouring chain, makes; the comparison of
``tools/op_roofline.py`` requires the kernel's error to stay below it.

The pricing (``price``) takes each operation kind's count at its measured
class rate and sums the classes with no overlap: an op-priced estimate,
printed beside the published-peak bound (``published_bound``, the bound of
``chip_smoke.py``: every operation at 34 or 67 TFLOP/s).  It fuses every
add it can with a multiply (min(add, mul) fmas at the fma rate) and
takes from each class chain's time the add that the chain carries
(``CHAIN_ADDS``).  It is a lower bound only where the kernel issues at
least ``count_ops``' operations and its classes cannot overlap, as in
float64, where all of them issue to the one FP64 pipe; in float32 the
special functions run beside the FMA pipe, and the sum is an estimate.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from rays_tpu_torch import native

OPS = ("fma", "mul", "add", "div", "sqrt", "rsqrt", "exp", "log", "cube")
N = 32768           # threads: the batch of the slab main path, one ray each
W = 8               # independent chains per thread
K = 8               # dependent applications per iteration
ITERS = 300
# the ILP sweep of the fma chain, (W, K), beside the class rates' (8, 8)
ILP = ((1, 8), (1, 64), (8, 64))
MATVEC_OPS = 21     # per iteration: 9 mul + 6 add of M v, 3 mul + 3 add of 0.25 y + 0.1
# the adds each chain of OPS carries beside its class operation
CHAIN_ADDS = {"div": 1, "sqrt": 1, "rsqrt": 1, "exp": 1, "log": 1}

# launches of each kernel in this process (not of the plain chains)
LAUNCHES: collections.Counter = collections.Counter()

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-fmad=false")

# NVIDIA's H100 SXM data sheet: memory rate, and FP64 / FP32 rates outside
# the tensor cores (an FMA is two operations)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
# special-function unit: 16 results per clock per SM, 132 SMs at 1.98 GHz;
# the float32 exponential is one such instruction (float64 has no unit)
SFU_PER_S = 16 * 132 * 1.98e9
# floating-point instructions among the 60 that nvcc emits for one
# exp(double) on sm_90a (tools/slab_rk4_probe.py sass)
EXP_F64_INSTRUCTIONS = 20

# the measured classes that price one operation of each kind of
# fused_slab.OP_KINDS (adds and multiplies that pair up: at the fma rate,
# ``price``): a power is an exponential of a logarithm
PRICE_OF_KIND = {"add": ("add",), "mul": ("mul",), "div": ("div",), "sqrt": ("sqrt",),
                 "exp": ("exp",), "pow": ("exp", "log")}
# ... and of each class of utils/op_census.CLASSES: comparisons, selects,
# reductions and copies at one add per element, as the JAX script priced
# them at its fma rate; the transcendental functions ('other' holds the
# rest) at the exponential's
PRICE_OF_CLASS = {"add": ("add",), "mul": ("mul",), "div": ("div",), "sqrt": ("sqrt",),
                  "exp": ("exp",), "log": ("log",), "pow": ("exp", "log"),
                  "compare": ("add",), "select": ("add",), "reduce": ("add",),
                  "copy": ("add",), "other": ("exp",)}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def kernel_name(op, w, k, dtype) -> str:
    """The name of a chain kernel in reports and the kernels line."""
    size = "" if (w, k) == (W, K) else f"_w{w}_k{k}"
    return f"op_rates_{op}{size}_{_SUFFIX[dtype]}"


def matvec_name(dtype) -> str:
    return f"op_rates_matvec_{_SUFFIX[dtype]}"


def chain_inputs(w=W, n=N, dtype=torch.float32, device="cpu"):
    """The start values (w, n): 1.1 ... 2.3 in even steps, as the script's."""
    return torch.linspace(1.1, 2.3, w * n, dtype=torch.float64).to(
        dtype=dtype, device=device).reshape(w, n)


def matvec_inputs(n=N, dtype=torch.float32, device="cpu"):
    """(m (9, n), x (3, n)): per column, four times the rotation by 0.3 ...
    1.2 rad about an axis in the first octant, x of ones.  The kernel's
    0.25 M v is then the rotated v exactly: v turns and moves along the
    axis by 0.1 (1, 1, 1) . axis every iteration, and never settles."""
    t = torch.linspace(0.0, 1.0, n, dtype=torch.float64)
    axis = torch.stack([1.0 + t, 2.0 - t, 1.0 + (3.7 * t) % 1.0])
    axis = axis / axis.norm(dim=0)
    theta = 0.3 + 0.9 * t
    c, s = torch.cos(theta), torch.sin(theta)
    (ux, uy, uz), k = axis, 1.0 - c
    rot = torch.stack([c + ux * ux * k, ux * uy * k - uz * s, ux * uz * k + uy * s,
                       uy * ux * k + uz * s, c + uy * uy * k, uy * uz * k - ux * s,
                       uz * ux * k - uy * s, uz * uy * k + ux * s, c + uz * uz * k])
    return ((4.0 * rot).to(dtype=dtype, device=device),
            torch.ones((3, n), dtype=dtype, device=device))


def chain_ops(x, k=K, iters=ITERS) -> int:
    """Operations of one chain launch over x: one per application."""
    return x.numel() * k * iters


def chain_flops(op, x, k=K, iters=ITERS) -> int:
    """Floating-point operations of one launch as the published peaks
    count them: an fma is two; every other application is one, whatever
    instructions it takes (the count of chip_smoke.py's bound)."""
    return chain_ops(x, k, iters) * (2 if op == "fma" else 1)


_SPLIT = 134217729.0     # 2**27 + 1: Veltkamp's split of a float64


def _split(a):
    """(hi, lo) with hi + lo = a, each of 26 bits at most."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def fma_reference(y, a, b):
    """y * a + b rounded once, as the kernel's fma() (a and b Python
    floats, rounded first to y's type).  float32: the product of two
    float32 is exact in float64, and the sum is rounded to float64 and
    then to float32.  float64: the product's rounding error by Dekker's
    product, the sum's by Knuth's two-sum, both added back before the
    last rounding (exact but where the result lies within 2**-100 of a
    rounding boundary; b is far smaller than y*a here)."""
    a = torch.tensor(a, dtype=y.dtype).item()
    b = torch.tensor(b, dtype=y.dtype).item()
    if y.dtype == torch.float32:
        return (y.double() * a + b).float()
    p = y * a
    (yh, yl), (ah, al) = _split(y), _split(a)
    e = ((yh * ah - p) + yh * al + yl * ah) + yl * al
    s = p + b
    t = b - (s - p)         # |p| >= |b|: the two-sum's error exactly
    return s + (t + e)


def _step(op, y):
    """One application of ``op`` to y in plain PyTorch, rounding as the
    kernel does."""
    if op == "fma":
        return fma_reference(y, 1.0000001, 1e-9)
    if op == "mul":
        return y * 1.0000001
    if op == "add":
        return y + 1e-3
    if op == "div":
        # a tensor over a tensor: ``0.6 / y`` would multiply by 1 / y
        return y + y.new_tensor(0.6) / y
    if op == "sqrt":
        return y + torch.sqrt(y)
    if op == "rsqrt":
        return y + torch.rsqrt(y)
    if op == "exp":
        return y + torch.exp(-y)
    if op == "log":
        return y + torch.log(y)
    if op == "cube":
        return y - y * y * y * 1e-4
    raise ValueError(f"unknown operation class {op!r}")


def chain_reference(op, x, k=K, iters=ITERS):
    """The plain chain: ``iters`` x ``k`` applications of ``op`` to every
    element of x, on x's device."""
    y = x
    for _ in range(iters * k):
        y = _step(op, y)
    return y


def matvec_reference(m, x, iters=ITERS):
    """The plain 3x3 product chain: v = 0.25 M v + 0.1 per column of x,
    ``iters`` times, summed left to right as the kernel sums; m (9, n)
    row-major per column, x (3, n)."""
    v0, v1, v2 = x[0], x[1], x[2]
    for _ in range(iters):
        y0 = m[0] * v0 + m[1] * v1 + m[2] * v2
        y1 = m[3] * v0 + m[4] * v1 + m[5] * v2
        y2 = m[6] * v0 + m[7] * v1 + m[8] * v2
        v0, v1, v2 = y0 * 0.25 + 0.1, y1 * 0.25 + 0.1, y2 * 0.25 + 0.1
    return torch.stack([v0, v1, v2])


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the op-rate kernels.  Returns
    (ctypes library, compiler output with the -Xptxas -v report)."""
    from rays_tpu_torch.tracing import fused_slab

    nvcc = fused_slab._nvcc()
    files = [native.CSRC / "op_rates.cu"]
    (path, log), = native.build_all([(
        "op_rates", files,
        lambda out: [nvcc, *NVCC_FLAGS, "-o", str(out), "op_rates.cu"])])
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for suffix in _SUFFIX.values():
        fn = getattr(lib, f"rays_op_chain_{suffix}")
        fn.argtypes, fn.restype = [ci, ci, ci, vp, vp, ci, ci, vp], ci
        fn = getattr(lib, f"rays_op_matvec_{suffix}")
        fn.argtypes, fn.restype = [vp, vp, vp, ci, ci, vp], ci
    return lib, log


def _check(t, rows, what):
    if t.dtype not in _SUFFIX:
        raise ValueError(f"{what} must be float32 or float64, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous ({rows}, n), got {tuple(t.shape)}")


def chain(op, x, k=K, iters=ITERS):
    """The chain kernel on x (w, n), w independent chains per thread, one
    thread per column.  CUDA tensors: launch (asynchronously) and count
    the launch; CPU tensors: ``chain_reference``."""
    if op not in OPS:
        raise ValueError(f"unknown operation class {op!r}")
    if x.device.type == "cpu":
        return chain_reference(op, x, k, iters)
    if x.device.type != "cuda":
        raise ValueError(f"op_rates.chain: unsupported device {x.device}")
    _check(x, x.shape[0], "x")
    w, n = x.shape
    lib, _ = load_library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"rays_op_chain_{_SUFFIX[x.dtype]}")(
            OPS.index(op), w, k, x.data_ptr(), y.data_ptr(), n, iters, stream)
    if rc != 0:
        raise RuntimeError(f"op_rates chain {op} (w={w}, k={k}) launch failed: "
                           + ("not instantiated" if rc == -1 else f"CUDA error {rc}"))
    LAUNCHES[kernel_name(op, w, k, x.dtype)] += 1
    return y


def matvec(m, x, iters=ITERS):
    """The 3x3 product kernel (m (9, n), x (3, n)); CPU tensors:
    ``matvec_reference``."""
    if m.device.type == "cpu":
        return matvec_reference(m, x, iters)
    if m.device.type != "cuda" or x.device != m.device or x.dtype != m.dtype:
        raise ValueError("op_rates.matvec: m and x must be CUDA tensors of one dtype")
    _check(m, 9, "m")
    _check(x, 3, "x")
    lib, _ = load_library()
    y = torch.empty_like(x)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = getattr(lib, f"rays_op_matvec_{_SUFFIX[m.dtype]}")(
            m.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1], iters, stream)
    if rc != 0:
        raise RuntimeError(f"op_rates matvec launch failed: CUDA error {rc}")
    LAUNCHES[matvec_name(m.dtype)] += 1
    return y


def resolution(prev, out, per_column=False):
    """The least relative change between ``prev`` and ``out``, two outputs
    of a plain chain (w, n) one iteration apart, and between neighbouring
    chains of one thread of ``out``: the error below which a comparison
    with ``out`` tells a kernel short of one iteration, or one that copied
    a chain into its neighbour, from a right one.  ``per_column``: relative
    to each column's largest magnitude (the matvec, whose components pass
    through zero), else to each element's."""
    out, prev = out.double(), prev.double()
    scale = out.abs().amax(0, keepdim=True) if per_column else out.abs()
    gap = (out - prev).abs() / scale
    least = float((gap.amax(0) if per_column else gap).min())
    if out.shape[0] > 1 and not per_column:
        least = min(least, float(((out[1:] - out[:-1]).abs() / scale[1:]).min()))
    return least


def unit_costs(rates):
    """{class: seconds per operation} at ``rates`` ({class: operations per
    second}): each class chain's time per application, less the adds it
    carries at the add rate (never below zero)."""
    cost = {c: 1.0 / r for c, r in rates.items()}
    for c, n in CHAIN_ADDS.items():
        if c in cost:
            cost[c] = max(cost[c] - n / rates["add"], 0.0)
    return cost


def price(counts, rates, price_of=PRICE_OF_KIND):
    """(seconds, {kind: seconds}) of ``counts`` ({kind: operations}) at
    ``rates`` ({class: operations per second}): min(add, mul) pairs as
    fmas at the fma rate (part "fma"), each other operation at the classes
    ``price_of`` names (``unit_costs``), the kinds summed with no overlap.
    Raises KeyError for a kind without a price."""
    cost = unit_costs(rates)
    counts = dict(counts)
    fused = min(counts.get("add", 0), counts.get("mul", 0))
    counts["add"], counts["mul"] = counts.get("add", 0) - fused, counts.get("mul", 0) - fused
    parts = {"fma": fused * cost["fma"]}
    parts.update({kind: n * sum(cost[c] for c in price_of[kind])
                  for kind, n in counts.items()})
    return sum(parts.values()), parts


def replicated_totals(ray_ops, n_rays):
    """{kind: operations} of n_rays rays that tile the example's launch
    rays (examples.replicate_rays), from each launch ray's counts."""
    reps = np.bincount(np.arange(n_rays) % len(ray_ops), minlength=len(ray_ops))
    return {k: int(sum(r * o[k] for r, o in zip(reps, ray_ops))) for k in ray_ops[0]}


def published_bound(total, n_rays, nv, dtype):
    """(bound ms, 'bytes' or 'operations', detail) of one slab RK4 launch
    doing ``total`` ({kind: operations}) on n_rays rays.  Bytes: v0 and
    status0 read, the end state, two int32 and two residuals per ray
    written.  Operations: every add, multiply, divide, square root,
    exponential and power as one, at the published peak of the type; for
    float32 also the exponentials at the special-function rate."""
    flops = sum(total.values())
    size = torch.finfo(dtype).bits // 8
    n_bytes = n_rays * (2 * nv * size + 3 * 4 + 2 * size)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if dtype == torch.float32:
        t_ops = max(t_ops, total["exp"] / SFU_PER_S * 1e3)
    detail = dict(total, flops=flops, bytes=n_bytes, ms_bytes=t_bytes, ms_ops=t_ops)
    if dtype == torch.float64:
        detail["ms_ops_exp_expanded"] = (
            (flops + (EXP_F64_INSTRUCTIONS - 1) * total["exp"]) / PEAK_FLOPS[dtype] * 1e3)
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), detail


def chain_bound(op, x, k=K, iters=ITERS):
    """(bound ms, 'bytes' or 'operations') of one chain launch at the
    published peaks: x read once and y written once, the operations of
    ``chain_flops``."""
    t_bytes = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    t_ops = chain_flops(op, x, k, iters) / PEAK_FLOPS[x.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def matvec_bound(m, x, iters=ITERS):
    t_bytes = (m.numel() + 2 * x.numel()) * x.element_size() / HBM_BYTES_PER_S * 1e3
    t_ops = MATVEC_OPS * x.shape[1] * iters / PEAK_FLOPS[x.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def example_ray_ops(text):
    """([{kind: operations}], [npoints]) of each launch ray of the slab
    example ``text``, counted on the CPU by the kernel body itself
    (``fused_slab.count_ops`` on the g++ build)."""
    from rays_tpu_torch import examples
    from rays_tpu_torch.tracing import fused_slab

    cfg, params, v0, st0, _ = examples.setup_example(text, device="cpu", dtype=torch.float64)
    lib = fused_slab.load_host_libraries()[fused_slab._variant(cfg)]
    ops, npts = [], []
    for i in range(v0.shape[0]):
        o, n = fused_slab.count_ops(lib, cfg, params, v0[i:i + 1].contiguous(),
                                    st0[i:i + 1].contiguous())
        ops.append(o)
        npts.append(int(n[0]))
    return ops, npts


def per_ray_step(ray_ops, npts):
    """{kind: operations per ray step} over the launch rays' steps."""
    steps = sum(p - 1 for p in npts)
    return {k: sum(o[k] for o in ray_ops) / steps for k in ray_ops[0]}
