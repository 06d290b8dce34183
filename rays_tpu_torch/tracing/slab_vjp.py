"""The VJP of the undamped slab RK4 step as one CUDA kernel: the adjoint
graph's backward piece (tracing/graphed_adjoint.py) for the slab kernel's
configurations without damping.

The generic backward piece recomputes ``trace.step`` under autograd and
calls ``torch.autograd.grad``: captured, about 3,900 library kernels of a
microsecond or two per outer step at 32,768 rays, so the backward is
launch-bound.  Here the piece is one launch of ``rays::slab_rk4_vjp``
(``csrc/slab_rk4_vjp.cu``, the per-ray body in ``csrc/slab_rk4_vjp.cuh``,
which says what bounds it and what its design does about that): one
thread per ray reads the ray's carry before the step from the stack that
the adjoint graph keeps, recomputes the step with the slab kernel's
physics, runs it backwards by hand, writes the float carry's cotangents
back in place and adds the cotangents of the Params values it reads into
a (rows, B) accumulator.  ``SlabVJP.reduce`` sums that over rays into the
leaves' accumulators once per backward.  Its plain version is the generic
piece: the tests hold the same body, built with g++
(``csrc/slab_rk4_vjp_host.cpp``), to it on the CPU.

``takes`` is the gate, one decision from the config and the device: CUDA
tensors, ``fused_slab.supported(cfg)`` and ``damping_model == "no_damp"``;
``StaticAdjoint`` makes it and nothing else does.  Every other
configuration keeps the generic piece.  A failed build or launch raises;
nothing falls back.  ``LAUNCHES`` counts the kernel's launches in this
process, not the host build's: those made outside a capture here, and for
a captured piece the launches ``SlabVJP.launch`` made into its graph
(``captured``), added at each replay (``graphed_adjoint._replay``).
"""

from __future__ import annotations

import ctypes
import functools
import shutil

import torch

from rays_tpu_torch import native
from rays_tpu_torch.tracing import fused_slab

# launches of the CUDA kernel in this process (not of the host build)
LAUNCHES = 0

# the packed Params vector and the accumulator rows, in rays::P_* order;
# then alpha_coef, gamma_coef and n0s, S rows each
ROWS = (("eq", "rmaj"), ("eq", "rmin"), ("eq", "x0"), ("eq", "by0"), ("eq", "bz0"),
        ("eq", "lby_shear_scale"), ("eq", "lbz_scale"), ("eq", "dbzdx"), ("eq", "ln_scale"),
        ("eq", "alphan1"), ("rf", "omgrf"), ("rf", "omgrf_ref"), ("rf", "k0"), ("ode", "ds"))
SPECIES_ROWS = (("species", "alpha_coef"), ("species", "gamma_coef"), ("species", "n0s"))

NVCC_FLAGS = fused_slab.NVCC_FLAGS
HOST_FLAGS = fused_slab.HOST_FLAGS


def takes(cfg, device) -> bool:
    """Whether the adjoint graph's "vjp" piece is this kernel: CUDA
    tensors, a configuration of the slab kernel, without damping."""
    return (torch.device(device).type == "cuda" and fused_slab.supported(cfg)
            and cfg.damping_model == "no_damp")


def _args_type(ctype):
    p = ctypes.c_void_p

    class SlabVjpArgs(ctypes.Structure):
        _fields_ = ([(n, p) for n in ("params", "k", "stack_v", "stack_f1", "stack_nstep",
                                      "stack_end", "stack_max", "nstep_out", "end_out",
                                      "cot_v", "cot_f1", "cot_end", "cot_max", "traj_cot",
                                      "resid_cot", "acc")]
                    + [("B", ctypes.c_int64)]
                    + [(n, ctypes.c_int32) for n in ("nstep_max", "by_model", "bz_model",
                                                     "dens_model", "time_param", "pad")])
    return SlabVjpArgs


_ARGS = {torch.float64: _args_type(ctypes.c_double), torch.float32: _args_type(ctypes.c_float)}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def bind(lib):
    """Declare the C interface of a slab VJP library (the CUDA launchers or
    the host build of the same body) and check the argument layout."""
    for dtype, suffix in _SUFFIX.items():
        size = getattr(lib, f"rays_slab_vjp_args_size_{suffix}")
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != ctypes.sizeof(_ARGS[dtype]):
            raise RuntimeError(
                f"SlabVjpArgs<{suffix}> layout differs between csrc/slab_rk4_vjp.cuh "
                f"({size()} bytes) and slab_vjp.py ({ctypes.sizeof(_ARGS[dtype])} bytes)")
        fn = getattr(lib, f"rays_slab_vjp_{suffix}")
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    return lib


_FILES = ("slab_rk4_vjp.cuh", "slab_rk4.cuh")


@functools.lru_cache(maxsize=None)
def load_library(dtype, ns):
    """Build (at first use, with nvcc) and load the CUDA library of one
    precision and species count; returns (ctypes library, compiler output
    with the -Xptxas -v report)."""
    nvcc = fused_slab._nvcc()
    files = [native.CSRC / f for f in ("slab_rk4_vjp.cu", *_FILES)]
    flags = (f"-DRAYS_VJP_SPECIES={int(ns)}", f"-DRAYS_VJP_F64={int(dtype == torch.float64)}")
    (path, log), = native.build_all([(
        f"slab_rk4_vjp_{_SUFFIX[dtype]}_s{int(ns)}", files,
        lambda out: [nvcc, *NVCC_FLAGS, *flags, "-o", str(out), "slab_rk4_vjp.cu"])])
    return bind(ctypes.CDLL(str(path))), log


@functools.lru_cache(maxsize=None)
def load_host_library():
    """Build (at first use, with g++) and load the host build of the same
    body, ``csrc/slab_rk4_vjp_host.cpp``, for the CPU tests and
    ``count_ops``.  Nothing on the tracing path uses it."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host build of the slab VJP needs it")
    files = [native.CSRC / f for f in ("slab_rk4_vjp_host.cpp", "counted.h", *_FILES)]
    (path, _), = native.build_all([(
        "slab_rk4_vjp_host", files,
        lambda out: [gxx, *HOST_FLAGS, "-o", str(out), "slab_rk4_vjp_host.cpp"])])
    lib = bind(ctypes.CDLL(str(path)))
    fn = lib.rays_slab_vjp_count_ops
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    return lib


def occupancy(lib):
    """What the CUDA runtime reports for a CUDA library's instantiation:
    {threads per block, blocks per SM, warps per SM, registers, local
    bytes}."""
    out = (ctypes.c_int * 4)()
    fn = lib.rays_slab_vjp_occupancy
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    rc = fn(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"slab VJP occupancy query failed with CUDA error {rc}")
    threads, blocks, regs, local = out
    return {"threads": threads, "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "registers": regs, "local_bytes": local}


def _ptr(t):
    return None if t is None else t.data_ptr()


class SlabVJP:
    """The kernel's side of one ``StaticAdjoint`` (``loop``): the packed
    Params vector, the (rows, B) accumulator and the launch's arguments,
    all on the loop's static buffers, so that a captured launch reads the
    values of each run.  ``lib``: a bound library whose code can address
    the loop's tensors (the CUDA library, or the host build on the CPU)."""

    def __init__(self, lib, loop):
        cfg, p = loop.cfg, loop.params
        self.captured = 0       # launches made into a CUDA graph's capture
        if not fused_slab.supported(cfg) or cfg.damping_model != "no_damp":
            raise ValueError("the slab VJP takes the slab kernel's configs without damping")
        v = loop.carry[0]
        B, dt, dev = v.shape[0], v.dtype, v.device
        self.lib, self.ns = lib, cfg.ns
        # the packed vector's sources (a scalar leaf is one row), and for
        # each: its leaf's index in loop.leaves, its first and past-last rows
        leaves = [getattr(getattr(p, g), f) for g, f in ROWS + SPECIES_ROWS]
        self.sources = [t.reshape(-1)[:cfg.ns] for t in leaves]
        index = {id(t): i for i, t in enumerate(loop.leaves)}
        self.leaf_of, start = [], 0
        for t, src in zip(leaves, self.sources):
            self.leaf_of.append((index[id(t)], start, start + src.numel()))
            start += src.numel()
        self.params = torch.zeros((start,), dtype=dt, device=dev)
        self.acc = torch.zeros((start, B), dtype=dt, device=dev)
        stack, carry = loop.stack, loop.carry
        cot_v, cot_f1, _, cot_end, cot_max = loop.cot
        st = cfg.eq_static
        self.args = _ARGS[dt](
            params=_ptr(self.params), k=_ptr(loop.k), stack_v=_ptr(stack[0]),
            stack_f1=_ptr(stack[1]), stack_nstep=_ptr(stack[5]), stack_end=_ptr(stack[6]),
            stack_max=_ptr(stack[7]), nstep_out=_ptr(carry[5]), end_out=_ptr(carry[6]),
            cot_v=_ptr(cot_v), cot_f1=_ptr(cot_f1), cot_end=_ptr(cot_end),
            cot_max=_ptr(cot_max), traj_cot=_ptr(loop.traj_cot), resid_cot=_ptr(loop.resid_cot),
            acc=_ptr(self.acc), B=B, nstep_max=cfg.nstep_max,
            by_model=fused_slab._BY_MODELS[st.by_prof_model],
            bz_model=fused_slab._BZ_MODELS[st.bz_prof_model],
            dens_model=fused_slab._DENS_MODELS[st.dens_prof_model],
            time_param=int(cfg.ray_param == "time"), pad=0)
        self.fn = getattr(lib, f"rays_slab_vjp_{_SUFFIX[dt]}")
        self.device = dev

    def pack(self):
        """The Params values into the packed vector, from the loop's static
        leaves, on the device (no host read)."""
        torch.cat(self.sources, out=self.params)

    def launch(self):
        """The VJP of outer step k (the loop's device index, already
        stepped down) on the current stream.  Counted in ``LAUNCHES`` or,
        made into a capture, in ``captured``."""
        global LAUNCHES
        stream = (torch.cuda.current_stream(self.device).cuda_stream
                  if self.device.type == "cuda" else None)
        rc = self.fn(ctypes.addressof(self.args), self.ns, stream)
        if rc != 0:
            raise RuntimeError(f"slab VJP launch failed with error {rc}")
        if self.device.type != "cuda":
            return
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            LAUNCHES += 1

    def reduce(self, acc):
        """The accumulator summed over rays into the leaves' accumulators
        ``acc`` (``loop.acc``, zeroed by the caller)."""
        sums = self.acc.sum(1)
        for leaf, a, b in self.leaf_of:
            acc[leaf].view(-1)[:b - a].add_(sums[a:b])


def count_ops(loop):
    """Floating-point operations of the VJP of the loop's current step k
    (a CPU float64 ``StaticAdjoint`` whose stack holds a forward, with its
    slab VJP on the host build), by kind (``fused_slab.OP_KINDS``): (all the
    body does, the part of them that repeats values the step computed
    before, the rays that stepped: the live ray steps they are spent on).
    What the VJP needs is the first less the second: one forward step
    and its reverse.  The cotangents and accumulators are written as a
    launch writes them."""
    s = loop.slab
    if s is None or s.device.type != "cpu" or s.params.dtype != torch.float64:
        raise ValueError("count_ops takes a CPU float64 loop with the host build's slab VJP")
    k, n = int(loop.k), loop.cfg.nstep_max
    after = loop.carry[5] if k + 1 >= n else loop.stack[5][k + 1]
    live = int((after != loop.stack[5][k]).sum())
    n_kinds = len(fused_slab.OP_KINDS)
    ops = (ctypes.c_int64 * (2 * n_kinds))()
    rc = s.lib.rays_slab_vjp_count_ops(ctypes.addressof(s.args), s.ns, ctypes.addressof(ops))
    if rc != 0:
        raise RuntimeError(f"rays_slab_vjp_count_ops failed ({rc})")
    return (dict(zip(fused_slab.OP_KINDS, ops[:n_kinds])),
            dict(zip(fused_slab.OP_KINDS, ops[n_kinds:])), live)
