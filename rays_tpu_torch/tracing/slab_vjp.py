"""The undamped slab RK4 step and its VJP as two CUDA kernels: the
adjoint graph's pieces (tracing/graphed_adjoint.py) for the slab kernel's
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
a (rows, B) accumulator.  ``SlabVJP.finish_backward`` sums that over
rays into the leaves' accumulators once per backward.

The generic forward piece copies the carry into the stack
(``index_copy_``) and runs ``trace.step``: about 1,250 library kernels a
step.  Here it is one launch of ``rays::slab_rk4_step`` (in the same
library, the per-ray body in ``csrc/slab_rk4_step.cuh``): one thread per
ray writes its carry into the stack at the device index k, steps it with
the slab kernel's physics and the RK4 stages that the VJP recomputes, and
writes the carry after the step in place (with trajectories, row k + 1
too).  Both kernels read the Params from one packed device vector that
``SlabVJP.pack`` fills at each run's load, in the slab kernel's layout
(``fused_slab.run_rows``), so a captured launch reads each run's values
and nothing is read on the host (tracing/kernel_side.py).  Their plain versions
are the generic pieces: the tests hold the same bodies, built with g++
(``csrc/slab_rk4_vjp_host.cpp``), to them on the CPU.

``takes`` is the gate, one decision from the config and the device: CUDA
tensors, ``fused_slab.supported(cfg)`` and ``damping_model == "no_damp"``;
``StaticAdjoint`` makes it and nothing else does, and takes both kernels
or neither, so a run differentiates the arithmetic it ran: on the card
its forward is the slab kernel's arithmetic (tracing/fused_slab.py), at
rounding level from ``trace.step``'s.  Every other configuration keeps
the generic pieces.  A failed build or launch raises; nothing falls
back.  ``LAUNCHES`` (the VJP) and ``STEP_LAUNCHES`` (the step) count the
kernels' launches in this process, not the host build's: those made
outside a capture here, and for a captured piece the launches that
``SlabVJP.launch`` made into its graph, added at each replay
(``kernel_side.KernelSide``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rays_tpu_torch import native
from rays_tpu_torch.tracing import fused_slab
from rays_tpu_torch.tracing.kernel_side import CARRY, KernelSide, ptr

# launches of the CUDA kernels in this process (not of the host build)
LAUNCHES = 0        # the VJP
STEP_LAUNCHES = 0   # the forward step

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
                    + [("B", ctypes.c_int64), ("nstep_max", ctypes.c_int32),
                       ("codes", ctypes.c_int32 * fused_slab.N_CODES)])
    return SlabVjpArgs


def _step_args_type(ctype):
    p = ctypes.c_void_p

    class SlabStepArgs(ctypes.Structure):
        _fields_ = ([(n, p) for n in ("params", "k", *CARRY)]
                    + [(f"stack_{n}", p) for n in CARRY]
                    + [("traj", p), ("resid", p), ("B", ctypes.c_int64),
                       ("nstep_max", ctypes.c_int32),
                       ("codes", ctypes.c_int32 * fused_slab.N_CODES)])
    return SlabStepArgs


# each piece's argument struct by precision, and the header that declares it
_ARGS = {"vjp": ({torch.float64: _args_type(ctypes.c_double),
                  torch.float32: _args_type(ctypes.c_float)}, "slab_rk4_vjp.cuh"),
         "step": ({torch.float64: _step_args_type(ctypes.c_double),
                   torch.float32: _step_args_type(ctypes.c_float)}, "slab_rk4_step.cuh")}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def bind(lib):
    """Declare the C interface of a slab VJP library (the CUDA launchers or
    the host build of the same bodies) and check its row and argument
    layouts."""
    fused_slab.check_rows(lib)
    for piece, (types, header) in _ARGS.items():
        for dtype, suffix in _SUFFIX.items():
            size = getattr(lib, f"rays_slab_{piece}_args_size_{suffix}")
            size.argtypes, size.restype = [], ctypes.c_int
            want = ctypes.sizeof(types[dtype])
            if size() != want:
                raise RuntimeError(
                    f"{types[dtype].__name__}<{suffix}> layout differs between csrc/{header} "
                    f"({size()} bytes) and slab_vjp.py ({want} bytes)")
            fn = getattr(lib, f"rays_slab_{piece}_{suffix}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


_FILES = ("slab_rk4_step.cuh", "slab_rk4_vjp.cuh", "slab_rk4.cuh")


@functools.lru_cache(maxsize=None)
def load_library(dtype, ns):
    """Build (at first use, with nvcc) and load the CUDA library of one
    precision and species count, the VJP and the forward step; returns
    (ctypes library, compiler output with the -Xptxas -v report of both
    kernels)."""
    nvcc = native.nvcc()
    files = [native.CSRC / f for f in ("slab_rk4_vjp.cu", *_FILES)]
    flags = (f"-DRAYS_VJP_SPECIES={int(ns)}", f"-DRAYS_VJP_F64={int(dtype == torch.float64)}")
    (path, log), = native.build_all([(
        f"slab_rk4_vjp_{_SUFFIX[dtype]}_s{int(ns)}", files,
        lambda out: [nvcc, *native.NVCC_FLAGS, *flags, "-o", str(out), "slab_rk4_vjp.cu"])])
    return bind(ctypes.CDLL(str(path))), log


@functools.lru_cache(maxsize=None)
def load_host_library():
    """Build (at first use, with g++) and load the host build of the same
    bodies, ``csrc/slab_rk4_vjp_host.cpp``, for the CPU tests and
    ``count_ops``.  Nothing on the tracing path uses it."""
    gxx = native.gxx()
    files = [native.CSRC / f for f in ("slab_rk4_vjp_host.cpp", "counted.h", *_FILES)]
    (path, _), = native.build_all([(
        "slab_rk4_vjp_host", files,
        lambda out: [gxx, *native.HOST_FLAGS, "-o", str(out), "slab_rk4_vjp_host.cpp"])])
    lib = bind(ctypes.CDLL(str(path)))
    fn = lib.rays_slab_vjp_count_ops
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    return lib


class SlabVJP(KernelSide):
    """The slab kernels' side of one ``StaticAdjoint`` (``loop``): the
    packed Params vector (``fused_slab.run_rows`` of the loop's static
    leaves), the VJP's (rows, B) accumulator over its first rows, and each
    piece's launch arguments: both pieces are its kernels'."""

    PIECES = ("step", "vjp")

    def __init__(self, lib, loop):
        cfg, p = loop.cfg, loop.params
        if not fused_slab.supported(cfg) or cfg.damping_model != "no_damp":
            raise ValueError("the slab VJP takes the slab kernel's configs without damping")
        # the packed vector's sources, views of the leaves' values outside
        # autograd (a view with a grad_fn would hold each leaf's gradient
        # accumulator on this stream), and for each leaf the VJP
        # differentiates: its index in loop.leaves, its first and past-last
        # rows
        super().__init__(lib, loop, fused_slab.run_rows(cfg, p))
        n_diff = len(fused_slab.ROWS) + len(fused_slab.SPECIES_ROWS)
        differentiated = fused_slab.run_leaves(p)[:n_diff]
        index = {id(t): i for i, t in enumerate(loop.leaves)}
        self.leaf_of, start = [], 0
        for t, src in zip(differentiated, self.sources):
            self.leaf_of.append((index[id(t)], start, start + src.numel()))
            start += src.numel()
        v = loop.carry[0]
        B, dt = v.shape[0], v.dtype
        self.acc = torch.zeros((start, B), dtype=dt, device=v.device)
        stack, carry = loop.stack, loop.carry
        cot_v, cot_f1, _, cot_end, cot_max = loop.cot
        models = dict(B=B, nstep_max=cfg.nstep_max, codes=fused_slab.model_codes(cfg))
        self.args = {
            "vjp": _ARGS["vjp"][0][dt](
                params=ptr(self.params), k=ptr(loop.k), stack_v=ptr(stack[0]),
                stack_f1=ptr(stack[1]), stack_nstep=ptr(stack[5]), stack_end=ptr(stack[6]),
                stack_max=ptr(stack[7]), nstep_out=ptr(carry[5]), end_out=ptr(carry[6]),
                cot_v=ptr(cot_v), cot_f1=ptr(cot_f1), cot_end=ptr(cot_end),
                cot_max=ptr(cot_max), traj_cot=ptr(loop.traj_cot),
                resid_cot=ptr(loop.resid_cot), acc=ptr(self.acc), **models),
            "step": _ARGS["step"][0][dt](
                params=ptr(self.params), k=ptr(loop.k),
                **{n: ptr(t) for n, t in zip(CARRY, carry)},
                **{f"stack_{n}": ptr(t) for n, t in zip(CARRY, stack)},
                traj=ptr(loop.traj), resid=ptr(loop.resid), **models)}
        self.fn = {piece: getattr(lib, f"rays_slab_{piece}_{_SUFFIX[dt]}")
                   for piece in self.args}

    def vjp(self):
        """The VJP of outer step k - 1 as one launch (k the device index,
        stepped down first): the carry cotangent in place, the Params
        cotangents into the per-ray accumulator."""
        self.k.sub_(1)
        self.launch("vjp")

    def count(self, piece, n):
        global LAUNCHES, STEP_LAUNCHES
        if piece == "step":
            STEP_LAUNCHES += n
        else:
            LAUNCHES += n

    def start_backward(self):
        self.acc.zero_()

    def finish_backward(self, acc):
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
    s = loop.kernels
    if (not isinstance(s, SlabVJP) or s.device.type != "cpu"
            or s.params.dtype != torch.float64):
        raise ValueError("count_ops takes a CPU float64 loop with the host build's slab VJP")
    k, n = int(loop.k), loop.cfg.nstep_max
    after = loop.carry[5] if k + 1 >= n else loop.stack[5][k + 1]
    live = int((after != loop.stack[5][k]).sum())
    n_kinds = len(fused_slab.OP_KINDS)
    ops = (ctypes.c_int64 * (2 * n_kinds))()
    rc = s.lib.rays_slab_vjp_count_ops(ctypes.addressof(s.args["vjp"]), s.ns,
                                       ctypes.addressof(ops))
    if rc != 0:
        raise RuntimeError(f"rays_slab_vjp_count_ops failed ({rc})")
    return (dict(zip(fused_slab.OP_KINDS, ops[:n_kinds])),
            dict(zip(fused_slab.OP_KINDS, ops[n_kinds:])), live)
