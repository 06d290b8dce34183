"""The slab RK4 trajectory as one CUDA kernel: the GPU forward path of the
slab slices, undamped and with fundamental-ECH damping.

Replaces ``rays_tpu/tracing/fused_slab.py::trace_batch_fused``, the JAX
package's only Pallas kernel, and extends it to the damping slots the
Pallas kernel lacked.  The kernel (``csrc/slab_rk4.cu`` with the per-ray
physics in ``csrc/slab_rk4.cuh``) runs one thread per ray, keeps the
``cfg.nv``-slot state in registers for all ``nstep_max`` steps, carries
the endpoint evaluation into the next step's first RK stage (4 equilibrium
evaluations per step, the order of arithmetic of ``trace_batch``), and, on
top of what the Pallas kernel did, writes the trajectory when
``cfg.save_trajectory`` is on.

What bounds it on the card is FP64/FP32 arithmetic, not memory: about
1.4k operations per ray step at two species (four evaluations of about
340; 11 divisions and 9 square roots among them), plus, with damping, a
Dawson sum at the evaluations where damping is live; it reads nothing
from device memory between steps.  So the design works on instructions
per step and on warps per SM: divisions by constants of the run became
multiplications by reciprocals that the launcher derives once (the second
block of ``SlabRun``), groups sharing a denominator take one reciprocal,
the RK sum is folded into one accumulator and the slots that cannot move
in a slab are carried as constants (fewer registers), blocks are 64
threads under a register cap chosen per precision and variant on the
card, and the Dawson sum is skipped where its result is masked, cut where
its terms cannot change it, and multiplies by a table of 1/n.
``occupancy`` reports the warps an SM holds; ``count_ops`` (host build)
counts the operations a batch needs, from which ``chip_smoke.py`` takes
the kernel's bound.

The damping variant (none, damp_fund_ECH, damp_fund_ECH with per-species
slots) fixes the state width at compile time, so each variant is its own
library (``-DRAYS_DAMPING``); the three build side by side at first use.

``trace_batch_fused`` is the wrapper: on CUDA tensors it builds the kernel
libraries at first use (nvcc, see ``native.py``), launches the one of the
config's variant on the current stream and counts the launch in
``LAUNCHES``; on CPU tensors it runs the plain twin.  A failed build or
launch raises; nothing falls back.  ``trace_batch_fused_reference`` is the
plain twin: the port's generic ``trace_batch`` on the same inputs, with
the same outputs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil

import torch

from rays_tpu_torch import constants, native
from rays_tpu_torch.models import base
from rays_tpu_torch.tracing.trace import RayResults, trace_batch
from rays_tpu_torch.utils import spans

# launches of the CUDA kernel in this process (not of the plain twin)
LAUNCHES = 0

MAX_SPECIES = 6
# damping variants, numbered as rays::DAMP_* in csrc/slab_rk4.cuh
VARIANTS = (0, 1, 2)

# model numbering shared with csrc/slab_rk4.cuh
_BY_MODELS = {"zero": 0, "constant": 1, "toroid": 2, "linear_shear": 3}
_BZ_MODELS = {"zero": 0, "constant": 1, "toroid": 2, "linear": 3, "linear_2": 4}
_DENS_MODELS = {"constant": 0, "linear": 1, "Gaussian": 2}
_T_MODELS = {"zero": 0, "constant": 1, "linear": 2, "linear_2": 3, "parabolic": 4}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def supported(cfg) -> bool:
    """Whether the kernel covers this run: the analytic slab with the
    profile models of the Pallas kernel, cold dispersion without gradient
    diagnostics, fixed-step RK4, at most 6 species.  Unlike the Pallas
    kernel it also writes trajectories (``save_trajectory``) and runs
    ``damp_fund_ECH`` damping, with or without the per-species slots.
    It has no compensated carry: a ``compensated_sum`` run takes the graph
    route on the card (``trace.route``), which keeps it.  A model of the
    caller's own registered under the name ``"slab"`` is not the slab
    whose physics the kernel holds."""
    if cfg.equilib_model != "slab" or "slab" in base.EQ_MODELS or cfg.compensated_sum:
        return False
    if cfg.damping_model not in ("no_damp", "damp_fund_ECH"):
        return False
    if cfg.integrate_eq_gradients or cfg.ode_solver_name != "RK4_ODE":
        return False
    if cfg.ray_deriv_name != "cold" or cfg.ray_param not in ("arcl", "time"):
        return False
    st = cfg.eq_static
    return (cfg.ns <= MAX_SPECIES
            and st.bx_prof_model == "zero"
            and st.by_prof_model in _BY_MODELS
            and st.bz_prof_model in _BZ_MODELS
            and st.dens_prof_model in _DENS_MODELS
            and all(m in _T_MODELS for m in st.t_prof_model))


# --- the run constants, field for field as rays::SlabRun<T> ---------------

_SCALARS = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax", "rmaj", "rmin", "x0",
            "by0", "bz0", "lby_shear_scale", "lbz_scale", "dbzdx", "ln_scale",
            "alphan1", "lt_scale", "dtdx")
_SPECIES = ("alpha_coef", "gamma_coef", "n0s", "t0s", "alphat1", "alphat2", "t_min")
_RUN = ("omgrf", "omgrf_ref", "k0", "ds", "s_max", "dispersion_resid_limit",
        "total_damping_limit", "ms0", "clight")
# filled by the library (rays::derive_run) from the fields above
_DERIVED = ("inv_k0", "inv_k0sq", "inv_omgrf", "inv_rmaj", "inv_rmin", "inv_lby", "inv_lbz",
            "inv_ln", "inv_lt", "gauss_coef", "half_ds", "sixth_ds", "omgc_coef",
            "two_over_ms0", "inv_clight")
_DERIVED_SPECIES = ("alpha_w2", "gamma_w", "dn_linear")
_INTS = ("by_model", "bz_model", "dens_model", "time_param", "nstep_max",
         "save_trajectory")


def _struct_type(ctype):
    class SlabRun(ctypes.Structure):
        _fields_ = ([(n, ctype) for n in _SCALARS]
                    + [(n, ctype * MAX_SPECIES) for n in _SPECIES]
                    + [(n, ctype) for n in _RUN]
                    + [(n, ctype) for n in _DERIVED]
                    + [(n, ctype * MAX_SPECIES) for n in _DERIVED_SPECIES]
                    + [(n, ctypes.c_int32) for n in _INTS]
                    + [("t_model", ctypes.c_int32 * MAX_SPECIES)])
    return SlabRun


_RUN_STRUCTS = {torch.float64: _struct_type(ctypes.c_double),
                torch.float32: _struct_type(ctypes.c_float)}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _variant(cfg) -> int:
    """The kernel library of this config's damping (rays::DAMP_*)."""
    if cfg.damping_model == "no_damp":
        return 0
    return 2 if cfg.multi_spec_damping else 1


def _run_struct(cfg, params, dtype):
    """Read the run constants from Params with one device-to-host copy.
    The derived fields stay zero: the library's launchers fill them."""
    sp, eq, rf = params.species, params.eq, params.rf
    values = {**{n: getattr(eq, n) for n in _SCALARS},
              "alpha_coef": sp.alpha_coef, "gamma_coef": sp.gamma_coef, "n0s": sp.n0s,
              "t0s": sp.t0s, "alphat1": eq.alphat1, "alphat2": eq.alphat2,
              "t_min": eq.t_min, "omgrf": rf.omgrf, "omgrf_ref": rf.omgrf_ref, "k0": rf.k0,
              "ds": params.ode.ds, "s_max": params.ode.s_max,
              "dispersion_resid_limit": params.limits.dispersion_resid_limit,
              "total_damping_limit": params.limits.total_damping_limit, "ms0": sp.ms[0]}
    tensors = [(n, t.detach().reshape(-1)) for n, t in values.items()]
    flat = torch.cat([t for _, t in tensors]).cpu().tolist()

    run = _RUN_STRUCTS[dtype]()
    i = 0
    for n, t in tensors:
        if n in _SPECIES:
            getattr(run, n)[:t.numel()] = flat[i:i + t.numel()]
        else:
            setattr(run, n, flat[i])
        i += t.numel()
    run.clight = constants.CLIGHT
    st = cfg.eq_static
    run.by_model = _BY_MODELS[st.by_prof_model]
    run.bz_model = _BZ_MODELS[st.bz_prof_model]
    run.dens_model = _DENS_MODELS[st.dens_prof_model]
    run.time_param = int(cfg.ray_param == "time")
    run.nstep_max = cfg.nstep_max
    run.save_trajectory = int(cfg.save_trajectory)
    run.t_model[:cfg.ns] = [_T_MODELS[m] for m in st.t_prof_model]
    return run


def bind(lib):
    """Declare the C interface of a slab RK4 library (the CUDA launchers or
    the host build of the same body) and check the struct layout."""
    vp = ctypes.c_void_p
    lib.rays_slab_damping.argtypes, lib.rays_slab_damping.restype = [], ctypes.c_int
    for dtype, suffix in _SUFFIX.items():
        size = getattr(lib, f"rays_slab_run_size_{suffix}")
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != ctypes.sizeof(_RUN_STRUCTS[dtype]):
            raise RuntimeError(
                f"SlabRun<{suffix}> layout differs between csrc/slab_rk4.cuh "
                f"({size()} bytes) and fused_slab.py "
                f"({ctypes.sizeof(_RUN_STRUCTS[dtype])} bytes)")
        fn = getattr(lib, f"rays_slab_rk4_{suffix}")
        fn.argtypes = [vp, ctypes.c_int, vp, vp, ctypes.c_int64] + [vp] * 8
        fn.restype = ctypes.c_int
    return lib


def occupancy(lib, dtype, nspecies):
    """What the CUDA runtime reports for the kernel instantiation that a
    launch of ``lib`` at ``dtype`` and ``nspecies`` runs: {threads per
    block, blocks per SM, warps per SM, registers, local bytes}."""
    out = (ctypes.c_int * 4)()
    fn = lib.rays_slab_occupancy
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    rc = fn(int(dtype == torch.float64), nspecies, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"slab RK4 occupancy query failed with CUDA error {rc}")
    threads, blocks, regs, local = out
    return {"threads": threads, "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "registers": regs, "local_bytes": local}


OP_KINDS = ("add", "mul", "div", "sqrt", "exp", "pow")


def count_ops(host_lib, cfg, params, v0, status0):
    """Floating-point operations that the kernel body needs for these rays,
    by kind (``OP_KINDS``): the float64 trajectories run once on the CPU on
    a type that counts its arithmetic (``csrc/host_shim.cpp``).  Also
    returns npoints.  ``host_lib`` is a bound host build of the config's
    damping variant; the tensors are float64 on the CPU."""
    _check_inputs(cfg, v0, status0)
    if v0.dtype != torch.float64 or v0.device.type != "cpu":
        raise ValueError("count_ops takes float64 CPU tensors")
    if host_lib.rays_slab_damping() != _variant(cfg):
        raise ValueError("the host library holds another damping variant")
    B, nv = v0.shape
    cfg = dataclasses.replace(cfg, save_trajectory=False)
    run = _run_struct(cfg, params, torch.float64)
    v_out = torch.empty((B, nv), dtype=torch.float64)
    stop, npoints = (torch.empty((B,), dtype=torch.int32) for _ in range(2))
    end_res, max_res = (torch.empty((B,), dtype=torch.float64) for _ in range(2))
    ops = (ctypes.c_int64 * len(OP_KINDS))()
    fn = host_lib.rays_slab_count_ops
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64] + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    rc = fn(ctypes.addressof(run), cfg.ns, v0.data_ptr(), status0.data_ptr(), B,
            v_out.data_ptr(), stop.data_ptr(), npoints.data_ptr(), end_res.data_ptr(),
            max_res.data_ptr(), None, None, ctypes.addressof(ops))
    if rc != 0:
        raise RuntimeError(f"rays_slab_count_ops failed ({rc})")
    return dict(zip(OP_KINDS, ops)), npoints


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the slab RK4 CUDA kernel cannot be built")


@functools.lru_cache(maxsize=None)
def load_libraries():
    """Build (at first use, the three variants side by side) and load the
    CUDA kernel libraries.  Returns {variant: (ctypes library, compiler
    output with the -Xptxas -v report)}."""
    nvcc = _nvcc()
    files = [native.CSRC / "slab_rk4.cu", native.CSRC / "slab_rk4.cuh"]

    def spec(variant):
        return (f"slab_rk4_d{variant}", files,
                lambda out: [nvcc, *NVCC_FLAGS, f"-DRAYS_DAMPING={variant}", "-o",
                             str(out), "slab_rk4.cu"])

    built = native.build_all([spec(v) for v in VARIANTS])
    return {v: (bind(ctypes.CDLL(str(path))), log) for v, (path, log) in zip(VARIANTS, built)}


HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def load_host_libraries():
    """Build (at first use, with g++) and load the host builds of the
    kernel body, ``csrc/host_shim.cpp``: the same per-ray code as a loop
    over rays on the CPU, for the CPU tests and for ``count_ops``.  Nothing
    on the tracing path uses them.  Returns {variant: library}."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host build of the kernel body needs it")
    files = [native.CSRC / f for f in ("host_shim.cpp", "counted.h", "slab_rk4.cuh")]

    def spec(variant):
        return (f"slab_rk4_host_d{variant}", files,
                lambda out: [gxx, *HOST_FLAGS, f"-DRAYS_DAMPING={variant}", "-o", str(out),
                             "host_shim.cpp"])

    built = native.build_all([spec(v) for v in VARIANTS])
    return {v: bind(ctypes.CDLL(str(path))) for v, (path, _) in zip(VARIANTS, built)}


def _check_inputs(cfg, v0, status0):
    if not supported(cfg):
        raise ValueError("config not supported by the slab RK4 kernel "
                         "(fused_slab.supported)")
    if v0.dim() != 2 or v0.shape[1] != cfg.nv:
        raise ValueError(f"v0 must be (B, {cfg.nv}), got {tuple(v0.shape)}")
    if v0.shape[0] == 0:
        raise ValueError("empty ray batch")
    if v0.dtype not in _RUN_STRUCTS:
        raise ValueError(f"v0 must be float32 or float64, got {v0.dtype}")
    if status0.shape != (v0.shape[0],) or status0.dtype != torch.int32:
        raise ValueError("status0 must be int32 of shape (B,)")
    if status0.device != v0.device:
        raise ValueError("v0 and status0 must be on one device")
    if not (v0.is_contiguous() and status0.is_contiguous()):
        raise ValueError("v0 and status0 must be contiguous")


def run_library(lib, cfg, params, v0, status0, pwr_wt, stream=None) -> RayResults:
    """Call a bound slab RK4 library on tensors that its code can address
    (CUDA tensors for the kernel, CPU tensors for the host build)."""
    _check_inputs(cfg, v0, status0)
    if lib.rays_slab_damping() != _variant(cfg):
        raise ValueError(f"the library holds damping variant {lib.rays_slab_damping()}, "
                         f"the config needs {_variant(cfg)}")
    B, nv, dt, dev = v0.shape[0], v0.shape[1], v0.dtype, v0.device
    run = _run_struct(cfg, params, dt)

    def empty(dtype):
        return torch.empty((B,), dtype=dtype, device=dev)

    v_out = torch.empty((B, nv), dtype=dt, device=dev)
    stop, npoints = empty(torch.int32), empty(torch.int32)
    end_res, max_res = empty(dt), empty(dt)
    if cfg.save_trajectory:
        # zero rows past each ray's stop are the kernel's by construction
        traj = torch.zeros((cfg.nstep_max + 1, nv, B), dtype=dt, device=dev)
        traj_res = torch.zeros((cfg.nstep_max + 1, B), dtype=dt, device=dev)
        traj_ptrs = (traj.data_ptr(), traj_res.data_ptr())
    else:
        traj_ptrs = (None, None)

    fn = getattr(lib, f"rays_slab_rk4_{_SUFFIX[dt]}")
    with spans.span("rays.kernel.launch"):
        rc = fn(ctypes.addressof(run), cfg.ns, v0.data_ptr(), status0.data_ptr(), B,
                v_out.data_ptr(), stop.data_ptr(), npoints.data_ptr(),
                end_res.data_ptr(), max_res.data_ptr(), *traj_ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"slab RK4 kernel launch failed with CUDA error {rc}")

    if cfg.save_trajectory:
        ray_vec, residual = traj.permute(2, 0, 1), traj_res.permute(1, 0)
    else:
        ray_vec = torch.zeros((B, 1, nv), dtype=dt, device=dev)
        residual = torch.zeros((B, 1), dtype=dt, device=dev)
    return RayResults(
        ray_vec=ray_vec, residual=residual, npoints=npoints, stop_flag=stop,
        initial_ray_power=pwr_wt, end_residuals=end_res, max_residuals=max_res,
        end_ray_parameter=v_out[:, 6], start_ray_vec=v0, end_ray_vec=v_out)


def trace_batch_fused(cfg, params, v0, status0, pwr_wt) -> RayResults:
    """The kernel wrapper.  CUDA tensors: launch the kernel on the current
    stream (asynchronously; synchronize before timing).  CPU tensors: the
    plain twin.  Trajectories come back as (B, nstep_max+1, nv) and
    (B, nstep_max+1) views of the kernel's (step, slot, ray) buffers.
    The span ``rays.kernel.prepare`` holds the checks, the library lookup,
    the run constants' host read, the allocations and the launch, whose
    own span is ``rays.kernel.launch``."""
    global LAUNCHES
    if v0.device.type == "cpu":
        return trace_batch_fused_reference(cfg, params, v0, status0, pwr_wt)
    if v0.device.type != "cuda":
        raise ValueError(f"trace_batch_fused: unsupported device {v0.device}")
    with spans.span("rays.kernel.prepare"):
        _check_inputs(cfg, v0, status0)
        lib, _ = load_libraries()[_variant(cfg)]
        stream = torch.cuda.current_stream(v0.device).cuda_stream
        with torch.cuda.device(v0.device):
            out = run_library(lib, cfg, params, v0, status0, pwr_wt, stream)
    LAUNCHES += 1
    return out


def trace_batch_fused_reference(cfg, params, v0, status0, pwr_wt) -> RayResults:
    """Plain twin of the kernel: the port's ``trace_batch`` on the same
    inputs, on whatever device they are."""
    _check_inputs(cfg, v0, status0)
    return trace_batch(cfg, params, v0, status0, pwr_wt)
