"""One outer RK4 step on the G-EQDSK spline toroid as one CUDA kernel: the
adjoint graph's "step" piece (tracing/graphed_adjoint.py) for the
axisymmetric toroid whose psi spline rides in a cell table.

The generic forward piece copies the carry into the adjoint's stack
(``index_copy_``) and runs ``trace.step``: about 1,900 library kernels of
a microsecond or two per outer step at 32,768 rays on this geometry.  Here
it is one launch of ``rays::toroid_step_fwd`` (``csrc/eqdsk_rk4.cu``, the
per-ray body in ``csrc/eqdsk_rk4.cuh``, which says what bounds it and what
its design does about that) and the step index's increment: one thread per ray
writes its carry into the stack at the device index k, steps it (four
equilibrium evaluations, each one row fetch of the psi cell table), and
writes the carry after the step in place (with trajectories, row k + 1
too).  The kernel reads the Params from one packed device vector that
``EqdskStep.pack`` fills at each run's load, and the cell table in place
from the loop's static leaf, so a captured launch reads each run's values
and nothing is read on the host (tracing/kernel_side.py).  Its plain
version is the generic piece:
the tests hold the same body, built with g++ (``csrc/eqdsk_rk4_host.cpp``),
to it on the CPU.

``takes`` is the gate, one decision from the config, the Params and the
device: CUDA tensors, ``supported(cfg, params)``.  ``StaticAdjoint`` makes
it after the slab kernels' gate (``slab_vjp.takes``, which admits slab
configs only, so the two never both open) and nothing else does.  The
"vjp" piece stays the generic one: it recomputes ``trace.step`` at the
carries this step wrote, so on the card the forward of these configs is
this kernel's arithmetic, at rounding level from ``trace.step``'s.  A
failed build or launch raises; nothing falls back.  ``STEP_LAUNCHES``
counts the kernel's launches in this process, not the host build's: those
made outside a capture, and for a captured piece the launches that
``EqdskStep.launch`` made into its graph, added at each replay
(``kernel_side.KernelSide``).  ``count_ops`` runs the host build's step on
a type that counts its arithmetic, for the kernel's operation bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rays_tpu_torch import native
from rays_tpu_torch.tracing import fused_slab
from rays_tpu_torch.tracing.kernel_side import CARRY, KernelSide, ptr

STEP_LAUNCHES = 0   # launches of the CUDA kernel in this process (not of the host build)

MAX_SPECIES = 6     # rays::MAX_SPECIES
_PROFILE_MODELS = {"zero": 0, "constant": 1, "parabolic": 2}   # rays::PROF_*
N_CODES = 2 + MAX_SPECIES   # rays::N_TOROID_CODES

# The packed run constants, in csrc/eqdsk_rk4.cuh's row order: a scalar's
# row, then each per-species field's cfg.ns rows; the Params path of each.
ROWS = (("cell_r0", "eq.mag.psi_cells.x0"), ("cell_dr", "eq.mag.psi_cells.dx"),
        ("cell_z0", "eq.mag.psi_cells.y0"), ("cell_dz", "eq.mag.psi_cells.dy"),
        ("psib", "eq.mag.psib"), ("plasma_psi_limit", "eq.plasma_psi_limit"),
        ("alphan1", "eq.alphan1"), ("alphan2", "eq.alphan2"),
        ("d_scrape_off", "eq.d_scrape_off"), ("t_scrape_off", "eq.t_scrape_off"),
        ("box_rmin", "eq.box_rmin"), ("box_rmax", "eq.box_rmax"), ("box_zmin", "eq.box_zmin"),
        ("box_zmax", "eq.box_zmax"), ("omgrf", "rf.omgrf"), ("omgrf_ref", "rf.omgrf_ref"),
        ("k0", "rf.k0"), ("ds", "ode.ds"), ("s_max", "ode.s_max"),
        ("dispersion_resid_limit", "limits.dispersion_resid_limit"))
SPECIES_ROWS = (("n0s", "species.n0s"), ("t0s", "species.t0s"),
                ("alpha_coef", "species.alpha_coef"), ("gamma_coef", "species.gamma_coef"),
                ("alphat1", "eq.alphat1"), ("alphat2", "eq.alphat2"))


def supported(cfg, params) -> bool:
    """Whether the kernel covers this run: the built-in axisymmetric toroid
    (not a model of the caller's own under its name) with the psi spline's
    cell table (``EqdskMagParams.psi_cells``), fixed-step RK4, cold
    dispersion with the closed-form derivatives, no damping, no gradient
    diagnostics, no compensated carry, at most 6 species, and profile
    models the kernel holds (density constant or parabolic, each species'
    temperature zero, constant or parabolic)."""
    from rays_tpu_torch.models import axisym_toroid, base

    if cfg.equilib_model != "axisym_toroid" or "axisym_toroid" in base.EQ_MODELS:
        return False
    st, mag = cfg.eq_static, getattr(params.eq, "mag", None)
    if (st.magnetics_model != "eqdsk_magnetics_spline_interp"
            or not isinstance(mag, axisym_toroid.EqdskMagParams) or mag.psi_cells is None
            or tuple(mag.psi_cells.cells.shape[2:]) != (2, 4, 4)):
        return False
    if (cfg.ode_solver_name != "RK4_ODE" or cfg.damping_model != "no_damp"
            or cfg.ray_deriv_name != "cold" or cfg.integrate_eq_gradients
            or cfg.compensated_sum):
        return False
    return (cfg.ns <= MAX_SPECIES and len(st.temperature_prof_model) == cfg.ns
            and st.density_prof_model in ("constant", "parabolic")
            and all(m in _PROFILE_MODELS for m in st.temperature_prof_model))


def takes(cfg, params, device) -> bool:
    """Whether the adjoint graph's "step" piece is this kernel: CUDA
    tensors and a configuration it supports."""
    return torch.device(device).type == "cuda" and supported(cfg, params)


def _leaf(params, path):
    for name in path.split("."):
        params = getattr(params, name)
    return params


def run_rows(cfg, params):
    """The packed run constants' rows, in the rows' order: detached 1-D
    views of the Params values, one row of a scalar and ``cfg.ns`` of a
    per-species field.  ``torch.cat`` of them is the packed vector."""
    rows = [(path, 1) for _, path in ROWS] + [(path, cfg.ns) for _, path in SPECIES_ROWS]
    return [_leaf(params, path).detach().reshape(-1)[:n] for path, n in rows]


def model_codes(cfg):
    """The run's profile models and ray parameter as the kernel's codes, in
    rays::TC_* order: an int32 array of ``N_CODES``."""
    st = cfg.eq_static
    return (ctypes.c_int32 * N_CODES)(
        _PROFILE_MODELS[st.density_prof_model], int(cfg.ray_param == "time"),
        *[_PROFILE_MODELS[m] for m in st.temperature_prof_model])


class EqdskStepArgs(ctypes.Structure):
    """rays::EqdskStepArgs, of either precision (pointers and integers)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("params", "k", "cells", *CARRY)]
                + [(f"stack_{n}", ctypes.c_void_p) for n in CARRY]
                + [("traj", ctypes.c_void_p), ("resid", ctypes.c_void_p),
                   ("B", ctypes.c_int64), ("nstep_max", ctypes.c_int32),
                   ("nxm", ctypes.c_int32), ("nym", ctypes.c_int32),
                   ("codes", ctypes.c_int32 * N_CODES)])


_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def bind(lib):
    """Declare the C interface of an EQDSK step library (the CUDA launcher
    or the host build of the same body) and check its row and argument
    layouts."""
    fn = lib.rays_eqdsk_row_names
    fn.argtypes, fn.restype = [], ctypes.c_char_p
    theirs = [names.split() for names in fn().decode().split("|")]
    ours = [[n for n, _ in rows] for rows in (ROWS, SPECIES_ROWS)]
    if theirs != ours:
        raise RuntimeError(f"the packed run constants differ between csrc/eqdsk_rk4.cuh "
                           f"({theirs}) and eqdsk_step.py ({ours})")
    for suffix in _SUFFIX.values():
        size = getattr(lib, f"rays_eqdsk_step_args_size_{suffix}")
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != ctypes.sizeof(EqdskStepArgs):
            raise RuntimeError(f"EqdskStepArgs<{suffix}> layout differs between "
                               f"csrc/eqdsk_rk4.cuh ({size()} bytes) and eqdsk_step.py "
                               f"({ctypes.sizeof(EqdskStepArgs)} bytes)")
        fn = getattr(lib, f"rays_eqdsk_step_{suffix}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


_FILES = ("eqdsk_rk4.cuh", "slab_rk4_vjp.cuh", "slab_rk4.cuh")


@functools.lru_cache(maxsize=None)
def load_library(dtype, ns):
    """Build (at first use, with nvcc) and load the CUDA library of one
    precision and species count; returns (ctypes library, compiler output
    with the kernel's -Xptxas -v report)."""
    nvcc = native.nvcc()
    files = [native.CSRC / f for f in ("eqdsk_rk4.cu", *_FILES)]
    flags = (f"-DRAYS_EQDSK_SPECIES={int(ns)}", f"-DRAYS_EQDSK_F64={int(dtype == torch.float64)}")
    (path, log), = native.build_all([(
        f"eqdsk_rk4_{_SUFFIX[dtype]}_s{int(ns)}", files,
        lambda out: [nvcc, *native.NVCC_FLAGS, *flags, "-o", str(out), "eqdsk_rk4.cu"])])
    return bind(ctypes.CDLL(str(path))), log


@functools.lru_cache(maxsize=None)
def load_host_library():
    """Build (at first use, with g++) and load the host build of the same
    body, ``csrc/eqdsk_rk4_host.cpp``, for the CPU tests and ``count_ops``.
    Nothing on the tracing path uses it."""
    gxx = native.gxx()
    files = [native.CSRC / f for f in ("eqdsk_rk4_host.cpp", "counted.h", *_FILES)]
    (path, _), = native.build_all([(
        "eqdsk_rk4_host", files,
        lambda out: [gxx, *native.HOST_FLAGS, "-o", str(out), "eqdsk_rk4_host.cpp"])])
    lib = bind(ctypes.CDLL(str(path)))
    fn = lib.rays_eqdsk_step_count_ops
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    return lib


class EqdskStep(KernelSide):
    """The EQDSK step's side of one ``StaticAdjoint`` (``loop``): the
    packed Params vector (``run_rows`` of the loop's static leaves) and the
    step's launch arguments; the cell table is read in place.  Its one
    piece is ``"step"``; the loop keeps the generic ``"vjp"``."""

    PIECES = ("step",)

    def __init__(self, lib, loop):
        cfg, p = loop.cfg, loop.params
        if not supported(cfg, p):
            raise ValueError("the EQDSK step takes the spline toroid's RK4 configs with a cell "
                             "table, cold and undamped (eqdsk_step.supported)")
        super().__init__(lib, loop, run_rows(cfg, p))
        v = loop.carry[0]
        cells = p.eq.mag.psi_cells.cells
        if cells.dtype != v.dtype or not cells.is_contiguous() or cells.data_ptr() % 16:
            raise ValueError("the cell table must be a contiguous, 16-byte aligned tensor of "
                             "the rays' dtype")
        self.args = {"step": EqdskStepArgs(
            params=ptr(self.params), k=ptr(loop.k), cells=ptr(cells),
            **{n: ptr(t) for n, t in zip(CARRY, loop.carry)},
            **{f"stack_{n}": ptr(t) for n, t in zip(CARRY, loop.stack)},
            traj=ptr(loop.traj), resid=ptr(loop.resid), B=v.shape[0], nstep_max=cfg.nstep_max,
            nxm=cells.shape[0], nym=cells.shape[1], codes=model_codes(cfg))}
        self.fn = {"step": getattr(lib, f"rays_eqdsk_step_{_SUFFIX[v.dtype]}")}

    def count(self, piece, n):
        global STEP_LAUNCHES
        STEP_LAUNCHES += n


def count_ops(loop):
    """Outer step k (the loop's device index, not stepped here) of a CPU
    float64 ``StaticAdjoint`` whose kernel side is the host build's EQDSK
    step, taken on the counting type: the carry stepped and the stack
    written as a launch does them.  Returns (the floating-point operations
    by kind, ``fused_slab.OP_KINDS``; the rays that stepped, the live ray
    steps they were spent on)."""
    s = loop.kernels
    if (not isinstance(s, EqdskStep) or s.device.type != "cpu"
            or s.params.dtype != torch.float64):
        raise ValueError("count_ops takes a CPU float64 loop with the host build's EQDSK step")
    before = loop.carry[5].clone()
    n_kinds = len(fused_slab.OP_KINDS)
    ops = (ctypes.c_int64 * n_kinds)()
    rc = s.lib.rays_eqdsk_step_count_ops(ctypes.addressof(s.args["step"]), s.ns,
                                         ctypes.addressof(ops))
    if rc != 0:
        raise RuntimeError(f"rays_eqdsk_step_count_ops failed ({rc})")
    return dict(zip(fused_slab.OP_KINDS, ops)), int((loop.carry[5] != before).sum())
