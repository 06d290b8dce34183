"""Per-ray stop/status taxonomy as int codes.

The reference threads character-string stop flags through the integration
(``ode_stop%ode_stop_flag``, reference RAYS_project/RAYS_lib/ode_m.f90:24-29
and the sites listed in SURVEY.md §5.3).  Inside jitted code we use int32
codes; ``STOP_FLAG_STRINGS`` maps back to the reference's exact strings so
results files remain comparable.

Semantics: code 0 (OK) means the ray is still propagating.  Once a ray's
status becomes nonzero its state freezes (mask-and-freeze in the scan); the
first nonzero code wins, reproducing the reference's early-exit ordering.
"""

import enum


class StopCode(enum.IntEnum):
    OK = 0
    # equilibrium errors (equib_err strings, slab_eq_m.f90:162-169,303-306;
    # solovev_eq_m.f90:155-156,272-273)
    X_OUT_OF_BOUNDS = 1
    Y_OUT_OF_BOUNDS = 2
    Z_OUT_OF_BOUNDS = 3
    R_OUT_OF_BOX = 4
    Z_OUT_OF_BOX = 5
    NEGATIVE_DENS = 6
    NEGATIVE_TEMP = 7
    PSI_OUT_OF_BOUNDS = 8
    OUT_OF_PLASMA = 9
    # RHS / solver errors (eqn_ray.f90:140-169, SG_ode_m.f90:140-147)
    INFINITE_VG = 10
    RAY_STALLED = 11
    ODE_TOTAL_ERROR = 12
    # check_save stops (check_save.f90:68-71,121-125)
    DISPERSION_RESIDUAL = 20
    TOTAL_ABSORPTION = 21
    # tracing-loop stops (ray_tracing.f90:128-172)
    SOUT_GT_SMAX = 30
    NSTEP_MAX = 31
    # ray never started (bad initial conditions, ray_tracing.f90:101-112)
    DID_NOT_START = 40


# Reference flag strings (exact, including the leading space the reference
# writes for the nstep flag, ray_tracing.f90:152).
STOP_FLAG_STRINGS = {
    StopCode.OK: "",
    StopCode.X_OUT_OF_BOUNDS: "x out_of_bounds",
    StopCode.Y_OUT_OF_BOUNDS: "y out_of_bounds",
    StopCode.Z_OUT_OF_BOUNDS: "z out_of_bounds",
    StopCode.R_OUT_OF_BOX: "R out_of_box",
    StopCode.Z_OUT_OF_BOX: "z out_of_box",
    StopCode.NEGATIVE_DENS: "negative_dens",
    StopCode.NEGATIVE_TEMP: "negative_temp",
    StopCode.PSI_OUT_OF_BOUNDS: "psi out_of_bounds",
    StopCode.OUT_OF_PLASMA: "out_of_plasma",
    StopCode.INFINITE_VG: "infinite Vg",
    StopCode.RAY_STALLED: "ray stalled",
    StopCode.ODE_TOTAL_ERROR: "ODE total error",
    StopCode.DISPERSION_RESIDUAL: "dispersion_residual",
    StopCode.TOTAL_ABSORPTION: "total_absorption",
    StopCode.SOUT_GT_SMAX: "sout > s_max",
    StopCode.NSTEP_MAX: " nstep > nstep_max",
    StopCode.DID_NOT_START: "did not start",
}


def flag_string(code: int) -> str:
    return STOP_FLAG_STRINGS.get(StopCode(int(code)), f"code_{int(code)}")


_STRING_TO_CODE = {s.strip(): int(c) for c, s in STOP_FLAG_STRINGS.items()}
# token-serialized forms (the LD / ray_list writers replace spaces with
# underscores so flags survive list-directed tokenization, and write the
# empty OK flag as 'OK') — fold both so every serialization round-trips
_STRING_TO_CODE.update(
    {s.strip().replace(" ", "_"): int(c) for c, s in STOP_FLAG_STRINGS.items()})
_STRING_TO_CODE["OK"] = 0


def flag_code(flag: str) -> int:
    """Inverse of flag_string: parse a stop-flag string (as stored in a
    results file, reference ray_results_m.f90:56,253-363 — or its
    underscore-folded token form from the LD/ray_list writers) back to the
    int code.  Unknown strings map to -1 so a file from a newer/older
    writer degrades loudly rather than silently to OK."""
    # tokenized forms may carry the reference's leading space as a
    # leading underscore (' nstep > nstep_max' -> '_nstep_>_nstep_max')
    s = flag.strip().lstrip("_")
    if s in _STRING_TO_CODE:
        return _STRING_TO_CODE[s]
    if s.startswith("code_"):
        try:
            return int(s[5:])
        except ValueError:
            pass
    return -1
