"""The benchmark's plain reference: cold-plasma ray tracing in plain
PyTorch, batched over rays, written for the benchmark alone.

It imports nothing of the program under test.  The formulas are those of
the RAYS Fortran, by way of the scalar transcription in ``tests/_oracle.py``
(eqn_ray.f90:86-229, deriv_cold.f90:40-171, RK4_ode_m.f90:59-94,
check_save.f90:64-133 and 163-235, slab_eq_m.f90:125-309,
simple_slab_ray_init_m.f90:119-182 with the root solver of
dispersion_solvers_m.f90:49-166 and ray_tracing.f90:93-245), rewritten to
run over a batch of rays with masks where the Fortran branches, so that a
run is a loop over steps on the whole batch, at the benchmark's sizes.
It has no damping: a namelist that damps is refused.

Gradients.  The derivative step of the program is taken with respect to
its parameter leaves, named here as ``group.field`` (``species.alpha_coef``,
``rf.omgrf``, ``eq.bz0``, ``ode.ds`` ...).  The reference holds the same
quantities as independent inputs and computes them from the namelist
itself (``build_case``); a leaf that no formula here reads has gradient
zero.  The gradient comes from reverse-mode autograd through this code,
each outer step under ``torch.utils.checkpoint``.

Everything runs in the dtype the case was built in: float64 is the
reference, float32 the control that the comparison must refuse.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.utils.checkpoint

from benchmark.reference import namelist

# RAYS constants_m.f90:42-48 (the reference's own, nonstandard values)
PI = 3.1415926535897932385
CLIGHT = 2.997930e8
MU0 = PI * 4.0e-7
EPS0 = 1.0 / (MU0 * CLIGHT**2)
ME = 9.1094e-31
E_CHARGE = 1.6022e-19
# species_m.f90:31-34: charge in e, mass in electron masses
SPECIES = {"electron": (-1.0, 1.0), "hydrogen": (1.0, 1836.0), "deuterium": (1.0, 3670.0),
           "tritium": (1.0, 5497.0), "3He": (2.0, 5496.0), "alpha": (2.0, 7294.0)}
TINY = 1.0e-30

# stop codes, numbered as the program's results report them
X_OUT, Y_OUT, Z_OUT = 1, 2, 3
NEGATIVE_DENS, NEGATIVE_TEMP = 6, 7
OUT_OF_PLASMA = 9
INFINITE_VG, RAY_STALLED = 10, 11
DISPERSION_RESIDUAL = 20
SOUT_GT_SMAX, NSTEP_MAX = 30, 31


class Case:
    """One namelist's run as the reference holds it: ``leaves`` (name ->
    0-d or (S,) tensor), the static choices, and the equilibrium."""

    def __init__(self, nml, dtype, device):
        self.nml, self.dtype, self.device = nml, dtype, device
        self.leaves = {}
        self.static = {}

    def t(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(self.device, self.dtype)

    def leaf(self, name, value):
        self.leaves[name] = self.t(value)

    def __getitem__(self, name):
        return self.leaves[name]


def _per_species(group, key, ns, default):
    """A per-species namelist entry as a list of ns values (indexed from 0,
    or a plain list)."""
    v = group.get(key, default)
    if isinstance(v, dict):
        return [v.get(i, default) for i in range(ns)]
    if isinstance(v, list):
        return (v + [v[-1]] * ns)[:ns]
    return [v] * ns


def build_case(text, dtype=torch.float64, device="cpu", fields=None):
    """The reference's case from namelist text.  ``fields`` builds the
    equilibrium from the case and its namelist (the slab when None)."""
    nml = namelist.parse(text)
    case = Case(nml, dtype, device)
    sp = nml["species_list"]
    n0 = float(sp["n0"])
    names = sp["spec_name"]
    ns = len(names)
    q_unit = np.array([SPECIES[names[i]][0] for i in range(ns)])
    m_unit = np.array([SPECIES[names[i]][1] for i in range(ns)])
    eta = np.array([1.0] + _per_species(sp, "eta", ns, 1.0)[1:])
    t0_ev = np.array(_per_species(sp, "t0s", ns, 0.0))
    qs, ms = q_unit * E_CHARGE, m_unit * ME

    rf = nml["rf_list"]
    omgrf = 2.0 * PI * float(rf["frf"])
    case.static.update(ns=ns, wave_mode=rf.get("wave_mode", "plus"),
                       k0_sign=float(rf.get("k0_sign", 1)),
                       ray_param=rf.get("ray_param", "arcl"))
    case.leaf("rf.omgrf", omgrf)
    case.leaf("rf.k0", omgrf / CLIGHT)
    case.leaf("rf.omgrf_ref", omgrf)
    # the nondimensional coefficients, in float64 before the cast
    case.leaf("species.alpha_coef", n0 * qs**2 / (EPS0 * ms * omgrf**2))
    case.leaf("species.gamma_coef", qs / (ms * omgrf))
    case.leaf("species.n0s", eta)
    case.leaf("species.t0s", t0_ev * E_CHARGE)
    case.leaf("species.ms", ms)

    damping = nml.get("damping_list", {}).get("damping_model", "no_damp")
    if damping != "no_damp":
        raise ValueError("the reference has no damping model " + damping)
    case.leaf("limits.dispersion_resid_limit", float(rf.get("dispersion_resid_limit", 0.1)))

    ode = nml["ode_list"]
    if ode["ode_solver_name"] != "RK4_ODE":
        raise ValueError("the reference integrates RK4_ODE only")
    case.static["nstep_max"] = int(ode["nstep_max"])
    case.leaf("ode.ds", float(ode["ds"]))
    case.leaf("ode.s_max", float(ode["s_max"]))

    case.static["nv"] = 7
    case.fields = (fields or slab_fields_builder)(case, nml)
    return case


# --- the slab (slab_eq_m.f90:125-309) ------------------------------------


def slab_fields_builder(case, nml):
    g = nml["slab_eq_list"]
    ns = case.static["ns"]
    for key, default in (("xmin", -1.0), ("xmax", 1.0), ("ymin", -1.0), ("ymax", 1.0),
                         ("zmin", -1.0), ("zmax", 1.0), ("by0", 0.0), ("bz0", 1.0),
                         ("rmaj", 1.0), ("ln_scale", 1.0), ("lt_scale", 1.0)):
        case.leaf("eq." + key, float(g.get(key, default)))
    case.leaf("eq.lbz_scale", float(g.get("lbz_scale", 1.0)))
    models = dict(by=g.get("by_prof_model", "zero"), bz=g.get("bz_prof_model", "constant"),
                  dens=g.get("dens_prof_model", "constant"),
                  t=_per_species(g, "t_prof_model", ns, "zero"))
    if g.get("bx_prof_model", "zero") != "zero":
        raise ValueError("the reference's slab has Bx = 0")
    case.static["slab_models"] = models

    def fields(x3):
        return slab_fields(case, models, x3)

    return fields


def _profile(model, x, v0, scale, name):
    """(value, d/dx) of a slab profile of x."""
    zero = torch.zeros_like(x)
    if model == "zero":
        return zero, zero
    if model == "constant":
        return v0 + zero, zero
    if model == "linear":
        return v0 * (1.0 + x / scale), v0 / scale + zero
    if model == "toroid":
        f = v0 / (1.0 + x / scale)
        return f, -f / (scale + x)
    raise ValueError(f"the reference's slab has no {name} model {model!r}")


def slab_fields(case, models, x3):
    """(bvec, gradb, ns, gradns, ts, gradts, err) at x3 (B, 3), with
    gradb[b, i, j] = dB_j/dx_i and the (B, S, 3) gradients d/dx_i."""
    c = case
    x, y, z = x3[:, 0], x3[:, 1], x3[:, 2]
    zero = torch.zeros_like(x)
    by, dby = _profile(models["by"], x, c["eq.by0"], c["eq.rmaj"], "By")
    bz, dbz = _profile(models["bz"], x, c["eq.bz0"],
                       c["eq.lbz_scale"] if models["bz"] == "linear" else c["eq.rmaj"], "Bz")
    bvec = torch.stack([zero, by, bz], -1)
    gradb = torch.stack([torch.stack([zero, dby, dbz], -1),
                         torch.zeros_like(bvec), torch.zeros_like(bvec)], 1)
    n, dn = _profile(models["dens"], x[:, None], c["species.n0s"], c["eq.ln_scale"], "density")
    ts_d = [_profile(m, x, c["species.t0s"][i], c["eq.lt_scale"], "temperature")
            for i, m in enumerate(models["t"])]
    ts = torch.stack([t for t, _ in ts_d], -1)
    dts = torch.stack([d for _, d in ts_d], -1)

    def x_only(d):
        return torch.stack([d, torch.zeros_like(d), torch.zeros_like(d)], -1)

    err = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    err = torch.where(ts.amin(-1) < 0.0, NEGATIVE_TEMP, err)
    err = torch.where(n.amin(-1) < 0.0, NEGATIVE_DENS, err)
    err = torch.where((z < c["eq.zmin"]) | (z > c["eq.zmax"]), Z_OUT, err)
    err = torch.where((y < c["eq.ymin"]) | (y > c["eq.ymax"]), Y_OUT, err)
    err = torch.where((x < c["eq.xmin"]) | (x > c["eq.xmax"]), X_OUT, err)
    return bvec, gradb, n, x_only(dn), ts, x_only(dts), err.to(torch.int32)


# --- the plasma at a point (equilibrium_m.f90:237-269) --------------------


class Point:
    pass


def plasma_point(case, x3):
    bvec, gradb, ns, gradns, ts, gradts, err = case.fields(x3)
    e = Point()
    e.bmag = torch.sqrt((bvec * bvec).sum(-1))
    bsafe = e.bmag.clamp_min(TINY)
    e.bunit = bvec / bsafe[:, None]
    e.gradbmag = (gradb * e.bunit[:, None, :]).sum(-1)
    e.gradbunit = (gradb - e.gradbmag[:, :, None] * e.bunit[:, None, :]) / bsafe[:, None, None]
    w, wref = case["rf.omgrf"], case["rf.omgrf_ref"]
    e.alpha = case["species.alpha_coef"] * ns * (wref / w) ** 2
    e.gamma = case["species.gamma_coef"] * e.bmag[:, None] * (wref / w)
    e.omgc = case["species.gamma_coef"] * e.bmag[:, None] * wref
    e.ns, e.gradns, e.ts, e.gradts, e.err = ns, gradns, ts, gradts, err
    return e


def deriv_cold(e, nvec, omgrf, k0):
    """(dD/dx, dD/dk, dD/domega) of the cold dispersion (deriv_cold.f90),
    the species sums and products over the species axis of (B, S)
    tensors."""
    a, g = e.alpha, e.gamma
    S = a.shape[-1]
    bunit = e.bunit
    n3 = (nvec * bunit).sum(-1)
    nperp = nvec - n3[:, None] * bunit
    n1sq = (nperp * nperp).sum(-1)
    dn3dx = (e.gradbunit * nvec[:, None, :]).sum(-1)
    safe_ns = torch.where(e.ns != 0.0, e.ns, torch.ones_like(e.ns))
    dadx = torch.where((e.ns != 0.0)[:, :, None],
                       e.alpha[:, :, None] * e.gradns / safe_ns[:, :, None], 0.0)
    dgdx = g[:, :, None] * (e.gradbmag / e.bmag.clamp_min(TINY)[:, None])[:, None, :]

    # products over the other species (deriv_cold.f90:77-91, 116-125): the
    # species left out are masked to a factor of one, never divided out
    idx = torch.arange(S, device=a.device)
    other = idx[None, :] != idx[:, None]                                   # [s, i]
    other2 = other[:, None, :] & other[None, :, :]                         # [s1, s2, i]
    gp1, gm1 = 1.0 + g, 1.0 - g
    dq1da = torch.where(other, gp1[:, None, :], 1.0).prod(-1)
    dq2da = torch.where(other, gm1[:, None, :], 1.0).prod(-1)
    gp = torch.where(other2, gp1[:, None, None, :], 1.0).prod(-1)          # [b, s1, s2]
    gm = torch.where(other2, gm1[:, None, None, :], 1.0).prod(-1)
    p = (1.0 - a.sum(-1))[:, None]
    t = (gp1 * gm1).prod(-1)[:, None]
    q1 = (a * dq1da).sum(-1, keepdim=True)
    q2 = (a * dq2da).sum(-1, keepdim=True)
    u = t - (a * dq1da * dq2da).sum(-1, keepdim=True)
    q = 2.0 * u - t + q1 * q2
    duda = -dq1da * dq2da
    dqda = 2.0 * duda + dq1da * q2 + q1 * dq2da
    n3s, n1s = (n3 * n3)[:, None], n1sq[:, None]
    ddda = (-t * n3s * n3s + (2.0 * (u - p * duda) + (-t + duda) * n1s) * n3s
            - q + p * dqda - (dqda - u + p * duda) * n1s + duda * n1s * n1s)
    ac = a[:, :, None]
    dtdg = 2.0 * g * duda
    dudg = dtdg + 2.0 * g * ((ac * gp * gm).sum(1) + a * duda)
    dq1dg = (ac * gp).sum(1) - a * dq1da
    dq2dg = -(ac * gm).sum(1) + a * dq2da
    dqdg = 2.0 * dudg - dtdg + dq1dg * q2 + q1 * dq2dg
    dddg = (dtdg * p * n3s * n3s + (-2.0 * p * dudg + (dtdg * p + dudg) * n1s) * n3s
            + p * dqdg - (dqdg + p * dudg) * n1s + dudg * n1s * n1s)
    p, t, u, q = p[:, 0], t[:, 0], u[:, 0], q[:, 0]
    dddn3 = (4.0 * t * p * n3 * n3 + 2.0 * (-2.0 * p * u + (t * p + u) * n1sq)) * n3
    dddn12 = (t * p + u) * n3 * n3 - (q + p * u) + 2.0 * u * n1sq

    dddk = dddn3[:, None] * bunit / k0 + dddn12[:, None] * 2.0 * nperp / k0
    dddx = ((ddda[:, :, None] * dadx + dddg[:, :, None] * dgdx).sum(1)
            + dddn3[:, None] * dn3dx - dddn12[:, None] * 2.0 * n3[:, None] * dn3dx)
    dddw = ((ddda * (-2.0 / omgrf * a) + dddg * (-1.0 / omgrf * g)).sum(-1)
            + dddn3 * (-n3 / omgrf) + dddn12 * (-2.0 / omgrf * n1sq))
    return dddx, dddk, dddw


def stix(alpha, gamma):
    """(S, D, P, R, L) (suscep_m.f90:180-219)."""
    R = 1.0 - (alpha / (1.0 + gamma)).sum(-1)
    L = 1.0 - (alpha / (1.0 - gamma)).sum(-1)
    return (R + L) / 2.0, (R - L) / 2.0, 1.0 - alpha.sum(-1), R, L


def residual(e, k1, k3, k0):
    """check_save.f90:163-235: |det(eps_h + n n - n^2 I)| over the sum of
    the magnitudes of its terms, n = (k1, 0, k3)/k0.  With the cold
    Hermitian eps = [[S, -iD, 0], [iD, S, 0], [0, 0, P]] the determinant
    and its norm are real."""
    S, D, P, _, _ = stix(e.alpha, e.gamma)
    n1, n3 = k1 / k0, k3 / k0
    n1s, n3s = n1 * n1, n3 * n3
    nsq = n1s + n3s
    e00, e11, e22 = S - n3s, S - nsq, P - n1s
    det = e22 * (e00 * e11 - D * D) - e11 * n1s * n3s
    a00, a11, a22, a01 = S.abs() + n1s, S.abs(), P.abs() + n3s, D.abs()
    denom = a22 * (a00 * a11 + a01 * a01) + S.abs() * n1s * n3s
    return det.abs() / denom


# --- the ray equations and the check (eqn_ray.f90, check_save.f90) -------


def eqn_ray(case, v):
    """(dv/ds (B, nv), status (B,), plasma point) at v."""
    k0, omgrf = case["rf.k0"], case["rf.omgrf"]
    e = plasma_point(case, v[:, 0:3])
    kvec = v[:, 3:6]
    dddx, dddk, dddw = deriv_cold(e, kvec / k0, omgrf, k0)
    dkmag = torch.sqrt((dddk * dddk).sum(-1))
    safe_w = torch.where(dddw != 0.0, dddw, torch.ones_like(dddw))
    if case.static["ray_param"] == "arcl":
        sgn = torch.where(dddw >= 0.0, 1.0, -1.0).to(v.dtype)
        m = torch.where(dkmag != 0.0, dkmag, torch.ones_like(dkmag))
        parts = [-(sgn / m)[:, None] * dddk, (sgn / m)[:, None] * dddx]
        dsd = torch.ones_like(dddw)
    else:
        parts = [-dddk / safe_w[:, None], dddx / safe_w[:, None]]
        dsd = torch.sqrt((parts[0] * parts[0]).sum(-1))
    parts.append(dsd[:, None])
    status = torch.zeros_like(e.err)
    if case.static["ray_param"] == "arcl":
        status = torch.where(dkmag == 0.0, RAY_STALLED, status)
    status = torch.where(dddw == 0.0, INFINITE_VG, status)
    status = torch.where(e.err != 0, e.err, status)
    return torch.cat(parts, -1), status.to(torch.int32), e


def check_save(case, v, e):
    """(residual, status) at v from its plasma point."""
    k0 = case["rf.k0"]
    kvec = v[:, 3:6]
    k3 = (kvec * e.bunit).sum(-1)
    kperp = kvec - k3[:, None] * e.bunit
    resid = residual(e, torch.sqrt((kperp * kperp).sum(-1)), k3, k0)
    status = torch.zeros_like(e.err)
    status = torch.where(resid > case["limits.dispersion_resid_limit"], DISPERSION_RESIDUAL,
                         status)
    status = torch.where(e.err != 0, e.err, status)
    return resid, status.to(torch.int32)


# --- the launch (simple_slab_ray_init_m.f90, dispersion_solvers_m.f90) ---

_MODES = ("plus", "minus", "fast", "slow")


def n1sq_roots(alpha, gamma, n3):
    """The cold n_perp^2 roots (plus, minus, fast, slow) for n_par = n3 and
    whether the pair is complex."""
    S, _, P, R, L = stix(alpha, gamma)
    a = S
    b = -R * L - P * S + n3 * n3 * (P + S)
    c = P * (n3 * n3 - R) * (n3 * n3 - L)
    disc = b * b - 4.0 * a * c
    root = torch.sqrt(disc.clamp_min(0.0))
    # the stable quadratic formula: the large root from -b - sign(b) root
    big = -b - torch.where(b >= 0.0, root, -root)
    big_safe = torch.where(big != 0.0, big, torch.ones_like(big))
    r_big, r_small = big / (2.0 * a), 2.0 * c / big_safe
    plus = torch.where(b < 0.0, r_big, r_small)
    minus = torch.where(b < 0.0, r_small, r_big)
    fast = torch.where(plus.abs() <= minus.abs(), plus, minus)
    slow = torch.where(plus.abs() <= minus.abs(), minus, plus)
    return dict(zip(_MODES, (plus, minus, fast, slow))), disc < 0.0


def launch_slab(case):
    """(v0 (B, nv), power weights (B,)) of the namelist's simple-slab fan."""
    g = case.nml["simple_slab_ray_init_list"]

    def axis(n, start, step):
        return [float(g.get(start, 0.0)) + float(g.get(step, 0.0)) * i
                for i in range(int(g.get(n, 1)))]

    xs = axis("n_x_launch", "x_launch0", "dx_launch")
    ys = axis("n_y_launch", "y_launch0", "dy_launch")
    zs = axis("n_z_launch", "z_launch0", "dz_launch")
    nys = axis("n_ky_launch", "rindex_y0", "delta_rindex_y0")
    nzs = axis("n_kz_launch", "rindex_z0", "delta_rindex_z0")
    cand = case.t([(x, y, z, ny, nz) for z in zs for y in ys for x in xs
                   for ny in nys for nz in nzs])
    r, ny, nz = cand[:, 0:3], cand[:, 3], cand[:, 4]
    e = plasma_point(case, r)
    n2 = ny * e.bunit[:, 2] - nz * e.bunit[:, 1]
    n3 = ny * e.bunit[:, 1] + nz * e.bunit[:, 2]
    roots, complex_pair = n1sq_roots(e.alpha, e.gamma, n3)
    rad = roots[case.static["wave_mode"]] - n2 * n2
    ok = (e.err == 0) & ~complex_pair & (rad >= 0.0)
    nx = case.static["k0_sign"] * torch.sqrt(rad.clamp_min(0.0))
    rindex = torch.stack([nx, ny, nz], -1)[ok]
    v0 = torch.zeros((int(ok.sum()), case.static["nv"]), dtype=case.dtype, device=case.device)
    v0[:, 0:3] = r[ok]
    v0[:, 3:6] = case["rf.k0"] * rindex
    return v0, torch.full((v0.shape[0],), 1.0 / v0.shape[0], dtype=case.dtype,
                          device=case.device)


# --- the trace (ray_tracing.f90:93-245) ------------------------------------


def _first_nonzero(codes):
    out = codes[0]
    for c in codes[1:]:
        out = torch.where(out != 0, out, c)
    return out


def _step(case, k, v, f1, st1, status, nstep, end_res, max_res):
    """One outer step of every ray."""
    ds = case["ode.ds"]
    sout = (k + 1.0) * ds
    status = torch.where((status == 0) & (sout > case["ode.s_max"]), SOUT_GT_SMAX, status)
    active = status == 0
    f2, st2, _ = eqn_ray(case, v + ds * f1 / 2.0)
    f3, st3, _ = eqn_ray(case, v + ds * f2 / 2.0)
    f4, st4, _ = eqn_ray(case, v + ds * f3)
    v_new = v + ds * (f1 + 2.0 * f2 + 2.0 * f3 + f4) / 6.0
    st = _first_nonzero([st1, st2, st3, st4])
    status = torch.where(active & (st != 0), st, status)
    accepted = active & (st == 0)
    f_new, st_new, e_new = eqn_ray(case, v_new)
    resid, cst = check_save(case, v_new, e_new)
    status = torch.where(accepted & (cst != 0), cst, status)
    ok = accepted & (cst == 0)
    v = torch.where(ok[:, None], v_new, v)
    f1 = torch.where(ok[:, None], f_new, f1)
    st1 = torch.where(ok, st_new, st1)
    nstep = nstep + ok.to(torch.int32)
    end_res = torch.where(ok, resid, end_res)
    max_res = torch.where(ok, torch.maximum(max_res, resid), max_res)
    return (v, f1, st1, status.to(torch.int32), nstep, end_res, max_res)


def trace(case, v0, checkpoint=False):
    """Trace every ray of v0 for ``nstep_max`` outer steps.  Returns a dict
    of end (B, nv), npoints, stop, end_res and max_res.  ``checkpoint``
    recomputes each step in the backward pass."""
    B = v0.shape[0]
    f1, st1, e0 = eqn_ray(case, v0)
    _, status = check_save(case, v0, e0)
    zeros = torch.zeros((B,), dtype=v0.dtype, device=v0.device)
    nstep = torch.zeros((B,), dtype=torch.int32, device=v0.device)
    carry = (v0, f1, st1, status.to(torch.int32), nstep, zeros, zeros)
    for k in range(case.static["nstep_max"]):
        kk = torch.full((), float(k), dtype=v0.dtype, device=v0.device)
        if checkpoint:
            carry = torch.utils.checkpoint.checkpoint(
                lambda *c: _step(case, *c), kk, *carry, use_reentrant=False)
        else:
            carry = _step(case, kk, *carry)
    v, _, _, status, nstep, end_res, max_res = carry
    return dict(end=v, npoints=nstep + 1, stop=torch.where(status == 0, NSTEP_MAX, status),
                end_res=end_res, max_res=max_res)


# --- the loss -------------------------------------------------------------


def endpoint_term(run, pwr):
    """sum over rays of |x_end|^2 times the ray's power weight."""
    return (run["end"][:, 0:3] ** 2 * pwr[:, None]).sum()


def grad_leaves(case):
    """The leaves a derivative is taken in: every floating one."""
    return {k: v for k, v in case.leaves.items() if v.is_floating_point()}
