"""The plain reference with damping: RAYS's weak fundamental-ECH absorption
on top of ``rays_plain``'s cold ray tracing, and the binning of the power
it removes, in plain PyTorch, batched over rays, written for the
benchmark alone.

It imports nothing of the program under test and no scipy.  What it adds
to ``rays_plain`` (whose launch, plasma point, cold derivatives, residual
and stop codes it takes by import):

* the Dawson function, from its power series and its asymptotic series;
* ``damp_fund_ECH`` (damp_fund_ECH.f90:39-127, by way of the scalar
  transcription ``tests/_oracle.py::damp_fund_ech``): k_i from the warm
  correction xi + 1/Z(xi), xi = (omega + Omega_ce) / (k_par v_th), over the
  cold dispersion's derivative along the group velocity, computed only on
  the rays where the Fortran does not return early (k_par = 0, |xi| > 5);
* the damping slots of the ray equations (eqn_ray.f90:196-213): the total
  absorbed fraction and, with ``multi_spec_damping``, one per species,
  each growing as 2 k_i (1 - P_total) per unit of arc length;
* the ``total_damping_limit`` stop of check_save (check_save.f90:64-133);
* the deposition profile (deposition_profiles_m.f90:229-293) with the
  uniform-grid binning of bin_to_uniform_grid_m.f90:80-148, written as
  differences of each segment's cumulative share left of every bin edge.

Everything runs in the dtype the case was built in: float64 is the
reference, float32 the control that the comparison must refuse.
"""

from __future__ import annotations

import math
import re

import torch
import torch.utils.checkpoint

from benchmark.reference import namelist, rays_plain

TOTAL_ABSORPTION = 21
DAMPING_SLOT = 7

# the Dawson function F(x) = exp(-x^2) int_0^x exp(t^2) dt
SERIES_TERMS = 130      # exp(-x^2) sum x^(2n+1) / (n! (2n+1)): below 1e-17 of F for |x| <= 6.5
ASYMPTOTIC_TERMS = 24   # 1/(2x) sum (2n-1)!! / (2x^2)^n: below 1e-17 of F for |x| > 6.5
SERIES_CUT = 6.5


def dawsn(x):
    """The Dawson function of real x, elementwise.  Within ``SERIES_CUT``
    the power series, whose terms are all positive (no cancellation): each
    x^(2n) / n! as the running product of x^2 / j; beyond it the
    asymptotic series.  Each branch runs on operands clamped to its own
    range, so the other's never overflows into the gradient."""
    xs = x.clamp(-SERIES_CUT, SERIES_CUT)
    x2 = xs * xs
    j = torch.arange(1, SERIES_TERMS, dtype=x.dtype, device=x.device)
    powers = torch.cat([torch.ones_like(x2)[..., None], torch.cumprod(x2[..., None] / j, -1)], -1)
    odd = 2.0 * torch.arange(SERIES_TERMS, dtype=x.dtype, device=x.device) + 1.0
    series = torch.exp(-x2) * xs * (powers / odd).sum(-1)

    far = x.abs() > SERIES_CUT
    big = torch.where(far, x, torch.full_like(x, 2.0 * SERIES_CUT))
    inv = 1.0 / (2.0 * big * big)
    m = torch.arange(1, ASYMPTOTIC_TERMS, dtype=x.dtype, device=x.device)
    terms = torch.cat([torch.ones_like(inv)[..., None],
                       torch.cumprod((2.0 * m - 1.0) * inv[..., None], -1)], -1)
    asymptotic = terms.sum(-1) / (2.0 * big)
    return torch.where(far, asymptotic, series)


def zfun0_real(xi, k3):
    """Z of a real argument with zfun0's Landau sign (zfunctions_m.f90:
    57-75): Z(xi) for k_par > 0, -Z(-xi) for k_par < 0, as a complex
    tensor.  On the real axis Z(x) = -2 F(x) + i sqrt(pi) exp(-x^2)."""
    re = -2.0 * dawsn(xi)
    im = math.sqrt(rays_plain.PI) * torch.exp(-xi * xi) * torch.sign(k3)
    return torch.complex(re, im)


# --- the case -------------------------------------------------------------


def build_case(text, dtype=torch.float64, device="cpu", fields=None):
    """``rays_plain.build_case`` of the namelist without its damping group,
    then the damping: the model, the per-species slots and the
    ``limits.total_damping_limit`` leaf."""
    nml = namelist.parse(text)
    group = nml.get("damping_list", {})
    model = group.get("damping_model", "no_damp")
    if model != "damp_fund_ECH":
        raise ValueError("the damped reference runs damp_fund_ECH, not " + model)
    undamped = re.sub(r"&damping_list\b.*?\n\s*/", "", text, count=1, flags=re.S | re.I)
    case = rays_plain.build_case(undamped, dtype, device, fields=fields)
    case.nml = nml
    multi = bool(group.get("multi_spec_damping", False))
    case.static.update(damping=model, multi_spec_damping=multi)
    case.static["nv"] = 8 + (case.static["ns"] if multi else 0)
    case.leaf("limits.total_damping_limit", float(group.get("total_damping_limit", 0.99)))
    return case


# --- damp_fund_ECH (damp_fund_ECH.f90:39-127) -----------------------------


def damp_fund_ech(case, e, kvec, vg_unit):
    """(ksi (B, S), ki (B,)): k_i of the weak fundamental-ECH absorption at
    the rays' plasma points ``e``, wavevectors ``kvec`` and group-velocity
    directions; electrons absorb, every other species' k_i is 0."""
    k0, omgrf = case["rf.k0"], case["rf.omgrf"]
    B = kvec.shape[0]
    k3 = (kvec * e.bunit).sum(-1)
    vth = torch.sqrt(2.0 * e.ts[:, 0] / case["species.ms"][0])
    # the Fortran's early returns: k_par = 0, no temperature, |xi| > 5
    start = (k3 != 0.0) & (vth > 0.0)
    safe_den = torch.where(start, k3 * vth, torch.ones_like(k3))
    xi_all = (omgrf + e.omgc[:, 0]) / safe_den
    idx = torch.nonzero(start & (xi_all.abs() <= 5.0)).squeeze(-1)

    k3, xi, vth = k3[idx], xi_all[idx], vth[idx]
    bunit, kv = e.bunit[idx], kvec[idx]
    nvec = kv / k0
    k1sq = ((kv - k3[:, None] * bunit) ** 2).sum(-1)
    r3 = k3 / k0
    r1s = k1sq / (k0 * k0)
    r3s = r3 * r3
    rs = r1s + r3s
    b1 = e.gamma[idx, 0]
    betae = b1 * b1
    vt = vth / rays_plain.CLIGHT
    zf = zfun0_real(xi, k3)

    p = e.alpha[idx, 0]
    q = p / 2.0 / (1.0 - b1)
    lam1 = ((1.0 - q) * rs * r1s + (1.0 - p) * rs * r3s - (1.0 - q) * (1.0 - p) * (rs + r3s)
            - (1.0 - 2.0 * q) * r1s + (1.0 - 2.0 * q) * (1.0 - p))
    lam2 = (-p / b1 * (rs * r1s - (1.0 - 2.0 * q) * r1s)
            + p * p / 4.0 / betae * r1s / r3s * (rs + r3s - 2.0 * (1.0 - 2.0 * q)))
    lam5 = p * (rs * r3s - (1.0 - q) * (rs + r3s) + (1.0 - 2.0 * q))
    d_warm = ((-(1.0 - b1) * r3 * vt * (lam1 + lam2 + r1s / 2.0 / r3 / betae * vt * xi * lam5))
              * (xi + 1.0 / zf))

    a = 1.0 - p - betae
    b = -((1.0 - p) * a + (1.0 - p) ** 2 - betae) + (a + (1.0 - p) * (1.0 - betae)) * r3s
    ddnx2 = 2.0 * a * r1s + b
    ddnz = 2.0 * r3 * ((a + (1.0 - p) * (1.0 - betae)) * r1s
                       + (1.0 - p) * (2.0 * (1.0 - betae) * r3s - 2.0 * a))
    ddn = ddnx2[:, None] * 2.0 * (nvec - r3[:, None] * bunit) + ddnz[:, None] * bunit
    along = (ddn * vg_unit[idx]).sum(-1)
    keep = along != 0.0
    delta = -d_warm / torch.where(keep, along, torch.ones_like(along))
    ki_live = torch.where(keep, k0 * delta.imag, torch.zeros_like(along))

    ki = kvec.new_zeros((B,)).index_put((idx,), ki_live)
    return torch.cat([ki[:, None], kvec.new_zeros((B, case.static["ns"] - 1))], -1), ki


# --- the ray equations and the check with damping -------------------------


def eqn_ray(case, v):
    """(dv/ds (B, nv), status, plasma point): ``rays_plain.eqn_ray``'s cold
    slots, then the absorption slots.  dx/ds lies along the group velocity
    in both parametrizations, so its direction is the group velocity's."""
    dv, status, e = rays_plain.eqn_ray(case, v[:, 0:7])
    dxds = dv[:, 0:3]
    norm = torch.sqrt((dxds * dxds).sum(-1))
    vg_unit = dxds / torch.where(norm > 0.0, norm, torch.ones_like(norm))[:, None]
    ksi, ki = damp_fund_ech(case, e, v[:, 3:6], vg_unit)
    dsd = dv[:, 6]
    one_minus_p = 1.0 - v[:, DAMPING_SLOT]
    parts = [dv, (dsd * 2.0 * ki * one_minus_p)[:, None]]
    if case.static["multi_spec_damping"]:
        parts.append(dsd[:, None] * 2.0 * ksi * one_minus_p[:, None])
    return torch.cat(parts, -1), status, e


def check_save(case, v, e):
    """(residual, status): ``rays_plain.check_save``, whose stops come
    before the absorption limit's."""
    resid, status = rays_plain.check_save(case, v[:, 0:7], e)
    absorbed = v[:, DAMPING_SLOT] > case["limits.total_damping_limit"]
    status = torch.where(status != 0, status, torch.where(absorbed, TOTAL_ABSORPTION, 0))
    return resid, status.to(torch.int32)


def _step(case, k, v, f1, st1, status, nstep, end_res, max_res):
    """One outer step of every ray (``rays_plain._step`` with the damped
    equations)."""
    ds = case["ode.ds"]
    sout = (k + 1.0) * ds
    status = torch.where((status == 0) & (sout > case["ode.s_max"]), rays_plain.SOUT_GT_SMAX,
                         status)
    active = status == 0
    f2, st2, _ = eqn_ray(case, v + ds * f1 / 2.0)
    f3, st3, _ = eqn_ray(case, v + ds * f2 / 2.0)
    f4, st4, _ = eqn_ray(case, v + ds * f3)
    v_new = v + ds * (f1 + 2.0 * f2 + 2.0 * f3 + f4) / 6.0
    st = rays_plain._first_nonzero([st1, st2, st3, st4])
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


def trace(case, v0, checkpoint=False, trajectory=False):
    """Trace every ray of v0 for ``nstep_max`` outer steps.  Returns a dict
    of end (B, nv), npoints, stop, end_res, max_res and, with
    ``trajectory``, traj (B, nstep_max + 1, nv): the state after each step,
    a stopped ray's last state repeated.  ``checkpoint`` recomputes each
    step in the backward pass."""
    B = v0.shape[0]
    f1, st1, e0 = eqn_ray(case, v0)
    _, status = check_save(case, v0, e0)
    zeros = torch.zeros((B,), dtype=v0.dtype, device=v0.device)
    nstep = torch.zeros((B,), dtype=torch.int32, device=v0.device)
    carry = (v0, f1, st1, status, nstep, zeros, zeros)
    rows = [v0]
    for k in range(case.static["nstep_max"]):
        kk = torch.full((), float(k), dtype=v0.dtype, device=v0.device)
        if checkpoint:
            carry = torch.utils.checkpoint.checkpoint(
                lambda *c: _step(case, *c), kk, *carry, use_reentrant=False)
        else:
            carry = _step(case, kk, *carry)
        if trajectory:
            rows.append(carry[0])
    v, _, _, status, nstep, end_res, max_res = carry
    out = dict(end=v, npoints=nstep + 1,
               stop=torch.where(status == 0, rays_plain.NSTEP_MAX, status),
               end_res=end_res, max_res=max_res)
    if trajectory:
        out["traj"] = torch.stack(rows, 1)
    return out


# --- deposition (deposition_profiles_m.f90:229-293) -----------------------


def _left_of(edge, lo, hi, d_q, thin):
    """sum over segments of dQ times the share of the segment left of
    ``edge`` (index space): a segment of no extent is all on the side of
    its point, ``[lo, lo + 1)`` being bin ``floor(lo)``."""
    extent = hi - lo
    share = ((edge - lo) / torch.where(thin, torch.ones_like(extent), extent)).clamp(0.0, 1.0)
    share = torch.where(thin, (lo < edge).to(lo.dtype), share)
    return (d_q * share).sum()


def deposition_profile(run, pwr, n_bins, xmin, xmax, slot=DAMPING_SLOT):
    """The absorbed power binned on x over ``n_bins`` uniform bins of
    [xmin, xmax], summed over rays: each trajectory segment's increment of
    the absorbed power (pwr times the damping slot) spread over the bins
    it crosses in proportion to its length in each (bin_to_uniform_grid_m
    .f90:80-148), the parts outside the grid dropped.  Bin b gets what
    lies left of edge b + 1 less what lies left of edge b."""
    traj = run["traj"]
    q = pwr[:, None] * traj[..., slot]
    ix = (traj[..., 0] - xmin) / ((xmax - xmin) / n_bins)
    lo = torch.minimum(ix[:, :-1], ix[:, 1:])
    hi = torch.maximum(ix[:, :-1], ix[:, 1:])
    d_q = q[:, 1:] - q[:, :-1]
    thin = (hi - lo) <= 1e-12

    def left_of(b):
        # each edge's sum recomputed in the backward pass, not kept
        edge = torch.full((), float(b), dtype=lo.dtype, device=lo.device)
        if torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(_left_of, edge, lo, hi, d_q, thin,
                                                     use_reentrant=False)
        return _left_of(edge, lo, hi, d_q, thin)

    left = torch.stack([left_of(b) for b in range(n_bins + 1)])
    return left[1:] - left[:-1]
