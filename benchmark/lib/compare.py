"""The comparison that decides ``correct``: the numbers that hold what the
timed path produced against the plain reference, each beside its limit.

Every number is a gap that is 0 when the two agree:

    launch_gap     the program's launch vectors against the reference's,
                   worst column group (position, wavevector, the rest),
                   relative to the reference's largest magnitude there
    end_gap        the same for every ray's end state
    resid_gap      worst ray's gap in its largest dispersion residual
                   (the residual is normalized already: an absolute gap)
    npoints_diff   rays whose number of points differs (exact: limit 0)
    stop_diff      rays whose stop code differs (exact: limit 0)
    loss_gap       |loss, program - reference| over the reference's
    grad_gap       the worst leaf's gap between the program's gradient
                   norm and the reference's, over the larger of the
                   reference's norm of that leaf and the median of the
                   reference's nonzero leaf norms

A cell's workload file gives the limit of each number it checks; a number
without a limit there is not computed.
"""

from __future__ import annotations

import statistics

import torch

_GROUPS = ((0, 3), (3, 6), (6, None))


def _rel_gap(a, b):
    a, b = a.double(), b.double()
    scale = b.abs().max()
    if scale == 0:
        return float((a - b).abs().max())
    return float((a - b).abs().max() / scale)


def state_gap(a, b):
    return max(_rel_gap(a[:, lo:hi], b[:, lo:hi]) for lo, hi in _GROUPS
               if a[:, lo:hi].numel())


def grad_gap(prog, ref):
    """prog, ref: {leaf name: tensor}; a leaf the reference lacks is one
    no reference formula reads, gradient 0."""
    norms = {k: float(torch.linalg.vector_norm(ref.get(k, torch.zeros(())).double()))
             for k in prog}
    nonzero = [v for v in norms.values() if v > 0.0]
    floor = statistics.median(nonzero) if nonzero else 1.0
    worst, which = 0.0, None
    for k, g in prog.items():
        gap = abs(float(torch.linalg.vector_norm(g.double())) - norms[k]) / max(norms[k], floor)
        if not gap <= worst:  # a NaN is the worst of all
            worst, which = gap, k
    return worst, which


def numbers(prog, ref, wanted):
    """{name: value} for the names in ``wanted``.  ``prog`` and ``ref`` are
    dicts of CPU tensors with the keys v0, end, npoints, stop, max_res
    and, for a derivative step, loss and grads."""
    out = {}
    if "launch_gap" in wanted:
        out["launch_gap"] = state_gap(prog["v0"], ref["v0"])
    if "end_gap" in wanted:
        out["end_gap"] = state_gap(prog["end"], ref["end"])
    if "resid_gap" in wanted:
        out["resid_gap"] = float((prog["max_res"].double() - ref["max_res"].double()).abs().max())
    if "npoints_diff" in wanted:
        out["npoints_diff"] = int((prog["npoints"] != ref["npoints"]).sum())
    if "stop_diff" in wanted:
        out["stop_diff"] = int((prog["stop"] != ref["stop"]).sum())
    if "loss_gap" in wanted:
        out["loss_gap"] = float((prog["loss"].double() - ref["loss"].double()).abs()
                                / ref["loss"].double().abs())
    if "grad_gap" in wanted:
        out["grad_gap"], _ = grad_gap(prog["grads"], ref["grads"])
    return out


def judge(values, limits):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit (a NaN never is)."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits if k in values}
    ok = len(checks) == len(limits) and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
