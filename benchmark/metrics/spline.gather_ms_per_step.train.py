"""spline.gather_ms_per_step.train (ms/step): the device time of the cell
spline's gathers and their scatter-adds in the traced derivative steps,
over the outer steps they took.  A cell-spline evaluation fetches the
coefficient rows of its points with one ``index_select`` of the table
(``rays_tpu_torch/ops/splines.py``, ``_cell_rows``), whose backward in
the VJP adds the rows' cotangents into the table's gradient with
``index_add_``.  On the card (PyTorch 2.11) the gather of a batch of
rays is ``vectorized_gather_kernel`` (``indexSelectLargeIndex`` where the
rows cannot be read as vectors) and the scatter-add
``indexFuncLargeIndex``; the adjoint's one-row reads of its carry stack
take ``indexSelectSmallIndex`` and are not counted.  No other kernel of a
step has these names: ``slab_ech.grad``'s census holds none of them
(PERF.md, section 3).  Counted from the start of the first
``rays.adjoint.forward`` / ``.reforward`` / ``.backward`` span
(``rays_tpu_torch/tracing/graphed_adjoint.py``) in the window, so the
eager initial evaluation's gather is left out and its scatter-add, one
kernel a call, is in; the steps are the forward spans' (``nstep_max``
each).  Nothing off the adjoint route, without the spans or without such
kernels.

Notes: each gather and index kernel's name, count and device ms in the
window, and the host ms of the program's ``rays.eq.build`` span (the
G-EQDSK read and the spline builds) where the record holds it: it runs
in the set-up, and spans are recorded only under a profiler or
``spans.recording()``.
"""

import re

from benchmark.lib import common

_SPANS = common.load_module(common.HERE / "metrics" / "dispatch.idle_share.fwd.py")
KERNELS = ("vectorized_gather_kernel", "indexSelectLargeIndex", "indexFuncLargeIndex")
LOOPS = ("rays.adjoint.forward", "rays.adjoint.reforward", "rays.adjoint.backward")


def read(w):
    if w.info["route"] != "adjoint" or w.info["outer_steps"] <= 0:
        return None
    recs = _SPANS.program_spans(w)
    if not recs:
        return None
    loops = [s for r, s, _ in recs if r.name in LOOPS]
    forwards = sum(r.name == "rays.adjoint.forward" for r, _, _ in recs)
    if not loops or not forwards:
        return None
    start = min(loops)
    kinds, seen = {}, {}        # a window holds millions of kernels of a few dozen names
    for name, s, d, copy in w.trace.ops:
        if copy or s < start:
            continue
        kind = kinds.get(name, False)
        if kind is False:
            m = re.search(r"\w*(index|gather)\w*", name, re.I)
            kind = kinds[name] = m and m.group(0)
        if kind:
            n, us = seen.get(kind, (0, 0.0))
            seen[kind] = (n + 1, us + d)
    found = [v for k, v in seen.items() if k in KERNELS]
    steps = forwards * w.info["outer_steps"]
    from rays_tpu_torch.utils import spans

    build = [r for r in spans.records() if r.name == "rays.eq.build"]
    w.notes = getattr(w, "notes", []) + [
        "spline.gather_ms_per_step.train: " + ", ".join(
            f"{k} {n} kernels {us * 1e-3:.3f} ms" for k, (n, us) in sorted(seen.items()))
        + f"; {steps} steps; rays.eq.build host ms: "
        + (", ".join(f"{(r.end_ns - r.start_ns) * 1e-6:.3f}" for r in build)
           if build else "not recorded (set-up, outside the profiler)")]
    if not found:
        return None
    return sum(us for _, us in found) * 1e-3 / steps
