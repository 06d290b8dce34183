"""spline.evals_per_step.train (evals/step): the 2-D cell-spline
evaluations (``rays_tpu_torch/ops/splines.py``: one row fetch of the
coefficient table for a batch of points) that the adjoint graph's replays
make in an outer step, forward and VJP together.  The program stores on
each cache entry the evaluations that each piece's capture ran, and each
replay adds its piece's count to ``splines.REPLAYED_EVALS``
(``rays_tpu_torch/tracing/graphed.py``); the reader divides that total by
half of ``graphed_adjoint.REPLAYS`` (a step replay and a VJP replay an
outer step).  Both are totals over the process, the warm-up call
included, so their ratio is the count of one step.  Nothing off the
adjoint route, nor from a program without the counter.
"""

import sys


def read(w):
    if w.info["route"] != "adjoint":
        return None
    sp = sys.modules.get("rays_tpu_torch.ops.splines")
    ga = sys.modules.get("rays_tpu_torch.tracing.graphed_adjoint")
    if sp is None or ga is None or not hasattr(sp, "REPLAYED_EVALS") or not ga.REPLAYS:
        return None
    steps = ga.REPLAYS / 2
    w.notes = getattr(w, "notes", []) + [
        f"spline.evals_per_step.train: {sp.REPLAYED_EVALS} cell-spline evaluations replayed "
        f"over {steps:g} outer steps of the process (step and VJP replays); "
        f"{sp.EVALS} run by Python"]
    return sp.REPLAYED_EVALS / steps
