"""Driver of a forward trace with damping: the program's call, what is
kept of it and what is compared are ``forward.py``'s (``trace.trace_rays``,
summaries only; on the card the slab kernel B1's damped library), the
absorption slots among the end state's.  The answer is held to the damped
plain reference (``reference/rays_damped.py``).  Reports ``rays_per_s``.
"""

from __future__ import annotations

import torch

from benchmark.lib import common, inputs

_FORWARD = common.load_module(common.HERE / "drivers" / "forward.py")

METRIC = _FORWARD.METRIC
Driver = _FORWARD.Driver


def reference_inputs(cell, seed, device, dtype):
    """(case, launch rays on the CPU, v0, pwr) of the damped reference, from
    the same namelist text as the program's (``inputs.namelist_text``)."""
    from benchmark.reference import rays_damped

    model = common.load_module(common.HERE / "reference" /
                               f"model_{cell.config['reference_model']}.py")
    case = rays_damped.build_case(inputs.namelist_text(cell, seed), dtype, device,
                                  fields=model.builder)
    case.static["nstep_max"] = inputs.nstep_max(cell, case.static["nstep_max"])
    v0, pwr = model.launch(case)
    inputs._check_count(cell, v0)
    return case, v0.detach().cpu(), v0, pwr


def reference(cell, seed, device, dtype):
    """The damped reference's answer to the same call, in ``dtype``."""
    from benchmark.reference import rays_damped

    case, v_base, v0, pwr = reference_inputs(cell, seed, device, dtype)
    with torch.no_grad():
        run = rays_damped.trace(case, v0)
    return dict(v0=v_base, pwr=pwr.cpu(), end=run["end"].cpu(), npoints=run["npoints"].cpu(),
                stop=run["stop"].cpu(), max_res=run["max_res"].cpu())
