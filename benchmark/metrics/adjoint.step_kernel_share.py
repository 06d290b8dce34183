"""adjoint.step_kernel_share (%): the share of the adjoint graph's outer
steps whose forward a hand-written step kernel ran.  100 times the step
kernels' launches, ``STEP_LAUNCHES`` of
``rays_tpu_torch/tracing/slab_vjp.py`` (the slab step) and of
``rays_tpu_torch/tracing/eqdsk_step.py`` (the EQDSK spline toroid's step),
over the outer steps that the step piece ran: half of
``graphed_adjoint.REPLAYS`` (a step replay and a VJP replay an outer step)
and the warm-up before each capture, which calls the step piece directly
``graphed_adjoint.WARMUP`` times (``CAPTURES`` captures).  The program
counts a captured launch at each replay of its graph and a launch outside
a capture when it is made, so a run whose every step ran a kernel reads
100.  All are totals over the process, read from ``sys.modules``; a module
or counter the program lacks counts 0.  Nothing off the adjoint route, nor
before a replay.
"""

import sys

_STEP_KERNELS = ("slab_vjp", "eqdsk_step")


def read(w):
    if w.info["route"] != "adjoint":
        return None
    ga = sys.modules.get("rays_tpu_torch.tracing.graphed_adjoint")
    if ga is None or not getattr(ga, "REPLAYS", 0):
        return None
    launches = {name: getattr(sys.modules.get(f"rays_tpu_torch.tracing.{name}"),
                              "STEP_LAUNCHES", 0) for name in _STEP_KERNELS}
    warmup = getattr(ga, "WARMUP", 0) * getattr(ga, "CAPTURES", 0)
    steps = ga.REPLAYS / 2 + warmup
    w.notes = getattr(w, "notes", []) + [
        "adjoint.step_kernel_share: step kernel launches "
        + ", ".join(f"{name} {n}" for name, n in launches.items())
        + f" over {steps:g} outer steps of the process (step and VJP replays, and "
        f"{warmup:g} warm-up steps)"]
    return 100.0 * sum(launches.values()) / steps
