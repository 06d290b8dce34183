"""adjoint.kernels_per_step (kernels/step): CUDA kernels, copies and sets
of whole derivative steps in the traced window, forward and backward,
over the outer steps they took (calls times ``nstep_max``)."""


def read(w):
    if w.info["route"] != "adjoint" or not w.trace.ops:
        return None
    return len(w.trace.ops) / (w.info["calls"] * w.info["outer_steps"])
