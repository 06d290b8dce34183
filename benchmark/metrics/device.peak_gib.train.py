"""device.peak_gib.train (GiB): ``torch.cuda.max_memory_allocated()`` over
the traced derivative steps (the adjoint's carry stack among it)."""


def read(w):
    if w.info["spec"]["driver"] == "forward" or w.info["peak_bytes"] <= 0:
        return None
    return w.info["peak_bytes"] / 2**30
