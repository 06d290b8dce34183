"""device.idle_share.train (%): 100 (1 - the union of the device's busy
intervals over the traced window) in a derivative-step cell."""

from benchmark.lib import readers


def read(w):
    if w.info["spec"]["driver"] == "forward" or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - readers.busy_s(w) / w.trace.window_s)
