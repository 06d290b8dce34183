"""slab_rk4_roofline (%): the slab kernel B1 (``csrc/slab_rk4.cu``)
against its roofline.  The work is what the inputs need: the rays' live
steps (npoints - 1, summed) times the frozen count of operations per live
step of the cell's variant (``counts/``), and the bytes each ray reads and
writes once.  The roofline time is the larger of the operations over the
published peak of the dtype and the bytes over the published memory rate
(``counts/peaks.h100_sxm.json``); the share is that time over the
kernel's device time per call."""

from benchmark.lib import common, readers


def read(w):
    spec = w.info["spec"]
    if w.info["route"] != "kernel" or "kernel_count" not in spec:
        return None
    count = common.count(spec["kernel_count"])
    peaks = common.count("peaks.h100_sxm")
    seconds, source = readers.kernel_seconds(w, count["kernel_name"])
    if seconds <= 0.0:
        return None
    live = float((w.info["npoints"].double() - 1).sum())
    ops = live * count["ops_per_live_step"]
    nbytes = w.info["rays"] * count["bytes_per_ray"][w.info["dtype"]]
    t_ops = ops / peaks["flops"][w.info["dtype"]]
    t_bytes = nbytes / peaks["bytes_per_s"]
    w.notes.append(f"slab_rk4_roofline: {live:.0f} live steps, {ops:.6e} operations, "
                   f"{nbytes:.6e} bytes; bound by {'operations' if t_ops >= t_bytes else 'bytes'}"
                   f" ({max(t_ops, t_bytes):.9f} s) against {seconds:.9f} s ({source})")
    return 100.0 * max(t_ops, t_bytes) / seconds
