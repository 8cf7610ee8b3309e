"""``ce_roofline``: the fused masked-CE kernels' least time (each launch's
bytes read once and written once, ``cilbench/cebytes.py``, over the HBM
peak) over their device time in the traced window, in percent.  The
kernels are found by the names in ``KERNELS``; none found, no reading."""

from cilbench import cebytes, peaks

KERNELS = ("fused_ce_fwd_sm90", "fused_ce_bwd_sm90")


def read(r):
    t = r.trace
    if t is None:
        return None
    b, w = r.counters["batch"], r.counters["head_width"]
    bound_s = device_s = 0.0
    for name, start, end, _ in t.kernels:
        for k in KERNELS:
            if k in name:
                bound_s += cebytes.KERNEL_BYTES[k](b, w) / peaks.HBM_BYTES_PER_S
                device_s += (end - start) / 1e9
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
