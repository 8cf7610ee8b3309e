"""The device's idle share of the traced window: ``1 - busy / window``,
busy being the union of its kernel and copy intervals."""


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None  # no device activity was traced
    return 1.0 - t.busy_s / t.window_s
