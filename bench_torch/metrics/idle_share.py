"""Share of the traced window in which no kernel ran on the device (%).
Layer: device."""


def read(trace, cfg):
    if trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
