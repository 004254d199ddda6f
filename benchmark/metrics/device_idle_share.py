"""``device_idle_share`` (%): the part of the traced window in which no
kernel, copy or memset ran on the card."""


def read(record):
    if record.trace is None or not record.trace.device:
        return None
    return 100.0 * (1.0 - record.trace.busy_us() * 1e-6 / record.trace_window_s)
