"""``k1_roofline`` (%): the least time K1's launches in the traced window
could take (each launch's operations over the float32 peak or its bytes
over the memory bandwidth, whichever is larger) over their device time.

Launch i of the K1 wrapper in the traced window is K1 kernel i on the
device: the window opens and closes on a drained device, and the program
launches from one thread onto one stream.  Where the counts differ, or
nothing was traced, there is nothing to read."""

KERNEL = "conv1d_bn_relu_kernel"


def read(record):
    if record.trace is None or not record.k1_launches:
        return None
    kernels = record.trace.kernels(KERNEL)
    if len(kernels) != len(record.k1_launches):
        return None
    bound = sum(unit.bound_s for unit in record.k1_launches)
    spent = sum(end - start for start, end, _name in kernels) * 1e-6
    return 100.0 * bound / spent
