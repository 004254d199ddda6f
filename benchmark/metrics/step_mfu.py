"""``step_mfu`` (%): DemuxNet's forward operations on every window of every
batch the program was called on in the traced part of the window, over
the card's busy time there, over the card's float32 peak (the program runs
float32 with TF32 off).  The whole step's share of the peak while the card
works, whichever kernels it runs: it bounds a kernel's roofline claim once
that kernel leaves the path.  Nothing traced, nothing to read."""

from benchmark import flops


def read(record):
    if record.trace is None or not record.step_batches or not record.trace.device:
        return None
    operations = (sum(record.step_batches) * record.windows_per_read * record.ends
                  * flops.forward_flops_per_window(record.network))
    busy_s = record.trace.busy_us() * 1e-6
    return 100.0 * operations / busy_s / flops.FP32_FLOP_PER_S
