"""``worker_decode_share`` (%): the reader workers' vbz decode (zstd and
the svb16 unpack with its prefix sum) over their busy time
(``worker_ms_per_read``'s), in the program's recording of the untraced
stretch of a ``--trace 1`` run (``program_spans.untraced``).  The
recorder costs about 141 µs of the main thread a batch, and a worker a
few clock reads a file; no profiler runs there."""

from benchmark import program_spans


def read(record):
    rec = program_spans.untraced(record)
    work = rec and program_spans.worker_work(rec)
    if not work:
        return None
    return 100.0 * work["decode_s"] / work["busy_s"]
