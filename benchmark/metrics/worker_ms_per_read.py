"""``worker_ms_per_read`` (ms): the reader workers' time (their
``read/file`` and ``batch/build`` spans) per read of the files read, in
the program's recording of the untraced stretch of a ``--trace 1`` run
(``program_spans.untraced``).  Σ over the workers: it falls when a read
costs a worker less, whatever the number of workers.  The recorder costs
about 141 µs of the main thread a batch, and a worker a few clock reads a
file; no profiler runs there (under one these spans read
1.1–1.7 times longer)."""

from benchmark import program_spans


def read(record):
    rec = program_spans.untraced(record)
    work = rec and program_spans.worker_work(rec)
    if not work:
        return None
    return 1e3 * work["busy_s"] / work["reads"]
