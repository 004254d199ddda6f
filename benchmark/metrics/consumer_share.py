"""``consumer_share`` (%): the time the stream's consumer (the CLI's rows,
here the benchmark's) held the main thread between results in the
untraced stretch of a ``--trace 1`` run (Σ ``stream/results``'
``consumer_s`` in the program's recording of it, ``program_spans.untraced``)
over that recording's window: the main thread's work outside the
program.  The recorder costs about 141 µs of the main thread a batch; no
profiler runs there."""

from benchmark import program_spans


def read(record):
    rec = program_spans.untraced(record)
    found = rec and program_spans.results(rec)
    if not found:
        return None
    return 100.0 * found[1] / program_spans.window_s(rec)
