"""``result_share`` (%): the main thread's time turning call tables into
``ReadResult`` rows in the untraced stretch of a ``--trace 1`` run
(``stream/results`` less the consumer's time between results,
``consumer_s``, in the program's recording of it,
``program_spans.untraced``) over that recording's window.  The recorder
costs about 141 µs of the main thread a batch; no profiler runs there."""

from benchmark import program_spans


def read(record):
    rec = program_spans.untraced(record)
    found = rec and program_spans.results(rec)
    if not found:
        return None
    spent, consumer = found
    return 100.0 * (spent - consumer) / program_spans.window_s(rec)
