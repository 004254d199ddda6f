"""``enqueue_share`` (%): the main thread's time enqueuing the program's
work in the untraced stretch of a ``--trace 1`` run (``stream/upload``,
``stream/enqueue`` — the ``call_packed`` that enqueues the step — and
``stream/release``, the slot-release checks after it, in the program's
recording of it, ``program_spans.untraced``) over that recording's
window.  The recorder costs about 141 µs of the main thread a batch; no
profiler runs there."""

from benchmark import program_spans


def read(record):
    rec = program_spans.untraced(record)
    if rec is None:
        return None
    spent = program_spans.seconds(rec, program_spans.ENQUEUE)
    if spent <= 0.0:
        return None
    return 100.0 * spent / program_spans.window_s(rec)
