"""``reader_wait_share`` (%): the part of the untraced stretch of a
``--trace 1`` run (the window's start to just before the profiler opens)
in which the stream's feeder thread waited inside the reader pool's batch
iterator, both timed by the harness.  Near 100, the pool sets the pace;
near 0, the card or the main thread does.  The program's recorder is on
in that stretch (about 141 µs of the main thread a batch); no profiler
is."""


def read(record):
    stretch = record.untraced
    if stretch is None or stretch.seconds <= 0.0:
        return None
    return 100.0 * stretch.pool_wait_s / stretch.seconds
