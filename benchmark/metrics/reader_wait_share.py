"""``reader_wait_share`` (%): the part of the window in which the stream's
feeder thread waited inside the reader pool's batch iterator.  Near 100,
the pool sets the pace; near 0, the card or the main thread does."""


def read(record):
    if record.pool_wait_s is None:
        return None
    return 100.0 * record.pool_wait_s / record.seconds
