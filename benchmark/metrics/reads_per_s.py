"""``reads_per_s``: call rows produced in the window per second of it."""


def read(record):
    return record.rows / record.seconds
