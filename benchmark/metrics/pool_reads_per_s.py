"""``pool_reads_per_s`` (reads/s): the reader pool's own rate, with
nothing uploaded and nothing else running in the process.  After the
window of a ``--trace 1`` run the stream is closed, the pool's workers
finish what they hold, and the same pool reads the cell's corpus again
through its own batch iterator, each batch's slot released as it arrives:
the reads handed over in the 8 s after a first, untimed 1 s, ÷ 8 s.
Beside the card's cap (from ``step_mfu``) it says which of the two sets
the pace.  No pass, nothing to read."""


def read(record):
    return record.pool_reads_per_s
