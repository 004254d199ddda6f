"""``worker_unpacked_share`` (%): the samples the reader workers unpacked
(svb16 and the prefix sum) over the samples of the vbz chunks they
zstd-decompressed, Σ over the ``read/file`` spans (their ``unpacked`` and
``samples`` args) in the program's recording of the untraced stretch of a
``--trace 1`` run (``program_spans.untraced``).  100 % where every chunk
touched is unpacked whole; lower where a chunk only a read's head needs
is unpacked only up to the head's last sample.  A program whose spans
carry no such counts gives nothing."""

from benchmark import program_spans


def read(record):
    rec = program_spans.untraced(record)
    if rec is None:
        return None
    samples = unpacked = 0
    for name, _start, _end, _pid, _tid, _batch, args in rec.window():
        if name == "read/file":
            samples += args.get("samples", 0)
            unpacked += args.get("unpacked", 0)
    if samples == 0:
        return None
    return 100.0 * unpacked / samples
