"""The program's own spans and counters, for the per-layer metrics that
read them (``metrics/worker_*.py``, ``enqueue_share``, ``result_share``,
``consumer_share``), and for the idle gaps' names.

The port keeps them in memory (``deepbinner_tpu_torch/runner/spans.py``):
the reader workers' ``read/file`` (with the file's ``open``, ``tables``,
``zstd`` and ``unpack`` seconds, its ``reads``, ``samples`` and
``unpacked``) and ``batch/build``, and the classify stream's ``stream/*``
on the main thread, ``stream/results`` with its ``consumer_s``.  All are on
``time.perf_counter``'s clock; a recording's window is its own (``start``,
``end``).

A ``--trace 1`` run has two recordings.  The untraced one
(:func:`untraced`), from the window's start to just before the profiler
opens (23 s of a 51 s window), is the harness's ``spans.start()`` and
``spans.stop()`` with no profiler on: every metric named above reads it.
The recorder costs about 141 µs of the main thread a batch; the profiler
inflates what the spans time far more (the workers' 1.1–1.7 times), so
the traced part's recording (:func:`recording`), which the classify
stream starts itself while the profiler records, only names the traced
window's idle gaps (its ``stream/*`` spans go into ``record.trace``).
A program without the recorder, a run with no trace, or a recording that
fails its check gives nothing to read.
"""

from __future__ import annotations

from typing import Optional

# The main thread's spans of the program's enqueue: the upload, the
# call_packed that enqueues the step, the slot-release checks after it.
ENQUEUE = ("stream/upload", "stream/enqueue", "stream/release")
PARSE = ("open", "tables")
DECODE = ("zstd", "unpack")


def _calls_are(rec, batches) -> bool:
    """Whether ``rec`` counted, call for call, the rows of ``batches`` (the
    calls the harness saw in the same stretch) in a window that ended."""
    if (rec is None or not batches or rec.end is None
            or rec.end <= rec.start):
        return False
    rows = [value for _at, value in rec.counters.get("call_packed/rows", ())]
    return rows == list(batches)


def recording(record):
    """The program's recording of the traced part of ``record``'s run, or
    None.  It is the one that followed this run's profiler only if the
    rows of the calls it counted (``call_packed/rows``) are, call for
    call, those the harness recorded in the traced window
    (``record.step_batches``): a recording left from another run, or one
    that never started, gives nothing."""
    if record.trace is None:
        return None
    try:
        from deepbinner_tpu_torch.runner import spans
    except ImportError:
        return None
    rec = spans.last()
    if rec is None or not rec.followed or not _calls_are(rec, record.step_batches):
        return None
    return rec


def untraced(record):
    """The program's recording of the untraced stretch of ``record``'s
    run, or None.  It is the harness's own only if no profiler started it
    and the rows of the calls it counted are, call for call, those the
    harness recorded in that stretch (``record.untraced.batches``): a
    recording left from another run, or one a profiler started, gives
    nothing."""
    stretch = record.untraced
    if stretch is None:
        return None
    rec = stretch.recording
    if rec is None or rec.followed or not _calls_are(rec, stretch.batches):
        return None
    return rec


def window_s(rec) -> float:
    return rec.end - rec.start


def seconds(rec, names) -> float:
    """Σ of the durations of the window's spans named in ``names``."""
    return sum(end - start for name, start, end, *_rest in rec.window()
               if name in names)


def results(rec):
    """(Σ duration, Σ ``consumer_s``) of the window's ``stream/results``,
    or None where it has none."""
    found = [(end - start, args["consumer_s"])
             for name, start, end, _pid, _tid, _batch, args in rec.window()
             if name == "stream/results"]
    if not found:
        return None
    return sum(d for d, _c in found), sum(c for _d, c in found)


def worker_work(rec) -> Optional[dict]:
    """The workers' busy seconds in the window (their ``read/file`` and
    ``batch/build`` spans), the reads of the files read in it, and those
    files' parse (``open`` + ``tables``) and decode (``zstd`` + ``unpack``)
    seconds; None where no file was read in it."""
    busy = parse = decode = 0.0
    reads = 0
    for name, start, end, _pid, _tid, _batch, args in rec.window():
        if name == "batch/build":
            busy += end - start
        elif name == "read/file":
            busy += end - start
            reads += args["reads"]
            parse += sum(args.get(key, 0.0) for key in PARSE)
            decode += sum(args.get(key, 0.0) for key in DECODE)
    if reads == 0 or busy <= 0.0:
        return None
    return {"busy_s": busy, "reads": reads, "parse_s": parse,
            "decode_s": decode}


def stream_spans(rec):
    """The window's ``stream/*`` spans as ``(start, end, name)``, but the
    feeder's ``stream/pool_wait``, which the harness's own
    ``bench/pool_wait`` already times from outside."""
    return [(start, end, name) for name, start, end, *_rest in rec.window()
            if name.startswith("stream/") and name != "stream/pool_wait"]
