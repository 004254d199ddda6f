"""Streaming batch executor: readers → fixed-shape batches → device.

Counterpart of ``deepbinner_tpu/runner/executor.py``.  Batches come from
one of two sources:

- in-process reader threads (:func:`iter_signals`, :func:`classify_files`)
  pull raw signal from fast5/pod5 files into a bounded queue and the batches
  are built here, on the consumer;
- the reader worker processes of :mod:`.mp_reader` build the batches
  themselves and hand them over in shared-memory slots
  (:func:`classify_batches` takes their ``(ids, start, start_len, end,
  end_len, release)`` 6-tuples).

Batches are padded to one fixed size.  CUDA launches are asynchronous, so
while the card works on batch i the host builds batch i+1.  Each batch's
call table is copied back to pinned host memory by a copy enqueued right
behind its own step, with an event recorded after the copy; a small
in-flight deque waits on the oldest batch's event alone, so the card runs
the steps enqueued after it while the host turns that batch into rows.
A shared-memory slot goes back to the workers only once the CUDA events
recorded right after its batch's upload, one on each of the program's
devices, have all completed.

Per-file read errors are skipped and counted.  When the consumer abandons
a pass, the prefetch feeder is stopped and joined and the batch generator
closed, so nothing of that pass keeps reading into the next one.

While the program's spans record (:mod:`.spans`: switched on and off, or
following a ``torch.profiler`` that records) :func:`classify_batches`
records each batch's ``stream/*`` spans, on the main thread and on the
feeder; off, it tests one flag per batch.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import profiler as autograd_profiler

from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.runner import spans
from deepbinner_tpu_torch.runner.hostbatch import (  # noqa: F401 — re-exported API
    BatchSpec,
    BuiltBatch,
    ExecutorStats,
    TrimSpec,
    build_batch_arrays,
)
from deepbinner_tpu_torch.runner.pipeline import ClassifyProgram, unpack_call_table
from deepbinner_tpu_torch.utils import fast5 as fast5_io


@dataclasses.dataclass
class ReadResult:
    """One classified read, as the CLI layer consumes it."""

    read_id: str
    call: int                 # final class index, 0 = none
    start_call: int
    end_call: int
    start_probs: np.ndarray   # (C,)
    end_probs: np.ndarray     # (C,)


_SENTINEL = object()
# How often a blocked producer looks at its stop flag, in seconds.
_POLL_S = 0.05

# Signature: path -> list of (read_id, int16 signal).
ReadFn = Callable[[str], List[Tuple[str, np.ndarray]]]


def _default_read_fn(path: str) -> List[Tuple[str, np.ndarray]]:
    return fast5_io.read_signal_file(path)  # fast5 AND pod5 by extension


def _put(out: "queue.Queue[object]", item: object, stop: threading.Event) -> bool:
    """Put unless ``stop`` is set first; False when the consumer is gone."""
    while not stop.is_set():
        try:
            out.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _reader_worker(
    paths: "queue.Queue[object]",
    out: "queue.Queue[object]",
    stats: ExecutorStats,
    stats_lock: threading.Lock,
    read_fn: ReadFn,
    stop: threading.Event,
) -> None:
    while not stop.is_set():
        path = paths.get()
        if path is _SENTINEL:
            break
        error = ""
        try:
            reads = read_fn(path)  # type: ignore[arg-type]
        except Exception as exc:  # noqa: BLE001 — skip-and-count semantics
            reads = []
            error = repr(exc)
        if not reads:
            with stats_lock:
                stats.record_failure(path, error)
            continue
        for item in reads:
            if not _put(out, item, stop):
                return
    _put(out, _SENTINEL, stop)


def iter_signals(
    fast5_paths: Sequence[str],
    num_readers: int = 4,
    queue_depth: int = 256,
    stats: Optional[ExecutorStats] = None,
    read_fn: ReadFn = _default_read_fn,
) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (read_id, signal) from files using a reader thread pool.

    Yields in *completion* order; the call table sorts downstream.  Closing
    the generator early stops the readers and waits for them.
    """
    stats = stats or ExecutorStats()
    path_q: "queue.Queue[object]" = queue.Queue()
    out_q: "queue.Queue[object]" = queue.Queue(maxsize=queue_depth)
    for path in fast5_paths:
        path_q.put(path)
    for _ in range(num_readers):
        path_q.put(_SENTINEL)
    lock = threading.Lock()
    stop = threading.Event()
    workers = [
        threading.Thread(
            target=_reader_worker,
            args=(path_q, out_q, stats, lock, read_fn, stop),
            daemon=True, name="classify-reader",
        )
        for _ in range(num_readers)
    ]
    for worker in workers:
        worker.start()
    try:
        finished = 0
        while finished < num_readers:
            item = out_q.get()
            if item is _SENTINEL:
                finished += 1
                continue
            yield item  # type: ignore[misc]
    finally:
        stop.set()
        for worker in workers:
            worker.join()


def batch_spec_for(
    cfg: PreprocessConfig, batch_size: int, dual: bool
) -> BatchSpec:
    """The BatchSpec matching a program's PreprocessConfig: under
    ``cfg.host_trim`` it carries the TrimSpec the device then skips."""
    trim = None
    if cfg.host_trim:
        trim = TrimSpec(
            trim_scan=cfg.trim_scan,
            trim_window=cfg.trim_window,
            trim_stride=cfg.trim_stride,
            trim_threshold=cfg.trim_threshold,
            window=cfg.window,
            scan_size=cfg.scan_size,
        )
    if cfg.wire in ("int8", "int4") and trim is None:
        raise ValueError(f"wire='{cfg.wire}' requires host_trim (quantisation "
                         "must run after the open-pore trim, on the host)")
    return BatchSpec(batch_size=batch_size, buffer_size=cfg.buffer_size,
                     dual=dual, trim=trim, wire=cfg.wire)


def build_batch(
    reads: Sequence[Tuple[str, np.ndarray]],
    cfg: PreprocessConfig,
    batch_size: int,
    dual: bool,
) -> BuiltBatch:
    """Pad reads into fixed-shape buffers (see hostbatch.build_batch_arrays)."""
    return build_batch_arrays(reads, batch_spec_for(cfg, batch_size, dual))


# The streaming window: batches enqueued on the device before the oldest
# result is copied back, and batches prefetched by the feeder thread.  A
# zero-copy pass (ReaderPool.iter_batches(copy=False)) holds a slot for
# every batch in that window, so a ring needs at least MIN_SHM_SLOTS.
IN_FLIGHT = 2
PREFETCH = 2
MIN_SHM_SLOTS = IN_FLIGHT + PREFETCH + 2


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records now (the flag torch's own
    ``record_function`` tests; a torch without it never turns the program's
    spans on)."""
    return getattr(autograd_profiler, "_is_profiler_enabled", False)


def _no_clock() -> float:
    return 0.0


def _copy_back(packed: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional["torch.cuda.Event"]]:
    """``packed`` on the host, and on a CUDA device the event that marks the
    copy done: the copy goes into pinned memory (a non-blocking copy to the
    CPU allocates it) on the current stream of ``packed``'s device, behind
    the step that made it.  A CPU tensor is its own host table."""
    if packed.device.type != "cuda":
        return packed, None
    with torch.cuda.device(packed.device):
        host = packed.to("cpu", non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
    return host, copied


@dataclasses.dataclass
class _Pending:
    """One dispatched batch: its ids, its packed result on the host, whole
    once ``copied`` has completed (no event on the CPU, where it is whole
    already), and for a shared-memory batch the slot's release and the
    upload's events (one per device the batch's rows went to); ``key`` is
    the batch's identifier where its reader worker gave one
    (:mod:`.spans`)."""

    ids: List[str]
    host: torch.Tensor
    copied: Optional["torch.cuda.Event"] = None
    release: Optional[Callable[[], None]] = None
    uploaded: Sequence["torch.cuda.Event"] = ()
    key: Optional[tuple] = None

    def release_if_uploaded(self, wait: bool = False) -> None:
        """Give the slot back once every upload has completed (``wait``:
        block until they have)."""
        if self.release is None:
            return
        if wait:
            for event in self.uploaded:
                event.synchronize()
        elif not all(event.query() for event in self.uploaded):
            return
        self.release()
        self.release = None


def classify_batches(
    program: ClassifyProgram,
    batches: Iterable[tuple],
    stats: Optional[ExecutorStats] = None,
    in_flight: int = IN_FLIGHT,
    prefetch: int = PREFETCH,
) -> Iterator[ReadResult]:
    """Classify pre-built fixed-shape batches; yields ReadResults in order.

    A batch is a 5-tuple ``(ids, start, start_len, end, end_len)`` of owned
    arrays, or a reader pool's 6-tuple with a ``release`` that gives its
    shared-memory slot back (or None), and a 7th field, the batch's
    identifier, where the pool's worker recorded spans.  A slot is released once the CUDA events
    recorded right after its upload, on each of the program's devices, have
    all completed: checked after every dispatch, and at the latest when the
    batch's result is back on the host (its copy back follows its own step,
    which follows its uploads).

    Each batch's packed call table is copied to pinned host memory on the
    stream of the (first) device, right behind the batch's own step, and an
    event is recorded after the copy.  Up to ``in_flight`` batches are
    enqueued on the device before the host waits on the oldest one's event:
    that wait ends when the oldest batch is back, not when the newest step
    is done, so the device runs the newer steps while the host makes the
    oldest batch's rows.  ``prefetch`` > 0 pulls ``batches`` on a feeder
    thread, so host batch assembly overlaps the wait for results.
    On exit, normal or not, the slots of pending batches are released once
    their uploads are done, the feeder is stopped and joined and the
    ``batches`` generator is closed.

    While the program's spans record, each batch gets, on the main thread,
    ``stream/feed_wait`` (blocked on the feeder), ``stream/upload``
    (``program.upload`` and ``upload_events``), ``stream/enqueue``
    (``call_packed`` and the copy back's enqueue), ``stream/release`` (the
    slot-release checks), ``stream/copy_back`` (the wait for the batch's
    copy back and its unpacking) and
    ``stream/results`` (the ``ReadResult`` rows, from the first ``tolist`` to
    the consumer's return from the last; its ``consumer_s`` is the time
    the consumer held the thread between results), and on the feeder
    ``stream/pool_wait`` (blocked on ``batches``) and ``stream/feed_put``
    (blocked on a full prefetch queue).  A recording that follows a
    profiler ends where the consumer took the thread when the profiler
    stopped.
    """
    stats = stats or ExecutorStats()
    pending: "collections.deque[_Pending]" = collections.deque()
    source = batches
    stop = threading.Event()
    feeder = None
    feed: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))

    if prefetch > 0:
        error: List[BaseException] = []

        def feed_batches() -> None:
            items = iter(source)
            try:
                while True:
                    rec = spans.current()
                    now = spans.clock if rec is not None else _no_clock
                    begin = now()
                    item = next(items, None)
                    if item is None:
                        break
                    waited = now()
                    if not _put(feed, item, stop):
                        return
                    if rec is not None:
                        key = item[6] if len(item) > 6 else None
                        rec.add("stream/pool_wait", begin, waited, key)
                        rec.add("stream/feed_put", waited, now(), key)
            except BaseException as exc:  # noqa: BLE001 — raised by the consumer
                error.append(exc)
            _put(feed, None, stop)

        feeder = threading.Thread(target=feed_batches, daemon=True,
                                  name="classify-batch-feeder")
        feeder.start()

        def iter_fed() -> Iterator[tuple]:
            while True:
                item = feed.get()
                if item is None:
                    if error:
                        raise error[0]
                    return
                yield item

        batches = iter_fed()

    def drain_one(rec: Optional[spans.Recording]) -> Iterator[ReadResult]:
        entry = pending.popleft()
        now = spans.clock if rec is not None else _no_clock
        copying = now()
        if entry.copied is not None:
            entry.copied.synchronize()  # this batch's copy, not a later step
        out = unpack_call_table(entry.host)
        entry.release_if_uploaded(wait=True)
        copied = now()
        calls = out.calls.tolist()
        start_calls = out.start_calls.tolist()
        end_calls = out.end_calls.tolist()
        stats.reads += len(entry.ids)
        if rec is None:
            for i, read_id in enumerate(entry.ids):
                yield ReadResult(
                    read_id=read_id,
                    call=calls[i],
                    start_call=start_calls[i],
                    end_call=end_calls[i],
                    start_probs=out.start_probs[i],
                    end_probs=out.end_probs[i],
                )
            return
        rec.add("stream/copy_back", copying, copied, entry.key)
        clock, follows = spans.clock, rec.followed
        consumer = 0.0
        ended = None  # where a followed profiler's stop was seen
        for i, read_id in enumerate(entry.ids):
            result = ReadResult(
                read_id=read_id,
                call=calls[i],
                start_call=start_calls[i],
                end_call=end_calls[i],
                start_probs=out.start_probs[i],
                end_probs=out.end_probs[i],
            )
            handed = clock()
            yield result
            if ended is None:
                if follows and not _profiling():
                    ended = handed
                else:
                    consumer += clock() - handed
        rec.add("stream/results", copied, ended or clock(), entry.key,
                consumer_s=consumer)
        if ended is not None:
            spans.follow(False, ended)

    def release_queued() -> None:
        """Give back the slots of batches fed but never dispatched."""
        while True:
            try:
                item = feed.get_nowait()
            except queue.Empty:
                return
            if item is not None and len(item) > 5 and item[5] is not None:
                item[5]()

    batches = iter(batches)
    try:
        while True:
            rec = spans.follow(_profiling())  # the one test a batch
            now = spans.clock if rec is not None else _no_clock
            begin = now()
            batch = next(batches, None)
            if batch is None:
                break
            ids, start, start_len, end, end_len = batch[:5]
            release = batch[5] if len(batch) > 5 else None
            key = batch[6] if len(batch) > 6 else None
            fed = now()
            uploaded = program.upload(start, start_len, end, end_len)
            events = program.upload_events() if release is not None else ()
            enqueuing = now()
            host, copied = _copy_back(program.call_packed(*uploaded))
            pending.append(_Pending(ids, host, copied, release, events, key))
            enqueued = now()
            stats.batches += 1
            for entry in pending:
                entry.release_if_uploaded()
            if rec is not None:
                rec.add("stream/feed_wait", begin, fed, key)
                rec.add("stream/upload", fed, enqueuing, key)
                rec.add("stream/enqueue", enqueuing, enqueued, key)
                rec.add("stream/release", enqueued, now(), key)
            if len(pending) >= in_flight:
                yield from drain_one(rec)
        while pending:
            yield from drain_one(spans.follow(_profiling()))
    finally:
        if not _profiling():
            spans.follow(False)  # a followed profiler that has stopped
        stop.set()
        # Slots go back before the feeder is joined: a feeder waiting on the
        # pool for its next batch needs the workers to find a free slot.
        for entry in pending:
            entry.release_if_uploaded(wait=True)
        release_queued()
        if feeder is not None:
            feeder.join()
        release_queued()
        close = getattr(source, "close", None)
        if close is not None:
            close()


def classify_stream(
    program: ClassifyProgram,
    signals: Iterable[Tuple[str, np.ndarray]],
    batch_size: int = 128,
    stats: Optional[ExecutorStats] = None,
    in_flight: int = IN_FLIGHT,
) -> Iterator[ReadResult]:
    """Classify a stream of (read_id, signal); yields ReadResults."""
    cfg = program.cfg.preprocess
    dual = program.cfg.dual_model

    def batch_iter() -> Iterator[BuiltBatch]:
        buffered: List[Tuple[str, np.ndarray]] = []
        try:
            for item in signals:
                buffered.append(item)
                if len(buffered) == batch_size:
                    yield build_batch(buffered, cfg, batch_size, dual)
                    buffered = []
            if buffered:
                yield build_batch(buffered, cfg, batch_size, dual)
        finally:
            close = getattr(signals, "close", None)
            if close is not None:
                close()

    yield from classify_batches(program, batch_iter(), stats=stats,
                                in_flight=in_flight)


def classify_files(
    program: ClassifyProgram,
    fast5_paths: Sequence[str],
    batch_size: int = 128,
    num_readers: int = 4,
    stats: Optional[ExecutorStats] = None,
    read_fn: ReadFn = _default_read_fn,
) -> Iterator[ReadResult]:
    """End-to-end: fast5/pod5 paths → classified reads (streaming)."""
    stats = stats or ExecutorStats()
    signals = iter_signals(
        fast5_paths, num_readers=num_readers, stats=stats, read_fn=read_fn
    )
    yield from classify_stream(program, signals, batch_size=batch_size, stats=stats)
