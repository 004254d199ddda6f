"""Reader worker processes: fast5/pod5 decode and batch assembly off the
classify process.

Counterpart of ``deepbinner_tpu/runner/mp_reader.py``.  Workers are
spawned, not forked (the parent has live CUDA and feeder threads), and
import only the port's numpy-only modules (``runner/hostbatch.py``,
``utils/fast5.py``, ``utils/pod5.py``, ``native/*``): never ``torch``,
whose import each spawned child would pay for.

Each worker assembles fixed-shape batches of a :class:`BatchSpec` itself,
running the open-pore trim and the wire quantisation when the spec asks for
them, and reads only the head (and, dual, the tail) of each signal that a
batch uses.  With ``shm_slots`` the batches travel through shared memory
(:class:`_ShmRing`): a worker builds a batch straight into a free slot and
the queue carries only the slot, the read ids and their source files.  On a CUDA
program the parent registers each slot as pinned memory once, when the ring
is built (``cudaHostRegister``), so a batch goes to the card straight from
its slot; ``close()`` unregisters the slots before the segments are closed
and unlinked.  A worker never touches CUDA.

:class:`ReaderPool` keeps its workers alive across passes (each pass is one
call of ``iter_batches``), so spawn and import are paid once.  A worker
that dies raises in the parent.

While the program's spans record (:mod:`.spans`; the pool's shared flag
tells its workers), a worker times each file (``read/file``,
with its pod5 parse and decode seconds) and each batch (``batch/slot_wait``,
``batch/build`` and its ``batch/trim`` and ``batch/quantise``) and sends
the spans with its next batch.
"""

from __future__ import annotations

import ctypes
import functools
import multiprocessing as mp
import os
import queue as queue_mod
import sys
import threading
import time
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from deepbinner_tpu_torch.runner import spans
from deepbinner_tpu_torch.runner.hostbatch import (
    Batch,
    BatchScratch,
    BatchSpec,
    ExecutorStats,
    build_batch_arrays,
)

# Control messages are tuples tagged with this marker so they can never
# collide with a data item and survive queue pickling.  Data items carry a
# pass id so a pass abandoned mid-drain can't leak stale reads into the next.
_CTL = "__deepbinner_ctl__"
_STOP = (_CTL, "stop")
# In-flight batches per worker: the bound of the queue to the parent.
_QUEUE_DEPTH_PER_WORKER = 4
# How often the parent, waiting on the workers, checks that they are alive.
_POLL_S = 0.5


class _ShmRing:
    """Fixed slots of shared memory for batch buffers + a free-slot queue.

    The multiprocessing queue then carries only (slot index, read ids):
    workers write the built arrays straight into the slot (no pickle of
    multi-MB payloads), the consumer uploads or copies them out and
    recycles the slot.  ``pin=True`` registers every slot with CUDA as
    pinned host memory, once (the parent only).
    """

    def __init__(self, ctx, spec: BatchSpec, slots: int, pin: bool = False) -> None:
        from multiprocessing import shared_memory

        self.spec = spec
        b = spec.batch_size
        self.sig_bytes = b * spec.wire_row_bytes
        self.len_bytes = b * 4            # int32
        per_end = self.sig_bytes + self.len_bytes
        self.slot_bytes = per_end * (2 if spec.dual else 1)
        self.slots = [
            shared_memory.SharedMemory(create=True, size=self.slot_bytes)
            for _ in range(slots)
        ]
        self.names = [s.name for s in self.slots]
        self.free: "mp.Queue" = ctx.Queue()
        for index in range(slots):
            self.free.put(index)
        self._registered: List[int] = []
        if pin:
            try:
                self._register()
            except BaseException:
                self.close()
                raise

    def _register(self) -> None:
        import torch

        torch.cuda.init()
        cudart = torch.cuda.cudart()
        for memory in self.slots:
            address = np.frombuffer(memory.buf, np.uint8).ctypes.data
            error = cudart.cudaHostRegister(address, self.slot_bytes, 0)
            if error != cudart.cudaError.success:
                raise RuntimeError(f"cudaHostRegister of a reader slot "
                                   f"failed: {error}")
            self._registered.append(address)

    def _unregister(self) -> None:
        if not self._registered:
            return
        import torch

        cudart = torch.cuda.cudart()
        for address in self._registered:
            cudart.cudaHostUnregister(address)
        self._registered = []

    @property
    def pinned(self) -> bool:
        return bool(self._registered)

    def views(self, memory) -> tuple:
        """(start, start_len, end, end_len) numpy views over one slot.

        The views hold an export of the slot's mapping (through
        ``np.frombuffer``), so the mapping cannot be closed under them;
        over ``memory.buf`` directly numpy would keep only the mmap object
        and ``close()`` would unmap it under live views.
        """
        return _slot_views(np.frombuffer(memory.buf, np.uint8), self.spec)

    def close(self) -> None:
        """Unregister, unmap and unlink every slot.

        A slot whose views a consumer still holds cannot be unmapped
        (``BufferError``): its mapping stays until the views are dropped,
        and its name is unlinked all the same.
        """
        self._unregister()
        for memory in self.slots:
            try:
                memory.close()
            except BufferError:
                pass
            try:
                memory.unlink()
            except FileNotFoundError:
                pass


def _slot_views(buffer, spec: BatchSpec) -> tuple:
    """(start, start_len, end, end_len) ndarray views over one slot buffer.

    THE single definition of the slot byte layout — used by the parent
    (`_ShmRing.views`, over `SharedMemory.buf`) and the workers
    (`emit_batch`, over the raw mmap).  A layout described twice would
    corrupt batches silently on the first divergence."""
    b, cols = spec.batch_size, spec.wire_cols
    sig_np = spec.wire_np
    sig_bytes = b * spec.wire_row_bytes
    len_bytes = b * 4
    o = 0
    start = np.ndarray((b, cols), sig_np, buffer=buffer, offset=o)
    o += sig_bytes
    start_len = np.ndarray((b,), np.int32, buffer=buffer, offset=o)
    o += len_bytes
    if not spec.dual:
        return start, start_len, None, None
    end = np.ndarray((b, cols), sig_np, buffer=buffer, offset=o)
    o += sig_bytes
    end_len = np.ndarray((b,), np.int32, buffer=buffer, offset=o)
    return start, start_len, end, end_len


def _attach_slots(names):
    """Child-side attach via raw mmap of the POSIX shm files.

    Children must NOT construct `SharedMemory(name=...)` when avoidable:
    each attach registers the name with the (shared) resource tracker
    whose cache is a set, so parent + N children produce one register
    entry but N+1 unregisters — a KeyError traceback in the tracker at
    exit.  Plain mmap of /dev/shm/<name> sidesteps the tracker entirely;
    the parent alone owns create/unlink.  Hosts without /dev/shm (macOS)
    fall back to SharedMemory + best-effort unregister."""
    import mmap

    slots = []
    for name in names:
        try:
            with open(f"/dev/shm/{name.lstrip('/')}", "r+b") as handle:
                slots.append(mmap.mmap(handle.fileno(), 0))
        except OSError:
            from multiprocessing import resource_tracker, shared_memory

            memory = shared_memory.SharedMemory(name=name)
            try:
                resource_tracker.unregister(memory._name, "shared_memory")  # noqa: SLF001
            except Exception:  # noqa: BLE001 — tracker API varies by version
                pass
            _ATTACHED_SEGMENTS.append(memory)  # keep the mapping alive
            slots.append(memory.buf)
    return slots


# Child-side keepalive for the SharedMemory fallback in _attach_slots:
# np.ndarray views into `memory.buf` do not hold the SharedMemory object,
# and a GC'd SharedMemory unmaps the segment under the views.
_ATTACHED_SEGMENTS: list = []


class _Built(NamedTuple):
    """A worker's batch, as it crosses the queue to the parent: the arrays
    inline (``arrays``, the pickled transport) or in shared-memory slot
    ``slot``; ``spans`` is ``(key, spans)`` where the worker recorded the
    program's spans, else None."""

    pass_id: int
    ids: List[str]
    paths: List[str]
    slot: Optional[int]
    arrays: Optional[list]
    spans: Optional[tuple]


# The seconds and counts a pod5 file's read/file span carries
# (utils/pod5.read_pod5's ``times``).
_POD5_TIMES = ("open", "tables", "zstd", "unpack", "bytes", "chunks",
               "payload_bytes", "samples", "unpacked")


# glibc's mallopt parameters, and what a worker sets them to: above any
# one batch's temporaries (the trim's (batch, trim_scan) float32 matrices
# are 2 MiB each), so they stay on the heap from batch to batch.
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3
_MMAP_THRESHOLD = 32 << 20
_TRIM_THRESHOLD = 64 << 20


def _keep_temporaries_on_the_heap() -> None:
    """A worker allocates and frees the same multi-megabyte temporaries in
    every batch.  glibc's defaults hand each one to ``mmap`` and return the
    heap's free top to the system, so every batch pays page faults on
    first touch again, unless the process happened to free a larger block
    first (glibc's threshold follows the largest block freed).  Fixed
    thresholds keep them on the heap whatever was freed before.  Nothing
    happens where the C library has no ``mallopt``."""
    mallopt = getattr(ctypes.CDLL(None), "mallopt", None)  # the C library's
    if mallopt is None:
        return
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    mallopt(_M_MMAP_THRESHOLD, _MMAP_THRESHOLD)
    mallopt(_M_TRIM_THRESHOLD, _TRIM_THRESHOLD)


def _pool_worker(
    task_queue: "mp.Queue",
    out_queue: "mp.Queue",
    use_native: bool,
    batch_spec: BatchSpec,
    shm_names: Optional[List[str]],
    shm_free: Optional["mp.Queue"],
    worker_index: int,
    recording,
) -> None:
    # Imported inside the child: file decode only, no torch.
    from deepbinner_tpu_torch.utils.fast5 import read_signal_file

    _keep_temporaries_on_the_heap()

    shm_slots = _attach_slots(shm_names) if shm_names else None

    fast5_fn = None
    if use_native:  # the parent has built the library (ReaderPool.__init__)
        from deepbinner_tpu_torch.native import fast5_reader

        fast5_fn = fast5_reader.read_file

    # Decode only the signal slices classify consumes: the head buffer
    # (and, dual, the tail buffer) per read — HDF5 hyperslab reads skip
    # the bulk of long reads entirely.
    head = (batch_spec.trim.raw_size if batch_spec.trim is not None
            else batch_spec.buffer_size)
    tail = head if batch_spec.dual else 0

    def read_file(path: str, times: Optional[dict] = None):
        # pod5 decodes through pyarrow/zstd and honours head/tail
        # chunk-lazily; the native C++ reader covers the HDF5 (fast5) path.
        if fast5_fn is not None and not path.endswith(".pod5"):
            return fast5_fn(path, head, tail)
        return read_signal_file(path, head, tail, times)

    pending: List[Tuple[str, np.ndarray]] = []
    # Each pending read's source file: the same str for every read of a
    # file, which pickle sends once a message.
    pending_paths: List[str] = []
    # Persistent assembly temporaries: a worker builds many batches; the
    # trim matrix / int16 build target / f32 quantise temp are allocated
    # once here instead of per batch.
    scratch = BatchScratch(batch_spec)
    # The program's spans (runner/spans.py), made while ``recording`` is
    # set and sent with the next batch, which is (worker_index, batches).
    pid, tid = os.getpid(), threading.get_native_id()
    made: list = []
    batches = 0

    def emit_batch(pass_id: int) -> None:
        nonlocal made, batches, pending_paths
        key = (worker_index, batches)
        batches += 1
        on = recording.value
        times: Optional[dict] = {} if on else None
        begin = time.perf_counter() if on else 0.0
        slot = arrays = None
        if shm_slots is None:
            built = begin
            ids, *arrays = build_batch_arrays(pending, batch_spec,
                                              scratch=scratch, times=times)
        else:
            # Shared-memory transport: assemble (and, int8, quantise) the
            # batch DIRECTLY into a free slot's views.  The queue carries
            # only the slot, the ids and the paths.  Blocks while every
            # slot is in flight — the same backpressure a bounded queue
            # gives.
            slot = shm_free.get()
            built = time.perf_counter() if on else 0.0
            views = _slot_views(shm_slots[slot], batch_spec)
            ids, *_arrays = build_batch_arrays(pending, batch_spec, out=views,
                                               scratch=scratch, times=times)
        # The queue pickles a message on its own thread after put(): the
        # paths list is handed over, never cleared.
        paths, pending_paths = pending_paths, []
        pending.clear()
        if on:
            done = time.perf_counter()
            if built > begin:
                made.append(("batch/slot_wait", begin, built, pid, tid, key,
                             None))
            made.append(("batch/build", built, done, pid, tid, key,
                         {"reads": len(ids)}))
            made += [(name, a, b, pid, tid, key, None)
                     for name, (a, b) in times.items()]
        sent = None
        if made:
            sent, made = (key, made), []
        out_queue.put(_Built(pass_id, ids, paths, slot, arrays, sent))

    while True:
        task = task_queue.get()
        if isinstance(task, tuple) and task and task[0] == _CTL:
            if task == _STOP:
                return
            if task[1] == "flush":
                # All output from this worker's earlier tasks is already on
                # out_queue (single consumer per worker, FIFO queues), so the
                # ack marks this worker's share of the pass complete.  The
                # leftover reads go out as one padded partial batch first.
                if pending:
                    emit_batch(task[2])
                out_queue.put((_CTL, "flush", task[2]))
            elif task[1] == "modules":
                out_queue.put((_CTL, "modules", task[2], sorted(sys.modules)))
            continue
        # Tasks carry a CHUNK of paths, not one: an mp.Queue get is a lock
        # + pipe wakeup, and per-file tasks leave workers idle on
        # single-read fast5s.
        pass_id, paths = task
        for path in paths:
            error = ""
            times = None
            on = recording.value
            if on:
                begin = time.perf_counter()
                if path.endswith(".pod5"):
                    times = dict.fromkeys(_POD5_TIMES, 0)
            try:
                reads = read_file(path, times)
            except Exception as exc:  # noqa: BLE001 — skip-and-count
                reads = []
                error = repr(exc)
            if on:
                made.append(("read/file", begin, time.perf_counter(), pid,
                             tid, (worker_index, batches),
                             dict(times or {}, reads=len(reads))))
            if not reads:
                out_queue.put((_CTL, "failed", pass_id, path, error))
                continue
            for item in reads:
                pending.append(item)
                pending_paths.append(path)
                if len(pending) == batch_spec.batch_size:
                    emit_batch(pass_id)


class ReaderPool:
    """Persistent fast5/pod5 decode worker pool (processes without torch).

    Each worker owns a private task queue (round-robin path distribution)
    so the per-pass flush protocol is exact: a worker acks one flush per
    pass, after all its reads are enqueued.  Use as a context manager, or
    call close().

    The workers build batches of ``batch_spec``.  ``use_native`` decodes
    fast5 through the C++ reader where it can be built (the parent builds
    it here, so a failed build raises here).  ``shm_slots`` > 0 sends the
    batches through that many shared-memory slots, 0 pickles them through
    the queue.  ``pin_memory`` registers the slots with CUDA as pinned
    memory (a CUDA program's pool).
    """

    def __init__(
        self,
        batch_spec: BatchSpec,
        num_workers: int = 2,
        use_native: bool = True,
        stall_timeout: float = 300.0,
        shm_slots: int = 0,
        pin_memory: bool = False,
    ) -> None:
        self.num_workers = max(1, int(num_workers))
        self.stall_timeout = stall_timeout
        self.batch_spec = batch_spec
        if use_native:
            from deepbinner_tpu_torch.native import fast5_reader

            use_native = fast5_reader.available()
        self.use_native = use_native
        ctx = mp.get_context("spawn")
        # Optional shared-memory batch transport: slots replace the pickled
        # multi-MB queue items (see _ShmRing).
        self._ring: Optional[_ShmRing] = None
        if shm_slots > 0:
            self._ring = _ShmRing(ctx, batch_spec, shm_slots, pin=pin_memory)
        self._tasks: List["mp.Queue"] = [ctx.Queue() for _ in range(self.num_workers)]
        # Items are batches of ~MB: a deep queue would buffer the whole
        # dataset in pickled form.
        self._out: "mp.Queue" = ctx.Queue(
            maxsize=_QUEUE_DEPTH_PER_WORKER * self.num_workers)
        # The program's span recorder's switch, as the workers see it (a
        # worker's spans travel with its batches).
        self._recording = ctx.RawValue("b", 0)
        spans.attach(self._recording)
        self._workers = [
            ctx.Process(
                target=_pool_worker,
                args=(self._tasks[i], self._out, use_native, batch_spec,
                      self._ring.names if self._ring else None,
                      self._ring.free if self._ring else None,
                      i, self._recording),
                daemon=True,
                name=f"deepbinner-reader-{i}",
            )
            for i in range(self.num_workers)
        ]
        for worker in self._workers:
            worker.start()
        self._closed = False
        self._pass_id = 0
        # Slots handed out by iter_batches(copy=False) and not yet released
        # by the consumer.  Guarded by a lock: the classify feeder thread
        # adds while the drain (main) thread releases.
        self._held_lock = threading.Lock()
        self._held: set = set()

    @property
    def pinned(self) -> bool:
        """Whether the shared-memory slots are registered as pinned memory."""
        return self._ring is not None and self._ring.pinned

    def _release_slot(self, slot: int) -> None:
        """Recycle a zero-copy slot once its upload has provably completed.

        Idempotent (a slot released twice must not enter the free queue
        twice — a double-free would let two workers write one slot).
        """
        with self._held_lock:
            if slot not in self._held:
                return
            self._held.discard(slot)
        self._ring.free.put(slot)

    def _reclaim_held_slots(self) -> None:
        """Recycle slots an abandoned pass yielded but never released.

        Called at pass start and close: if a consumer tore down mid-pass
        (exception between yield and release), its held slots would
        otherwise starve every later pass.  By the time a NEW pass starts
        the previous consumer is gone, so the views are dead."""
        if self._ring is None:
            return
        with self._held_lock:
            leftover, self._held = self._held, set()
        for slot in leftover:
            self._ring.free.put(slot)

    def _get(self) -> tuple:
        """The next item from the workers.

        Raises when a worker has died or nothing arrives for
        ``stall_timeout`` seconds.
        """
        waited = 0.0
        while True:
            try:
                return self._out.get(timeout=_POLL_S)
            except queue_mod.Empty:
                pass
            for worker in self._workers:
                if not worker.is_alive():
                    raise RuntimeError(f"reader worker {worker.name} exited "
                                       f"(code {worker.exitcode})")
            waited += _POLL_S
            if waited >= self.stall_timeout:
                raise RuntimeError(f"reader pool stalled (no reads for "
                                   f"{self.stall_timeout:.0f}s)")

    def _discard_stale(self, item: tuple) -> None:
        """Drop an item of an abandoned pass, recycling its slot."""
        if isinstance(item, _Built) and item.slot is not None:
            self._ring.free.put(item.slot)

    def _next_pass(self) -> int:
        if self._closed:
            raise RuntimeError("ReaderPool is closed")
        self._reclaim_held_slots()
        self._pass_id += 1
        return self._pass_id

    def _drain_pass(
        self,
        fast5_paths: Sequence[str],
        stats: ExecutorStats,
    ) -> Iterator[_Built]:
        """Feed one pass and yield its workers' batches in completion order."""
        pass_id = self._next_pass()
        # Chunked round-robin distribution: small chunks keep the load
        # balanced across workers; ≥8 chunks per worker on big passes,
        # per-file granularity on tiny ones.
        chunk = max(1, min(32, len(fast5_paths) // (8 * self.num_workers)))
        for k, start in enumerate(range(0, len(fast5_paths), chunk)):
            self._tasks[k % self.num_workers].put(
                (pass_id, list(fast5_paths[start : start + chunk]))
            )
        for task_queue in self._tasks:
            task_queue.put((_CTL, "flush", pass_id))
        acks = 0
        while acks < self.num_workers:
            item = self._get()
            if item[0] == _CTL:
                if item[2] != pass_id:  # stale control from an abandoned pass
                    continue
                if item[1] == "flush":
                    acks += 1
                elif item[1] == "failed":  # ("failed", pass_id, path, error)
                    stats.record_failure(item[3], item[4])
                continue
            if item.pass_id != pass_id:  # stale data from an abandoned pass
                self._discard_stale(item)
                continue
            yield item

    def worker_modules(self) -> List[List[str]]:
        """Each worker's loaded module names (the workers must not import
        torch)."""
        pass_id = self._next_pass()
        for task_queue in self._tasks:
            task_queue.put((_CTL, "modules", pass_id))
        replies: List[List[str]] = []
        while len(replies) < self.num_workers:
            item = self._get()
            if item[0] == _CTL and item[1] == "modules" and item[2] == pass_id:
                replies.append(item[3])
            else:
                self._discard_stale(item)
        return replies

    def iter_batches(
        self,
        fast5_paths: Sequence[str],
        stats: Optional[ExecutorStats] = None,
        copy: bool = True,
    ) -> Iterator[Batch]:
        """One pass: yield worker-built fixed-shape batches, each a
        :class:`Batch` with its reads' source files in ``paths``.

        Full batches stream as they fill; each worker's leftover reads
        arrive as one padded partial batch at pass end (rows beyond
        len(ids) are padding, dropped downstream).

        ``copy=False`` (the classify hot path): a shared-memory batch's
        arrays are VIEWS straight over its slot and ``release()`` recycles
        the slot.  Call it only once the batch's upload has completed
        (``executor.classify_batches`` waits on a CUDA event recorded after
        the upload).  The consumer must keep enough slots configured to
        cover its in-flight window (``executor.MIN_SHM_SLOTS``) or workers
        block on the free queue until the pass stall-times-out.  Slots
        never released (abandoned pass) are reclaimed at the next pass /
        close.

        A batch whose worker recorded the program's spans (:mod:`.spans`)
        has its identifier ``(worker index, sequence number)`` in ``key``;
        its spans go to the recorder here.
        """
        for built in self._drain_pass(fast5_paths, stats or ExecutorStats()):
            key = None
            if built.spans is not None:
                key, made = built.spans
                spans.take(made)
            if built.slot is None:
                yield Batch(built.ids, *built.arrays, key=key,
                            paths=built.paths)
                continue
            views = self._ring.views(self._ring.slots[built.slot])
            if copy:
                arrays = [None if view is None else view.copy()
                          for view in views]
                del views
                self._ring.free.put(built.slot)  # recycle now (copied out)
                yield Batch(built.ids, *arrays, key=key, paths=built.paths)
            else:
                with self._held_lock:
                    self._held.add(built.slot)
                yield Batch(built.ids, *views,
                            release=functools.partial(self._release_slot,
                                                      built.slot),
                            key=key, paths=built.paths)

    def close(self) -> None:
        """Stop the workers and free the slots.

        Workers blocked on a full out queue or on the free-slot queue are
        unblocked by draining the out queue while they stop; one still
        alive after a few seconds (e.g. busy with an abandoned pass's
        files) is terminated.
        """
        if self._closed:
            return
        self._closed = True
        spans.detach(self._recording)
        self._reclaim_held_slots()
        for task_queue in self._tasks:
            task_queue.put(_STOP)
        deadline = time.monotonic() + 5.0
        while (any(worker.is_alive() for worker in self._workers)
               and time.monotonic() < deadline):
            try:
                self._discard_stale(self._out.get(timeout=0.05))
            except queue_mod.Empty:
                pass
        for worker in self._workers:
            if worker.is_alive():
                worker.terminate()
            worker.join(timeout=5)
        for task_queue in self._tasks:
            task_queue.cancel_join_thread()
        if self._ring is not None:
            self._ring.free.cancel_join_thread()
            self._ring.close()

    def __enter__(self) -> "ReaderPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

