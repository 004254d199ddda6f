"""`realtime` workload: classify-during-sequencing directory watcher.

Counterpart of ``deepbinner_tpu/cli/realtime.py``, and of the reference's
``deepbinner/realtime.py`` (SURVEY.md §3.2): an infinite loop scans
``--in_dir`` for fast5/pod5 files not yet processed, classifies each new
batch with the same machinery as `classify`, **moves** the files into
``--out_dir/<barcode>/``, sleeps, and exits cleanly on Ctrl-C.

Latency:
- the classify program is built and warmed up **once at startup**
  (``ClassifyProgram.warm_up``: kernel build, first launches), so the
  first live batch runs at steady state;
- partial batches are flushed every poll — a single new read is classified
  within one poll interval plus one device step;
- unreadable files (still being written by MinKNOW) are skipped *without*
  being marked done, so they are retried on the next scan; files that stay
  unreadable are abandoned after ``_MAX_ATTEMPTS`` scans.

Long runs (this is the one mode that lives for days):
- on the card, files are decoded in a persistent ``ReaderPool`` of worker
  processes that import no torch, so the process that drives the card
  never opens a signal file, and the pool outlives polls, so spawn cost is
  paid once at startup.  A worker that dies (a native crash on a
  half-written file) raises in the loop, which respawns the pool and
  retries the scan one file at a time to isolate the culprit;
- the seen/attempted bookkeeping is pruned every scan against the files
  actually present in ``in_dir`` (sorted files left the directory), so a
  multi-day run holds state only for the current directory contents.

Additions over the reference: ``--stop_file`` (clean shutdown signal for
headless runs) and ``--max_batches`` (bounded runs; used by tests).
:func:`realtime` returns the watch's :class:`ExecutorStats` (reads and
device batches classified).
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

from deepbinner_tpu_torch.runner.hostbatch import ExecutorStats
from deepbinner_tpu_torch.utils import table
from deepbinner_tpu_torch.utils.fast5 import find_signal_files, read_signal_file
from deepbinner_tpu_torch.utils.log import log, section

_MAX_ATTEMPTS = 5


class _WatchState:
    """Seen/attempt bookkeeping for the watch loop, bounded by in_dir.

    ``done`` holds files already sorted or abandoned; ``attempts`` counts
    scans that failed to read a file.  Both are pruned against the current
    directory listing every cycle — a moved file can never be re-seen at
    its old path, so dropping it keeps memory proportional to the files
    *currently* in ``in_dir`` over a multi-day sequencing run.
    """

    def __init__(self) -> None:
        self.done: Set[str] = set()
        self.attempts: Dict[str, int] = {}

    def prune(self, present: Set[str]) -> None:
        self.done &= present
        self.attempts = {
            path: n for path, n in self.attempts.items() if path in present
        }

    def record_attempt(self, path: str, unreadable: bool) -> None:
        """One failed classification attempt; abandon after _MAX_ATTEMPTS."""
        self.attempts[path] = self.attempts.get(path, 0) + 1
        if not unreadable or self.attempts[path] >= _MAX_ATTEMPTS:
            self.done.add(path)  # give up on persistently bad files


def _route_results(results, owners: Dict[str, str],
                   counts: Dict[str, int]) -> Dict[str, str]:
    """Fold per-read results into per-file moves; warn on mixed calls."""
    moves: Dict[str, str] = {}
    mixed: Dict[str, Set[str]] = {}
    for result in results:
        call = table.class_index_to_call(result.call)
        counts[call] = counts.get(call, 0) + 1
        path = owners[result.read_id]
        # Multi-read files move to the *first* read's bin (single-read files,
        # the realtime-mode norm, are unaffected).
        moves.setdefault(path, call)
        mixed.setdefault(path, set()).add(call)
    # A multi-read MinKNOW file with disagreeing calls cannot be sorted
    # per-read by moving the file — count and warn instead of mis-sorting
    # silently (`classify`+`bin` handle per-read).
    conflicted = {p: calls for p, calls in mixed.items() if len(calls) > 1}
    for path, calls in conflicted.items():
        log(f"  warning: {os.path.basename(path)} holds reads with mixed "
            f"calls {sorted(calls)}; filed under its first read's bin "
            f"({moves[path]}) — use `classify`+`bin` for per-read routing")
    return moves


def _classify_new_files(program, new_files: List[str], args, counts: Dict[str, int],
                        read_fn=None, stats: Optional[ExecutorStats] = None,
                        ) -> Tuple[Dict[str, str], Set[str]]:
    """In-process decode variant (``--device cpu`` / --reader_processes 0)."""
    from deepbinner_tpu_torch.runner.executor import classify_stream

    if read_fn is None:
        read_fn = read_signal_file  # fast5 and pod5
    signals = []
    owners: Dict[str, str] = {}  # read_id -> path
    unreadable: Set[str] = set()
    for path in new_files:
        try:
            reads = read_fn(path)
        except Exception:  # noqa: BLE001 — skipped and retried next scan
            reads = []
        if not reads:
            unreadable.add(path)
            continue
        for read_id, signal in reads:
            owners[read_id] = path
            signals.append((read_id, signal))

    results = classify_stream(program, iter(signals),
                              batch_size=args.batch_size, stats=stats)
    return _route_results(results, owners, counts), unreadable


def _classify_new_files_pool(program, pool, new_files: List[str], args,
                             counts: Dict[str, int],
                             stats: Optional[ExecutorStats] = None,
                             ) -> Tuple[Dict[str, str], Set[str]]:
    """ReaderPool variant: decode in worker processes, classify streaming.

    The process that drives the card never opens a signal file; owners fill
    as reads stream off the pool, strictly before the batch containing them
    is classified, so every yielded result can be routed.
    """
    from deepbinner_tpu_torch.runner.executor import classify_stream

    stats = stats if stats is not None else ExecutorStats()
    failed_before = len(stats.failed_paths)
    owners: Dict[str, str] = {}

    def signals() -> Iterable[Tuple[str, object]]:
        for read_id, signal, path in pool.iter_reads_with_paths(
            new_files, stats
        ):
            owners[read_id] = path
            yield read_id, signal

    results = classify_stream(program, signals(), batch_size=args.batch_size,
                              stats=stats)
    moves = _route_results(results, owners, counts)
    return moves, set(stats.failed_paths[failed_before:])


def _make_reader_pool(program, args):
    """A persistent stream-mode ReaderPool, or None for in-process decode.

    The default (``--reader_processes -1``) follows the program's device:
    2 worker processes on the card, in-process reads on the CPU.  Workers
    ship only the head/tail slices classify consumes, so long reads cost
    ~KBs per queue item, not MBs.
    """
    reader_processes = int(getattr(args, "reader_processes", -1))
    if reader_processes < 0:
        reader_processes = 2 if program.device.type == "cuda" else 0
    if reader_processes <= 0:
        return None
    from deepbinner_tpu_torch.runner.mp_reader import ReaderPool

    pre = program.cfg.preprocess
    head = pre.trim_scan + pre.scan_size  # raw samples build_batch consumes
    tail = head if program.cfg.dual_model else 0
    log(f"  {reader_processes} reader worker process(es) decode files; "
        f"the process that drives the card never opens them")
    return ReaderPool(
        num_workers=reader_processes,
        use_native=not getattr(args, "no_native_reader", False),
        trim_head=head, trim_tail=tail,
        # Realtime batches are small (one poll's worth of files): a healthy
        # pool answers in seconds, so a dead worker (e.g. a native crash on
        # a file MinKNOW is still writing) should surface fast — the watch
        # loop respawns the pool and keeps running.
        stall_timeout=60.0,
    )


def realtime(args) -> ExecutorStats:
    from deepbinner_tpu_torch.cli.classify import _select_read_fn, build_program

    section("Realtime classification")
    log(f"  watching {args.in_dir} → {args.out_dir}")
    os.makedirs(args.out_dir, exist_ok=True)

    program, _ = build_program(args)
    pool = _make_reader_pool(program, args)
    read_fn = None if pool is not None else _select_read_fn(args)
    t0 = time.monotonic()
    program.warm_up(args.batch_size)
    log(f"  program warmed up in {time.monotonic() - t0:.1f}s; watching...")

    state = _WatchState()
    stats = ExecutorStats()
    counts: Dict[str, int] = {}
    batches = 0
    try:
        while True:
            if args.stop_file and os.path.exists(args.stop_file):
                log("  stop file found; exiting")
                break
            present = set(find_signal_files(args.in_dir))
            state.prune(present)
            new_files = sorted(present - state.done)
            if new_files:
                batch_start = time.monotonic()
                if pool is not None:
                    try:
                        moves, unreadable = _classify_new_files_pool(
                            program, pool, new_files, args, counts, stats=stats
                        )
                    except RuntimeError as error:
                        # A worker died mid-batch (a native crash on a
                        # half-written file kills the process, which no
                        # in-worker `except` can catch) — the pool stall
                        # surfaces here.  Respawn the workers, then isolate
                        # the culprit by retrying this scan's files ONE AT A
                        # TIME: only a file that individually kills the pool
                        # is charged an attempt (and abandoned after
                        # _MAX_ATTEMPTS scans, like any persistently
                        # unreadable file); healthy files that merely shared
                        # the scan are classified right now.  The watch mode
                        # lives for days; it must outlive its pool.
                        log(f"  reader pool failed ({error}); respawning "
                            f"workers and isolating the culprit")
                        pool.close()
                        pool = _make_reader_pool(program, args)
                        moves, unreadable = {}, set()
                        for path in new_files:
                            try:
                                one_moves, one_bad = _classify_new_files_pool(
                                    program, pool, [path], args, counts,
                                    stats=stats
                                )
                                moves.update(one_moves)
                                unreadable |= one_bad
                            except RuntimeError as err2:
                                log(f"  {os.path.basename(path)} crashed the "
                                    f"pool ({err2}); respawning")
                                pool.close()
                                pool = _make_reader_pool(program, args)
                                unreadable.add(path)
                else:
                    moves, unreadable = _classify_new_files(
                        program, new_files, args, counts, read_fn=read_fn,
                        stats=stats
                    )
                for path, call in moves.items():
                    bin_dir = os.path.join(args.out_dir, call)
                    os.makedirs(bin_dir, exist_ok=True)
                    shutil.move(path, os.path.join(bin_dir, os.path.basename(path)))
                    state.done.add(path)
                for path in new_files:
                    if path not in moves:
                        state.record_attempt(path, path in unreadable)
                if moves:
                    batches += 1
                    latency = time.monotonic() - batch_start
                    log(f"  batch {batches}: {len(moves)} file(s) sorted in "
                        f"{latency:.2f}s (totals: {dict(sorted(counts.items()))})")
                if args.max_batches and batches >= args.max_batches:
                    log("  max batches reached; exiting")
                    break
            time.sleep(args.poll_interval)
    except KeyboardInterrupt:
        log("\n  interrupted; exiting cleanly")
    finally:
        if pool is not None:
            pool.close()
    section("Final counts per bin")
    for call in sorted(counts):
        log(f"  {call}: {counts[call]}")
    return stats
