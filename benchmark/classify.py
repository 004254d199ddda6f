"""One run of a cell: pod5 files in, call rows out, through the port's
classify stream as the CLI builds it.

Set-up: the corpus is generated into the run's ``TMPDIR``; the CLI's
arguments for ``classify`` (its defaults plus the configuration's models)
go through ``cli/main.get_arguments``; ``cli/classify.build_program``
builds the program and ``StreamRunner`` the reader pool; one warm-up pass
over as many files as the pool has workers builds or loads K1 and each
worker's decoder.  Then one ``StreamRunner.classify`` call takes the
corpus's file list repeated more often than the window can use, and each
``ReadResult`` becomes its row through ``cli/classify.result_to_row``.
The window opens once a whole pass's worth of rows has come out, and
counts the rows produced before it closes.

The reader pool's batch iterator is wrapped, so the read ids of every
batch handed to the stream are known in order: row k must be the k-th of
them.  After the window, every read handed over in it must have its row
within ``LATE_S`` seconds; then the card's peak memory is read, the
stream closed, the pool stopped, and the plain reference
(``references/demuxnet.py``) works out each read of the corpus again for
:class:`benchmark.compare.Expected` to judge every row of the window.

With ``--trace 1`` the window has two stretches.  From its start the
program's own recorder (``runner/spans.start()``) records alone, with no
profiler: the untraced stretch, which the host's per-layer metrics read
(``program_spans.untraced``).  It is stopped just before
``torch.profiler`` opens, on a drained card, to trace the middle of the
window (at most ``TRACE_S`` seconds) with the program's calls annotated
(``bench/*``) and the K1 wrapper's launches recorded; the classify stream
then records its spans again itself, and those go into the trace to name
its idle gaps.  The program's batches are recorded in both stretches.
After the window the stream is closed and the same reader pool reads the
corpus alone, with nothing uploaded, for ``pool_reads_per_s``.  A
``--trace 0`` run starts no recorder and makes no such pass.

K1's nvcc build, on a checkout's first run, happens inside the warm-up
pass and so inside ``setup_s``; its seconds are also reported apart, as
``k1_build_s`` on the result line (0.0 where the library was on disk).
"""

from __future__ import annotations

import contextlib
import gc
import os
import queue
import shutil
import sys
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np

from benchmark import corpus as corpus_mod
from benchmark import flops, harness, program_spans
from benchmark.compare import Expected
from benchmark.references import demuxnet
from benchmark.trace import load as load_trace

LATE_S = 60.0        # how long a read handed over in the window may take
TRACE_S = 5.0        # the longest traced part of a window
POOL_UNTIMED_S = 1.0  # the start of the pool-only pass, not timed
POOL_TIMED_S = 8.0    # the timed part of the pool-only pass
MAX_READS_PER_S = 50_000  # sizes the repeated file list, past any rate seen
CLOCK = "bench/clock"


def _calls(rows: List[str]) -> np.ndarray:
    return np.array([0 if call == "none" else int(call[len("barcode"):])
                     for call in rows], np.int64)


def _cli_argv(config: dict, corpus_dir: str, extra_args) -> List[str]:
    c = config["classify"]
    if c.get("wire", "int8") != "int8" or not c.get("host_trim", True):
        raise ValueError("the benchmark runs the CLI's int8 wire with "
                         "host trim")
    argv = ["classify", corpus_dir,
            "-s", os.path.join(harness.ROOT, config["start_model"])]
    if config.get("end_model"):
        argv += ["-e", os.path.join(harness.ROOT, config["end_model"])]
    argv += ["--scan_size", str(c["scan_size"]),
             "--batch_size", str(c["batch_size"]),
             "--min_score", str(c["min_score"]),
             "--score_diff", str(c["score_diff"]),
             "--combine", c["combine"]]
    if c["require_both"]:
        argv.append("--require_both")
    return argv + list(extra_args)


class _Tracer:
    """The two stretches of a ``--trace 1`` window.  Made at the window's
    start, it turns the program's recorder on (the untraced stretch; a
    recording a caller already has on is left alone, and the stretch then
    has none); at ``begin`` it stops it and opens the traced part, on a
    drained card, closed at ``end``.  The program's batches are recorded
    in each stretch, K1's launches in the traced part."""

    def __init__(self, torch, device, begin: float, end: float,
                 recorded: dict) -> None:
        from torch.profiler import ProfilerActivity, profile

        from deepbinner_tpu_torch.runner import spans

        self.untraced = self.untraced_end = None
        if spans.current() is None:
            self.untraced = spans.start()
            recorded["rows"] = recorded["untraced"]
        self.torch, self.device, self.spans = torch, device, spans
        self.begin, self.end = begin, end
        self.recorded = recorded
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=activities)
        self.opened = self.window_s = self.clock = None

    def _stop_untraced(self) -> None:
        if self.untraced_end is not None:
            return
        self.untraced_end = self.spans.clock()
        if self.untraced is not None and self.spans.current() is self.untraced:
            self.spans.stop(self.untraced_end)
        self.recorded["rows"] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def tick(self, now: float) -> None:
        if self.opened is None and now >= self.begin:
            self._stop_untraced()
            self._sync()
            self.profile.start()
            # The profiler records the main thread's annotations only; this
            # one ties its clock to perf_counter's, for the feeder's waits.
            with self.torch.profiler.record_function(CLOCK):
                self.clock = time.perf_counter()
            for key in ("k1", "batches"):
                self.recorded[key].clear()
            self.recorded["on"] = True
            self.recorded["rows"] = self.recorded["batches"]
            self.opened = time.perf_counter()
        elif self.opened is not None and self.window_s is None and now >= self.end:
            self.close()

    def close(self) -> None:
        self._stop_untraced()
        if self.opened is None or self.window_s is not None:
            return
        self._sync()
        self.window_s = time.perf_counter() - self.opened
        self.recorded["on"] = False
        self.recorded["rows"] = None
        self.profile.stop()


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", extra_args=(),
        corpus_workers: Optional[int] = None) -> dict:
    """One run of ``cell``; returns the result line's fields and, under
    ``"record"``, the :class:`harness.Record` for the metric readers.
    ``t0`` is the process's start on ``time.perf_counter``'s clock."""
    import torch

    from deepbinner_tpu_torch.cli import classify as cli
    from deepbinner_tpu_torch.cli.main import get_arguments
    from deepbinner_tpu_torch.models import kernel_apply
    from deepbinner_tpu_torch.ops import kernel_build
    from deepbinner_tpu_torch.runner import executor

    config, traffic = cell.config, cell.traffic
    network = demuxnet.network_of(config, harness.ROOT)
    if any(network[key] != value for key, value in config["network"].items()):
        raise ValueError(f"{config['start_model']} is not the configuration's "
                         f"network {config['network']}")
    geometry = demuxnet.geometry(config["classify"], network["input_length"])
    ends = 2 if config.get("end_model") else 1
    work = tempfile.mkdtemp(prefix="deepbinner-bench-")
    annotate = (torch.profiler.record_function if trace
                else lambda _name: contextlib.nullcontext())
    restore = []
    try:
        phase = _Phases(t0)
        corpus = corpus_mod.generate(
            traffic, config["kit"], seed, os.path.join(work, "pod5"),
            geometry.raw_size,
            workers=corpus_workers or min(8, os.cpu_count() or 1))
        phase("corpus")
        args = get_arguments(_cli_argv(config, os.path.join(work, "pod5"),
                                       extra_args))
        program, _ = cli.build_program(args)
        phase("program")
        dual = program.cfg.dual_model
        stats = executor.ExecutorStats()
        runner = cli.StreamRunner(program, args, stats)
        phase("reader_pool")
        stream = None
        try:
            if runner.pool is None:
                raise RuntimeError("the benchmark measures the reader "
                                   "pool; this run has reader threads")
            lock = threading.Lock()
            batches: list = []  # (time handed over, read ids)
            waits: list = []    # (start, end) of each wait on the pool
            pool_batches = runner.pool.iter_batches

            def iter_batches(paths, stats=None, copy=True):
                source = pool_batches(paths, stats, copy)
                try:
                    while True:
                        begin = time.perf_counter()
                        try:
                            batch = next(source)
                        except StopIteration:
                            return
                        with lock:
                            now = time.perf_counter()
                            batches.append((now, batch[0]))
                            waits.append((begin, now))
                        yield batch
                finally:
                    source.close()

            runner.pool.iter_batches = iter_batches
            # K1's launches while the traced part is open, and the reads of
            # each batch the program is called on into "rows": the list of
            # the stretch now open, the untraced one's or the traced one's.
            recorded = {"on": False, "k1": [], "batches": [], "untraced": [],
                        "rows": None}
            if trace:
                _annotate_program(program, executor, kernel_apply, annotate,
                                  recorded, restore)
            # Warm-up: every worker decodes a file, K1 is built or loaded
            # and launched, the first batches go to the card and back.
            for _result in runner.classify(corpus.paths[:runner.pool.num_workers]):
                pass
            if trace:
                with torch.profiler.profile():  # the profiler's own first start
                    torch.zeros(1, device=program.device).add_(1)
            with lock:
                batches.clear()
                waits.clear()
            phase("warm_up")
            k1_build_s = kernel_build.BUILD_SECONDS.get("conv1d_bn_relu", 0.0)
            _Phases.log("of which K1's nvcc build", k1_build_s)

            repeats = -(-int(MAX_READS_PER_S * (seconds + LATE_S + 10))
                        // corpus.reads)
            stream = runner.classify(corpus.paths * repeats)
            seen = _consume(stream, cli.result_to_row, dual, corpus.reads,
                            seconds, lock, batches, trace, torch,
                            program.device, recorded)
            phase("ramp", seen["t_start"])
            _Phases.log("window and the rows due",
                        time.perf_counter() - seen["t_start"])
            if program.device.type == "cuda":
                torch.cuda.synchronize(program.device)
                peak = torch.cuda.max_memory_allocated(program.device)
                kind = torch.cuda.get_device_name(program.device)
            else:
                peak, kind = 0, "cpu"
            pool_reads_per_s = None
            if trace:
                stream.close()
                _drop_queued_files(runner.pool)
                began = time.perf_counter()
                pool_reads_per_s = _pool_reads_per_s(
                    runner.pool, pool_batches, corpus, stats)
                _Phases.log("pool-only pass", time.perf_counter() - began)
            forbidden = harness.forbidden_modules()
            tracer = seen["tracer"]
            profile = tracer.profile if tracer else None
        finally:
            if stream is not None:
                stream.close()
            _drop_queued_files(runner.pool)
            runner.close()
            vars(runner.pool).pop("iter_batches", None)
            for target, name, value in restore:
                setattr(target, name, value)
        del program, runner
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

        device_info = {"platform": "gpu" if kind != "cpu" else "cpu",
                       "kind": kind, "count": 1, "memory_peak_bytes": int(peak),
                       **harness.host_cpus()}
        record = harness.Record(
            seconds=seconds, setup_s=seen["t_start"] - t0,
            rows=seen["rows_in_window"],
            pool_wait_s=_waited(waits, seen["t_start"], seen["t_end"]),
            windows_per_read=geometry.num_windows, ends=ends, network=network,
            pool_reads_per_s=pool_reads_per_s)
        if tracer is not None:
            record.untraced = harness.Untraced(
                seconds=tracer.untraced_end - seen["t_start"],
                pool_wait_s=_waited(waits, seen["t_start"],
                                    tracer.untraced_end),
                recording=tracer.untraced, batches=recorded["untraced"])
        breakdown = None
        if profile is not None and tracer.window_s is not None:
            path = os.path.join(work, "trace.json")
            profile.export_chrome_trace(path)
            record.trace = load_trace(path)
            os.unlink(path)
            record.trace_window_s = tracer.window_s
            record.k1_launches = recorded["k1"]
            record.step_batches = recorded["batches"]
            host = [(begin, end, "bench/pool_wait") for begin, end in waits]
            traced = program_spans.recording(record)
            if traced is not None:
                host += program_spans.stream_spans(traced)
            record.trace.add_host_spans(host, tracer.clock, CLOCK)
            device_info["busy_s"] = record.trace.busy_us() * 1e-6
            device_info["window_s"] = record.trace_window_s
            breakdown = {"device_ops": record.trace.top_device_ops(),
                         "idle_gaps": record.trace.idle_gaps()}

        # The expected ids of every row the window judges, in order.
        expected = [read_id for _t, ids in batches for read_id in ids]
        expected = expected[seen["p0"]:seen["p1"]]
        judged_ids = seen["ids"]
        misplaced = sum(a != b for a, b in zip(judged_ids, expected))
        missing = max(0, len(expected) - len(judged_ids))
        index = {read_id: k for k, read_id in enumerate(corpus.read_ids)}
        known = [k for k, read_id in enumerate(judged_ids) if read_id in index]
        misplaced += len(judged_ids) - len(known)

        ref = demuxnet.Reference(config, harness.ROOT,
                                 device="cuda" if kind != "cpu" else "cpu")
        outcomes = Expected(ref.window_probs(corpus.heads, corpus.tails,
                                             corpus.lengths),
                            config["classify"])
        del ref
        numbers = outcomes.judge(
            np.array([index[judged_ids[k]] for k in known], np.int64),
            _calls([seen["calls"][k] for k in known]),
            np.stack([seen["start"][k] for k in known]) if known
            else np.zeros((0, 1), np.float32),
            np.stack([seen["end"][k] for k in known]) if known
            else np.zeros((0, 1), np.float32))
        limits = config["limits"]
        checks = {
            "rows_misplaced": {"value": misplaced, "limit": 0},
            "rows_missing": {"value": missing, "limit": 0},
            "failed_files": {"value": stats.failed_files, "limit": 0},
            "forbidden_modules": {"value": len(forbidden), "limit": 0},
            "stream_ran_out": {"value": int(seen["ran_out"]), "limit": 0},
            "calls_differing": {"value": numbers["calls_differing"], "limit": 0},
            "prob_gap": {"value": numbers["prob_gap"],
                         "limit": limits["prob_gap"]},
        }
        correct = (len(judged_ids) > 0
                   and all(c["value"] <= c["limit"] for c in checks.values()))
        return {
            "correct": bool(correct),
            "attempted": int(seen["attempted"]),
            "failed": int(stats.failed_files * traffic["reads_per_file"]
                          + missing),
            "device": device_info,
            "breakdown": breakdown,
            "k1_build_s": k1_build_s,
            "setup_phases": phase.seconds,
            "checks": checks,
            "forbidden": forbidden,
            "record": record,
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


class _Phases:
    """The seconds each phase of set-up took, from the process's start
    ``t0`` to the window's: logged on standard error as each ends, and kept
    in ``seconds`` (their sum is ``setup_s``)."""

    def __init__(self, t0: float) -> None:
        self.last = t0
        self.seconds: dict = {}
        self("imports")

    @staticmethod
    def log(name: str, seconds: float) -> None:
        print(f"bench: {name} {seconds:.3f} s", file=sys.stderr, flush=True)

    def __call__(self, name: str, until: Optional[float] = None) -> None:
        """The phase ``name`` ended now, or at ``until``."""
        now = time.perf_counter() if until is None else until
        self.seconds[name] = now - self.last
        self.log(name, self.seconds[name])
        self.last = now


def _waited(waits, begin: float, end: float) -> float:
    """The part of ``[begin, end]`` spent in the ``(start, end)`` waits."""
    return sum(max(0.0, min(b, end) - max(a, begin)) for a, b in waits)


def _pool_reads_per_s(pool, iter_batches, corpus, stats) -> Optional[float]:
    """The reader pool's own rate, once the stream is closed and its queued
    files dropped: an empty pass first waits until every worker has
    finished the files it holds (and another one after, so the pool is
    left as idle as it was found); then ``iter_batches``, the pool's own,
    reads the corpus repeated past any rate seen, each batch's slot
    released as it arrives, and the reads handed over from
    ``POOL_UNTIMED_S`` after the pass's start to ``POOL_TIMED_S`` later,
    ÷ ``POOL_TIMED_S``, are the rate.  A failed file counts in ``stats``;
    a pass that runs out first gives None."""
    _settle(iter_batches, stats)
    repeats = -(-int(2 * MAX_READS_PER_S * (POOL_UNTIMED_S + POOL_TIMED_S))
                // corpus.reads)
    timed = time.perf_counter() + POOL_UNTIMED_S
    end = timed + POOL_TIMED_S
    reads = 0
    batches = iter_batches(corpus.paths * repeats, stats, copy=False)
    try:
        for batch in batches:
            now = time.perf_counter()
            if batch.release is not None:
                batch.release()
            if now >= end:
                return reads / POOL_TIMED_S
            if now >= timed:
                reads += len(batch.ids)
    finally:
        batches.close()
        _drop_queued_files(pool)
        _settle(iter_batches, stats)
    return None


def _settle(iter_batches, stats) -> None:
    """An empty pass: it ends once every worker has finished the files it
    holds and handed over what it had left, each batch's slot released."""
    for batch in iter_batches([], stats, copy=False):
        if batch.release is not None:
            batch.release()


def _drop_queued_files(pool) -> None:
    """Take back the files of the repeated list that no worker has begun:
    the pool hands a pass's files to its workers at once, and files still
    queued would keep them busy, and the queues' threads alive, after the
    stream is closed."""
    for tasks in getattr(pool, "_tasks", ()):
        try:
            while True:
                tasks.get(timeout=0.05)
        except queue.Empty:
            pass


def _annotate_program(program, executor, kernel_apply, annotate, recorded,
                      restore):
    """Annotate the program's calls (``bench/upload``, ``bench/call``,
    ``bench/drain``), record the reads of each batch the program is called
    on into ``recorded["rows"]`` where that is a list, and, while
    ``recorded["on"]``, each K1 launch's shape (``recorded["k1"]``);
    ``restore`` gets what to put back."""

    def wrap(target, name, label):
        original = getattr(target, name)

        def annotated(*args, **kwargs):
            rows = recorded["rows"]
            if name == "call_packed" and rows is not None:
                rows.append(int(args[0].shape[0]))
            with annotate(label):
                return original(*args, **kwargs)

        restore.append((target, name, original))
        setattr(target, name, annotated)

    wrap(program, "upload", "bench/upload")
    wrap(program, "call_packed", "bench/call")
    wrap(executor, "unpack_call_table", "bench/drain")
    unit_kernel = kernel_apply.fused_conv1d_bn_relu

    def k1_recorded(x, kernel, scale, bias, dilation=1, relu=True, pool=False):
        if recorded["on"]:
            recorded["k1"].append(flops.Unit(x.shape[0], x.shape[1], x.shape[2],
                                       kernel.shape[2], kernel.shape[0],
                                       dilation, pool))
        return unit_kernel(x, kernel, scale, bias, dilation=dilation,
                           relu=relu, pool=pool)

    restore.append((kernel_apply, "fused_conv1d_bn_relu", unit_kernel))
    kernel_apply.fused_conv1d_bn_relu = k1_recorded


def _consume(stream, to_row, dual, ramp_rows, seconds, lock, batches,
             trace, torch, device, recorded) -> dict:
    """Read the stream: a pass's worth of rows, then the window, then the
    rows still due for reads handed over in it.  With ``trace`` the
    window's :class:`_Tracer` is made at its start and closed at the end."""
    seen = {"ids": [], "calls": [], "start": [], "end": [], "tracer": None,
            "rows_in_window": 0, "attempted": 0, "ran_out": True}
    count = 0
    t_start = t_end = p1 = None
    tracer = None
    try:
        for result in stream:
            now = time.perf_counter()
            read_id, call = to_row(result, False, dual).split("\t")
            if t_start is None:
                count += 1
                if count >= ramp_rows:
                    t_start = time.perf_counter()
                    t_end = t_start + seconds
                    seen.update(t_start=t_start, t_end=t_end, p0=count)
                    if trace:
                        span = min(TRACE_S, seconds / 2)
                        begin = t_start + (seconds - span) / 2
                        tracer = _Tracer(torch, device, begin, begin + span,
                                         recorded)
                        seen["tracer"] = tracer
                continue
            if now < t_end:
                seen["rows_in_window"] += 1
            elif p1 is None:
                with lock:
                    p1 = sum(len(ids) for t, ids in batches if t < t_end)
                    seen["attempted"] = sum(len(ids) for t, ids in batches
                                            if t_start <= t < t_end)
                seen["p1"] = p1
                if tracer is not None:
                    tracer.close()
            if p1 is not None and count >= p1:
                seen["ran_out"] = False
                break
            seen["ids"].append(read_id)
            seen["calls"].append(call)
            seen["start"].append(result.start_probs)
            seen["end"].append(result.end_probs)
            count += 1
            if p1 is not None and count >= p1:
                seen["ran_out"] = False
                break
            if now >= t_end + LATE_S:
                seen["ran_out"] = False
                break
            if tracer is not None:
                tracer.tick(now)
    finally:
        # The untraced stretch's recorder and the profiler off, whatever
        # ended the loop.
        if tracer is not None:
            tracer.close()
    if t_start is None:
        raise RuntimeError("the stream ended before a pass's worth of rows")
    seen.setdefault("p1", count)
    return seen
