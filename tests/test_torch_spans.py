"""The program's spans and counters (``runner/spans.py``) in a classify run
on the CPU, through a reader pool of two spawned workers on a pod5 corpus.

Off, the recorder holds nothing and the results are those of a recorded
run, bit for bit.  On, every batch has its worker's ``batch/build`` and the
main thread's ``stream/*`` spans under one identifier, the build ends
before the upload begins (one clock across processes), and the counters
hold each call's rows and each unit kernel launch.  A recorded pass
abandoned on a pool without shared-memory slots closes cleanly.  A
profiler that records turns the recorder on and off; ``classify
--profile_dir`` writes one trace that holds the program's spans and
counters beside the profiler's events, and the same table as without the
flag.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

from deepbinner_tpu_torch.cli import classify as cli
from deepbinner_tpu_torch.cli.main import get_arguments
from deepbinner_tpu_torch.cli.main import main as port_main
from deepbinner_tpu_torch.models.network import unit_scopes
from deepbinner_tpu_torch.runner import executor, mp_reader, spans
from deepbinner_tpu_torch.utils import pod5, simulate
from deepbinner_tpu_torch.utils.fast5 import find_signal_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "deepbinner_tpu", "models", "data", "TINY_dryrun.dbt")
BATCH = 8
ARGS = ("--scan_size", "768", "--batch_size", str(BATCH), "--device", "cpu",
        "--reader_processes", "2")
STREAM = ("stream/upload", "stream/enqueue", "stream/copy_back",
          "stream/results")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """28 reads in 5 pod5 files of at most 6 reads."""
    root = tmp_path_factory.mktemp("spans")
    truth = simulate.make_dataset(root, kit="EXP-NBD103", reads_per_barcode=2,
                                  none_reads=4, genome_length=600, seed=5,
                                  write_fastq=False, container="pod5",
                                  reads_per_container=6)
    directory = str(root / "fast5s")
    return directory, find_signal_files(directory), truth


@pytest.fixture(scope="module")
def runner(corpus):
    """The CLI's stream, dual model, with a pool of two workers."""
    directory, _files, _truth = corpus
    args = get_arguments(["classify", directory, "-s", TINY, "-e", TINY,
                          *ARGS])
    program, _ = cli.build_program(args)
    stream = cli.StreamRunner(program, args, executor.ExecutorStats())
    assert stream.pool is not None and stream.pool.num_workers == 2
    try:
        yield stream
    finally:
        stream.close()


def _pass(runner, files):
    """One pass: its results by read id, and its batches."""
    before = runner.stats.batches
    results = {r.read_id: r for r in runner.classify(files)}
    return results, runner.stats.batches - before


def _recorded(runner, files):
    spans.start()
    try:
        results, batches = _pass(runner, files)
    finally:
        rec = spans.stop()
    return results, batches, rec


def test_off_records_nothing_and_on_changes_no_result(runner, corpus):
    _directory, files, truth = corpus
    before = spans.last()
    off, _ = _pass(runner, files)
    assert spans.current() is None and spans.last() is before
    on, _batches, rec = _recorded(runner, files)
    assert rec.window()
    assert sorted(on) == sorted(off) == sorted(truth)
    for read_id, result in off.items():
        other = on[read_id]
        assert (result.call, result.start_call, result.end_call) == (
            other.call, other.start_call, other.end_call)
        assert np.array_equal(result.start_probs, other.start_probs)
        assert np.array_equal(result.end_probs, other.end_probs)


def test_every_batch_has_its_spans_on_one_clock(runner, corpus):
    _directory, files, truth = corpus
    _results, batches, rec = _recorded(runner, files)
    main = os.getpid()
    by_batch = collections.defaultdict(lambda: collections.defaultdict(list))
    for name, start, end, pid, _tid, batch, args in rec.window():
        assert rec.start <= start <= end <= rec.end
        by_batch[batch][name].append((start, end, pid, args))
    keys = [key for key in by_batch if key is not None]
    assert len(keys) == batches
    assert {key[0] for key in keys} == {0, 1}  # both workers built batches
    for key in keys:
        named = by_batch[key]
        (build,) = named["batch/build"]
        assert build[2] != main
        assert 0 < build[3]["reads"] <= BATCH
        for name in ("batch/trim", "batch/quantise"):
            (child,) = named[name]
            assert build[0] <= child[0] <= child[1] <= build[1]
        for name in STREAM:
            assert len(named[name]) == 1 and named[name][0][2] == main, name
        (upload,) = named["stream/upload"]
        assert build[1] <= upload[0]  # built in one process, sent to another
        (results,) = named["stream/results"]
        assert 0 <= results[3]["consumer_s"] <= results[1] - results[0]
    names = collections.Counter(s[0] for s in rec.window())
    assert names["stream/enqueue"] == batches
    files_read = [s for s in rec.window() if s[0] == "read/file"]
    assert len(files_read) == len(files)
    assert sum(s[6]["reads"] for s in files_read) == len(truth)
    for span in files_read:
        args = span[6]
        assert args["bytes"] > 0 and args["chunks"] >= args["reads"]
        parts = sum(args[k] for k in ("open", "tables", "zstd", "unpack"))
        assert 0 < parts <= span[2] - span[1]


def test_counters_hold_each_call_and_each_unit_launch(runner, corpus):
    _directory, files, _truth = corpus
    _results, batches, rec = _recorded(runner, files)
    scopes = list(unit_scopes(runner.program.start_net.config))
    ends = 2
    times = [at for at, _value in rec.counters["k1/units"]]
    assert times == sorted(times) and rec.start <= times[0] <= times[-1] <= rec.end
    launches = [value for _at, value in rec.counters["k1/units"]]
    assert [scope for scope, _shape, _loop in launches] == scopes * ends * batches
    windows = {shape[0] for _scope, shape, _loop in launches}
    assert len(windows) == 1 and windows.pop() % BATCH == 0
    # Every unit of the tiny model's geometry takes the pipelined loop.
    assert {loop for _scope, _shape, loop in launches} == {"pipelined"}
    rows = [value for _at, value in rec.counters["call_packed/rows"]]
    assert rows == [BATCH] * batches
    # Each call's rows are counted inside its stream/enqueue span.
    enqueues = [s for s in rec.window() if s[0] == "stream/enqueue"]
    for (at, _rows), span in zip(rec.counters["call_packed/rows"], enqueues):
        assert span[1] <= at <= span[2]


def test_an_abandoned_recorded_pass_without_slots_closes_cleanly(corpus):
    """Batches without a shared-memory slot carry no release beside their
    identifier: those still queued when the consumer leaves are dropped,
    and the pool runs the next pass."""
    directory, files, truth = corpus
    args = get_arguments(["classify", directory, "-s", TINY, *ARGS,
                          "--shm_slots", "0"])
    program, _ = cli.build_program(args)
    stream = cli.StreamRunner(program, args, executor.ExecutorStats())
    try:
        assert stream.pool is not None and stream.pool.num_workers == 2
        spans.start()
        try:
            results = stream.classify(files * 4)
            next(results)
            results.close()
        finally:
            rec = spans.stop()
        assert any(s[5] is not None for s in rec.window())
        assert sorted(r.read_id for r in stream.classify(files)) == sorted(truth)
    finally:
        stream.close()


def test_a_profiler_turns_the_recorder_on_and_off(runner, corpus):
    """The stream follows a profiler started and stopped by its consumer,
    as a caller's traced window does: the recording ends where the
    consumer took the thread in which the profiler stopped."""
    _directory, files, truth = corpus
    profiler = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    rows = 0
    # More batches than the pool's slots: the workers build some of them
    # while the profiler records.
    for _result in runner.classify(files * 8):
        rows += 1
        if rows == 1:
            profiler.start()
        elif rows == 150:
            stopped = spans.clock()
            profiler.stop()
    assert rows == 8 * len(truth)
    rec = spans.last()
    assert rec.followed and spans.current() is None
    assert rec.end is not None and rec.end <= stopped
    names = {s[0] for s in rec.window()}
    assert {"stream/enqueue", "stream/results", "batch/build"} <= names


def test_profile_dir_trace_holds_the_programs_spans(runner, corpus, tmp_path,
                                                   capsys):
    directory, _files, truth = corpus
    argv = ["classify", directory, "-s", TINY, *ARGS]
    port_main(argv)
    want = capsys.readouterr().out
    trace_dir = tmp_path / "trace"
    port_main(argv + ["--profile_dir", str(trace_dir)])
    assert capsys.readouterr().out == want
    assert len(want.splitlines()) == len(truth) + 1
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json"), traces
    with open(trace_dir / traces[0]) as handle:
        events = json.load(handle)["traceEvents"]
    assert any(e.get("name") == cli.PROFILE_ANCHOR for e in events)
    main = os.getpid()
    ours = [e for e in events if e.get("cat") == "deepbinner"]
    stream = [e for e in ours if e["name"].startswith("stream/")]
    files = [e for e in ours if e["name"] == "read/file"]
    assert {e["name"] for e in stream} >= set(STREAM)
    assert {e["pid"] for e in stream} == {main}
    workers = {e["pid"] for e in files}
    assert len(workers) == 2 and main not in workers
    rows = {e["pid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert {rows[pid] for pid in workers} == {"reader worker 0",
                                              "reader worker 1"}
    built = {tuple(e["args"]["batch"]): e["ts"] + e["dur"] for e in ours
             if e["name"] == "batch/build"}
    uploads = [e for e in stream if e["name"] == "stream/upload"]
    assert uploads and len(built) == len(uploads)
    for upload in uploads:
        assert built[tuple(upload["args"]["batch"])] <= upload["ts"]
    # The counters: an instant event at each call and each unit launch.
    counted = collections.Counter(e["name"] for e in ours if e["ph"] == "i")
    scopes = list(unit_scopes(runner.program.start_net.config))
    assert counted["call_packed/rows"] == len(uploads)
    assert counted["k1/units"] == len(scopes) * len(uploads)


def test_read_pod5_times_change_no_read(corpus):
    _directory, files, _truth = corpus
    for path in files:
        times = dict.fromkeys(mp_reader._POD5_TIMES, 0)
        plain = pod5.read_pod5(path, 2048, 2048)
        timed = pod5.read_pod5(path, 2048, 2048, times)
        assert [r for r, _s in timed] == [r for r, _s in plain]
        for (_r, a), (_r2, b) in zip(plain, timed):
            assert np.array_equal(a, b)
        assert times["bytes"] == os.path.getsize(path)
        assert times["chunks"] >= len(plain)
        assert min(times[k] for k in ("open", "tables", "zstd", "unpack")) > 0
        assert 0 < times["unpacked"] <= times["samples"]


@pytest.mark.parametrize("head,tail", [(0, 0), (100, 0), (100, 100)])
def test_read_pod5_counts_the_samples_it_unpacks(corpus, head, tail):
    """``samples``: those of the chunks decompressed; ``unpacked``: those
    unpacked.  Equal with no head (prep's whole decode) and where the tail
    needs each read's one chunk; the head alone unpacks each read's
    first ``head``."""
    _directory, files, _truth = corpus
    for path in files:
        times = dict.fromkeys(mp_reader._POD5_TIMES, 0)
        timed = pod5.read_pod5(path, head, tail, times)
        plain = pod5.read_pod5(path, head, tail)
        for (r, a), (r2, b) in zip(plain, timed, strict=True):
            assert r == r2 and np.array_equal(a, b)
        lengths = [s.size for _r, s in pod5.read_pod5(path)]
        assert max(lengths) <= pod5.SIGNAL_CHUNK_SIZE  # one chunk a read
        assert times["samples"] == sum(lengths)
        want = (sum(min(head, n) for n in lengths) if head and not tail
                else sum(lengths))
        assert times["unpacked"] == want
        if head and not tail:
            assert want < sum(lengths)


def test_read_file_spans_carry_samples_and_unpacked(runner, corpus):
    """The pool's ``read/file`` spans carry the two counts, unpacked no
    more than decompressed, summing to what read_pod5 counts at the
    pool's head and tail; the reads are those of a run without the
    recorder."""
    _directory, files, _truth = corpus
    off, _ = _pass(runner, files)
    on, _batches, rec = _recorded(runner, files)
    assert sorted(on) == sorted(off)
    for read_id, result in off.items():
        assert np.array_equal(result.start_probs, on[read_id].start_probs)
    files_read = [s[6] for s in rec.window() if s[0] == "read/file"]
    assert len(files_read) == len(files)
    for args in files_read:
        assert 0 < args["unpacked"] <= args["samples"]
    spec = runner.pool.batch_spec
    head = spec.trim.raw_size if spec.trim is not None else spec.buffer_size
    want = dict.fromkeys(mp_reader._POD5_TIMES, 0)
    for path in files:
        pod5.read_pod5(path, head, head if spec.dual else 0, want)
    for key in ("samples", "unpacked"):
        assert sum(args[key] for args in files_read) == want[key]


class _Flag:
    value = 0


def test_the_switch_reaches_attached_flags_and_the_window_keeps_its_spans():
    flag = _Flag()
    spans.attach(flag)
    try:
        rec = spans.start()
        assert flag.value == 1 and spans.start() is rec
        assert spans.counter("n") is rec.counters["n"]
        spans.counter("n").append((rec.start + 0.25, 7))
        rec.add("inside", rec.start, rec.start)
        spans.stop(at=rec.start + 1.0)
        assert flag.value == 0 and spans.counter("n") is None
        # A worker's spans arrive late: those inside the window stay.
        spans.take([("late", rec.start + 0.5, rec.start + 0.9, 1, 1, (0, 0), None),
                    ("after", rec.start + 0.5, rec.start + 1.5, 1, 1, (0, 0), None)])
        assert [s[0] for s in rec.window()] == ["inside", "late"]
        # follow() stops only a recording it started.
        assert spans.follow(True).followed and flag.value == 1
        assert spans.follow(False) is None and flag.value == 0
        explicit = spans.start()
        assert spans.follow(False) is explicit
        spans.stop()
    finally:
        spans.stop()
        spans.detach(flag)
    events = spans.chrome_events(rec, 1000.0, rec.start)
    late = next(e for e in events if e["name"] == "late")
    assert late["ts"] == pytest.approx(1000.0 + 0.5e6)
    assert late["dur"] == pytest.approx(0.4e6)
    assert late["args"] == {"batch": [0, 0]}
    (count,) = [e for e in events if e["ph"] == "i"]
    assert count["name"] == "n" and count["args"] == {"value": 7}
    assert count["ts"] == pytest.approx(1000.0 + 0.25e6)
