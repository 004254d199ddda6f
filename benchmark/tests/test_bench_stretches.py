"""The two stretches of a ``--trace 1`` run and the pool-only pass after
its window, in small cells on the CPU: the host's per-layer metrics read
the untraced stretch's recording and no other, the traced part's
``stream/*`` spans name its idle gaps, the pool's own rate is measured
after the window, and a ``--trace 0`` run does none of it."""

import copy
import os
import time

import pytest

from conftest import CPU_ARGS, small_cell

# The readers of the untraced stretch's recording.
SEVEN = ("worker_ms_per_read", "worker_decode_share", "worker_parse_share",
         "worker_unpacked_share", "enqueue_share", "result_share",
         "consumer_share")


def _run(name, trace, seed, seconds):
    from benchmark import classify, harness

    cell = small_cell(name)
    try:
        out = classify.run(cell, seed, seconds, trace, time.perf_counter(),
                           device="cpu", extra_args=CPU_ARGS, corpus_workers=1)
    finally:
        harness.stop_children()
    return cell, out


@pytest.fixture(scope="module")
def traced():
    """One traced run (a 6 s window: 1.5 s untraced, 3 s traced), with the
    program's recording of its traced part."""
    from deepbinner_tpu_torch.runner import spans

    cell, out = _run("rbk004-genomic", True, 2 ** 31 + 21, 6.0)
    return cell, out, spans.last()


def _read(record):
    from benchmark import harness

    return {name: harness.reader(name).read(record) for name in SEVEN}


def test_the_stretches_are_recorded(traced):
    _cell, out, traced_rec = traced
    assert out["correct"]
    stretch = out["record"].untraced
    rec = stretch.recording
    assert rec is not None and not rec.followed and rec.end is not None
    assert traced_rec is not None and traced_rec.followed
    assert traced_rec is not rec and traced_rec.start >= rec.end
    assert stretch.batches and out["record"].step_batches
    assert stretch.seconds == pytest.approx(rec.end - rec.start, abs=0.01)
    assert all(value is not None for value in _read(out["record"]).values())


def test_the_host_readers_read_the_untraced_recording(traced, monkeypatch):
    """A span of known duration planted in the traced part's recording
    moves no reader; planted in the untraced one it moves each by what it
    adds."""
    from benchmark import program_spans
    from deepbinner_tpu_torch.runner import spans

    _cell, out, traced_rec = traced
    record = copy.copy(out["record"])
    record.untraced = copy.copy(record.untraced)
    record.untraced.recording = untraced = copy.deepcopy(
        record.untraced.recording)
    traced_rec = copy.deepcopy(traced_rec)
    monkeypatch.setattr(spans, "last", lambda: traced_rec)
    before = _read(record)
    work = program_spans.worker_work(untraced)
    window = program_spans.window_s(untraced)
    samples = unpacked = 0
    for name, _s, _e, _pid, _tid, _batch, args in untraced.window():
        if name == "read/file":
            samples += args["samples"]
            unpacked += args["unpacked"]

    def plant(rec):
        at = rec.start + 0.1 * (rec.end - rec.start)
        d = 0.01 * (rec.end - rec.start)
        rec.spans += [
            ("read/file", at, at + d, 1, 1, (0, 99),
             {"reads": 100, "open": d / 4, "tables": 0.0, "zstd": d / 2,
              "unpack": 0.0, "samples": 1000, "unpacked": 1000}),
            ("stream/upload", at, at + d, 2, 2, None, None),
            ("stream/results", at, at + d, 2, 2, None, {"consumer_s": d / 4}),
        ]
        return d

    plant(traced_rec)
    assert _read(record) == before
    d = plant(untraced)
    busy, reads = work["busy_s"] + d, work["reads"] + 100
    expected = {
        "worker_ms_per_read": 1e3 * busy / reads,
        "worker_decode_share": 100 * (work["decode_s"] + d / 2) / busy,
        "worker_parse_share": 100 * (work["parse_s"] + d / 4) / busy,
        "worker_unpacked_share": 100 * (unpacked + 1000) / (samples + 1000),
        "enqueue_share": before["enqueue_share"] + 100 * d / window,
        "result_share": before["result_share"] + 100 * 0.75 * d / window,
        "consumer_share": before["consumer_share"] + 100 * 0.25 * d / window,
    }
    after = _read(record)
    for name in SEVEN:
        assert after[name] == pytest.approx(expected[name], rel=1e-9), name
        assert after[name] != pytest.approx(before[name], rel=1e-6), name


def test_a_stale_or_profiler_started_recording_gives_nothing(traced):
    _cell, out, traced_rec = traced
    record = copy.copy(out["record"])
    stretch = record.untraced
    # The traced part's recording, which the classify stream started
    # itself under the profiler: nothing.
    record.untraced = copy.copy(stretch)
    record.untraced.recording = traced_rec
    assert all(v is None for v in _read(record).values())
    # The same, as if no profiler had started it: its calls are not the
    # stretch's.
    other = copy.copy(traced_rec)
    other.followed = False
    record.untraced.recording = other
    assert all(v is None for v in _read(record).values())
    # The stretch's own recording, held against another run's calls.
    record.untraced.recording = stretch.recording
    record.untraced.batches = stretch.batches[1:]
    assert all(v is None for v in _read(record).values())


def test_the_traced_parts_stream_spans_name_its_idle_gaps(traced):
    _cell, out, traced_rec = traced
    names = {name for _s, _e, name in out["record"].trace.annotations}
    assert {"stream/upload", "stream/enqueue", "stream/results",
            "bench/pool_wait", "bench/call"} <= names
    # The feeder's stream/pool_wait is bench/pool_wait already.
    assert "stream/pool_wait" not in names


def test_a_traced_run_reports_the_pools_own_rate(traced):
    from benchmark import harness

    cell, out, _rec = traced
    assert out["failed"] == 0
    read = harness.read_metrics(cell.per_layer, out["record"])
    assert read["pool_reads_per_s"]["value"] > 0
    assert read["pool_reads_per_s"]["unit"] == "reads/s"


def test_the_result_names_the_host_and_the_phases_of_set_up(traced):
    _cell, out, _rec = traced
    device = out["device"]
    assert device["cpu_model"] and device["cpu_count"] >= 1
    assert 1 <= device["cpu_affinity"] <= device["cpu_count"]
    phases = out["setup_phases"]
    assert list(phases) == ["imports", "corpus", "program", "reader_pool",
                            "warm_up", "ramp"]
    assert sum(phases.values()) == pytest.approx(out["record"].setup_s)
    assert all(seconds >= 0 for seconds in phases.values())


def test_an_untraced_run_starts_no_recorder_and_makes_no_pool_pass(monkeypatch):
    from benchmark import classify, harness
    from deepbinner_tpu_torch.runner import spans

    called = []
    start, pool_pass = spans.start, classify._pool_reads_per_s
    monkeypatch.setattr(spans, "start",
                        lambda *a, **k: called.append("start") or start(*a, **k))
    monkeypatch.setattr(
        classify, "_pool_reads_per_s",
        lambda *a, **k: called.append("pool") or pool_pass(*a, **k))
    cell, out = _run("rbk004-amplicon", False, 2 ** 31 + 22, 1.0)
    assert out["correct"] and called == []
    record = out["record"]
    assert record.untraced is None and record.pool_reads_per_s is None
    assert harness.reader("pool_reads_per_s").read(record) is None
    assert set(out["setup_phases"]) == {"imports", "corpus", "program",
                                        "reader_pool", "warm_up", "ramp"}
    assert spans.current() is None


def test_a_file_that_fails_in_the_pool_pass_counts(monkeypatch):
    """A corpus file replaced by one that is no pod5 between the window and
    the pool-only pass: its reads count in ``failed`` and the run is not
    correct."""
    from benchmark import classify

    pool_pass = classify._pool_reads_per_s

    def replaced(pool, iter_batches, corpus, stats):
        path = corpus.paths[0]
        with open(path + ".new", "wb") as handle:
            handle.write(b"not a pod5 file" * 64)
        os.replace(path + ".new", path)  # workers holding the old keep it
        return pool_pass(pool, iter_batches, corpus, stats)

    monkeypatch.setattr(classify, "_pool_reads_per_s", replaced)
    cell, out = _run("rbk004-amplicon", True, 2 ** 31 + 23, 2.0)
    assert out["checks"]["rows_missing"]["value"] == 0
    assert out["checks"]["failed_files"]["value"] >= 1
    assert out["failed"] >= cell.traffic["reads_per_file"]
    assert out["correct"] is False
