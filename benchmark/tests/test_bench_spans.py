"""The per-layer metrics that read the program's own spans: on synthetic
spans, with nothing to read, and in a traced run of a small cell on the
CPU, where the program's ``stream/pool_wait`` must measure what the
harness's pool waits measure from outside, over the window and over the
untraced stretch of a ``--trace 1`` run."""

import time

import pytest

from conftest import CPU_ARGS, small_cell

SIX = ("worker_ms_per_read", "worker_decode_share", "worker_parse_share",
       "enqueue_share", "result_share", "consumer_share")


def _record(rec, batches=(256, 256)):
    """A record whose untraced stretch has the recording ``rec`` (None:
    a run with no untraced stretch)."""
    from benchmark import harness

    untraced = (None if rec is None else harness.Untraced(
        seconds=2.0, pool_wait_s=0.5, recording=rec, batches=list(batches)))
    return harness.Record(seconds=10.0, setup_s=1.0, rows=1, pool_wait_s=0.0,
                          windows_per_read=11, ends=1, network={},
                          untraced=untraced)


def test_readers_of_the_programs_spans():
    from benchmark import harness
    from deepbinner_tpu_torch.runner import spans

    rec = spans.Recording(100.0)
    rec.end = 102.0
    rec.counters["call_packed/rows"] += [(100.45, 256), (101.2, 256)]
    pod5 = {"open": 0.01, "tables": 0.03, "zstd": 0.1, "unpack": 0.06,
            "bytes": 1000, "chunks": 10}
    rec.spans.extend([
        ("read/file", 100.1, 100.3, 9, 9, (0, 0), dict(pod5, reads=100)),
        ("batch/build", 100.3, 100.35, 9, 9, (0, 0), {"reads": 100}),
        # Still in flight at the window's end: left out.
        ("read/file", 101.9, 102.2, 9, 9, (0, 1), dict(pod5, reads=50)),
    ])
    for name, start, end, args in (
            ("stream/upload", 100.4, 100.41, {}),
            ("stream/enqueue", 100.41, 100.51, {}),
            ("stream/release", 100.51, 100.52, {}),
            ("stream/copy_back", 100.6, 100.7, {}),
            ("stream/results", 100.7, 101.1, {"consumer_s": 0.3})):
        rec.add(name, start, end, (0, 0), **args)
    record = _record(rec)
    read = {name: harness.reader(name).read(record) for name in SIX}
    assert read["worker_ms_per_read"] == pytest.approx(1e3 * 0.25 / 100)
    assert read["worker_decode_share"] == pytest.approx(100 * 0.16 / 0.25)
    assert read["worker_parse_share"] == pytest.approx(100 * 0.04 / 0.25)
    assert read["enqueue_share"] == pytest.approx(100 * 0.12 / 2.0)
    assert read["result_share"] == pytest.approx(100 * 0.1 / 2.0)
    assert read["consumer_share"] == pytest.approx(100 * 0.3 / 2.0)
    assert harness.reader("reader_wait_share").read(record) == pytest.approx(25.0)
    # No untraced stretch, or one with no recording: nothing.
    assert all(harness.reader(n).read(_record(None)) is None for n in SIX)
    record.untraced.recording = None
    assert all(harness.reader(n).read(record) is None for n in SIX)
    # A recording whose calls are not the stretch's (another run's): nothing.
    for other in (_record(rec, (256,)), _record(rec, (256, 128)),
                  _record(rec, ())):
        assert all(harness.reader(n).read(other) is None for n in SIX)
    # One that a profiler started, or one still recording: nothing.
    rec.followed = True
    assert all(harness.reader(n).read(_record(rec)) is None for n in SIX)
    rec.followed, rec.end = False, None
    assert all(harness.reader(n).read(_record(rec)) is None for n in SIX)
    # A recording with no such span: nothing.
    empty = spans.Recording(100.0)
    empty.end = 102.0
    empty.counters["call_packed/rows"] += [(100.5, 256), (101.0, 256)]
    assert all(harness.reader(n).read(_record(empty)) is None for n in SIX)


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    """No recording of the traced part to name its idle gaps with, and no
    untraced stretch to read."""
    import sys

    from benchmark import harness, program_spans
    from benchmark.trace import Trace

    monkeypatch.setitem(sys.modules, "deepbinner_tpu_torch.runner.spans", None)
    record = _record(None)
    record.trace, record.step_batches = Trace([], []), [256, 256]
    assert program_spans.recording(record) is None
    assert all(harness.reader(n).read(record) is None for n in SIX)


def _run(trace, seed, seconds):
    from benchmark import classify, harness

    cell = small_cell("rbk004-genomic")
    t0 = time.perf_counter()
    try:
        out = classify.run(cell, seed, seconds, trace, t0, device="cpu",
                           extra_args=CPU_ARGS, corpus_workers=1)
    finally:
        harness.stop_children()
    return cell, out, t0


def test_a_traced_run_reports_the_six_in_range():
    from benchmark import harness

    # A traced part of 2 s: the workers read files in it on the CPU too.
    cell, out, _t0 = _run(True, 2 ** 31 + 11, 4.0)
    assert out["correct"]
    read = harness.read_metrics(cell.per_layer, out["record"])
    values = {name: read[name]["value"] for name in SIX}
    assert values["worker_ms_per_read"] > 0
    for name in SIX[1:]:
        assert 0 <= values[name] <= 100, (name, values[name])
    assert values["worker_decode_share"] + values["worker_parse_share"] <= 100
    assert (values["enqueue_share"] + values["result_share"]
            + values["consumer_share"]) <= 100


@pytest.mark.parametrize("stretch", ["window", "untraced"])
def test_the_programs_pool_wait_is_the_harness_pool_wait(stretch):
    """The program's feeder's ``stream/pool_wait`` against the harness's
    pool waits, which wrap the same iterator from outside: over the
    measured window of a ``--trace 0`` run with the program's recorder on
    for the whole run (``pool_wait_s``), and over the untraced stretch of
    a ``--trace 1`` run in the harness's own recording of it
    (``untraced.pool_wait_s``, which ``reader_wait_share`` reads)."""
    from deepbinner_tpu_torch.runner import spans

    if stretch == "window":
        spans.start()
        try:
            _cell, out, t0 = _run(False, 2 ** 31 + 12, 1.0)
        finally:
            rec = spans.stop()
        record = out["record"]
        seconds, harness_wait = record.seconds, record.pool_wait_s
    else:
        _cell, out, t0 = _run(True, 2 ** 31 + 13, 6.0)
        record = out["record"]
        rec = record.untraced.recording
        seconds = record.untraced.seconds
        harness_wait = record.untraced.pool_wait_s
    begin = t0 + record.setup_s
    end = begin + seconds
    # Every span the feeder added to the recording, clipped to the stretch.
    waited = sum(max(0.0, min(e, end) - max(s, begin))
                 for name, s, e, *_rest in rec.spans
                 if name == "stream/pool_wait")
    assert harness_wait > 0
    assert abs(waited - harness_wait) <= max(
        0.005, 0.05 * harness_wait), (waited, harness_wait)
