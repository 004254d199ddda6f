"""``worker_unpacked_share``: on a hand-made recording of the untraced
stretch, with nothing to read (no such stretch, no ``read/file`` span,
or spans without the two counts, as a program from before them
records), and in a traced run of a small cell on the CPU."""

import time

import pytest

from conftest import CPU_ARGS, small_cell

NAME = "worker_unpacked_share"


def _record(rec):
    """A record whose untraced stretch has the recording ``rec`` (None:
    a run with no untraced stretch)."""
    from benchmark import harness

    untraced = (None if rec is None else harness.Untraced(
        seconds=2.0, pool_wait_s=0.0, recording=rec, batches=[256, 256]))
    return harness.Record(seconds=10.0, setup_s=1.0, rows=1, pool_wait_s=0.0,
                          windows_per_read=11, ends=1, network={},
                          untraced=untraced)


def _recording(files):
    from deepbinner_tpu_torch.runner import spans

    rec = spans.Recording(100.0)
    rec.end = 102.0
    rec.counters["call_packed/rows"] += [(100.45, 256), (101.2, 256)]
    rec.spans.extend(files)
    rec.spans.append(("batch/build", 100.3, 100.35, 9, 9, (0, 0),
                      {"reads": 100}))
    return rec


def test_the_share_of_samples_unpacked():
    from benchmark import harness

    reader = harness.reader(NAME)
    counts = {"zstd": 0.1, "unpack": 0.02, "chunks": 3}
    rec = _recording([
        ("read/file", 100.1, 100.3, 9, 9, (0, 0),
         dict(counts, reads=2, samples=300_000, unpacked=30_000)),
        ("read/file", 100.3, 100.5, 8, 8, (1, 0),
         dict(counts, reads=1, samples=100_000, unpacked=100_000)),
        # Still in flight at the window's end: left out.
        ("read/file", 101.9, 102.2, 9, 9, (0, 1),
         dict(counts, reads=1, samples=100_000, unpacked=1)),
    ])
    assert reader.read(_record(rec)) == pytest.approx(100.0 * 130_000 / 400_000)
    assert reader.read(_record(None)) is None  # no untraced stretch
    # No read/file span; spans without the counts (an older program's).
    for files in ([], [("read/file", 100.1, 100.3, 9, 9, (0, 0),
                        dict(counts, reads=2))]):
        assert reader.read(_record(_recording(files))) is None


def test_a_traced_run_reports_the_share():
    from benchmark import classify, harness

    cell = small_cell("rbk004-genomic")
    try:
        out = classify.run(cell, 2 ** 31 + 17, 4.0, True, time.perf_counter(),
                           device="cpu", extra_args=CPU_ARGS, corpus_workers=1)
    finally:
        harness.stop_children()
    assert out["correct"]
    read = harness.read_metrics(cell.per_layer, out["record"])
    assert 0 < read[NAME]["value"] <= 100
