"""The corpus: made from the seed alone, the same work for every seed, and
pod5 files the port reads back to the generated signals."""

import json
import os

import numpy as np
import pytest

from conftest import ROOT, small_cell


def _traffic(name="genomic", reads=24, per_file=8):
    with open(os.path.join(ROOT, "benchmark", "traffic", name + ".json")) as f:
        traffic = json.load(f)
    traffic.update(reads=reads, reads_per_file=per_file)
    if name == "genomic":  # short enough for a test, some over two chunks
        traffic["genomic_bases"] = dict(traffic["genomic_bases"], median=12000,
                                        min=3000, max=30000)
    return traffic


def test_same_seed_same_corpus_other_seed_other_signals(tmp_path):
    from benchmark import corpus

    traffic = _traffic()
    a = corpus.generate(traffic, "EXP-NBD103", 2 ** 31 + 99, str(tmp_path / "a"), 512)
    b = corpus.generate(traffic, "EXP-NBD103", 2 ** 31 + 99, str(tmp_path / "b"), 512,
                        write=False)
    c = corpus.generate(traffic, "EXP-NBD103", 2 ** 31 + 100, str(tmp_path / "c"), 512)
    assert a.read_ids == b.read_ids
    for field in ("barcodes", "lengths", "heads", "tails"):
        assert np.array_equal(getattr(a, field), getattr(b, field))
    assert not set(a.read_ids) & set(c.read_ids)
    assert not np.array_equal(a.heads, c.heads)
    # The same work in another order: lengths within a dwell's noise,
    # the same barcodes.
    assert sorted(a.barcodes) == sorted(c.barcodes)
    ratio = np.sort(a.lengths) / np.sort(c.lengths)
    assert np.all(np.abs(ratio - 1) < 0.05)


def test_worker_processes_make_the_same_corpus(tmp_path):
    from benchmark import corpus

    traffic = _traffic(reads=16)
    one = corpus.generate(traffic, "SQK-RBK004", 3, str(tmp_path / "one"), 256)
    two = corpus.generate(traffic, "SQK-RBK004", 3, str(tmp_path / "two"), 256,
                          workers=2)
    assert one.read_ids == two.read_ids
    assert np.array_equal(one.heads, two.heads)
    assert np.array_equal(one.tails, two.tails)


def test_traffic_sets_are_fixed():
    from benchmark import corpus

    traffic = _traffic("amplicon", reads=4096, per_file=256)
    counts = np.bincount(corpus.barcode_set(traffic), minlength=13)
    assert counts[0] == 410 and counts[1:].min() >= 307 and counts.sum() == 4096
    lengths = corpus.genomic_lengths(traffic)
    assert lengths.min() >= 500 and lengths.max() <= 4000
    assert abs(np.median(lengths) - 1500) <= 2


@pytest.mark.parametrize("head,tail", [(0, 0), (512, 512), (512, 0)])
def test_port_reads_the_frozen_writers_files(tmp_path, head, tail):
    from benchmark import corpus
    from deepbinner_tpu_torch.utils.pod5 import read_pod5

    keep = 512
    data = corpus.generate(_traffic(), "EXP-NBD103", 11, str(tmp_path), keep)
    assert any(size > 102_400 for size in data.lengths)
    got = [r for path in data.paths for r in read_pod5(path, head, tail)]
    assert [r[0] for r in got] == data.read_ids
    for k, (_read_id, signal) in enumerate(got):
        size = int(data.lengths[k])
        if head == 0 or head + tail >= size:
            assert signal.size == size
        assert np.array_equal(signal[:keep], data.heads[k, :min(size, keep)])
        if tail or head == 0:
            assert np.array_equal(signal[-keep:], data.tails[k, :min(size, keep)])


def test_frozen_vbz_gives_the_ports_bytes():
    from benchmark import pod5w
    from deepbinner_tpu_torch.utils import pod5

    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 4096, 102_400):
        signal = (rng.standard_normal(n) * 900 + 450).astype(np.int16)
        signal[::97] = rng.integers(-32000, 32000, signal[::97].size)
        delta = np.empty_like(signal)
        delta[:1] = signal[:1]
        delta[1:] = (signal[1:].astype(np.int32)
                     - signal[:-1].astype(np.int32)).astype(np.int16)
        assert pod5w.svb16_zigzag_delta(signal) == pod5.svb16_encode(
            pod5._zigzag_encode(delta))
        assert np.array_equal(
            pod5.vbz_decompress(pod5w.vbz_compress(signal), n), signal)


def test_small_cells_corpus_fits_the_tiny_geometry():
    cell = small_cell("rbk004-genomic")
    assert cell.traffic["reads"] == 48 and cell.config["end_model"] is None
