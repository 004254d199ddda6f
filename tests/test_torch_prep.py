"""The port's prep, balance and training-data modules.

The JAX package's own cases (``tests/test_train.py``) run on the port's
copies, and both packages' functions and CLIs run on the same simulated
reads and fast5 datasets: rows equal, TSVs byte-identical.
"""

import gzip

import numpy as np
import pytest

from deepbinner_tpu.cli.main import main as jax_main
from deepbinner_tpu.train import balance as jax_balance
from deepbinner_tpu.train import prep as jax_prep
from deepbinner_tpu.utils import simulate as jax_simulate
from deepbinner_tpu_torch.cli.main import main as port_main
from deepbinner_tpu_torch.train import balance as balance_mod
from deepbinner_tpu_torch.train import data as data_io
from deepbinner_tpu_torch.train import prep as prep_mod
from deepbinner_tpu_torch.utils import fast5 as fast5_io
from deepbinner_tpu_torch.utils import kits, simulate


# -- the JAX package's cases, on the port's copies -----------------------------

def test_edit_distance_find_exact_and_indels():
    assert prep_mod.edit_distance_find("AAACGTACGTAAA", "CGTACGT", 0) == (3, 10, 0)
    start, end, edits = prep_mod.edit_distance_find("AAACGTACGTAAA", "CGTTCGT", 1)
    assert (start, end, edits) == (3, 10, 1)
    start, end, edits = prep_mod.edit_distance_find("AAACGTCGTAAA", "CGTACGT", 1)
    assert edits == 1 and start == 3 and end == 9
    start, end, edits = prep_mod.edit_distance_find("AAACGTAACGTAAA", "CGTACGT", 1)
    assert edits == 1 and start == 3 and end == 11
    assert prep_mod.edit_distance_find("AAACGTACGTAAA", "GGGGGGG", 1) is None
    assert prep_mod.edit_distance_find("", "AAAA", 0) is None


def _corrupt_with_indels(sequence, rng, rate=0.10):
    out = []
    for base in sequence:
        roll = rng.random()
        if roll < rate / 2:
            continue  # deletion
        if roll < rate:
            out.append("ACGT"[rng.integers(4)])  # insertion before the base
        out.append(base)
    return "".join(out)


def test_indel_tolerant_localisation_beats_hamming():
    """At 10% indel error the edit search recovers >= 90%, Hamming far less."""
    rng = np.random.default_rng(7)
    barcodes = simulate.barcode_sequences("EXP-NBD103")
    trials, edit_hits, hamming_hits = 40, 0, 0
    for _ in range(trials):
        true_idx = int(rng.integers(len(barcodes)))
        flank_l = "".join(rng.choice(list("ACGT"), 60))
        flank_r = "".join(rng.choice(list("ACGT"), 200))
        read = _corrupt_with_indels(flank_l + barcodes[true_idx] + flank_r, rng)
        best = None
        for i, candidate in enumerate(barcodes):
            hit = prep_mod.edit_distance_find(read[:150], candidate, 5)
            if hit and (best is None or hit[2] < best[0]):
                best = (hit[2], i, hit[0])
        if best is not None and best[1] == true_idx and abs(best[2] - 60) <= 12:
            edit_hits += 1
        for i, candidate in enumerate(barcodes):
            if prep_mod.approximate_find(read[:150], candidate, 3) >= 0:
                hamming_hits += i == true_idx
                break
    assert edit_hits >= 0.9 * trials
    assert hamming_hits <= 0.25 * trials


def test_approximate_find():
    assert prep_mod.approximate_find("AAACGTACGTAAA", "CGTACGT", 0) == 3
    assert prep_mod.approximate_find("AAACGTACGTAAA", "CGTTCGT", 1) == 3
    assert prep_mod.approximate_find("AAACGTACGTAAA", "GGGGGGG", 1) == -1
    assert prep_mod.approximate_find("AA", "AAAA", 0) == -1


def test_base_range_to_signal_range():
    dwells = np.asarray([3, 2, 4, 1])
    assert prep_mod.base_range_to_signal_range(100, dwells, 1, 3) == (103, 109)
    assert prep_mod.base_range_to_signal_range(100, dwells, 2, 99) == (105, 110)


def test_cut_sample_centres_and_refuses_short_reads():
    signal = np.arange(1000)
    cut = prep_mod._cut_sample(signal, 400, 440, 200, 10)
    np.testing.assert_array_equal(cut, np.arange(320, 520))
    assert prep_mod._cut_sample(signal[:150], 50, 60, 200, 10) is None
    np.testing.assert_array_equal(prep_mod._cut_sample(signal, 990, 999, 100, 5),
                                  np.arange(900, 1000))


def test_extract_training_samples_start():
    rng = np.random.default_rng(0)
    read = simulate.simulate_read("EXP-NBD103", 4, rng, genome_length=600)
    samples = prep_mod.extract_training_samples(
        read.signal, read.sequence, (read.signal_start_of_bases, read.dwells),
        "EXP-NBD103", "start", signal_size=512, margin=64)
    labels = [s[0] for s in samples]
    assert 4 in labels and 0 in labels
    assert all(s[1].size == 512 for s in samples)


def test_extract_training_samples_end_reversed():
    rng = np.random.default_rng(1)
    read = simulate.simulate_read("EXP-NBD103", 7, rng, genome_length=600)
    samples = prep_mod.extract_training_samples(
        read.signal, read.sequence, (read.signal_start_of_bases, read.dwells),
        "EXP-NBD103", "end", signal_size=512, margin=64)
    assert 7 in [s[0] for s in samples]


def test_real_kit_sequences_localised_in_simulated_basecalls():
    rng = np.random.default_rng(3)
    for kit in ("EXP-NBD103", "SQK-RBK004"):
        forms = kits.barcode_start_forms(kit)
        for barcode in (1, 5, 12):
            read = simulate.simulate_read(kit, barcode, rng, genome_length=400)
            assert forms[barcode - 1] in read.sequence[:120]
            samples = prep_mod.extract_training_samples(
                read.signal, read.sequence,
                (read.signal_start_of_bases, read.dwells), kit, "start",
                signal_size=512, margin=64)
            assert barcode in [s[0] for s in samples]
        if kit == "EXP-NBD103":
            read = simulate.simulate_read(kit, 9, rng, genome_length=400)
            samples = prep_mod.extract_training_samples(
                read.signal, read.sequence,
                (read.signal_start_of_bases, read.dwells), kit, "end",
                signal_size=512, margin=64)
            assert 9 in [s[0] for s in samples]


def test_read_end_rows_need_the_native_kit():
    rng = np.random.default_rng(4)
    read = simulate.simulate_read("SQK-RBK004", 2, rng, genome_length=400)
    with pytest.raises(ValueError):
        prep_mod.extract_training_samples(
            read.signal, read.sequence, (read.signal_start_of_bases, read.dwells),
            "SQK-RBK004", "end", signal_size=512, margin=64)


def test_known_barcode_localisation_failure_skips_read():
    rng = np.random.default_rng(30)
    read = simulate.simulate_read("EXP-NBD103", 0, rng, genome_length=400)
    move = (read.signal_start_of_bases, read.dwells)
    assert prep_mod.extract_training_samples(
        read.signal, read.sequence, move, "EXP-NBD103", "start",
        signal_size=512, margin=64, known_barcode=7) == []
    samples = prep_mod.extract_training_samples(
        read.signal, read.sequence, move, "EXP-NBD103", "start",
        signal_size=512, margin=64, known_barcode=0)
    assert samples and all(label == 0 for label, _ in samples)


def _fast5_run(tmp_path, seed, barcodes):
    """A multi-read fast5 with move tables, and its basecalls."""
    rng = np.random.default_rng(seed)
    reads, moves, records = [], {}, []
    for barcode in barcodes:
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=300, open_pore_length=50)
        reads.append((read.read_id, read.signal))
        moves[read.read_id] = (read.signal_start_of_bases, read.dwells)
        records.append((read.read_id, f"@{read.read_id}\n{read.sequence}\n+\n"
                                      f"{'I' * len(read.sequence)}\n"))
    f5_dir = tmp_path / "fast5s"
    f5_dir.mkdir()
    fast5_io.write_multi_read_fast5(f5_dir / "batch0.fast5", reads, moves)
    (tmp_path / "reads.fastq").write_text("".join(r for _, r in records))
    return f5_dir, records


def _prep_labels(tmp_path, f5_dir, *extra):
    out = tmp_path / "train.tsv"
    port_main(["prep", str(f5_dir), "--kit", "EXP-NBD103", "--end", "start",
               "--reads", str(tmp_path / "reads.fastq"), "--out", str(out),
               "--signal_size", "512", "--margin", "64", *extra])
    return [int(line.split("\t")[0]) for line in out.read_text().splitlines()]


def test_prep_multi_read_fast5_move_tables(tmp_path):
    f5_dir, records = _fast5_run(tmp_path, 2, [1, 2, 3])
    tables = fast5_io.get_move_tables(f5_dir / "batch0.fast5")
    assert set(tables) == {read_id for read_id, _ in records}
    assert {1, 2, 3}.issubset(_prep_labels(tmp_path, f5_dir))


def test_prep_external_assignments(tmp_path):
    f5_dir, records = _fast5_run(tmp_path, 12, [1, 2, 3, 4])
    assign = [f"{records[0][0]}\tbarcode01", f"{records[1][0]}\tbarcode02",
              f"{records[2][0]}\tnone"]  # read 4 has no assignment
    (tmp_path / "assign.tsv").write_text("\n".join(assign) + "\n")
    labels = _prep_labels(tmp_path, f5_dir, "--assignments",
                          str(tmp_path / "assign.tsv"))
    assert 1 in labels and 2 in labels
    assert 4 not in labels
    assert 3 not in labels and 0 in labels


def test_prep_porechop_bins(tmp_path):
    f5_dir, records = _fast5_run(tmp_path, 21, [1, 2, 0])
    porechop = tmp_path / "porechop"
    porechop.mkdir()
    with gzip.open(porechop / "BC01.fastq.gz", "wt") as handle:
        handle.write(records[0][1])
    (porechop / "BC02.fastq").write_text(records[1][1])
    (porechop / "none.fastq").write_text(records[2][1])
    assert sorted(prep_mod.parse_porechop_bins(str(porechop)).values()) == [0, 1, 2]
    labels = _prep_labels(tmp_path, f5_dir, "--porechop", str(porechop))
    assert 1 in labels and 2 in labels and 0 in labels


def test_porechop_dir_without_bins_errors(tmp_path):
    (tmp_path / "notes.txt").write_text("hello")
    with pytest.raises(SystemExit):
        prep_mod.parse_porechop_bins(str(tmp_path))


def test_balance_equalises():
    rows = []
    rng = np.random.default_rng(0)
    for label, count in [(1, 10), (2, 4), (3, 7), (0, 30)]:
        for _ in range(count):
            rows.append((label, rng.integers(0, 100, 64).astype(np.int16)))
    counts = {}
    for label, _ in balance_mod.balance_samples(rows, none_fraction=0.2, seed=0):
        counts[label] = counts.get(label, 0) + 1
    assert counts[1] == counts[2] == counts[3] == 4
    assert counts[0] == 3  # 0.2/0.8 * 12 = 3


def test_balance_without_barcodes_raises():
    with pytest.raises(ValueError):
        balance_mod.balance_samples([(0, np.zeros(4, np.int16))], 0.1, 0)


def test_data_roundtrip(tmp_path):
    rows = [(3, np.arange(16, dtype=np.int16)), (0, np.ones(16, np.int16))]
    path = tmp_path / "train.tsv"
    data_io.write_samples(path, rows)
    signals, labels = data_io.load_training_set(str(path))
    assert signals.shape == (2, 16) and signals.dtype == np.float32
    np.testing.assert_array_equal(labels, [3, 0])
    np.testing.assert_array_equal(signals[0], np.arange(16))


def test_inconsistent_sizes_raise(tmp_path):
    path = tmp_path / "bad.tsv"
    path.write_text("1\t1,2,3\n2\t1,2\n")
    with pytest.raises(ValueError):
        data_io.load_training_set(str(path))


# -- the port against the JAX package ------------------------------------------

@pytest.mark.parametrize("kit,end,known", [
    ("EXP-NBD103", "start", None), ("EXP-NBD103", "end", None),
    ("SQK-RBK004", "start", None), ("EXP-NBD103", "start", 5),
])
def test_extract_training_samples_equal_jax(kit, end, known):
    rng = np.random.default_rng(40)
    for barcode in list(range(13)) + [5, 5]:
        read = jax_simulate.simulate_read(kit, barcode, rng, genome_length=500)
        move = (read.signal_start_of_bases, read.dwells)
        kwargs = dict(signal_size=512, margin=64, known_barcode=known,
                      none_rows=3)
        want = jax_prep.extract_training_samples(
            read.signal, read.sequence, move, kit, end, **kwargs)
        got = prep_mod.extract_training_samples(
            read.signal, read.sequence, move, kit, end, **kwargs)
        assert [label for label, _ in got] == [label for label, _ in want]
        for (_l, g), (_w, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,none_fraction", [(0, 0.1), (7, 0.3), (3, 0.0)])
def test_balance_samples_equal_jax(seed, none_fraction):
    rng = np.random.default_rng(seed)
    rows = [(int(label), rng.integers(0, 900, 32).astype(np.int16))
            for label in rng.integers(0, 13, 300)]
    got = balance_mod.balance_samples(rows, none_fraction, seed)
    want = jax_balance.balance_samples(rows, none_fraction, seed)
    assert [id(r[1]) for r in got] == [id(r[1]) for r in want]


@pytest.fixture(scope="module")
def fast5_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("prep_dataset")
    simulate.make_dataset(root, kit="EXP-NBD103", reads_per_barcode=2,
                          none_reads=4, genome_length=600, seed=9,
                          container="multifast5", reads_per_container=10)
    return root


@pytest.mark.parametrize("extra", [
    ["--end", "start"],
    ["--end", "end", "--signal_size", "700", "--margin", "100"],
    ["--end", "start", "--assignments", "truth.tsv"],
])
def test_prep_and_balance_tsvs_byte_identical_to_jax(fast5_dataset, tmp_path,
                                                     extra, capsys):
    extra = [str(fast5_dataset / e) if e == "truth.tsv" else e for e in extra]
    tsvs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        prep_out = tmp_path / f"{name}_prep.tsv"
        main(["prep", str(fast5_dataset / "fast5s"), "--kit", "EXP-NBD103",
              "--reads", str(fast5_dataset / "reads.fastq"),
              "--out", str(prep_out), *extra])
        balanced = tmp_path / f"{name}_balanced.tsv"
        main(["balance", str(prep_out), str(prep_out), "--out", str(balanced),
              "--none_fraction", "0.25", "--seed", "4"])
        tsvs[name] = (prep_out.read_bytes(), balanced.read_bytes())
    capsys.readouterr()
    assert tsvs["port"] == tsvs["jax"]
    labels = {int(line.split(b"\t")[0]) for line in tsvs["port"][1].splitlines()}
    assert 0 in labels and len(labels) > 6
