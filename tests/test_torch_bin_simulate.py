"""The port's `bin` and `simulate` subcommands against the JAX CLI's.

`bin` must write byte-identical gzipped bins from the same call table and
reads (FASTQ, FASTA, gzipped or not), send unclassified reads to ``none``
and refuse corrupt call strings as the JAX CLI does
(``tests/test_cli.py``).  `simulate` must write the same truth table,
FASTQ and dataset description byte for byte, and the same reads in each
container (compared by their decoded signals: zstd may pack them into
other bytes).
"""

import gzip
import os

import numpy as np
import pytest

from deepbinner_tpu.cli.main import main as jax_main
from deepbinner_tpu.utils import fast5 as jax_fast5
from deepbinner_tpu_torch.cli.main import main as port_main
from deepbinner_tpu_torch.utils import fast5 as port_fast5


def _records(seed, count=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        seq = "".join("ACGT"[b] for b in rng.integers(0, 4, int(rng.integers(5, 90))))
        quals = "".join(chr(33 + int(q)) for q in rng.integers(0, 40, len(seq)))
        out.append((f"read_{i:03d}", f"read_{i:03d} ch={i} extra", seq, quals))
    return out


def _write_reads(path, records, fmt, gz):
    if fmt == "fastq":
        text = "".join(f"@{h}\n{s}\n+\n{q}\n" for _n, h, s, q in records)
    else:  # multi-line FASTA
        text = "".join(f">{h}\n" + "".join(s[k:k + 30] + "\n"
                                            for k in range(0, len(s), 30))
                       for _n, h, s, _q in records)
    if gz:
        with gzip.open(path, "wt") as handle:
            handle.write(text)
    else:
        path.write_text(text)


def _classes(path, records, seed):
    rng = np.random.default_rng(seed)
    lines = ["read_ID\tbarcode_call"]
    for name, *_rest in records:
        call = int(rng.integers(0, 13))
        lines.append(f"{name}\t{'none' if call == 0 else f'barcode{call:02d}'}")
    path.write_text("\n".join(lines) + "\n")


def _bin(main, classes, reads, out_dir, capsys):
    main(["bin", "--classes", str(classes), "--reads", str(reads),
          "--out_dir", str(out_dir)])
    capsys.readouterr()
    return {name: (out_dir / name).read_bytes()
            for name in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("fmt,gz", [("fastq", False), ("fasta", False),
                                    ("fastq", True), ("fasta", True)])
def test_bin_byte_identical_to_jax(tmp_path, capsys, fmt, gz):
    records = _records(1)
    reads = tmp_path / f"reads.{fmt}{'.gz' if gz else ''}"
    _write_reads(reads, records, fmt, gz)
    classes = tmp_path / "calls.tsv"
    _classes(classes, records, 2)
    want = _bin(jax_main, classes, reads, tmp_path / "jax", capsys)
    got = _bin(port_main, classes, reads, tmp_path / "port", capsys)
    assert sorted(got) == sorted(want)
    assert all(name.endswith(f".{fmt}.gz") for name in got)
    assert got == want
    total = 0
    for data in got.values():
        lines = gzip.decompress(data).decode().count("\n")
        total += lines // (4 if fmt == "fastq" else 2)  # one-line records
    assert total == len(records)


def test_unclassified_reads_go_to_none(tmp_path, capsys):
    records = _records(3)
    reads = tmp_path / "reads.fastq"
    _write_reads(reads, records, "fastq", False)
    classes = tmp_path / "calls.tsv"
    classes.write_text(f"{records[0][0]}\tbarcode05\n")  # one read classified
    got = _bin(port_main, classes, reads, tmp_path / "port", capsys)
    assert got == _bin(jax_main, classes, reads, tmp_path / "jax", capsys)
    assert sorted(got) == ["barcode05.fastq.gz", "none.fastq.gz"]
    none = gzip.decompress(got["none.fastq.gz"]).decode()
    assert none.count("\n+\n") == len(records) - 1


@pytest.mark.parametrize("call", ["../escape", "barcode13", "barcode00",
                                  "BARCODE01", "barcode1x", ""])
def test_bin_rejects_corrupt_call_strings(tmp_path, capsys, call):
    """Call strings become output file names: garbage must fail loudly."""
    reads = tmp_path / "r.fastq"
    reads.write_text("@read1\nACGT\n+\n!!!!\n")
    classes = tmp_path / "calls.tsv"
    classes.write_text(f"read1\t{call}\n")
    for name, main in (("jax", jax_main), ("port", port_main)):
        with pytest.raises(SystemExit) as exc:
            main(["bin", "--classes", str(classes), "--reads", str(reads),
                  "--out_dir", str(tmp_path / name)])
        assert exc.value.code != 0
    assert "unrecognised barcode call" in capsys.readouterr().err
    assert not (tmp_path / "escape.fastq.gz").exists()
    assert not os.path.exists(tmp_path / "port")


@pytest.mark.parametrize("missing", ["classes", "reads"])
def test_bin_missing_input_exits(tmp_path, capsys, missing):
    reads = tmp_path / "r.fastq"
    reads.write_text("@read1\nACGT\n+\n!!!!\n")
    classes = tmp_path / "calls.tsv"
    classes.write_text("read1\tnone\n")
    (reads if missing == "reads" else classes).unlink()
    with pytest.raises(SystemExit) as exc:
        port_main(["bin", "--classes", str(classes), "--reads", str(reads),
                   "--out_dir", str(tmp_path / "bins")])
    assert exc.value.code != 0
    assert "not found" in capsys.readouterr().err


def _signals(fast5_module, root):
    return {read_id: signal
            for path in fast5_module.find_signal_files(root)
            for read_id, signal in fast5_module.read_signal_file(path)}


@pytest.mark.parametrize("container", ["fast5", "multifast5", "pod5"])
def test_simulate_writes_what_jax_writes(tmp_path, capsys, container):
    argv = ["--reads_per_barcode", "1", "--none_reads", "2",
            "--genome_length", "300", "--seed", "9", "--container", container,
            "--reads_per_container", "5"]
    jax_main(["simulate", str(tmp_path / "jax"), *argv])
    port_main(["simulate", str(tmp_path / "port"), *argv])
    assert "wrote 14 simulated reads" in capsys.readouterr().err
    for name in ("truth.tsv", "reads.fastq", "dataset.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    assert (sorted(os.listdir(tmp_path / "port" / "fast5s"))
            == sorted(os.listdir(tmp_path / "jax" / "fast5s")))
    want = _signals(jax_fast5, tmp_path / "jax")
    got = _signals(port_fast5, tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == 14
    for read_id, signal in want.items():
        np.testing.assert_array_equal(got[read_id], signal)
    # each package reads the other's containers to the same signals
    for read_id, signal in _signals(jax_fast5, tmp_path / "port").items():
        np.testing.assert_array_equal(signal, want[read_id])
