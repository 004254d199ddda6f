"""The port's FASTQ/FASTA reader against the JAX package's.

Mirrors the FASTQ/FASTA cases of ``tests/test_seqio.py``: each input goes
through both packages' ``seqio``, whose records (and errors) must be
equal, and the port's are also checked against the expected values.
"""

import gzip

import pytest

from deepbinner_tpu.utils import seqio as jax_seqio
from deepbinner_tpu_torch.utils import seqio

FASTQ = "@read1 extra info\nACGT\n+\nIIII\n@read2\nGGCC\n+\n!!!!\n"
FASTA = ">read1 extra\nACGT\nACGT\n>read2\nGG\n"


def _both(read, path):
    got = list(getattr(seqio, read)(path))
    assert got == list(getattr(jax_seqio, read)(path))
    return got


def test_fastq_roundtrip(tmp_path):
    path = tmp_path / "reads.fastq"
    path.write_text(FASTQ)
    records = _both("iterate_reads", path)
    assert [r[0] for r in records] == ["read1", "read2"]
    assert records[0][1:] == ("read1 extra info", "ACGT", "IIII")
    for record in records:
        for fmt in ("fastq", "fasta"):
            assert (seqio.format_record(record, fmt)
                    == jax_seqio.format_record(record, fmt))
    assert seqio.format_record(records[1], "fastq") == "@read2\nGGCC\n+\n!!!!\n"


@pytest.mark.parametrize("text,fmt", [(FASTQ, "fastq"), (FASTA, "fasta")])
def test_gzip_detected_by_magic_bytes(tmp_path, text, fmt):
    path = tmp_path / "reads.weirdext"
    with gzip.open(path, "wt") as handle:
        handle.write(text)
    assert seqio.detect_read_format(path) == fmt
    assert jax_seqio.detect_read_format(path) == fmt
    assert len(_both("iterate_reads", path)) == 2


def test_fasta_multiline(tmp_path):
    path = tmp_path / "reads.fasta"
    path.write_text(FASTA)
    records = _both("iterate_reads", path)
    assert records[0][2] == "ACGTACGT"  # multi-line concatenated
    assert records[0][3] is None
    assert records[1][0] == "read2"
    with pytest.raises(ValueError):
        seqio.format_record(records[0], "fastq")  # no qualities to write


@pytest.mark.parametrize("text", ["not a reads file\n", "", "\n\n"])
def test_bad_format(tmp_path, text):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError):
        seqio.detect_read_format(path)
    with pytest.raises(ValueError):
        jax_seqio.detect_read_format(path)


@pytest.mark.parametrize("text", [
    "@read1\nACGT\n-\nIIII\n",   # bad separator
    "@read1\nACGT\n+\nIII\n",    # quality length mismatch
    "read1\nACGT\n+\nIIII\n",    # header without '@'
])
def test_bad_fastq_records(tmp_path, text):
    path = tmp_path / "bad.fastq"
    path.write_text(text)
    with pytest.raises(ValueError):
        list(seqio.iterate_fastq(path))
    with pytest.raises(ValueError):
        list(jax_seqio.iterate_fastq(path))


def test_crlf_files_parse_clean(tmp_path):
    """Windows line endings must not leak '\\r' into sequences/qualities."""
    fq = tmp_path / "crlf.fastq"
    fq.write_bytes(b"@read1 extra\r\nACGT\r\n+\r\n!!!!\r\n")
    ((name, _header, seq, quals),) = _both("iterate_fastq", fq)
    assert (name, seq, quals) == ("read1", "ACGT", "!!!!")
    fa = tmp_path / "crlf.fasta"
    fa.write_bytes(b">read2\r\nACGT\r\nTTAA\r\n")
    ((name2, _h, seq2, _q),) = _both("iterate_fasta", fa)
    assert (name2, seq2) == ("read2", "ACGTTTAA")


@pytest.mark.parametrize("read,data", [
    ("iterate_fastq", b"@ \nAC\n+\n!!\n"),
    ("iterate_fasta", b">  \nAC\n"),
])
def test_whitespace_only_header_does_not_crash(tmp_path, read, data):
    path = tmp_path / "ws.txt"
    path.write_bytes(data)
    ((name, _h, seq, _q),) = _both(read, path)
    assert name == "" and seq == "AC"
