"""FASTQ/FASTA iteration and writing, gzip-aware.

A copy of ``deepbinner_tpu/utils/seqio.py`` for the PyTorch port.
Reference parity: ``deepbinner/misc.py`` (fastq/fasta iterators used by
``bin.py``) — reconstructed per SURVEY.md §2 item 10.  The behaviours that
matter downstream:

- format auto-detection from the first non-empty character (``>`` fasta,
  ``@`` fastq),
- transparent gzip based on magic bytes (not file extension),
- read names are the first whitespace-delimited token of the header.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, Tuple

# (name, full_header, sequence, qualities_or_None)
SeqRecord = Tuple[str, str, str, str | None]

_GZIP_MAGIC = b"\x1f\x8b"


def _open_maybe_gzip(path: str | os.PathLike) -> io.TextIOWrapper:
    """Open a text file, transparently decompressing gzip (by magic bytes)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == _GZIP_MAGIC:
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "rt")


def detect_read_format(path: str | os.PathLike) -> str:
    """Return 'fasta', 'fastq' or raise ValueError, from the first character."""
    with _open_maybe_gzip(path) as handle:
        for line in handle:
            stripped = line.strip()
            if not stripped:
                continue
            if stripped.startswith(">"):
                return "fasta"
            if stripped.startswith("@"):
                return "fastq"
            raise ValueError(
                f"{path} is not fasta or fastq (first char {stripped[0]!r})"
            )
    raise ValueError(f"{path} is empty")


def iterate_fastq(path: str | os.PathLike) -> Iterator[SeqRecord]:
    with _open_maybe_gzip(path) as handle:
        while True:
            header = handle.readline()
            if not header:
                return
            header = header.rstrip("\r\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"bad fastq header in {path}: {header!r}")
            seq = handle.readline().rstrip("\r\n")
            plus = handle.readline()
            if not plus.startswith("+"):
                raise ValueError(f"bad fastq separator in {path}: {plus!r}")
            quals = handle.readline().rstrip("\r\n")
            if len(quals) != len(seq):
                raise ValueError(f"fastq length mismatch in {path} for {header!r}")
            tokens = header[1:].split()
            name = tokens[0] if tokens else ""
            yield name, header[1:], seq, quals


def iterate_fasta(path: str | os.PathLike) -> Iterator[SeqRecord]:
    with _open_maybe_gzip(path) as handle:
        name, header, chunks = None, None, []
        for line in handle:
            line = line.rstrip("\r\n")
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, header, "".join(chunks), None
                header = line[1:]
                tokens = header.split()
                name = tokens[0] if tokens else ""
                chunks = []
            else:
                if name is None:
                    raise ValueError(f"fasta {path} does not start with '>'")
                chunks.append(line)
        if name is not None:
            yield name, header, "".join(chunks), None


def iterate_reads(path: str | os.PathLike) -> Iterator[SeqRecord]:
    """Iterate records from a fasta or fastq file (gzip ok), auto-detected."""
    fmt = detect_read_format(path)
    return iterate_fastq(path) if fmt == "fastq" else iterate_fasta(path)


def format_record(record: SeqRecord, fmt: str) -> str:
    """Serialise a record back out in the given format."""
    _, header, seq, quals = record
    if fmt == "fastq":
        if quals is None:  # fasta→fastq is lossy; refuse silently inventing quals
            raise ValueError("cannot write fastq without qualities")
        return f"@{header}\n{seq}\n+\n{quals}\n"
    return f">{header}\n{seq}\n"
