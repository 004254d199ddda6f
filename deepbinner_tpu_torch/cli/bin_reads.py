"""`bin` workload: route basecalled reads into per-barcode files.

Counterpart of ``deepbinner_tpu/cli/bin_reads.py``, and of the reference's
``deepbinner/bin.py::bin_reads`` (SURVEY.md §3.3).  Pure host text
processing — no torch, no h5py — and the step whose output must be
byte-identical across single- and multi-host classify runs.  Determinism
comes from (a) the classification table being canonically merged upstream and
(b) reads being written in input-file order here.

Output files are gzipped, named ``barcode01`` .. ``barcode12`` and ``none``,
in the input's format (fastq/fasta).
"""

from __future__ import annotations

import gzip
import os
from typing import Dict

from deepbinner_tpu_torch.utils import seqio, table
from deepbinner_tpu_torch.utils.log import log, quit_with_error, section


def bin_reads(args) -> None:
    if not os.path.isfile(args.classes):
        quit_with_error(f"classification file not found: {args.classes}")
    if not os.path.isfile(args.reads):
        quit_with_error(f"reads file not found: {args.reads}")

    section("Binning reads")
    calls = table.parse_classification_file(args.classes)
    # Validate every call up front: call strings become output FILENAMES, so
    # a corrupt/hand-edited table must fail loudly here, not scatter files
    # (or escape out_dir via a path-like "call").
    for read_id, call in calls.items():
        try:
            table.call_to_class_index(call)
        except ValueError:
            quit_with_error(
                f"{args.classes}: unrecognised barcode call {call!r} for "
                f"read {read_id!r} (expected none/barcode01..12)"
            )
    log(f"  {len(calls)} classified reads in {args.classes}")

    fmt = seqio.detect_read_format(args.reads)
    os.makedirs(args.out_dir, exist_ok=True)

    handles: Dict[str, gzip.GzipFile] = {}
    counts: Dict[str, int] = {}
    missing = 0

    def handle_for(call: str):
        if call not in handles:
            path = os.path.join(args.out_dir, f"{call}.{fmt}.gz")
            # mtime=0 + fixed filename in the gzip header → byte-identical
            # output for identical input, regardless of when/where it runs.
            raw = open(path, "wb")
            handles[call] = gzip.GzipFile(
                filename="", mode="wb", fileobj=raw, mtime=0
            )
            counts[call] = 0
        return handles[call]

    records = (seqio.iterate_fastq(args.reads) if fmt == "fastq"
               else seqio.iterate_fasta(args.reads))  # fmt already detected
    try:
        for record in records:
            call = calls.get(record[0])
            if call is None:
                call = table.NONE_CALL
                missing += 1
            out = handle_for(call)
            out.write(seqio.format_record(record, fmt).encode())
            counts[call] += 1
    finally:
        for out in handles.values():
            fileobj = out.fileobj
            out.close()
            fileobj.close()  # close the underlying raw file too

    section("Read counts per bin")
    for call in sorted(counts):
        log(f"  {call}: {counts[call]}")
    if missing:
        log(f"  ({missing} reads had no classification → binned as none)")
