"""`prep` workload: build labelled training samples from sequenced runs.

A copy of ``deepbinner_tpu/train/prep.py`` for the PyTorch port, on the
port's own fast5, seqio, simulate and table modules.  It reads fast5 only,
as the JAX package does.
Reference parity: ``deepbinner/prep.py`` (SURVEY.md §2 item 5, §3.4) — the
reference's largest module.  Per read:

1. locate the barcode in the *basecalled* sequence (the reference parses
   Porechop output and/or aligns known barcode+adapter sequences; here an
   approximate sub-sequence search against the kit's barcode set),
2. map base coordinates back to **raw-signal coordinates** via the
   basecaller's move/dwell table stored in the fast5,
3. extract the signal region around the barcode (with margin) and emit a
   ``label<TAB>signal-values`` training row of exactly ``signal_size``
   samples (> CNN input, enabling random-crop augmentation at train time),
4. additionally emit a class-0 ("none") row cut from mid-read genomic
   signal, giving `balance` real no-barcode examples.

For ``--end end`` (EXP-NBD103 read ends), the reverse-complement barcode is
located near the read's 3' end and the extracted signal is **reversed**, so
end-model training data matches what classify feeds the end model (the
executor reverses end-of-read signal; see runner.executor.build_batch).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepbinner_tpu_torch.train import data as data_io
from deepbinner_tpu_torch.utils import seqio
from deepbinner_tpu_torch.utils.fast5 import (
    find_all_fast5s,
    get_move_tables,
    iterate_reads_in_fast5,
)
from deepbinner_tpu_torch.utils.log import Progress, log, quit_with_error, section
from deepbinner_tpu_torch.utils.simulate import barcode_sequences, reverse_complement


def approximate_find(haystack: str, needle: str, max_mismatch: int) -> int:
    """Best sliding-window Hamming match of `needle` in `haystack`.

    Returns the start index, or -1 if no window has ≤ max_mismatch
    mismatches.  Vectorised over positions (numpy byte comparison) — fast
    enough to scan every read without an alignment library (edlib/mappy are
    optional deps of the reference; neither is available here).
    """
    n, m = len(haystack), len(needle)
    if m == 0 or n < m:
        return -1
    hay = np.frombuffer(haystack.encode(), dtype=np.uint8)
    ndl = np.frombuffer(needle.encode(), dtype=np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(hay, m)
    mismatches = np.count_nonzero(windows != ndl[None, :], axis=1)
    best = int(np.argmin(mismatches))
    if int(mismatches[best]) > max_mismatch:
        return -1
    return best


def _semi_global_end_scores(
    hay: np.ndarray, ndl: np.ndarray, anchored_start: bool = False
) -> np.ndarray:
    """Edit distances of the best `ndl` alignment ending at each hay position.

    Semi-global (infix) Levenshtein DP: the needle must align end-to-end,
    the haystack end is free.  Returns ``ends`` of shape (n+1,) where
    ``ends[j]`` is the minimum edit distance of the needle against a
    haystack substring ending at position j — starting anywhere when
    ``anchored_start`` is False, or exactly at position 0 (i.e. against the
    full prefix ``hay[:j]``) when True.

    The row recurrence's left-to-right gap term is closed with a prefix-min
    identity (``min_k f[k] + (j-k)`` = running-min of ``f - j`` plus ``j``),
    so each needle row is one vectorised numpy pass — no per-cell Python.
    """
    n = hay.size
    js = np.arange(n + 1, dtype=np.int32)
    prev = js.copy() if anchored_start else np.zeros(n + 1, np.int32)
    for i in range(1, ndl.size + 1):
        sub = prev[:-1] + (hay != ndl[i - 1]).astype(np.int32)
        up = prev[1:] + 1
        f = np.empty(n + 1, np.int32)
        f[0] = i  # needle prefix vs empty haystack
        f[1:] = np.minimum(sub, up)
        prev = np.minimum.accumulate(f - js) + js
    return prev


def edit_distance_find(
    haystack: str, needle: str, max_edits: int
) -> Optional[Tuple[int, int, int]]:
    """Best indel-tolerant occurrence of `needle` in `haystack`.

    Returns ``(start, end, edits)`` of the lowest-edit-distance alignment
    (semi-global Levenshtein), or None if every alignment needs more than
    ``max_edits``.  This is what survives real nanopore basecalls (5-15%
    indel error) where a fixed-width Hamming scan finds nothing — the
    reference gets the same tolerance from Porechop/edlib alignment
    (deepbinner/prep.py :: prep, SURVEY.md §2 item 5).
    """
    n, m = len(haystack), len(needle)
    if m == 0 or n == 0:
        return None
    hay = np.frombuffer(haystack.encode(), dtype=np.uint8)
    ndl = np.frombuffer(needle.encode(), dtype=np.uint8)
    ends = _semi_global_end_scores(hay, ndl)
    end = int(np.argmin(ends))
    edits = int(ends[end])
    if edits > max_edits:
        return None
    # Locate the match start: align the reversed needle against the reversed
    # haystack prefix with the start anchored at `end` (prefix alignment),
    # so r_ends[k] = distance(needle, hay[end-k:end]).  Among equally-scoring
    # starts prefer the match length closest to the needle length.
    r_ends = _semi_global_end_scores(hay[:end][::-1], ndl[::-1],
                                     anchored_start=True)
    candidates = np.flatnonzero(r_ends == edits)
    length = int(candidates[np.argmin(np.abs(candidates - m))])
    return end - length, end, edits


def base_range_to_signal_range(
    first_sample: int, dwells: np.ndarray, base_start: int, base_end: int
) -> Tuple[int, int]:
    """Map a [base_start, base_end) basecall range to raw-signal samples."""
    boundaries = first_sample + np.concatenate([[0], np.cumsum(dwells)])
    base_start = max(0, min(base_start, len(dwells)))
    base_end = max(0, min(base_end, len(dwells)))
    return int(boundaries[base_start]), int(boundaries[base_end])


def _cut_sample(
    signal: np.ndarray, start: int, end: int, signal_size: int, margin: int
) -> Optional[np.ndarray]:
    """Cut a `signal_size` window containing [start-margin, end+margin)."""
    lo = max(0, start - margin)
    hi = min(signal.size, end + margin)
    if hi - lo <= 0:
        return None
    # Centre the barcode region within the fixed-size window where possible.
    centre = (lo + hi) // 2
    cut_lo = max(0, centre - signal_size // 2)
    cut_hi = cut_lo + signal_size
    if cut_hi > signal.size:
        cut_hi = signal.size
        cut_lo = max(0, cut_hi - signal_size)
    if cut_hi - cut_lo < signal_size:
        return None  # read too short for a full training sample
    return signal[cut_lo:cut_hi]


def extract_training_samples(
    signal: np.ndarray,
    sequence: str,
    move: Tuple[int, np.ndarray],
    kit: str,
    end: str,
    signal_size: int,
    margin: int,
    max_edits: int = 5,
    search_bases: int = 400,
    none_rows: int = 1,
    known_barcode: Optional[int] = None,
    synthetic_barcodes: bool = False,
) -> List[Tuple[int, np.ndarray]]:
    """All training rows derivable from one read (barcode row + none row).

    Barcode localisation is indel-tolerant (semi-global edit distance, see
    :func:`edit_distance_find`): real nanopore basecalls carry 5-15% indel
    error, which a fixed-width Hamming scan cannot survive.  All kit
    barcodes are scored and the lowest-edit match wins, like the
    reference's best-alignment selection (deepbinner/prep.py :: prep).

    When an external demultiplexer already assigned this read a barcode
    (the reference's Porechop-output mode — SURVEY.md §2 item 5), pass it
    as ``known_barcode``: only that barcode is aligned (to find *where* it
    sits), with a relaxed edit budget since there is no multiple-testing
    across 12 candidates.  ``known_barcode=0`` forces the read to supply
    "none" rows only.
    """
    first_sample, dwells = move
    barcodes = barcode_sequences(kit, synthetic=synthetic_barcodes)
    samples: List[Tuple[int, np.ndarray]] = []

    if end == "start":
        search_region = sequence[:search_bases]
        offset = 0
    else:
        if kit != "EXP-NBD103":
            raise ValueError("read-end training data only exists for EXP-NBD103")
        offset = max(0, len(sequence) - search_bases)
        search_region = sequence[offset:]

    if known_barcode is not None:
        candidates = (
            [] if known_barcode == 0 else
            [(known_barcode, barcodes[known_barcode - 1])]
        )
        budget = max_edits + 2  # single hypothesis → no multiple-testing
    else:
        candidates = list(enumerate(barcodes, start=1))
        budget = max_edits

    best: Tuple[int, int, int, int] | None = None  # (edits, index, start, end)
    for index, barcode in candidates:
        probe = reverse_complement(barcode) if end == "end" else barcode
        hit = edit_distance_find(search_region, probe, budget)
        if hit is not None and (best is None or hit[2] < best[0]):
            best = (hit[2], index, offset + hit[0], offset + hit[1])
    if best is not None:
        _edits, index, base_start, base_end = best
        sig_start, sig_end = base_range_to_signal_range(
            first_sample, dwells, base_start, base_end
        )
        cut = _cut_sample(signal, sig_start, sig_end, signal_size, margin)
        if cut is not None:
            if end == "end":
                cut = cut[::-1]
            samples.append((index, cut))
        # Mid-read genomic signal is a clean "none" example (far from any
        # barcode) — one per barcoded read keeps class 0 supplied.
        none_bases = [len(dwells) // 2]
    elif known_barcode not in (None, 0):
        # An external demultiplexer says this read HAS a barcode, but we
        # could not localise it — the read-start region very likely still
        # contains barcode signal, so cutting "none" rows from it would
        # contaminate class 0 with barcode-bearing squiggle.  Skip the read
        # entirely (round-2 ADVICE, severity medium).
        return samples
    else:
        # No barcode found: the read-start (or read-end) region itself
        # supplies the "none" examples — adapter+genomic, exactly what
        # classify scans on a barcode-less read.  Classify examines ~13
        # windows across the whole scan region, so class 0 must cover the
        # same positional distribution: `none_rows` cuts spread across the
        # searched bases (single-position none training leaves deeper
        # windows off-distribution → false-positive barcode calls).
        limit = max(0, len(dwells) - 30)
        if end == "start":
            hi = min(search_bases, limit)
            none_bases = [
                min(50 + (i * max(hi - 50, 1)) // max(none_rows, 1), limit)
                for i in range(max(none_rows, 1))
            ]
        else:
            lo = max(0, len(dwells) - search_bases)
            none_bases = [
                max(0, len(dwells) - 80 - (i * max(len(dwells) - 80 - lo, 1))
                    // max(none_rows, 1))
                for i in range(max(none_rows, 1))
            ]
    for none_base in dict.fromkeys(none_bases):  # dedupe, keep order
        sig_start, sig_end = base_range_to_signal_range(
            first_sample, dwells, none_base, none_base + 24
        )
        cut = _cut_sample(signal, sig_start, sig_end, signal_size, margin)
        if cut is not None:
            if end == "end":
                cut = cut[::-1]
            samples.append((0, cut))
    return samples


def parse_porechop_bins(bin_dir: str) -> Dict[str, int]:
    """Read Porechop's ``-b`` output directory into read_id → class index.

    Reference parity: ``deepbinner/prep.py :: prep`` consumes Porechop's
    demultiplexing output directly (SURVEY.md §2 item 5).  Porechop's
    barcode-binning mode writes one reads file per bin — ``BC01.fastq.gz``
    … ``BC12.fastq.gz`` plus ``none.fastq.gz`` — which is its stable,
    documented output surface; this parser maps each binned read id back to
    its barcode class.  Bin names ``BC%02d``/``NB%02d``/``barcode%02d``
    (any case, .fastq/.fasta, gzipped or not) are accepted;
    ``none``/``unclassified`` map to class 0.

    PARITY-REVERIFY: if the reference parses Porechop's *stdout log* rather
    than its binned files, re-derive the exact format from
    deepbinner/prep.py once the mount is populated.
    """
    import re

    if not os.path.isdir(bin_dir):
        quit_with_error(f"--porechop expects Porechop's -b output directory; "
                        f"{bin_dir} is not a directory")
    assignments: Dict[str, int] = {}
    pattern = re.compile(r"^(?:bc|nb|barcode)(\d{1,2})$", re.IGNORECASE)
    recognised_files = 0
    for name in sorted(os.listdir(bin_dir)):
        stem = name
        for suffix in (".gz", ".fastq", ".fasta", ".fq", ".fa"):
            if stem.lower().endswith(suffix):
                stem = stem[: -len(suffix)]
        match = pattern.match(stem)
        if match:
            label = int(match.group(1))
            if not 1 <= label <= 12:
                continue
        elif stem.lower() in ("none", "unclassified"):
            label = 0
        else:
            continue
        recognised_files += 1
        for read_id, _name, _seq, _quals in seqio.iterate_reads(
            os.path.join(bin_dir, name)
        ):
            assignments[read_id] = label
    if not recognised_files:
        quit_with_error(f"no Porechop bin files (BC01.fastq[.gz] … none.fastq"
                        f"[.gz]) found in {bin_dir}")
    return assignments


def prep(args) -> None:
    section(f"Preparing {args.end}-of-read training data ({args.kit})")
    files = find_all_fast5s(args.fast5_dir)
    if not files:
        quit_with_error(f"no fast5 files in {args.fast5_dir}")
    if not os.path.isfile(args.reads):
        quit_with_error(f"reads file not found: {args.reads}")

    sequences: Dict[str, str] = {
        rec[0]: rec[2] for rec in seqio.iterate_reads(args.reads)
    }
    log(f"  {len(sequences)} basecalled reads, {len(files)} fast5 files")

    # External assignments (the reference's Porechop-output mode): a known
    # barcode per read restricts localisation to that barcode.  Two input
    # forms: --porechop (Porechop's -b bin directory, parsed directly) and
    # --assignments (a read_id→call TSV from any demultiplexer).
    assignments: Optional[Dict[str, int]] = None
    if getattr(args, "porechop", None):
        if getattr(args, "assignments", None):
            quit_with_error("--porechop and --assignments are exclusive")
        assignments = parse_porechop_bins(args.porechop)
        log(f"  {len(assignments)} Porechop bin assignments loaded "
            f"from {args.porechop}")
    elif getattr(args, "assignments", None):
        from deepbinner_tpu_torch.utils import table as table_mod

        raw = table_mod.parse_classification_file(args.assignments)
        assignments = {}
        unrecognised = 0
        for read_id, call in raw.items():
            try:
                assignments[read_id] = table_mod.call_to_class_index(call)
            except ValueError:
                # Foreign vocab ("unclassified", out-of-kit barcodes, …):
                # treat as not-assigned, matching the skip semantics of
                # reads absent from the table entirely.
                unrecognised += 1
        log(f"  {len(assignments)} external barcode assignments loaded"
            + (f" ({unrecognised} unrecognised call(s) ignored)"
               if unrecognised else ""))

    progress = Progress("reads prepped")
    rows: List[Tuple[int, np.ndarray]] = []
    skipped = 0
    no_move_files = 0
    for path in files:
        # One pass resolves every move table in the file: the root-level
        # Analyses group of single-read (albacore-era) files AND the
        # per-read read_<id>/Analyses groups of multi-read MinKNOW files.
        moves = get_move_tables(path)
        if not moves:
            no_move_files += 1
        for read_id, signal in iterate_reads_in_fast5(path):
            sequence = sequences.get(read_id)
            move = moves.get(read_id)
            if sequence is None or move is None:
                skipped += 1
                continue
            known = assignments.get(read_id) if assignments is not None else None
            if assignments is not None and known is None:
                skipped += 1  # assignments given but this read has none
                continue
            rows.extend(
                extract_training_samples(
                    signal, sequence, move, args.kit, args.end,
                    args.signal_size, args.margin, known_barcode=known,
                    synthetic_barcodes=bool(
                        getattr(args, "synthetic_barcodes", False)),
                )
            )
            progress.update()
    progress.finish()
    if skipped:
        log(f"  skipped {skipped} reads (no basecall or no move table; "
            f"{no_move_files} file(s) carried no move tables at all)")
    if not rows:
        quit_with_error("no training samples extracted")
    data_io.write_samples(args.out, rows)
    counts: Dict[int, int] = {}
    for label, _ in rows:
        counts[label] = counts.get(label, 0) + 1
    log(f"  wrote {len(rows)} samples to {args.out} "
        f"(per-class: {dict(sorted(counts.items()))})")
