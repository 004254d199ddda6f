"""`balance` workload: merge + class-balance prepared training data.

A copy of ``deepbinner_tpu/train/balance.py`` for the PyTorch port: the
same seed gives the same rows in the same order.
Reference parity: ``deepbinner/balance.py`` (SURVEY.md §2 item 6): merge
prep outputs, equalise per-barcode counts, include class-0 ("none")
samples at a controlled fraction, shuffle deterministically, write the
final training TSV.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from deepbinner_tpu_torch import NUM_BARCODES
from deepbinner_tpu_torch.train import data as data_io
from deepbinner_tpu_torch.utils.log import log, quit_with_error, section


def balance_samples(
    samples: List[Tuple[int, np.ndarray]],
    none_fraction: float,
    seed: int,
) -> List[Tuple[int, np.ndarray]]:
    rng = np.random.default_rng(seed)
    by_class: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    for item in samples:
        by_class.setdefault(item[0], []).append(item)

    barcode_counts = [len(by_class.get(k, ())) for k in range(1, NUM_BARCODES + 1)]
    present = [c for c in barcode_counts if c > 0]
    if not present:
        raise ValueError("no barcode samples present")
    per_class = min(present)

    balanced: List[Tuple[int, np.ndarray]] = []
    for k in range(1, NUM_BARCODES + 1):
        rows = by_class.get(k, [])
        if not rows:
            continue
        picks = rng.permutation(len(rows))[:per_class]
        balanced.extend(rows[i] for i in picks)

    if none_fraction > 0:
        none_rows = by_class.get(0, [])
        target = int(round(
            none_fraction / max(1.0 - none_fraction, 1e-9) * len(balanced)
        ))
        if none_rows:
            picks = rng.permutation(len(none_rows))[: min(target, len(none_rows))]
            balanced.extend(none_rows[i] for i in picks)

    order = rng.permutation(len(balanced))
    return [balanced[i] for i in order]


def balance(args) -> None:
    section("Balancing training data")
    samples: List[Tuple[int, np.ndarray]] = []
    for path in args.training_data:
        samples.extend(data_io.iterate_samples(path))
    log(f"  {len(samples)} samples from {len(args.training_data)} file(s)")
    if not samples:
        quit_with_error("no training samples found")
    try:
        balanced = balance_samples(samples, args.none_fraction, args.seed)
    except ValueError as error:
        quit_with_error(str(error))
    data_io.write_samples(args.out, balanced)
    counts: Dict[int, int] = {}
    for label, _ in balanced:
        counts[label] = counts.get(label, 0) + 1
    log(f"  wrote {len(balanced)} balanced samples to {args.out} "
        f"(per-class: {dict(sorted(counts.items()))})")
