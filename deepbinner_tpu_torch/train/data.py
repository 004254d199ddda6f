"""Training-sample TSV codec and in-memory dataset.

A copy of ``deepbinner_tpu/train/data.py`` for the PyTorch port.
Reference parity: the training rows emitted by ``deepbinner/prep.py`` and
consumed by ``balance``/``train`` — ``label<TAB>signal-values`` (SURVEY.md
§3.4).  Signal values are comma-separated raw DAC ints; every row stores
``signal_size`` samples (longer than the CNN input so train-time random
cropping can augment — SURVEY.md §2 item 7).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np


def format_sample(label: int, signal: np.ndarray) -> str:
    return f"{label}\t{','.join(str(int(v)) for v in signal)}"


def iterate_samples(path: str | os.PathLike) -> Iterator[Tuple[int, np.ndarray]]:
    with open(path) as handle:
        for line in handle:
            line = line.rstrip("\n")
            if not line:
                continue
            label_str, signal_str = line.split("\t")
            yield int(label_str), np.array(signal_str.split(","), dtype=np.int16)


def write_samples(
    path: str | os.PathLike, samples: List[Tuple[int, np.ndarray]]
) -> None:
    with open(path, "w") as handle:
        for label, signal in samples:
            handle.write(format_sample(label, signal) + "\n")


def load_training_set(
    paths: List[str] | str,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load TSV(s) → (signals (N, signal_size) float32, labels (N,) int32).

    All rows must share one signal length (prep guarantees it); mismatched
    rows raise.
    """
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    signals: List[np.ndarray] = []
    labels: List[int] = []
    size = None
    for path in paths:
        for label, signal in iterate_samples(path):
            if size is None:
                size = signal.size
            elif signal.size != size:
                raise ValueError(
                    f"inconsistent sample size in {path}: {signal.size} vs {size}"
                )
            signals.append(signal)
            labels.append(label)
    if not signals:
        raise ValueError(f"no training samples in {paths}")
    return (
        np.stack(signals).astype(np.float32),
        np.asarray(labels, dtype=np.int32),
    )
