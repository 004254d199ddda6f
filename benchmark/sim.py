"""The squiggle simulator the benchmark's reads come from.

A frozen copy of the signal model of ``deepbinner_tpu_torch/utils/simulate.py``
at commit 402717dbde1c47220f6674dc523b70c64264754a: the same pore table
(4^6 k-mer levels drawn from a fixed seed), dwell of 4 + Poisson(5)
samples per base (mean 9), Gaussian noise of 14 DAC units, and an open-pore
segment at the read start, rounded and clipped to int16.  Two departures,
both for speed and neither changing the distribution: DNA is drawn with
one vectorised call instead of a Python loop, and :func:`squiggle` takes
the generator it draws from.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

KMER = 6
OPEN_PORE_LEVEL = 560.0
OPEN_PORE_NOISE = 6.0
SIGNAL_MEAN = 450.0
SIGNAL_SPREAD = 55.0
SIGNAL_NOISE = 14.0
MEAN_DWELL = 9.0  # samples per base
_BASES = np.frombuffer(b"ACGT", np.uint8)
_PORE_TABLE: Optional[np.ndarray] = None


def _seeded_rng(*parts: str) -> np.random.Generator:
    digest = hashlib.sha256("|".join(parts).encode()).digest()
    return np.random.default_rng(np.frombuffer(digest[:16], dtype=np.uint64))


def pore_table() -> np.ndarray:
    """All 4^KMER current levels (the simulator's seeded table)."""
    global _PORE_TABLE
    if _PORE_TABLE is None:
        rng = _seeded_rng("pore-model-table")
        _PORE_TABLE = (SIGNAL_MEAN + SIGNAL_SPREAD
                       * rng.standard_normal(4 ** KMER)).astype(np.float32)
    return _PORE_TABLE


def random_dna(rng: np.random.Generator, length: int) -> str:
    return _BASES[rng.integers(0, 4, length)].tobytes().decode()


def _levels(seq: str) -> np.ndarray:
    codes = np.frombuffer(seq.encode(), np.uint8)
    lut = np.zeros(256, np.int64)
    for index, char in enumerate(b"ACGT"):
        lut[char] = index
    digits = lut[codes]
    weights = 4 ** np.arange(KMER - 1, -1, -1)
    return pore_table()[np.lib.stride_tricks.sliding_window_view(
        digits, KMER) @ weights]


def squiggle(seq: str, rng: np.random.Generator) -> np.ndarray:
    """DNA → float32 current: one level per k-mer, held for 4 + Poisson(5)
    samples, plus Gaussian noise."""
    if len(seq) < KMER:
        return np.zeros(0, np.float32)
    levels = _levels(seq)
    dwells = 4 + rng.poisson(MEAN_DWELL - 4.0, levels.size)
    signal = np.repeat(levels, dwells).astype(np.float32)
    signal += SIGNAL_NOISE * rng.standard_normal(signal.size).astype(np.float32)
    return signal


def open_pore(rng: np.random.Generator, length: int) -> np.ndarray:
    return (OPEN_PORE_LEVEL + OPEN_PORE_NOISE
            * rng.standard_normal(length)).astype(np.float32)


def digitise(signal: np.ndarray) -> np.ndarray:
    """Float current → int16 DAC values, as the simulator stores them."""
    return np.clip(np.round(signal), -32000, 32000).astype(np.int16)
