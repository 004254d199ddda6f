"""A traffic mix's corpus: simulated reads in pod5 files, made from a seed.

A traffic file (``traffic/<name>.json``) gives the number of reads, the
reads per file, the distribution of genomic read lengths, the share of
reads without a barcode and the open-pore lengths.  The *set* of lengths,
barcodes and open-pore lengths is fixed by the traffic file (quantiles of
its distributions, equal barcode counts) and only its order comes from the
seed, so every seed gives the reader pool and the card the same work; the
signals themselves (DNA, dwells, noise, read ids) come from the seed.

Each read is the simulator's (``sim.py``): open pore, the kit's start
region (adapter, barcode and flanks), genomic sequence, and for the native
kit's barcoded reads the end barcode and adapter.  The first and last
``exact_flank_bases`` of the genomic part are simulated base by base; a
longer read's body between them is a slice of one long squiggle simulated
once per run from the seed (``body_pool_bases``), with the simulator's
levels, dwells and noise, so its bytes on disk and its decode cost are a
real read's.  The heads and tails that the classifier reads are always
simulated in full.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import uuid
from typing import List

import numpy as np

from benchmark import kits, pod5w, sim


@dataclasses.dataclass
class Corpus:
    """The files, and what the reference needs of each read: its id, true
    barcode, length in samples, and its first and last ``keep`` samples
    (zero-padded past a shorter read; the tail in read order)."""

    paths: List[str]
    read_ids: List[str]
    barcodes: np.ndarray  # (n,) int: 0 = no barcode
    lengths: np.ndarray   # (n,) int64 samples
    heads: np.ndarray     # (n, keep) int16
    tails: np.ndarray     # (n, keep) int16

    @property
    def reads(self) -> int:
        return len(self.read_ids)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64,
                                                         *stream]))


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def genomic_lengths(traffic: dict) -> np.ndarray:
    """The traffic's n genomic lengths in bases, at its distribution's
    quantiles (sorted)."""
    spec = traffic["genomic_bases"]
    if spec["distribution"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['distribution']!r}")
    normal = statistics.NormalDist()
    z = np.array([normal.inv_cdf(p) for p in _quantiles(traffic["reads"])])
    lengths = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.round(lengths), spec["min"], spec["max"]).astype(np.int64)


def barcode_set(traffic: dict) -> np.ndarray:
    """The traffic's barcodes: ``no_barcode_share`` of the reads without
    one, the rest spread evenly over its barcodes (sorted)."""
    n = traffic["reads"]
    low, high = traffic["barcodes"]
    none = int(round(traffic["no_barcode_share"] * n))
    choices = np.arange(low, high + 1)
    rest = n - none
    counts = np.full(choices.size, rest // choices.size)
    counts[: rest % choices.size] += 1
    return np.concatenate([np.zeros(none, np.int64),
                           np.repeat(choices, counts)])


def open_pore_set(traffic: dict) -> np.ndarray:
    low, high = traffic["open_pore_samples"]
    return (low + np.floor((high - low) * _quantiles(traffic["reads"]))
            ).astype(np.int64)


def _make_file(task: tuple) -> tuple:
    """One file's reads: (ids, sizes, heads, tails); written to ``path``
    unless it is None."""
    (seed, kit, keep, flank, first, lengths, barcodes, pores, pool,
     path) = task
    read_ids: List[str] = []
    sizes = np.zeros(len(lengths), np.int64)
    heads = np.zeros((len(lengths), keep), np.int16)
    tails = np.zeros((len(lengths), keep), np.int16)
    reads = []
    for j, (genomic, barcode, pore) in enumerate(zip(lengths, barcodes, pores)):
        rng = _rng(seed, 2, first + j)
        read_id = str(uuid.UUID(bytes=rng.bytes(16), version=4))
        genomic, barcode = int(genomic), int(barcode)
        head = min(flank, genomic // 2)
        tail = min(flank, genomic - head)
        parts = [sim.open_pore(rng, int(pore)),
                 sim.squiggle(kits.start_region(kit, barcode)
                              + sim.random_dna(rng, head), rng)]
        body = int(round((genomic - head - tail) * sim.MEAN_DWELL))
        if body > 0:
            offset = int(rng.integers(pool.size))
            parts.append(np.take(pool, np.arange(offset, offset + body),
                                 mode="wrap"))
        parts.append(sim.squiggle(sim.random_dna(rng, tail)
                                  + kits.end_region(kit, barcode), rng))
        signal = sim.digitise(np.concatenate(parts))
        k = min(signal.size, keep)
        heads[j, :k] = signal[:k]
        tails[j, :k] = signal[signal.size - k:]
        sizes[j] = signal.size
        read_ids.append(read_id)
        reads.append((read_id, signal))
    if path is not None:
        pod5w.write_pod5(path, reads)
    return read_ids, sizes, heads, tails


def generate(traffic: dict, kit: str, seed: int, directory: str, keep: int,
             write: bool = True, workers: int = 1) -> Corpus:
    """Make the corpus of ``traffic`` for ``kit`` from ``seed``; write its
    pod5 files into ``directory`` (unless ``write`` is False).  With
    ``workers`` above 1 the files are made by that many spawned processes,
    all of which have ended when this returns; the corpus is the same."""
    n = traffic["reads"]
    per_file = traffic["reads_per_file"]
    layout = _rng(seed, 0)
    lengths = layout.permutation(genomic_lengths(traffic))
    barcodes = layout.permutation(barcode_set(traffic))
    pores = layout.permutation(open_pore_set(traffic))
    flank = traffic["exact_flank_bases"]
    pool = np.zeros(0, np.float32)
    if (lengths > 2 * flank).any():
        pool_rng = _rng(seed, 1)
        pool = sim.squiggle(sim.random_dna(pool_rng, traffic["body_pool_bases"]),
                            pool_rng)
    if write:
        os.makedirs(directory, exist_ok=True)
    tasks, paths = [], []
    for first in range(0, n, per_file):
        part = slice(first, min(first + per_file, n))
        path = None
        if write:
            path = os.path.join(directory, f"batch_{first // per_file:04d}.pod5")
            paths.append(path)
        tasks.append((seed, kit, keep, flank, first, lengths[part],
                      barcodes[part], pores[part], pool, path))
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(min(workers, len(tasks)),
                                 mp_context=multiprocessing.get_context("spawn")
                                 ) as executor:
            files = list(executor.map(_make_file, tasks))
    else:
        files = [_make_file(task) for task in tasks]
    return Corpus(paths, [i for f in files for i in f[0]], barcodes,
                  np.concatenate([f[1] for f in files]),
                  np.concatenate([f[2] for f in files]),
                  np.concatenate([f[3] for f in files]))
