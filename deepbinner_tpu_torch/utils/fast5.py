"""fast5 (HDF5) raw-signal reading and writing.

Reference parity: ``deepbinner/load_fast5s.py::find_all_fast5s`` /
``get_read_id_and_signal`` (SURVEY.md §2 item 10).  The reference reads the
albacore-era *single-read* layout ``Raw/Reads/Read_*/Signal`` with the read id
in the ``read_id`` attribute.  The rebuild also understands the *multi-read*
layout (``/read_<uuid>/Raw/Signal``) so modern MinKNOW output works.

This module reads through h5py.  The C++ reader of
:mod:`deepbinner_tpu_torch.native.fast5_reader` reads the same layouts
through the HDF5 runtime library without h5py; `classify` uses it where it
can be built (``--native_reader`` / ``--no_native_reader``).

Writing (:func:`write_single_read_fast5`) exists for fixtures, the signal
simulator, and tests; the reference never writes fast5s.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


def find_all_fast5s(directory: str | os.PathLike) -> List[str]:
    """Recursively find ``*.fast5`` under `directory`, sorted.

    The reference walks with os.walk; we additionally *sort* the result so
    that multi-host file sharding (stride by process index) is deterministic
    regardless of filesystem enumeration order (SURVEY.md §7 build step 6).
    """
    fast5s: List[str] = []
    for root, _dirs, files in os.walk(directory):
        for name in files:
            if name.endswith(".fast5"):
                fast5s.append(os.path.join(root, name))
    return sorted(fast5s)


def _slice_signal(dset, head: int, tail: int) -> np.ndarray:
    """Read a Signal dataset, optionally only its head+tail samples.

    When ``head > 0`` and the read is longer than ``head + tail``, only
    those samples cross the HDF5 decode path — classify consumes exactly
    the first/last buffer of each read, so reading the middle of a long
    read is pure waste (executor.build_batch's slicing semantics are
    preserved by the concatenation: first-`head` and last-`tail` slices of
    the result equal those of the full signal, see mp_reader._trim_signal).
    """
    n = int(dset.shape[0]) if dset.shape else 0
    if head <= 0 or head + max(tail, 0) >= n:
        return np.asarray(dset[:], dtype=np.int16)
    if tail > 0:
        return np.concatenate([
            np.asarray(dset[:head], dtype=np.int16),
            np.asarray(dset[n - tail:], dtype=np.int16),
        ])
    return np.asarray(dset[:head], dtype=np.int16)


def _iter_single_read_layout(handle, head: int = 0,
                             tail: int = 0) -> Iterator[Tuple[str, np.ndarray]]:
    reads_group = handle.get("Raw/Reads")
    if reads_group is None:
        return
    for read_name in reads_group:
        read = reads_group[read_name]
        if "Signal" not in read:
            continue
        read_id = read.attrs.get("read_id", read_name)
        if isinstance(read_id, bytes):
            read_id = read_id.decode()
        yield str(read_id), _slice_signal(read["Signal"], head, tail)


def _iter_multi_read_layout(handle, head: int = 0,
                            tail: int = 0) -> Iterator[Tuple[str, np.ndarray]]:
    for key in handle:
        if not key.startswith("read_"):
            continue
        group = handle[key]
        raw = group.get("Raw")
        if raw is None or "Signal" not in raw:
            continue
        read_id = raw.attrs.get("read_id", key[len("read_"):])
        if isinstance(read_id, bytes):
            read_id = read_id.decode()
        yield str(read_id), _slice_signal(raw["Signal"], head, tail)


def iterate_reads_in_fast5(path: str | os.PathLike, head: int = 0,
                           tail: int = 0) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (read_id, int16 raw signal) for every read in a fast5 file.

    ``head``/``tail`` > 0 read only those end slices of each signal
    (classify's access pattern); 0 reads everything (prep's).
    """
    import h5py  # deferred: bin subcommand must not pay for h5py/libhdf5

    with h5py.File(path, "r") as handle:
        yield from _iter_single_read_layout(handle, head, tail)
        yield from _iter_multi_read_layout(handle, head, tail)


def find_signal_files(directory: str | os.PathLike) -> List[str]:
    """Recursively find raw-signal containers (*.fast5 and *.pod5), sorted."""
    found: List[str] = []
    for root, _dirs, files in os.walk(directory):
        for name in files:
            if name.endswith((".fast5", ".pod5")):
                found.append(os.path.join(root, name))
    return sorted(found)


def read_signal_file(path: str, head: int = 0,
                     tail: int = 0) -> List[Tuple[str, np.ndarray]]:
    """All reads from one raw-signal container, by extension (ReadFn contract).

    fast5 → h5py backend; pod5 → the pure-Python pod5 parser.  This is the
    format-agnostic default the executor and reader workers plug in.
    ``head``/``tail`` bound the samples decoded per read end in BOTH formats:
    HDF5 hyperslab slices for fast5, chunk-lazy vbz decode for pod5 (only
    the 102,400-sample chunks covering the slices are decompressed).
    """
    if path.endswith(".pod5"):
        from deepbinner_tpu_torch.utils.pod5 import read_pod5

        return read_pod5(path, head, tail)
    return list(iterate_reads_in_fast5(path, head, tail))


def get_read_id_and_signal(
    path: str | os.PathLike,
) -> Tuple[Optional[str], Optional[np.ndarray]]:
    """First read's (read_id, signal), or (None, None) if unreadable.

    Matches the reference's per-file error tolerance: realtime mode must skip
    files still being written by MinKNOW (SURVEY.md §5 failure-detection row).
    """
    try:
        for read_id, signal in iterate_reads_in_fast5(path):
            return read_id, signal
        return None, None
    except (OSError, KeyError, ValueError):
        return None, None


def _move_table_from_group(group) -> Optional[Tuple[int, np.ndarray]]:
    """(first_sample, dwells) from an ``Analyses``-bearing HDF5 group."""
    move = group.get("Analyses/Basecall_1D_000/BaseCalled_template/Move")
    if move is None:
        return None
    first = 0
    summary = group.get("Analyses/Segmentation_000/Summary")
    if summary is not None:
        first = int(summary.attrs.get("first_sample_template", 0))
    return first, np.asarray(move[:], dtype=np.int64)


def get_move_table(
    path: str | os.PathLike,
) -> Optional[Tuple[int, np.ndarray]]:
    """Root-level move/dwell table → (first_sample, per-base dwells).

    The reference maps basecalled coordinates to raw-signal coordinates via
    the albacore event table in the fast5 (SURVEY.md §3.4); modern
    basecallers store an equivalent Move table.  Returns None when absent.
    Single-read layout only — prefer :func:`get_move_tables`, which also
    resolves per-read tables in multi-read files.
    """
    import h5py

    try:
        with h5py.File(path, "r") as handle:
            return _move_table_from_group(handle)
    except (OSError, KeyError, ValueError):
        return None


def get_move_tables(
    path: str | os.PathLike,
) -> dict:
    """All move/dwell tables in a fast5 → {read_id: (first_sample, dwells)}.

    Handles both layouts: the albacore-era single-read file stores ONE
    root-level ``Analyses`` group (mapped here to that file's read id), and
    multi-read MinKNOW files store a per-read ``read_<id>/Analyses`` group.
    Unreadable files return {} — prep counts and skips them.
    """
    import h5py

    tables: dict = {}
    try:
        with h5py.File(path, "r") as handle:
            root_table = _move_table_from_group(handle)
            if root_table is not None:
                reads_group = handle.get("Raw/Reads")
                if reads_group is not None:
                    for read_name in reads_group:
                        read_id = reads_group[read_name].attrs.get(
                            "read_id", read_name
                        )
                        if isinstance(read_id, bytes):
                            read_id = read_id.decode()
                        tables[str(read_id)] = root_table
            for key in handle:
                if not key.startswith("read_"):
                    continue
                group = handle[key]
                per_read = _move_table_from_group(group)
                if per_read is None:
                    continue
                raw = group.get("Raw")
                read_id = key[len("read_"):]
                if raw is not None:
                    read_id = raw.attrs.get("read_id", read_id)
                if isinstance(read_id, bytes):
                    read_id = read_id.decode()
                tables[str(read_id)] = per_read
    except (OSError, KeyError, ValueError):
        return {}
    return tables


def write_single_read_fast5(
    path: str | os.PathLike,
    read_id: str,
    signal: np.ndarray,
    read_number: int = 0,
) -> None:
    """Write a single-read (albacore-layout) fast5: Raw/Reads/Read_N/Signal."""
    import h5py

    signal = np.asarray(signal, dtype=np.int16)
    with h5py.File(path, "w") as handle:
        group = handle.create_group(f"Raw/Reads/Read_{read_number}")
        group.attrs["read_id"] = read_id
        group.attrs["read_number"] = read_number
        group.create_dataset("Signal", data=signal, dtype="<i2")


def write_multi_read_fast5(
    path: str | os.PathLike,
    reads: List[Tuple[str, np.ndarray]],
    moves: Optional[dict] = None,
) -> None:
    """Write a multi-read fast5: /read_<id>/Raw/Signal.

    `moves` optionally maps read_id → (first_sample, dwells); matching reads
    get a per-read ``read_<id>/Analyses`` basecaller group the way MinKNOW
    multi-read files carry one (consumed by :func:`get_move_tables`).
    """
    import h5py

    with h5py.File(path, "w") as handle:
        for read_id, signal in reads:
            raw = handle.create_group(f"read_{read_id}/Raw")
            raw.attrs["read_id"] = read_id
            raw.create_dataset(
                "Signal", data=np.asarray(signal, dtype=np.int16), dtype="<i2"
            )
            move = (moves or {}).get(read_id)
            if move is not None:
                first_sample, dwells = move
                summary = handle.create_group(
                    f"read_{read_id}/Analyses/Segmentation_000/Summary"
                )
                summary.attrs["first_sample_template"] = int(first_sample)
                handle.create_dataset(
                    f"read_{read_id}/Analyses/Basecall_1D_000/"
                    f"BaseCalled_template/Move",
                    data=np.asarray(dwells, dtype=np.int32),
                )
