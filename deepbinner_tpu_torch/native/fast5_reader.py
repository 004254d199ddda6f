"""ctypes bindings for the C++ fast5 batch reader (``src/fast5_reader.cc``).

Counterpart of ``deepbinner_tpu/native/fast5_reader.py``.  One C++ call
decodes a whole file (all reads, single- and multi-read layouts) off the
GIL into malloc'd buffers that are copied into numpy arrays, with the same
read ids and int16 signals as the h5py path of :mod:`..utils.fast5`.

The library is built with g++ at first use (:mod:`.build`).
:func:`available` is False where it cannot be built (no g++, no HDF5
runtime), and the caller then reads through h5py; a build or link that
fails where both were found raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from deepbinner_tpu_torch.native import build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class _ReadOut(ctypes.Structure):
    _fields_ = [
        ("read_id", ctypes.c_char * 64),
        ("signal", ctypes.POINTER(ctypes.c_int16)),
        ("length", ctypes.c_int64),
    ]


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("fast5_reader")
            # int db_read_fast5_slices(path, head, tail, out, count) — head/
            # tail > 0 decode only those end slices of each signal.
            lib.db_read_fast5_slices.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(_ReadOut)),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.db_read_fast5_slices.restype = ctypes.c_int
            lib.db_free_reads.argtypes = [ctypes.POINTER(_ReadOut), ctypes.c_int]
            lib.db_free_reads.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; False where it cannot be
    built here (:func:`build.missing`)."""
    if _lib is not None:
        return True
    if build.missing("fast5_reader") is not None:
        return False
    _library()
    return True


def read_file(path: str, head: int = 0,
              tail: int = 0) -> List[Tuple[str, np.ndarray]]:
    """Read all raw-signal reads from one fast5 via the C++ reader.

    Same contract as the h5py path (same read ids, same int16 arrays).
    ``head``/``tail`` > 0 decode only those end slices per signal (HDF5
    hyperslab selections, skipping the bulk of long reads).  Raises
    ``OSError`` for a file it cannot read.
    """
    lib = _library()
    out = ctypes.POINTER(_ReadOut)()
    count = ctypes.c_int(0)
    status = lib.db_read_fast5_slices(
        os.fsencode(path), head, tail, ctypes.byref(out), ctypes.byref(count)
    )
    if status != 0:
        raise OSError(f"native fast5 reader failed on {path} (status {status})")
    try:
        reads: List[Tuple[str, np.ndarray]] = []
        for i in range(count.value):
            entry = out[i]
            # as_array views the C buffer as int16 already; one copy takes
            # ownership.
            signal = np.ctypeslib.as_array(entry.signal, (entry.length,)).copy()
            reads.append((entry.read_id.decode(), signal))
        return reads
    finally:
        lib.db_free_reads(out, count)
