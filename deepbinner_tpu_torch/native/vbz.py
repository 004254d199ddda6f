"""ctypes binding for the native vbz signal unpacker (``src/vbz_decode.cc``).

Counterpart of ``deepbinner_tpu/native/vbz.py``.  One fused C pass
replaces the numpy svb16 + zigzag + cumsum chain in
:func:`..utils.pod5.vbz_decompress`, after zstd.  The library is built with
g++ at first use (:mod:`.build`); :func:`available` is False where there is
no g++, and the numpy path, which stays the oracle, is used then.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from deepbinner_tpu_torch.native import build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("vbz_decode")
            lib.db_vbz_unpack.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.db_vbz_unpack.restype = ctypes.c_int64
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; False where it cannot be
    built here (:func:`build.missing`)."""
    if _lib is not None:
        return True
    if build.missing("vbz_decode") is not None:
        return False
    _library()
    return True


def unpack(raw, count: int, keep: Optional[int] = None) -> np.ndarray:
    """svb16-unpack + zigzag + wrapping-int16 prefix sum, one C pass.

    ``raw`` (any buffer, read by address: ``zstd.decompress``'s view too)
    is the zstd-decompressed vbz payload of ``count`` samples;
    returns its first ``keep`` (default: all ``count``) as an int16 signal,
    equal to the same prefix of the whole unpack.  Raises ValueError on a
    truncated stream, also one cut after the kept prefix (as the numpy path
    does), and on a ``keep`` outside [0, count].
    """
    keep = count if keep is None else keep
    if not 0 <= keep <= count:
        raise ValueError(f"keep {keep} outside [0, {count}]")
    lib = _library()
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(keep, np.int16)
    status = lib.db_vbz_unpack(src.ctypes.data, src.size, count, keep,
                               out.ctypes.data)
    if status != 0:
        raise ValueError("svb16 stream truncated")
    return out
