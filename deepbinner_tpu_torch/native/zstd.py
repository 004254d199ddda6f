"""ctypes binding for the system zstd library (the zstd stage of vbz).

The pod5 signal codec (:mod:`..utils.pod5`) is zstd over svb16-packed
zigzag deltas.  This module calls the system ``libzstd`` (the soname that
``ctypes.util.find_library("zstd")`` finds, ``libzstd.so.1`` on Linux)
directly, so reading and writing pod5 needs no Python zstd package and no
compiler.  Nothing is loaded when the module is imported; where no zstd
library is found, the first call raises an ``OSError`` that names it.

- :func:`compress` is ``ZSTD_compress`` at level 1, as the JAX package's
  ``ZstdCompressor(level=1)``.  zstd versions may pack the same input into
  other bytes, so files are compared by their decoded reads, never by
  their bytes.
- :func:`decompress` uses one ``ZSTD_DCtx`` per thread: a context must
  not be shared by threads that decompress at the same time (the reader
  threads of ``runner.executor.iter_signals`` do), and creating one per
  chunk costs more than the chunk.  It reads its source by address, so
  any buffer will do (a read-only view of a mapped pod5 file too), and
  writes into one output buffer per thread, which grows on demand and is
  never zero-filled; it returns a view of that buffer, not a copy.  A
  thread's context and buffer are freed when the thread ends.  An error
  code raises ``ValueError``, so a garbage file counts as a failed file.

Every ``size_t`` the library returns is declared as ``c_size_t`` and
tested with ``ZSTD_isError``, never by its sign.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_local = threading.local()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            name = ctypes.util.find_library("zstd")
            if name is None:
                raise OSError(
                    "libzstd not found: ctypes.util.find_library('zstd') "
                    "finds no zstd library; pod5 needs the system zstd "
                    "runtime (libzstd.so.1)")
            lib = ctypes.CDLL(name)
            size_t, void_p = ctypes.c_size_t, ctypes.c_void_p
            signatures = {
                "ZSTD_compressBound": ([size_t], size_t),
                "ZSTD_compress": ([void_p, size_t, ctypes.c_char_p, size_t,
                                   ctypes.c_int], size_t),
                "ZSTD_createDCtx": ([], void_p),
                "ZSTD_freeDCtx": ([void_p], size_t),
                "ZSTD_decompressDCtx": ([void_p, void_p, size_t, void_p,
                                         size_t], size_t),
                "ZSTD_isError": ([size_t], ctypes.c_uint),
                "ZSTD_getErrorName": ([size_t], ctypes.c_char_p),
                "ZSTD_versionNumber": ([], ctypes.c_uint),
            }
            for function, (argtypes, restype) in signatures.items():
                getattr(lib, function).argtypes = argtypes
                getattr(lib, function).restype = restype
            _lib = lib
        return _lib


def _checked(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def version() -> str:
    """The loaded library's version, e.g. ``"1.5.4"``."""
    number = _library().ZSTD_versionNumber()
    return f"{number // 10000}.{number // 100 % 100}.{number % 100}"


def compress(data: bytes) -> bytes:
    """One zstd frame holding ``data``, at level 1."""
    lib = _library()
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(max(bound, 1))
    size = _checked(lib, lib.ZSTD_compress(out, bound, data, len(data), 1),
                    "zstd compression failed")
    return ctypes.string_at(out, size)


class _DCtx:
    """One thread's decompression context and output buffer, freed with
    the thread's locals."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self.lib = lib
        self.ptr = lib.ZSTD_createDCtx()
        if not self.ptr:
            raise MemoryError("ZSTD_createDCtx failed")
        self.out = np.empty(0, np.uint8)

    def output(self, size: int) -> np.ndarray:
        """The thread's output buffer, grown to at least ``size`` bytes."""
        if self.out.size < size:
            self.out = np.empty(size, np.uint8)
        return self.out

    def __del__(self) -> None:
        if getattr(self, "ptr", None):
            self.lib.ZSTD_freeDCtx(self.ptr)


def decompress(payload, max_size: int) -> np.ndarray:
    """The content of the zstd frame in the buffer ``payload``, at most
    ``max_size`` bytes, as a uint8 view of this thread's output buffer: the
    thread's next call overwrites it.  Raises ``ValueError`` for a corrupt
    frame or a larger content."""
    lib = _library()
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        ctx = _local.ctx = _DCtx(lib)
    src = np.frombuffer(payload, np.uint8)
    out = ctx.output(max(max_size, 1))
    size = _checked(lib, lib.ZSTD_decompressDCtx(ctx.ptr, out.ctypes.data,
                                                 max_size, src.ctypes.data,
                                                 src.size),
                    "zstd decompression failed")
    return out[:size]
