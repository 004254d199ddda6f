"""The pod5 writer the benchmark's corpus files come from.

A frozen copy of ``write_pod5`` and its vbz codec and footer encoder in
``deepbinner_tpu_torch/utils/pod5.py``, and of ``compress`` in
``deepbinner_tpu_torch/native/zstd.py``, at commit
402717dbde1c47220f6674dc523b70c64264754a: an 8-byte signature and a
section marker, then the Reads, Signal and Run-info tables as Arrow IPC
files, then a FlatBuffers footer.  Each 102,400-sample chunk of a read is
compressed on its own (delta, zig-zag, StreamVByte-16, zstd level 1 through
the system ``libzstd``), which is what lets a reader decode only the
chunks that cover a read's head and tail.  Two departures, both for speed:
the zig-zag and the StreamVByte packing are written with fewer numpy
passes, and give the same bytes (``tests/test_bench_corpus.py``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import struct
import uuid
from typing import List, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x8bPOD\r\n\x1a\n"
CHUNK = 102_400  # samples per compressed chunk (the official writer's)
_NAMESPACE = uuid.UUID("6ba7b810-9dad-11d1-80b4-00c04fd430c8")
_ZSTD = None


def _zstd() -> ctypes.CDLL:
    global _ZSTD
    if _ZSTD is None:
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise OSError("libzstd not found: the corpus is vbz-compressed "
                          "through the system zstd library")
        lib = ctypes.CDLL(name)
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        _ZSTD = lib
    return _ZSTD


def zstd_compress(data: bytes) -> bytes:
    """One zstd frame at level 1."""
    lib = _zstd()
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(max(bound, 1))
    size = lib.ZSTD_compress(out, bound, data, len(data), 1)
    if lib.ZSTD_isError(size):
        raise ValueError("zstd compression failed")
    return ctypes.string_at(out, size)


def svb16_zigzag_delta(signal: np.ndarray) -> bytes:
    """int16 signal → wrapping delta → zig-zag → StreamVByte-16 (one key
    bit per value, 1 if it takes two data bytes; then the data bytes, low
    byte first)."""
    v = np.ascontiguousarray(signal, dtype=np.int16)
    if v.size == 0:
        return b""
    delta = np.empty_like(v)
    delta[:1] = v[:1]
    np.subtract(v[1:], v[:-1], out=delta[1:])  # wraps in int16, as intended
    zig = ((delta << 1) ^ (delta >> 15)).view(np.uint16)
    wide = zig > 0xFF
    keys = np.packbits(wide, bitorder="little")
    pairs = zig.astype("<u2").view(np.uint8).reshape(-1, 2)
    keep = np.ones((zig.size, 2), bool)
    keep[:, 1] = wide
    return keys.tobytes() + pairs[keep].tobytes()


def vbz_compress(signal: np.ndarray) -> bytes:
    return zstd_compress(svb16_zigzag_delta(signal))


def _build_footer(file_identifier: str,
                  embedded: List[Tuple[int, int, int]]) -> bytes:
    """Footer{file_identifier, software, pod5_version,
    contents:[EmbeddedFile{offset, length, format, content_type}]} as a
    FlatBuffers buffer."""
    buf = bytearray(4)

    def pad(alignment: int) -> None:
        buf.extend(bytes(-len(buf) % alignment))

    def link(at: int, target: int) -> None:
        struct.pack_into("<I", buf, at, target - at)

    def table(fields: List[Tuple[str, int]]) -> List[int]:
        offsets, size = [], 4
        for code, _value in fields:
            width = struct.calcsize(code)
            size += -size % width
            offsets.append(size)
            size += width
        pad(2)
        vtable = len(buf)
        buf.extend(struct.pack(f"<{2 + len(fields)}H", 4 + 2 * len(fields),
                               size, *offsets))
        pad(8)
        start = len(buf)
        buf.extend(bytes(size))
        struct.pack_into("<i", buf, start, start - vtable)
        for (code, value), offset in zip(fields, offsets):
            struct.pack_into("<" + code, buf, start + offset, value)
        return [start] + [start + offset for offset in offsets]

    def string(text: str) -> int:
        pad(4)
        at = len(buf)
        data = text.encode()
        buf.extend(struct.pack("<I", len(data)) + data + b"\0")
        return at

    footer = table([("I", 0)] * 4)
    targets = [string(file_identifier), string("deepbinner_tpu"),
               string("0.3.10")]
    pad(4)
    vector = len(buf)
    buf.extend(struct.pack(f"<{1 + len(embedded)}I", len(embedded),
                           *([0] * len(embedded))))
    targets.append(vector)
    for i, (offset, length, content_type) in enumerate(embedded):
        entry = table([("q", offset), ("q", length), ("h", 0),
                       ("h", content_type)])
        link(vector + 4 + 4 * i, entry[0])
    for at, target in zip(footer[1:], targets):
        link(at, target)
    link(0, footer[0])
    pad(8)
    return bytes(buf)


def write_pod5(path: str, reads: Sequence[Tuple[str, np.ndarray]]) -> None:
    """Write ``(read_id, int16 signal)`` pairs as one pod5 file (read ids
    are UUID strings)."""
    import pyarrow as pa

    signal_rows: List[Tuple[bytes, bytes, int]] = []
    read_rows: List[Tuple[bytes, List[int], str]] = []
    for read_id, signal in reads:
        rid = uuid.UUID(read_id).bytes
        signal = np.ascontiguousarray(signal, dtype=np.int16)
        indices = []
        for start in range(0, max(signal.size, 1), CHUNK):
            chunk = signal[start : start + CHUNK]
            indices.append(len(signal_rows))
            signal_rows.append((rid, vbz_compress(chunk), chunk.size))
        read_rows.append((rid, indices, read_id))

    signal_table = pa.table({
        "read_id": pa.array([r[0] for r in signal_rows], pa.binary(16)),
        "signal": pa.array([r[1] for r in signal_rows], pa.large_binary()),
        "samples": pa.array([r[2] for r in signal_rows], pa.uint32()),
    })
    reads_table = pa.table({
        "read_id": pa.array([r[0] for r in read_rows], pa.binary(16)),
        "signal": pa.array([r[1] for r in read_rows], pa.list_(pa.uint64())),
        "read_number": pa.array(range(len(read_rows)), pa.uint32()),
        "read_id_string": pa.array([r[2] for r in read_rows], pa.string()),
    })
    run_info_table = pa.table({
        "acquisition_id": pa.array(["deepbinner_tpu_fixture"], pa.string()),
    })
    file_identifier = str(uuid.uuid5(_NAMESPACE, os.path.basename(path)))
    section_marker = uuid.uuid5(_NAMESPACE, file_identifier).bytes

    def feather_bytes(table) -> bytes:
        sink = pa.BufferOutputStream()
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
        return sink.getvalue().to_pybytes()

    tmp = path + ".tmp"
    embedded: List[Tuple[int, int, int]] = []
    with open(tmp, "wb") as handle:
        handle.write(SIGNATURE)
        handle.write(section_marker)
        for content_type, table in ((0, reads_table), (1, signal_table),
                                    (2, run_info_table)):
            payload = feather_bytes(table)
            embedded.append((handle.tell(), len(payload), content_type))
            handle.write(payload)
            handle.write(b"\0" * (-len(payload) % 8))
            handle.write(section_marker)
        footer = _build_footer(file_identifier, embedded)
        handle.write(footer)
        handle.write(struct.pack("<q", len(footer)))
        handle.write(section_marker)
        handle.write(SIGNATURE)
    os.replace(tmp, path)
