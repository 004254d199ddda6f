"""pod5 raw-signal container: pure-Python reader/writer.

The reference predates pod5 and reads only fast5 (deepbinner/load_fast5s.py
:: get_read_id_and_signal — SURVEY.md §2 item 10); modern MinKNOW emits
pod5, so the rebuild ingests it behind the same ReadFn contract the fast5
readers use (north star: "ingests raw fast5/pod5 current traces").

No pod5 library exists in this image, so this module implements the
container format directly.  It needs pyarrow (the embedded tables) and the
system zstd library through ctypes (:mod:`..native.zstd`); the FlatBuffers
footer is encoded and decoded here with ``struct``:

- **Container** (per nanoporetech/pod5-file-format docs): an 8-byte
  signature, a 16-byte section marker, then embedded Apache-Arrow
  (FeatherV2 = Arrow IPC file) tables each followed by padding + the
  section marker, and at the tail a FlatBuffers footer describing the
  embedded tables, its int64 length, the section marker, and the signature
  again.
- **Tables**: a Signal table (``read_id`` fixed(16), ``signal``
  large_binary, ``samples`` uint32) holding vbz-compressed signal chunks,
  and a Reads table (``read_id`` fixed(16), ``signal`` list<uint64> of
  Signal-table row indices, ``read_number`` uint32).
- **vbz codec** (nanoporetech/vbz_compression): per-sample int16 delta →
  zig-zag → StreamVByte svb16 (1 control bit per value: 1 or 2 data bytes)
  → zstd.  Implemented vectorised in numpy; round-trip pinned by tests.

PARITY-REVERIFY: written against the public spec from memory in a
zero-egress environment — byte-level compatibility with files produced by
the official library is untested (no real pod5 exists here).  Field order
of the footer flatbuffer and the enum values below are the items to
re-check first against nanoporetech/pod5-file-format's footer.fbs.

Non-UUID read ids (pod5 proper allows only UUIDs) are preserved through a
``read_id_string`` extension column on the Reads table; files without it
(i.e. real pod5) present the canonical UUID string as the read id.
"""

from __future__ import annotations

import functools
import mmap
import os
import struct
import time
import traceback
import uuid
from typing import List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x8bPOD\r\n\x1a\n"
FORMAT_FEATHER_V2 = 0
CONTENT_READS_TABLE = 0
CONTENT_SIGNAL_TABLE = 1
CONTENT_RUN_INFO_TABLE = 2
SIGNAL_CHUNK_SIZE = 102_400  # the official writer's default chunking
_READ_ID_NAMESPACE = uuid.UUID("6ba7b810-9dad-11d1-80b4-00c04fd430c8")


# ---------------------------------------------------------------- vbz codec

def _zigzag_encode(values: np.ndarray) -> np.ndarray:
    v = values.astype(np.int32)
    return (((v << 1) ^ (v >> 15)) & 0xFFFF).astype(np.uint16)


def _zigzag_decode(values: np.ndarray) -> np.ndarray:
    z = values.astype(np.int32)
    return ((z >> 1) ^ -(z & 1)).astype(np.int16)


def svb16_encode(values: np.ndarray) -> bytes:
    """StreamVByte for 16-bit values: 1 control bit + 1-2 data bytes each."""
    values = np.ascontiguousarray(values, dtype=np.uint16)
    n = values.size
    if n == 0:
        return b""
    wide = values > 0xFF
    keys = np.packbits(wide.astype(np.uint8), bitorder="little")
    sizes = 1 + wide.astype(np.int64)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    data = np.zeros(int(ends[-1]), np.uint8)
    data[starts] = (values & 0xFF).astype(np.uint8)
    data[starts[wide] + 1] = (values[wide] >> 8).astype(np.uint8)
    return keys.tobytes() + data.tobytes()


def svb16_decode(payload: bytes, count: int,
                 keep: Optional[int] = None) -> np.ndarray:
    """The first ``keep`` (default: all) of the ``count`` values in
    ``payload``.  Raises ValueError where ``payload`` holds fewer bytes than
    its keys say all ``count`` values take, whatever ``keep``."""
    keep = count if keep is None else keep
    if not 0 <= keep <= count:
        raise ValueError(f"keep {keep} outside [0, {count}]")
    if count == 0:
        return np.zeros(0, np.uint16)
    key_len = (count + 7) // 8
    keys = np.unpackbits(
        np.frombuffer(payload[:key_len], np.uint8), bitorder="little"
    )[:count].astype(bool)
    data = np.frombuffer(payload[key_len:], np.uint8)
    if data.size < count + int(np.count_nonzero(keys)):
        raise ValueError("svb16 stream truncated")
    keys = keys[:keep]
    sizes = 1 + keys.astype(np.int64)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    out = data[starts].astype(np.uint16)
    out[keys] |= data[starts[keys] + 1].astype(np.uint16) << 8
    return out


def vbz_compress(signal: np.ndarray) -> bytes:
    """int16 signal → delta → zig-zag → svb16 → zstd (vbz v1 semantics)."""
    from deepbinner_tpu_torch.native import zstd

    v = np.ascontiguousarray(signal, dtype=np.int16)
    delta = np.empty_like(v)
    delta[:1] = v[:1]
    # wrapping int16 difference, exactly invertible by the wrapping cumsum
    delta[1:] = (v[1:].astype(np.int32) - v[:-1].astype(np.int32)).astype(np.int16)
    return zstd.compress(svb16_encode(_zigzag_encode(delta)))


def vbz_decompress(payload, sample_count: int,
                   keep: Optional[int] = None,
                   times: Optional[dict] = None) -> np.ndarray:
    """One vbz chunk of ``sample_count`` samples, in any buffer (a view of
    a mapped pod5 file's bytes, for :func:`read_pod5`) → its first ``keep``
    (default: all) as a new int16 array.  zstd decompresses the whole chunk
    into its thread's output buffer; the unpack stops after ``keep``
    samples.  ``times``: where given, its ``"zstd"`` and ``"unpack"``
    seconds grow by this chunk's, its ``"chunks"`` by 1, its
    ``"payload_bytes"`` by the compressed bytes, its ``"samples"`` by
    ``sample_count`` and its ``"unpacked"`` by ``keep``."""
    # native.zstd keeps one decompression context and output buffer per
    # thread: the in-process reader threads (runner.executor.iter_signals)
    # decode pod5 files side by side, and a shared one is not safe for that.
    from deepbinner_tpu_torch.native import zstd

    size = (sample_count + 7) // 8 + 2 * sample_count
    keep = sample_count if keep is None else keep
    if times is None:
        return _svb16_unpack(zstd.decompress(payload, size), sample_count,
                             keep)
    begin = time.perf_counter()
    raw = zstd.decompress(payload, size)
    middle = time.perf_counter()
    out = _svb16_unpack(raw, sample_count, keep)
    times["zstd"] += middle - begin
    times["unpack"] += time.perf_counter() - middle
    times["chunks"] += 1
    times["payload_bytes"] += memoryview(payload).nbytes
    times["samples"] += sample_count
    times["unpacked"] += keep
    return out


def _svb16_unpack(raw, sample_count: int, keep: int) -> np.ndarray:
    """svb16 keys and bytes (any buffer) → zig-zag decode → the delta
    prefix sum, for the first ``keep`` of the ``sample_count`` samples, in
    a new int16 array."""
    from deepbinner_tpu_torch.native import vbz as native_vbz

    # One fused C pass where it can be built (native/vbz.py); the numpy
    # chain below stays its oracle (tests/test_torch_native.py).  Both
    # raise ValueError when ``raw`` holds fewer bytes than its keys say the
    # whole chunk needs, whatever ``keep``.
    if native_vbz.available():
        return native_vbz.unpack(raw, sample_count, keep)
    delta = _zigzag_decode(svb16_decode(raw, sample_count, keep))
    # int64 cumsum then int16 cast == wrapping int16 prefix sum
    return np.cumsum(delta.astype(np.int64)).astype(np.int16)


# ------------------------------------------------------------ footer codec
#
# The footer is a FlatBuffers buffer of two tables:
#   Footer{file_identifier: string, software: string, pod5_version: string,
#          contents: [EmbeddedFile]}                     (slots 0-3)
#   EmbeddedFile{offset: int64, length: int64, format: int16,
#                content_type: int16}                    (slots 0-3)
# laid out by FlatBuffers' rules, so that any FlatBuffers reader reads it:
# the root table's uoffset at byte 0; a table starts with an int32 soffset
# back to its vtable (vtable = table - soffset); a vtable holds its own size,
# the table's size and a uint16 offset per slot (0: the field is absent and
# takes its default); strings and vectors start with a uint32 length and
# strings end in NUL; a uoffset is relative to its own position and points
# forward; each scalar is aligned to its size from byte 0.

def _build_footer(file_identifier: str,
                  embedded: List[Tuple[int, int, int]]) -> bytes:
    """Footer{file_identifier, software, pod5_version,
    contents:[EmbeddedFile{offset,length,format,content_type}]}."""
    buf = bytearray(4)  # the root uoffset, linked at the end

    def pad(alignment: int) -> None:
        buf.extend(bytes(-len(buf) % alignment))

    def link(at: int, target: int) -> None:
        struct.pack_into("<I", buf, at, target - at)

    def table(fields: List[Tuple[str, int]]) -> List[int]:
        """Append a vtable and its table of (struct code, value) fields in
        slot order; returns each field's position."""
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
        entry = table([("q", offset), ("q", length), ("h", FORMAT_FEATHER_V2),
                       ("h", content_type)])
        link(vector + 4 + 4 * i, entry[0])
    for at, target in zip(footer[1:], targets):
        link(at, target)
    link(0, footer[0])
    pad(8)
    return bytes(buf)


def _field(buf: bytes, table: int, slot: int) -> Optional[int]:
    """Position of a table's field, or None where the vtable omits it."""
    (back,) = struct.unpack_from("<i", buf, table)
    vtable = table - back
    (vtable_size,) = struct.unpack_from("<H", buf, vtable)
    entry = 4 + 2 * slot
    if entry >= vtable_size:
        return None
    (offset,) = struct.unpack_from("<H", buf, vtable + entry)
    return table + offset if offset else None


def _follow(buf: bytes, at: int) -> int:
    """The position a uoffset at ``at`` points to."""
    return at + struct.unpack_from("<I", buf, at)[0]


def _scalar(buf: bytes, table: int, slot: int, code: str) -> int:
    at = _field(buf, table, slot)
    return struct.unpack_from("<" + code, buf, at)[0] if at is not None else 0


def _parse_footer(buf: bytes) -> List[Tuple[int, int, int, int]]:
    """→ [(offset, length, format, content_type)] from footer flatbuffer."""
    footer = _follow(buf, 0)
    at = _field(buf, footer, 3)
    if at is None:
        return []
    vector = _follow(buf, at)
    (count,) = struct.unpack_from("<I", buf, vector)
    out = []
    for i in range(count):
        entry = _follow(buf, vector + 4 + 4 * i)
        out.append((_scalar(buf, entry, 0, "q"), _scalar(buf, entry, 1, "q"),
                    _scalar(buf, entry, 2, "h"), _scalar(buf, entry, 3, "h")))
    return out


# -------------------------------------------------------------- read/write

def _read_id_uuid(read_id: str) -> bytes:
    try:
        return uuid.UUID(read_id).bytes
    except ValueError:
        return uuid.uuid5(_READ_ID_NAMESPACE, read_id).bytes


def write_pod5(path: str | os.PathLike,
               reads: List[Tuple[str, np.ndarray]],
               chunk_size: int = SIGNAL_CHUNK_SIZE) -> None:
    """Write reads as a pod5 container (vbz-compressed, chunked signal)."""
    import pyarrow as pa

    signal_rows: List[Tuple[bytes, bytes, int]] = []  # (uuid, vbz, samples)
    read_rows: List[Tuple[bytes, List[int], str]] = []
    for number, (read_id, signal) in enumerate(reads):
        rid = _read_id_uuid(read_id)
        signal = np.ascontiguousarray(signal, dtype=np.int16)
        indices = []
        for start in range(0, max(signal.size, 1), chunk_size):
            chunk = signal[start : start + chunk_size]
            indices.append(len(signal_rows))
            signal_rows.append((rid, vbz_compress(chunk), chunk.size))
        read_rows.append((rid, indices, read_id))

    signal_table = pa.table({
        "read_id": pa.array([r[0] for r in signal_rows],
                            pa.binary(16)),
        "signal": pa.array([r[1] for r in signal_rows], pa.large_binary()),
        "samples": pa.array([r[2] for r in signal_rows], pa.uint32()),
    })
    reads_table = pa.table({
        "read_id": pa.array([r[0] for r in read_rows], pa.binary(16)),
        "signal": pa.array([r[1] for r in read_rows],
                           pa.list_(pa.uint64())),
        "read_number": pa.array(range(len(read_rows)), pa.uint32()),
        # Extension column: preserves non-UUID ids (absent in real pod5).
        "read_id_string": pa.array([r[2] for r in read_rows], pa.string()),
    })
    run_info_table = pa.table({
        "acquisition_id": pa.array(["deepbinner_tpu_fixture"], pa.string()),
    })

    file_identifier = str(uuid.uuid5(_READ_ID_NAMESPACE, os.fspath(path)))
    section_marker = uuid.uuid5(_READ_ID_NAMESPACE, file_identifier).bytes

    def feather_bytes(table) -> bytes:
        sink = pa.BufferOutputStream()
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
        return sink.getvalue().to_pybytes()

    tmp = os.fspath(path) + ".tmp"
    embedded: List[Tuple[int, int, int]] = []
    with open(tmp, "wb") as handle:
        handle.write(SIGNATURE)
        handle.write(section_marker)
        for content_type, table in (
            (CONTENT_READS_TABLE, reads_table),
            (CONTENT_SIGNAL_TABLE, signal_table),
            (CONTENT_RUN_INFO_TABLE, run_info_table),
        ):
            payload = feather_bytes(table)
            embedded.append((handle.tell(), len(payload), content_type))
            handle.write(payload)
            handle.write(b"\0" * (-len(payload) % 8))  # 8-byte alignment
            handle.write(section_marker)
        footer = _build_footer(file_identifier, embedded)
        handle.write(footer)
        handle.write(struct.pack("<q", len(footer)))
        handle.write(section_marker)
        handle.write(SIGNATURE)
    os.replace(tmp, path)


def _decode_read_signal(
    payloads, samples, indices, head: int, tail: int,
    times: Optional[dict] = None,
) -> np.ndarray:
    """Decode one read's signal from its vbz chunk rows, chunk-lazily.

    ``head``/``tail`` > 0 decode ONLY the chunks overlapping the first
    ``head`` / last ``tail`` samples and return their concatenation (the
    whole signal where it is not longer than ``head + tail``) — the slices
    of the full signal a batch uses, at the cost of the covering chunks
    instead of the whole read.
    Possible because the writer compresses each SIGNAL_CHUNK_SIZE chunk
    independently (vbz delta coding restarts per chunk), so a chunk is the
    random-access unit; fast5 gets the same treatment via HDF5 hyperslabs
    (utils/fast5._slice_signal).  With the default 102,400-sample chunks a
    dual-model classify decodes ≤2 chunks per end of a long read instead
    of all of them.  A chunk only the head needs is zstd-decompressed whole
    but unpacked only up to the head's last sample (``keep``); a chunk the
    tail needs is unpacked whole, since its prefix sum runs from the
    chunk's first sample.
    """
    decode = (vbz_decompress if times is None
              else functools.partial(vbz_decompress, times=times))
    counts = [int(samples[int(i)]) for i in indices]
    total = sum(counts)
    if head <= 0 or head + max(tail, 0) >= total:
        chunks = [decode(payloads[int(i)], c) for i, c in zip(indices, counts)]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.int16)

    parts: List[np.ndarray] = []
    tail_lo = total - tail  # first sample index the tail slice needs
    offset = 0
    for i, count in zip(indices, counts):
        lo, hi = offset, offset + count
        offset = hi
        need_head = lo < head          # chunk overlaps [0, head)
        need_tail = tail > 0 and hi > tail_lo  # overlaps [total-tail, total)
        if not (need_head or need_tail):
            continue  # untouched chunk: never decompressed
        keep = count if need_tail else min(head - lo, count)
        chunk = decode(payloads[int(i)], count, keep=keep)
        if need_head:
            parts.append(chunk[: min(head - lo, count)])
        if need_tail:
            parts.append(chunk[max(0, tail_lo - lo):])
    return np.concatenate(parts) if parts else np.zeros(0, np.int16)


# The bytes around the footer: its int64 length, the section marker and
# the signature; and the smallest file that holds them and a head.
_TRAILER = 8 + 16 + len(SIGNATURE)
_MIN_FILE = len(SIGNATURE) + 16 + _TRAILER


def read_pod5(path: str | os.PathLike, head: int = 0, tail: int = 0,
              times: Optional[dict] = None) -> List[Tuple[str, np.ndarray]]:
    """Read every read in a pod5 file → [(read_id, int16 signal)].

    ``head``/``tail`` > 0 decode only the vbz chunks covering each read's
    first-``head``/last-``tail`` samples (classify's access pattern — see
    :func:`_decode_read_signal`); 0 decodes everything (prep's).

    The file is mapped read-only, and zstd reads each chunk it decodes
    where it lies in the mapping: no byte of the file is copied before it
    is decoded.  The mapping is closed before this returns, and no
    returned array refers to it.  A file cut short or still being written
    lacks its trailing signature and raises ``OSError``; a file truncated
    in place while it is mapped ends the process (``SIGBUS``), as writers
    that replace a finished file whole (``write_pod5``) never do.

    ``times`` (a reader worker's, while the program's spans record): a dict
    whose ``"open"`` (mapping the file, the signatures and the footer),
    ``"tables"`` (the Arrow IPC tables and their columns' buffers),
    ``"zstd"`` and ``"unpack"`` (svb16 and the prefix sum) seconds grow by
    this file's, and whose ``"bytes"`` (the file's size), ``"chunks"``
    (decoded), ``"payload_bytes"`` (their compressed bytes, handed to
    zstd), ``"samples"`` (of the chunks zstd decompressed) and
    ``"unpacked"`` (samples unpacked) counts too.
    """
    begin = time.perf_counter()
    with open(path, "rb") as handle:
        size = os.fstat(handle.fileno()).st_size
        if size < _MIN_FILE:
            raise OSError(f"{path}: not a pod5 file ({size} bytes)")
        mapping = mmap.mmap(handle.fileno(), size, access=mmap.ACCESS_READ)
    try:
        return _read_mapped(path, mapping, head, tail, times, begin)
    except BaseException as error:
        # The frames of the traceback hold views of the mapping, and a
        # view left alive would keep it from closing.
        traceback.clear_frames(error.__traceback__)
        raise
    finally:
        mapping.close()  # BufferError if a view of it outlived the read


def _view(array, dtype, extra: int = 0) -> np.ndarray:
    """An Arrow array's second buffer as a numpy view: a fixed-width
    array's values, or with ``extra`` = 1 a binary or list array's
    offsets.  Read through numpy, not ``Array.to_numpy``, which imports
    pandas where it is installed (half a second in each new worker)."""
    if array.null_count:
        raise OSError(f"pod5 column of {array.type} with "
                      f"{array.null_count} nulls")
    return np.frombuffer(array.buffers()[1], dtype, len(array) + extra,
                         array.offset * np.dtype(dtype).itemsize)


def _read_mapped(path, mapping: mmap.mmap, head: int, tail: int,
                 times: Optional[dict],
                 begin: float) -> List[Tuple[str, np.ndarray]]:
    """:func:`read_pod5` on the file's mapping; every view of the mapping
    it makes goes with its frame."""
    import pyarrow as pa

    size = len(mapping)
    if (mapping[:len(SIGNATURE)] != SIGNATURE
            or mapping[size - len(SIGNATURE):] != SIGNATURE):
        raise OSError(f"{path}: not a pod5 file (bad signature)")
    (footer_len,) = struct.unpack_from("<q", mapping, size - _TRAILER)
    footer_at = size - _TRAILER - footer_len
    if not 0 < footer_len <= size - _MIN_FILE:
        raise OSError(f"{path}: pod5 footer length {footer_len} outside "
                      f"the file")
    with memoryview(mapping) as view:
        embedded = _parse_footer(view[footer_at : size - _TRAILER])
    if times is not None:
        opened = time.perf_counter()
        times["open"] += opened - begin
        times["bytes"] += size

    whole = pa.py_buffer(mapping)
    tables = {}
    for offset, length, fmt, content_type in embedded:
        if fmt != FORMAT_FEATHER_V2:
            continue
        if offset < 0 or length < 0 or offset + length > footer_at:
            raise OSError(f"{path}: pod5 table at {offset}+{length} outside "
                          f"the file")
        reader = pa.ipc.open_file(pa.BufferReader(whole.slice(offset, length)))
        tables[content_type] = reader.read_all()
    reads_table = tables.get(CONTENT_READS_TABLE)
    signal_table = tables.get(CONTENT_SIGNAL_TABLE)
    if reads_table is None or signal_table is None:
        raise OSError(f"{path}: pod5 footer lacks reads/signal tables")

    # Each Signal-table row's payload: a view of its record batch's data
    # buffer, between two of the batch's offsets.
    payloads, samples = [], []
    for signal, count in zip(signal_table.column("signal").chunks,
                             signal_table.column("samples").chunks):
        if signal.type != pa.large_binary():
            raise OSError(f"{path}: pod5 signal column of {signal.type}")
        offsets = _view(signal, np.int64, 1).tolist()
        values = signal.buffers()[2]
        data = (np.frombuffer(values, np.uint8) if values is not None
                else np.zeros(0, np.uint8))
        payloads += [data[lo:hi] for lo, hi in zip(offsets[:-1], offsets[1:])]
        samples += _view(count, np.uint32).tolist()

    if "read_id_string" in reads_table.column_names:
        read_ids = reads_table.column("read_id_string").to_pylist()
    else:
        read_ids = [str(uuid.UUID(bytes=b))
                    for b in reads_table.column("read_id").to_pylist()]
    # Each read's Signal-table rows: a slice of its record batch's list
    # values.
    read_indices = []
    for signal in reads_table.column("signal").chunks:
        offsets = _view(signal, np.int32, 1).tolist()
        values = _view(signal.values, np.uint64)
        read_indices += [values[lo:hi].tolist()
                         for lo, hi in zip(offsets[:-1], offsets[1:])]
    if times is not None:
        times["tables"] += time.perf_counter() - opened

    return [(read_id, _decode_read_signal(payloads, samples, indices, head,
                                          tail, times))
            for read_id, indices in zip(read_ids, read_indices)]
