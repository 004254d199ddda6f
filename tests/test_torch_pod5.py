"""The port's pod5 container and vbz codec against the JAX package's.

Mirrors ``tests/test_pod5.py`` and adds what the port's own codecs need:
files and footers that cross between the two packages both ways, the zstd
binding's errors and per-thread contexts, and a subprocess that writes and
reads pod5 with ``zstandard`` and ``flatbuffers`` blocked.  zstd versions
may pack the same input into other bytes, so files are compared by their
decoded reads, never by their bytes.
"""

import gc
import json
import os
import struct
import subprocess
import sys
import threading
import weakref

import numpy as np
import pytest

from deepbinner_tpu.utils import pod5 as jax_pod5
from deepbinner_tpu_torch.native import zstd
from deepbinner_tpu_torch.runner import executor
from deepbinner_tpu_torch.utils import pod5
from deepbinner_tpu_torch.utils.fast5 import find_signal_files, read_signal_file

EMBEDDED = [(24, 1000, pod5.CONTENT_READS_TABLE),
            (1032, 5000, pod5.CONTENT_SIGNAL_TABLE),
            (6040, 300, pod5.CONTENT_RUN_INFO_TABLE)]


def _reads(seed):
    rng = np.random.default_rng(seed)
    return [
        ("read_aabbccdd00112233", rng.integers(200, 800, 5000).astype(np.int16)),
        # longer than the chunk size: multi-chunk reassembly
        ("read_ffee", rng.integers(200, 800, 2500).astype(np.int16)),
        ("9c7c2a60-0000-4000-8000-000000000001",  # genuine-UUID read id
         rng.integers(200, 800, 100).astype(np.int16)),
        ("read_empty", np.zeros(0, np.int16)),
    ]


def _assert_same_reads(got, want):
    assert [r for r, _ in got] == [r for r, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)


def test_svb16_round_trip():
    rng = np.random.default_rng(0)
    cases = [
        np.zeros(0, np.uint16),
        np.array([0, 1, 255, 256, 257, 65535], np.uint16),
        rng.integers(0, 1 << 16, 1000).astype(np.uint16),
        rng.integers(0, 200, 777).astype(np.uint16),  # all 1-byte
        np.full(513, 65535, np.uint16),               # all 2-byte
    ]
    for values in cases:
        encoded = pod5.svb16_encode(values)
        assert encoded == jax_pod5.svb16_encode(values)
        np.testing.assert_array_equal(pod5.svb16_decode(encoded, values.size),
                                      values)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_vbz_round_trip(writer, reader):
    compress = {"port": pod5.vbz_compress, "jax": jax_pod5.vbz_compress}[writer]
    decompress = {"port": pod5.vbz_decompress,
                  "jax": jax_pod5.vbz_decompress}[reader]
    rng = np.random.default_rng(1)
    cases = [
        np.zeros(0, np.int16),
        np.zeros(1, np.int16),
        np.array([-32768, 32767, 0, -1, 1], np.int16),  # wrap-around deltas
        rng.normal(450, 60, 5000).astype(np.int16),     # realistic squiggle
        rng.integers(-(1 << 15), 1 << 15, 4097).astype(np.int16),
    ]
    for signal in cases:
        np.testing.assert_array_equal(
            decompress(compress(signal), signal.size), signal)
    squiggle = rng.normal(450, 60, 20000).astype(np.int16)
    assert len(compress(squiggle)) < squiggle.nbytes


def test_pod5_file_round_trip(tmp_path):
    reads = _reads(2)
    path = tmp_path / "batch.pod5"
    pod5.write_pod5(path, reads, chunk_size=1024)
    _assert_same_reads(pod5.read_pod5(path), reads)
    got = dict(read_signal_file(str(path)))  # the ReadFn dispatch
    np.testing.assert_array_equal(got["read_ffee"], reads[1][1])
    assert find_signal_files(tmp_path) == [str(path)]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_pod5_files_cross_both_ways(tmp_path, direction):
    reads = _reads(3)
    path = tmp_path / "cross.pod5"
    if direction == "port_to_jax":
        pod5.write_pod5(path, reads, chunk_size=700)
        for head, tail in ((0, 0), (1500, 1200), (1500, 0)):
            _assert_same_reads(jax_pod5.read_pod5(path, head, tail),
                               pod5.read_pod5(path, head, tail))
        got = jax_pod5.read_pod5(path)
    else:
        jax_pod5.write_pod5(path, reads, chunk_size=700)
        got = pod5.read_pod5(path)
    _assert_same_reads(got, reads)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port",
                                       "port_to_port"])
def test_footers_cross_both_ways(direction):
    build = {"port_to_jax": pod5._build_footer,
             "jax_to_port": jax_pod5._build_footer,
             "port_to_port": pod5._build_footer}[direction]
    parse = {"port_to_jax": jax_pod5._parse_footer,
             "jax_to_port": pod5._parse_footer,
             "port_to_port": pod5._parse_footer}[direction]
    footer = build("6ba7b810-9dad-11d1-80b4-00c04fd430c8", EMBEDDED)
    want = [(offset, length, pod5.FORMAT_FEATHER_V2, content)
            for offset, length, content in EMBEDDED]
    assert parse(footer) == want
    assert parse(build("x", [])) == []


def test_port_footer_follows_flatbuffers_rules():
    """The flatbuffers library reads the strings, and every int64 field
    sits 8-byte aligned from the start of the footer."""
    from flatbuffers import table as fb_table

    footer = pod5._build_footer("file-id", EMBEDDED)
    assert len(footer) % 8 == 0
    root = fb_table.Table(footer, struct.unpack_from("<I", footer, 0)[0])
    strings = [root.String(root.Offset(4 + 2 * slot) + root.Pos).decode()
               for slot in range(3)]
    assert strings == ["file-id", "deepbinner_tpu", "0.3.10"]
    vector = root.Vector(root.Offset(10))
    assert root.VectorLen(root.Offset(10)) == len(EMBEDDED)
    for i in range(len(EMBEDDED)):
        entry = fb_table.Table(footer, root.Indirect(vector + 4 * i))
        for slot in (0, 1):
            assert (entry.Offset(4 + 2 * slot) + entry.Pos) % 8 == 0


def test_pod5_head_tail_chunk_lazy(tmp_path, monkeypatch):
    """head/tail decode touches ONLY the covering vbz chunks, and unpacks a
    chunk only the head needs only up to the head's last sample."""
    rng = np.random.default_rng(7)
    long = rng.integers(200, 800, 10_000).astype(np.int16)
    short = rng.integers(200, 800, 900).astype(np.int16)  # single chunk
    path = tmp_path / "lazy.pod5"
    pod5.write_pod5(path, [("long_read", long), ("short_read", short)],
                    chunk_size=1000)

    calls = []
    real = pod5.vbz_decompress

    def counting(payload, count, keep=None):
        calls.append((count, keep))
        return real(payload, count, keep)

    monkeypatch.setattr(pod5, "vbz_decompress", counting)

    # (count, keep) per chunk decoded: the head's two chunks, the second
    # bounded at the head's end; the tail's two whole; the short read,
    # which the slices cover whole, decoded whole.
    head_tail = [(1000, 1000), (1000, 500), (1000, 1000), (1000, 1000),
                 (900, None)]
    got = dict(pod5.read_pod5(path, head=1500, tail=1200))
    assert calls == head_tail, calls  # 2 head + 2 tail chunks; short: 1
    np.testing.assert_array_equal(
        got["long_read"], np.concatenate([long[:1500], long[-1200:]]))
    np.testing.assert_array_equal(got["short_read"], short)

    calls.clear()
    got = dict(pod5.read_pod5(path, head=1500))
    assert calls == [(1000, 1000), (1000, 500), (900, None)], calls
    np.testing.assert_array_equal(got["long_read"], long[:1500])

    calls.clear()
    got2 = dict(read_signal_file(str(path), 1500, 1200))
    assert calls == head_tail, calls
    np.testing.assert_array_equal(
        got2["long_read"], np.concatenate([long[:1500], long[-1200:]]))


def test_pod5_head_tail_matches_trim_signal_semantics(tmp_path):
    """Lazy pod5 batches are bit-identical to full-decode batches."""
    from deepbinner_tpu.runner.mp_reader import _trim_signal
    from deepbinner_tpu_torch.runner.hostbatch import BatchSpec, build_batch_arrays

    rng = np.random.default_rng(8)
    reads = [(f"r{i}", rng.integers(200, 800, n).astype(np.int16))
             for i, n in enumerate([5000, 2048, 2049, 900, 1, 3333])]
    path = tmp_path / "parity.pod5"
    pod5.write_pod5(path, reads, chunk_size=512)

    head = tail = 1024
    lazy = pod5.read_pod5(path, head=head, tail=tail)
    full = pod5.read_pod5(path)
    assert [r for r, _ in lazy] == [r for r, _ in full]
    for (rid, lazy_sig), (_, full_sig) in zip(lazy, full):
        np.testing.assert_array_equal(
            lazy_sig, _trim_signal(full_sig, head, tail), err_msg=rid)

    spec = BatchSpec(batch_size=8, buffer_size=1024, dual=True)
    for a, b in zip(build_batch_arrays(lazy, spec)[1:],
                    build_batch_arrays(full, spec)[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def edge_reads(tmp_path_factory):
    """Reads in 1000-sample chunks around the slices below: shorter than
    every head, inside one chunk, at a chunk's edge, across chunks; and
    the file they are written to."""
    rng = np.random.default_rng(9)
    lengths = [300, 999, 1000, 1001, 1700, 2000, 2501, 3700, 6000, 10_000]
    reads = [(f"edge{n}", rng.normal(450, 60, n).astype(np.int16))
             for n in lengths]
    path = tmp_path_factory.mktemp("edges") / "edges.pod5"
    pod5.write_pod5(path, reads, chunk_size=1000)
    return reads, path


@pytest.fixture(params=["native", "numpy"])
def unpack_path(request, monkeypatch):
    from deepbinner_tpu_torch.native import build, vbz

    if request.param == "native":
        reason = build.missing("vbz_decode")
        if reason is not None:
            pytest.skip(f"the native vbz unpacker cannot be built here: {reason}")
    else:
        monkeypatch.setattr(vbz, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("tail", [0, 400, 1000, 1500])
@pytest.mark.parametrize("head", [700, 1000, 1001, 2500])
def test_pod5_bounded_unpack_is_trim_of_full_decode(edge_reads, unpack_path,
                                                    head, tail):
    """The head's bounded unpack gives the reads the JAX package's
    _trim_signal cuts from the whole decode, and the JAX package's
    read_pod5, head alone and with a tail; the counts say how much was
    unpacked."""
    from deepbinner_tpu.runner.mp_reader import _trim_signal
    from deepbinner_tpu_torch.runner.mp_reader import _POD5_TIMES

    reads, path = edge_reads
    times = dict.fromkeys(_POD5_TIMES, 0)
    got = pod5.read_pod5(path, head, tail, times)
    full = pod5.read_pod5(path)
    _assert_same_reads(full, reads)
    _assert_same_reads(got, [(r, _trim_signal(s, head, tail))
                             for r, s in reads])
    _assert_same_reads(got, jax_pod5.read_pod5(path, head, tail))
    chunk = 1000
    samples = unpacked = 0
    for _r, signal in reads:
        n = signal.size
        if n <= head + tail:  # the slices cover it: decoded whole
            samples += n
            unpacked += n
            continue
        for lo in range(0, n, chunk):
            count = min(chunk, n - lo)
            in_head, in_tail = lo < head, tail > 0 and lo + count > n - tail
            if in_head or in_tail:
                samples += count
                unpacked += count if in_tail else min(head - lo, count)
    assert (times["samples"], times["unpacked"]) == (samples, unpacked)
    # A head that ends inside a chunk leaves part of that chunk unpacked.
    assert (unpacked < samples) == (head % chunk != 0)


@pytest.mark.parametrize("damage", ["not_pod5", "truncated", "bad_chunk",
                                    "empty", "cut_in_payload"])
def test_pod5_rejects_garbage(tmp_path, damage):
    """A damaged file raises; reader threads count it as a failed file and
    read the good one beside it.  A file that is empty, or cut short (as
    one still being written is), raises OSError before any chunk is
    read."""
    good = tmp_path / "good.pod5"
    reads = _reads(4)
    pod5.write_pod5(good, reads)
    data = good.read_bytes()
    bad = tmp_path / "junk.pod5"
    if damage == "not_pod5":
        bad.write_bytes(b"not a pod5 file at all")
    elif damage == "truncated":
        bad.write_bytes(data[: len(data) // 2])
    elif damage == "empty":
        bad.write_bytes(b"")
    elif damage == "cut_in_payload":  # inside the last chunk's zstd frame
        frame = pod5.vbz_compress(reads[-1][1])
        at = data.rindex(frame)
        bad.write_bytes(data[: at + len(frame) // 2])
    else:  # a zstd frame in the signal table loses its magic number
        at = data.index(pod5.vbz_compress(reads[0][1]))
        bad.write_bytes(data[:at] + bytes(4) + data[at + 4:])
    with pytest.raises(Exception) as exc:
        pod5.read_pod5(bad)
    if damage != "bad_chunk":
        assert isinstance(exc.value, OSError)
    stats = executor.ExecutorStats()
    got = dict(executor.iter_signals(find_signal_files(tmp_path), num_readers=2,
                                     stats=stats, read_fn=read_signal_file))
    assert stats.failed_paths == [str(bad)]
    assert sorted(got) == sorted(r for r, _ in reads)


def test_zstd_errors_raise_value_error():
    raw = bytes(range(200)) * 10
    frame = zstd.compress(raw)
    assert zstd.decompress(frame, len(raw)).tobytes() == raw
    with pytest.raises(ValueError, match="zstd decompression failed"):
        zstd.decompress(b"\x00" * 32, 1024)  # not a frame
    with pytest.raises(ValueError, match="zstd decompression failed"):
        zstd.decompress(frame, len(raw) - 1)  # content larger than allowed
    with pytest.raises(ValueError, match="truncated"):
        pod5.vbz_decompress(zstd.compress(b"\x00"), 100)  # too few bytes
    assert zstd.version().count(".") == 2


def test_zstd_contexts_are_per_thread_and_freed():
    """One decompression context and one output buffer per thread, the
    buffer reused from call to call (each result a view of it) and grown
    on demand, both freed when the thread ends."""
    frame = zstd.compress(b"abc" * 1000)
    larger = zstd.compress(b"abcd" * 1000)
    contexts = []
    barrier = threading.Barrier(6)

    def work():
        barrier.wait(timeout=30)
        for _ in range(20):
            got = zstd.decompress(frame, 3000)
            assert got.tobytes() == b"abc" * 1000
        ctx = zstd._local.ctx
        assert np.shares_memory(got, ctx.out) and ctx.out.size == 3000
        first = ctx.out.ctypes.data
        assert zstd.decompress(frame, 3000).ctypes.data == first  # reused
        assert zstd.decompress(larger, 4000).tobytes() == b"abcd" * 1000
        assert ctx.out.size == 4000  # grown
        assert zstd.decompress(frame, 3000).ctypes.data == ctx.out.ctypes.data
        contexts.append((ctx.ptr, weakref.ref(ctx), ctx.out.ctypes.data,
                         weakref.ref(ctx.out)))
        del got
        barrier.wait(timeout=30)  # all alive: their contexts are distinct

    threads = [threading.Thread(target=work) for _ in range(6)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    assert not any(thread.is_alive() for thread in threads)
    assert len(contexts) == 6
    assert len({ptr for ptr, *_rest in contexts}) == 6
    assert len({out for _ptr, _ref, out, _out_ref in contexts}) == 6
    gc.collect()
    assert all(ref() is None for _ptr, ref, _out, _out_ref in contexts)
    assert all(out_ref() is None for *_rest, out_ref in contexts)


@pytest.mark.parametrize("head,tail", [(0, 0), (1500, 1200), (1500, 0)])
def test_read_pod5_counts_the_payload_bytes_it_decodes(tmp_path, monkeypatch,
                                                       head, tail):
    """``payload_bytes`` is the sum of the compressed bytes of the chunks
    decoded, at most the file's ``bytes``; below it with a head, which
    leaves the middle chunks alone."""
    from deepbinner_tpu_torch.runner.mp_reader import _POD5_TIMES

    path = tmp_path / "payload.pod5"
    pod5.write_pod5(path, _reads(10), chunk_size=700)
    handed = []
    real = pod5.vbz_decompress

    def counting(payload, count, keep=None, times=None):
        handed.append(memoryview(payload).nbytes)
        return real(payload, count, keep, times)

    monkeypatch.setattr(pod5, "vbz_decompress", counting)
    times = dict.fromkeys(_POD5_TIMES, 0)
    pod5.read_pod5(path, head, tail, times)
    assert times["chunks"] == len(handed) > 0
    assert times["payload_bytes"] == sum(handed) <= times["bytes"]
    assert times["bytes"] == os.path.getsize(path)
    if head:
        whole = dict.fromkeys(_POD5_TIMES, 0)
        pod5.read_pod5(path, 0, 0, whole)
        assert times["payload_bytes"] < whole["payload_bytes"]


def _mapped(path) -> bool:
    with open("/proc/self/maps") as maps:
        return any(line.rstrip("\n").endswith(os.fspath(path))
                   for line in maps)


@pytest.mark.parametrize("outcome", ["returned", "raised"])
def test_no_mapping_outlives_read_pod5(tmp_path, monkeypatch, outcome):
    """The file's mapping is closed when read_pod5 returns or raises, and
    no returned array refers to it: overwriting the file in place leaves
    them as they were."""
    if not os.path.exists("/proc/self/maps"):
        pytest.skip("no /proc/self/maps here to list the mappings")
    reads = _reads(11)
    path = tmp_path / "mapped.pod5"
    pod5.write_pod5(path, reads, chunk_size=700)
    if outcome == "raised":
        real = pod5.vbz_decompress
        calls = []

        def failing(payload, count, keep=None, times=None):
            calls.append(count)
            if len(calls) == 3:
                raise ValueError("chunk 3 fails")
            return real(payload, count, keep, times)

        monkeypatch.setattr(pod5, "vbz_decompress", failing)
        with pytest.raises(ValueError, match="chunk 3 fails"):
            pod5.read_pod5(path, 1500, 1200)
        assert not _mapped(path)
        return
    got = pod5.read_pod5(path, 1500, 1200)
    assert not _mapped(path)
    want = [(r, s.copy()) for r, s in got]
    before = path.read_bytes()
    other = tmp_path / "other.pod5"
    pod5.write_pod5(other, [(r, s[::-1] + 1) for r, s in reads],
                    chunk_size=700)
    with open(path, "r+b") as handle:  # the same inode, written over
        handle.write(other.read_bytes())
    after = path.read_bytes()
    assert sum(a != b for a, b in zip(before, after)) > len(before) // 2
    _assert_same_reads(got, want)


class _SplitWriter:
    """An Arrow IPC file writer that writes each table in record batches of
    ``rows`` rows, as real pod5 files hold them."""

    def __init__(self, writer, rows):
        self.writer, self.rows = writer, rows

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.writer.close()

    def write_table(self, table):
        self.writer.write_table(table, max_chunksize=self.rows)


@pytest.mark.parametrize("head,tail", [(0, 0), (1500, 1200), (1500, 0)])
def test_pod5_tables_in_several_record_batches(tmp_path, monkeypatch, head,
                                               tail):
    """Signal and Reads tables that each span several record batches read
    as the JAX package reads them, and as the one-batch file of the same
    reads."""
    import pyarrow as pa

    reads = _reads(12)
    single = tmp_path / "single.pod5"
    pod5.write_pod5(single, reads, chunk_size=700)
    new_file = pa.ipc.new_file
    monkeypatch.setattr(pa.ipc, "new_file", lambda sink, schema: _SplitWriter(
        new_file(sink, schema), 3))
    split = tmp_path / "split.pod5"
    pod5.write_pod5(split, reads, chunk_size=700)
    monkeypatch.undo()

    data = split.read_bytes()
    (footer_len,) = struct.unpack_from("<q", data, len(data) - 32)
    batches = {}
    for offset, length, _fmt, content in pod5._parse_footer(
            data[len(data) - 32 - footer_len : len(data) - 32]):
        reader = pa.ipc.open_file(pa.BufferReader(data[offset:offset + length]))
        batches[content] = reader.num_record_batches
    assert batches[pod5.CONTENT_SIGNAL_TABLE] > 2
    assert batches[pod5.CONTENT_READS_TABLE] > 1

    got = pod5.read_pod5(split, head, tail)
    _assert_same_reads(got, jax_pod5.read_pod5(split, head, tail))
    _assert_same_reads(got, pod5.read_pod5(single, head, tail))
    _assert_same_reads(pod5.read_pod5(split), reads)


def test_missing_libzstd_is_named(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(OSError, match="libzstd"):
        zstd.compress(b"x")
    with pytest.raises(OSError, match="libzstd"):
        pod5.vbz_compress(np.zeros(4, np.int16))


_BLOCKED = r"""
import json, sys
import numpy as np

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("zstandard", "flatbuffers", "jax",
                                  "deepbinner_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
from deepbinner_tpu_torch.utils import pod5
rng = np.random.default_rng(5)
reads = [(f"r{i}", rng.integers(200, 800, n).astype(np.int16))
         for i, n in enumerate([3000, 10, 0])]
pod5.write_pod5(sys.argv[1], reads, chunk_size=1000)
got = pod5.read_pod5(sys.argv[1])
print(json.dumps({
    "same": [r for r, _ in got] == [r for r, _ in reads] and all(
        np.array_equal(g, w) for (_, g), (_, w) in zip(got, reads)),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("zstandard", "flatbuffers")),
}))
"""


def test_pod5_without_zstandard_or_flatbuffers(tmp_path):
    path = tmp_path / "blocked.pod5"
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, str(path)],
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"same": True, "loaded": []}
    _assert_same_reads(jax_pod5.read_pod5(path), pod5.read_pod5(path))


_READ_ONLY = r"""
import json, sys
from deepbinner_tpu_torch.utils import pod5
reads = pod5.read_pod5(sys.argv[1], 1500, 1200)
print(json.dumps({"reads": len(reads),
                  "pandas": any(m.split(".")[0] == "pandas"
                                for m in sys.modules)}))
"""


def test_read_pod5_imports_no_pandas(tmp_path):
    """A new reader worker's first file costs no pandas import: the Arrow
    columns are read through numpy, not ``Array.to_numpy``."""
    path = tmp_path / "fresh.pod5"
    pod5.write_pod5(path, _reads(13), chunk_size=700)
    proc = subprocess.run([sys.executable, "-c", _READ_ONLY, str(path)],
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"reads": 4, "pandas": False}
