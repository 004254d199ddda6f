"""The port's native fast5 reader and vbz unpacker against the JAX package's
h5py and numpy paths, case for case with tests/test_native.py.

The libraries are built with g++ at first use; the tests skip, with the
reason, where g++ or the HDF5 runtime library is missing.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import zstandard

from deepbinner_tpu.ops.preprocess import PreprocessConfig as JaxPreprocessConfig
from deepbinner_tpu.runner.executor import batch_spec_for as jax_batch_spec_for
from deepbinner_tpu.runner.hostbatch import build_batch_arrays as jax_build_batch
from deepbinner_tpu.utils import fast5 as jax_fast5
from deepbinner_tpu.utils import pod5 as jax_pod5
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.native import build, fast5_reader, vbz
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.runner.executor import batch_spec_for
from deepbinner_tpu_torch.runner.hostbatch import build_batch_arrays
from deepbinner_tpu_torch.utils import pod5


@pytest.fixture
def native():
    reason = build.missing("fast5_reader")
    if reason is not None:
        pytest.skip(f"the native fast5 reader cannot be built here: {reason}")
    assert fast5_reader.available()
    return fast5_reader


def test_single_read_parity(native, tmp_path):
    sig = (np.arange(5000) % 700).astype(np.int16)
    path = str(tmp_path / "one.fast5")
    jax_fast5.write_single_read_fast5(path, "read_abc123", sig, read_number=7)
    h5py_reads = jax_fast5.read_signal_file(path)
    native_reads = native.read_file(path)
    assert len(native_reads) == len(h5py_reads) == 1
    assert native_reads[0][0] == h5py_reads[0][0] == "read_abc123"
    np.testing.assert_array_equal(native_reads[0][1], h5py_reads[0][1])
    assert native_reads[0][1].dtype == np.int16


def test_multi_read_parity(native, tmp_path):
    reads = [
        ("aaaa-bbbb", np.full(100, -5, np.int16)),
        ("cccc-dddd", np.arange(-300, 300, dtype=np.int16)),
    ]
    path = str(tmp_path / "multi.fast5")
    jax_fast5.write_multi_read_fast5(path, reads)
    got = dict(native.read_file(path))
    expected = dict(jax_fast5.read_signal_file(path))
    assert sorted(got) == sorted(expected)
    for read_id in got:
        np.testing.assert_array_equal(got[read_id], expected[read_id])


def test_garbage_file_raises(native, tmp_path):
    path = tmp_path / "bad.fast5"
    path.write_bytes(b"nope, not hdf5")
    with pytest.raises(OSError):
        native.read_file(str(path))


@pytest.mark.parametrize("container", ["fast5", "multifast5"])
def test_dataset_parity(native, tmp_path, container):
    """A whole simulated dataset: the same reads as h5py's."""
    simulate.make_dataset(tmp_path, reads_per_barcode=2, none_reads=2,
                          genome_length=500, seed=9, write_fastq=False,
                          container=container, reads_per_container=5)
    files = jax_fast5.find_all_fast5s(tmp_path)
    h5py_all = {rid: s for f in files for rid, s in jax_fast5.read_signal_file(f)}
    native_all = {rid: s for f in files for rid, s in native.read_file(f)}
    assert sorted(native_all) == sorted(h5py_all)
    for read_id in native_all:
        np.testing.assert_array_equal(native_all[read_id], h5py_all[read_id])


def test_sliced_read_parity(native, tmp_path):
    """head/tail hyperslab reads == the JAX h5py path's slices, across the
    threshold where slicing degenerates to a full read."""
    sig = (np.arange(30000) * 3 % 1900).astype(np.int16)
    path = str(tmp_path / "long.fast5")
    jax_fast5.write_single_read_fast5(path, "read_long", sig, read_number=1)
    short_path = str(tmp_path / "short.fast5")
    jax_fast5.write_single_read_fast5(short_path, "read_short", sig[:3000],
                                      read_number=2)
    for head, tail in [(8192, 0), (8192, 8192), (100, 50)]:
        for one in (path, short_path):
            [(rid, got)] = native.read_file(one, head, tail)
            [(want_id, want)] = jax_fast5.read_signal_file(one, head, tail)
            assert rid == want_id
            np.testing.assert_array_equal(got, want)


def test_sliced_batches_bit_identical(native, tmp_path):
    """Batches from slice-read signals == the JAX package's batches from
    full h5py reads."""
    rng = np.random.default_rng(3)
    paths = []
    for i in range(4):
        sig = rng.integers(200, 800, 25000 + 1000 * i).astype(np.int16)
        path = str(tmp_path / f"r{i}.fast5")
        jax_fast5.write_single_read_fast5(path, f"read_{i}", sig, read_number=i)
        paths.append(path)

    for dual in (False, True):
        spec = batch_spec_for(PreprocessConfig(host_trim=True), 4, dual)
        jax_spec = jax_batch_spec_for(JaxPreprocessConfig(host_trim=True), 4,
                                      dual)
        head = spec.trim.raw_size
        tail = head if dual else 0
        full, sliced = [], []
        for path in paths:
            full.extend(jax_fast5.read_signal_file(path))
            sliced.extend(native.read_file(path, head, tail))
        want = jax_build_batch(full, jax_spec)
        got = build_batch_arrays(sliced, spec)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            if b is None:
                assert a is None
                continue
            np.testing.assert_array_equal(a, b, err_msg=f"dual={dual}")


def test_native_vbz_unpack_parity():
    """The fused C pass is bit-identical to the numpy oracle across value
    ranges, sizes and the narrow-final-byte tail case; the port's
    vbz_decompress (which uses it) equals the JAX package's."""
    reason = build.missing("vbz_decode")
    if reason is not None:
        pytest.skip(f"the native vbz unpacker cannot be built here: {reason}")
    assert vbz.available()
    rng = np.random.default_rng(12)
    cases = [
        np.zeros(0, np.int16),
        np.asarray([5], np.int16),
        np.asarray([-1, 1, -32768, 32767, 0], np.int16),  # wrap + wide mix
        rng.integers(300, 700, 4097).astype(np.int16),     # mostly narrow
        rng.integers(-32768, 32767, 2048).astype(np.int16),  # mostly wide
    ]
    for sig in cases:
        comp = jax_pod5.vbz_compress(sig)
        n = sig.size
        raw = zstandard.ZstdDecompressor().decompress(
            comp, max_output_size=max((n + 7) // 8 + 2 * n, 1))
        ref = np.cumsum(
            pod5._zigzag_decode(pod5.svb16_decode(raw, n)).astype(np.int64)
        ).astype(np.int16)
        np.testing.assert_array_equal(vbz.unpack(raw, n), ref)
        np.testing.assert_array_equal(pod5.vbz_decompress(comp, n),
                                      jax_pod5.vbz_decompress(comp, n))
        np.testing.assert_array_equal(pod5.vbz_decompress(comp, n), sig)
    sig = rng.integers(-32768, 32767, 512).astype(np.int16)
    raw = zstandard.ZstdDecompressor().decompress(
        jax_pod5.vbz_compress(sig), max_output_size=(512 + 7) // 8 + 1024)
    with pytest.raises(ValueError):
        vbz.unpack(raw[:-3], 512)


def _vbz_raw(count, seed=13):
    """A signal of ``count`` samples, mostly narrow deltas with a wide one
    every 13th, and its zstd-decompressed vbz payload."""
    rng = np.random.default_rng(seed)
    sig = rng.integers(300, 700, count).astype(np.int16)
    sig[::13] = rng.integers(-32768, 32767, sig[::13].size)
    raw = zstandard.ZstdDecompressor().decompress(
        jax_pod5.vbz_compress(sig), max_output_size=(count + 7) // 8 + 2 * count)
    return sig, raw


@pytest.fixture(params=["native", "numpy"])
def unpack_path(request, monkeypatch):
    """``pod5._svb16_unpack`` on the C pass, or on the numpy oracle that
    runs where there is no g++."""
    if request.param == "native":
        reason = build.missing("vbz_decode")
        if reason is not None:
            pytest.skip(f"the native vbz unpacker cannot be built here: {reason}")
        assert vbz.available()
    else:
        monkeypatch.setattr(vbz, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("count", [4096, 4099])
@pytest.mark.parametrize("keep", [0, 1, 7, 8, 9, "count-1", "count"])
def test_bounded_unpack_is_the_prefix_of_the_full_unpack(unpack_path, count,
                                                         keep):
    """The unpack bounded at ``keep`` gives the first ``keep`` samples of
    the whole unpack, on both paths, for a count a multiple of 8 or not."""
    keep = {"count-1": count - 1, "count": count}.get(keep, keep)
    sig, raw = _vbz_raw(count)
    full = pod5._svb16_unpack(raw, count, count)
    np.testing.assert_array_equal(full, sig)
    got = pod5._svb16_unpack(raw, count, keep)
    assert got.dtype == np.int16 and got.shape == (keep,)
    np.testing.assert_array_equal(got, full[:keep])
    if unpack_path == "native":
        np.testing.assert_array_equal(vbz.unpack(raw, count, keep), sig[:keep])


@pytest.mark.parametrize("cut", ["last_byte", "after_prefix"])
@pytest.mark.parametrize("keep", [0, 9, 4098])
def test_bounded_unpack_still_rejects_a_truncated_chunk(unpack_path, cut,
                                                        keep):
    """A chunk cut after the kept prefix is still a damaged chunk: both
    paths raise ValueError whatever ``keep``, as for the whole unpack."""
    count = 4099
    sig, raw = _vbz_raw(count)
    key_len = (count + 7) // 8
    keys = np.unpackbits(np.frombuffer(raw[:key_len], np.uint8),
                         bitorder="little")[:count]
    prefix_end = key_len + keep + int(keys[:keep].sum())  # the prefix's bytes
    short = raw[:-1] if cut == "last_byte" else raw[:prefix_end]
    assert len(short) < len(raw)
    np.testing.assert_array_equal(pod5._svb16_unpack(raw, count, keep),
                                  sig[:keep])
    with pytest.raises(ValueError):
        pod5._svb16_unpack(short, count, keep)
    with pytest.raises(ValueError):
        pod5._svb16_unpack(raw, count, count + 1)
    with pytest.raises(ValueError):
        pod5._svb16_unpack(raw, count, -1)


def test_missing_compiler_means_not_available(monkeypatch):
    """Without g++ neither library is available, and classify reads
    through h5py and numpy; nothing is built."""
    from deepbinner_tpu_torch.cli.classify import _select_read_fn
    from deepbinner_tpu_torch.runner.executor import _default_read_fn

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(fast5_reader, "_lib", None)
    monkeypatch.setattr(vbz, "_lib", None)
    assert build.missing("fast5_reader") == "no g++ on the path"
    assert not fast5_reader.available()
    assert not vbz.available()

    class Args:
        native_reader = True
        no_native_reader = False

    assert _select_read_fn(Args()) is _default_read_fn


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    if build.missing("vbz_decode") is not None:
        pytest.skip(f"no compiler here: {build.missing('vbz_decode')}")
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "vbz_decode.cc").write_text("int broken( {\n")
    monkeypatch.setattr(build, "SRC", str(tmp_path / "src"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for vbz_decode.cc"):
        build.build("vbz_decode")
    assert not list((tmp_path / "out").iterdir())


def test_concurrent_builds_give_one_library(monkeypatch, tmp_path):
    """Builds started together (as xdist workers do) all load one
    content-addressed library and leave no temporary file behind."""
    if build.missing("vbz_decode") is not None:
        pytest.skip(f"no compiler here: {build.missing('vbz_decode')}")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def one():
        try:
            paths.append(build.build("vbz_decode"))
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    threads = [threading.Thread(target=one) for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    assert errors == [] and len(set(paths)) == 1 and len(paths) == 4
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].split("/")[-1]]
    assert build.library_path("vbz_decode") == paths[0]


def test_bad_files_read_from_threads_leave_hdf5_quiet(native, tmp_path):
    """A threadsafe HDF5 keeps one error stack per thread: reads of a bad
    file from several threads print no diagnostics and leave no errors for
    the library's shutdown to trip over."""
    bad = tmp_path / "bad.fast5"
    bad.write_bytes(b"not an hdf5 file")
    script = (
        "import sys, threading\n"
        "from deepbinner_tpu_torch.native import fast5_reader\n"
        "def one():\n"
        "    try:\n"
        "        fast5_reader.read_file(sys.argv[1])\n"
        "    except OSError:\n"
        "        pass\n"
        "threads = [threading.Thread(target=one) for _ in range(4)]\n"
        "[t.start() for t in threads]\n"
        "[t.join() for t in threads]\n"
    )
    proc = subprocess.run([sys.executable, "-c", script, str(bad)],
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr
    assert "HDF5" not in proc.stderr, proc.stderr
