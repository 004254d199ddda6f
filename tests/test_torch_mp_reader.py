"""The port's reader worker pool against the JAX package's, case for case
with tests/test_mp_reader.py: the same reads and the same batches, bit for
bit per read id, over fast5, multifast5 and pod5 directories."""

import multiprocessing as mp
import os

import numpy as np
import pytest

from deepbinner_tpu.ops.preprocess import PreprocessConfig as JaxPreprocessConfig
from deepbinner_tpu.runner import executor as jax_executor
from deepbinner_tpu.runner import hostbatch as jax_hostbatch
from deepbinner_tpu.runner import mp_reader as jax_mp_reader
from deepbinner_tpu.utils import fast5 as jax_fast5
from deepbinner_tpu.utils import pod5 as jax_pod5
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.runner import executor, hostbatch, mp_reader
from deepbinner_tpu_torch.runner.mp_reader import ReaderPool, iter_signals_mp


def _dataset(root, seed, container="fast5", none_reads=2):
    simulate.make_dataset(root, reads_per_barcode=1, none_reads=none_reads,
                          genome_length=300, seed=seed, write_fastq=False,
                          container=container, reads_per_container=4)
    return jax_fast5.find_signal_files(root)


def _h5py_reads(files):
    out = {}
    for path in files:
        out.update(jax_fast5.read_signal_file(path))
    return out


def _collect(pool, files, **kwargs):
    """{read_id: (start row, start len, end row, end len)} of one pass,
    releasing each zero-copy slot once the row is copied out."""
    out = {}
    for batch in pool.iter_batches(files, **kwargs):
        ids, start, start_len, end, end_len = batch[:5]
        assert not start[len(ids):].any()  # rows beyond the ids are padding
        for i, read_id in enumerate(ids):
            out[read_id] = (start[i].copy(), int(start_len[i]),
                            None if end is None else end[i].copy(),
                            None if end_len is None else int(end_len[i]))
        if len(batch) > 5:
            batch[5]()
    return out


def _assert_same_batches(got, want):
    assert sorted(got) == sorted(want)
    for read_id, (row, n, erow, en) in want.items():
        grow, gn, gerow, gen = got[read_id]
        assert (gn, gen) == (n, en), read_id
        np.testing.assert_array_equal(grow, row, err_msg=read_id)
        if erow is None:
            assert gerow is None
        else:
            np.testing.assert_array_equal(gerow, erow, err_msg=read_id)


def _assert_same_reads(got, want):
    assert sorted(got) == sorted(want)
    for read_id, signal in want.items():
        np.testing.assert_array_equal(got[read_id], signal, err_msg=read_id)


def test_mp_reader_reads_everything(tmp_path):
    files = _dataset(tmp_path, seed=3)
    garbage = tmp_path / "fast5s" / "zz_garbage.fast5"
    garbage.write_bytes(b"junk")
    files = jax_fast5.find_signal_files(tmp_path)

    jax_stats, stats = jax_executor.ExecutorStats(), executor.ExecutorStats()
    want = dict(jax_mp_reader.iter_signals_mp(files, num_workers=2,
                                              stats=jax_stats))
    got = dict(iter_signals_mp(files, num_workers=2, stats=stats))
    _assert_same_reads(got, want)
    assert stats.failed_files == jax_stats.failed_files == 1
    assert stats.failed_paths == [str(garbage)]


def test_mp_reader_empty_input():
    assert list(iter_signals_mp([], num_workers=2)) == []
    assert list(jax_mp_reader.iter_signals_mp([], num_workers=2)) == []


def test_reader_pool_multi_pass_and_abandon(tmp_path):
    """One pool serves several passes; an abandoned pass leaks nothing."""
    files = _dataset(tmp_path, seed=4)
    want = dict(jax_mp_reader.iter_signals_mp(files, num_workers=2))
    with ReaderPool(num_workers=2) as pool:
        _assert_same_reads(dict(pool.iter_reads(files)), want)
        gen = pool.iter_reads(files)
        next(gen)
        gen.close()
        _assert_same_reads(dict(pool.iter_reads(files)), want)
        paths = {read_id: path for read_id, _s, path
                 in pool.iter_reads_with_paths(files)}
    assert sorted(paths) == sorted(want)
    for read_id, path in paths.items():
        assert read_id in dict(jax_fast5.read_signal_file(path))


def test_reader_pool_worker_built_batches(tmp_path):
    """Batch mode: worker-built batches carry exactly the dataset's reads,
    as the JAX pool's do."""
    files = _dataset(tmp_path, seed=6)
    full = _h5py_reads(files)
    spec = dict(batch_size=4, buffer_size=256, dual=True)
    with jax_mp_reader.ReaderPool(
            num_workers=2, batch_spec=jax_hostbatch.BatchSpec(**spec)) as pool:
        want = _collect(pool, files)
    with ReaderPool(num_workers=2,
                    batch_spec=hostbatch.BatchSpec(**spec)) as pool:
        got = _collect(pool, files)
        n2 = sum(len(b[0]) for b in pool.iter_batches(files))  # persistent
    _assert_same_batches(got, want)
    assert n2 == len(full)
    for read_id, signal in full.items():
        row, n, erow, en = got[read_id]
        assert n == en == min(signal.size, 256)
        np.testing.assert_array_equal(row[:n], signal[:n])
        np.testing.assert_array_equal(erow[:n], signal[-n:][::-1])


@pytest.mark.parametrize("wire", ["int16", "int8"])
@pytest.mark.parametrize("container", ["fast5", "multifast5", "pod5"])
def test_reader_pool_shm_transport_bit_identical(tmp_path, container, wire):
    """The shared-memory transport against the JAX pool's, across two
    passes through 3 slots (slots really recycle), dual buffers and host
    trim included."""
    files = _dataset(tmp_path, seed=16, container=container, none_reads=3)
    cfg = dict(scan_size=768, window=256, stride=128, trim_scan=512,
               trim_window=64, trim_stride=16, host_trim=True, wire=wire)
    jax_spec = jax_executor.batch_spec_for(JaxPreprocessConfig(**cfg), 4, True)
    spec = executor.batch_spec_for(PreprocessConfig(**cfg), 4, True)
    assert spec.trim.raw_size == jax_spec.trim.raw_size
    with jax_mp_reader.ReaderPool(num_workers=2, batch_spec=jax_spec,
                                  shm_slots=3) as pool:
        want = _collect(pool, files)
    with ReaderPool(num_workers=2, batch_spec=spec, shm_slots=3) as pool:
        got = _collect(pool, files)
        got2 = _collect(pool, files)
    assert len(want) == 15
    _assert_same_batches(got, want)
    _assert_same_batches(got2, want)


@pytest.mark.parametrize("wire", ["int16", "int8"])
@pytest.mark.parametrize("trimmed", [False, True])
def test_build_batch_into_dirty_slot_views_bit_identical(wire, trimmed):
    """In-place assembly into dirty slot views == the JAX package's
    allocating path, twice through the same scratch."""
    trim = dict(trim_scan=64, trim_window=16, trim_stride=8,
                trim_threshold=0.8, window=64, scan_size=192)
    spec = hostbatch.BatchSpec(
        batch_size=4, buffer_size=192, dual=True, wire=wire,
        trim=hostbatch.TrimSpec(**trim) if trimmed else None)
    jax_spec = jax_hostbatch.BatchSpec(
        batch_size=4, buffer_size=192, dual=True, wire=wire,
        trim=jax_hostbatch.TrimSpec(**trim) if trimmed else None)
    rng = np.random.default_rng(11)
    reads = [
        ("a", rng.integers(300, 700, 1000).astype(np.int16)),
        ("b", rng.integers(300, 700, 120).astype(np.int16)),
        ("c", rng.integers(300, 700, 5000).astype(np.int16)),
    ]
    want = jax_hostbatch.build_batch_arrays(reads, jax_spec)
    buffer = bytearray(4 * spec.wire_row_bytes * 2 + 4 * 4 * 2)
    buffer[:] = b"\x55" * len(buffer)
    out = mp_reader._slot_views(buffer, spec)
    scratch = hostbatch.BatchScratch(spec)
    for _ in range(2):
        got = hostbatch.build_batch_arrays(reads, spec, out=out, scratch=scratch)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.shares_memory(np.asarray(got[1]), out[0])  # wrote in place


def test_quantise_wire_out_and_scratch_bit_identical():
    rng = np.random.default_rng(7)
    sig = rng.integers(-500, 500, (5, 96)).astype(np.int16)
    lens = np.asarray([96, 40, 0, 96, 7], np.int32)
    for i, n in enumerate(lens):
        sig[i, n:] = 0  # the documented zero-padding contract
    want = jax_hostbatch.quantise_wire(sig, lens)
    out = np.full((8, 96), 0x55, np.int8)  # oversized + dirty
    f32 = np.full((8, 96), np.nan, np.float32)
    got = hostbatch.quantise_wire(sig, lens, out=out, f32=f32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(out[:5], want)


def test_reader_pool_zero_copy_release_cycle(tmp_path):
    """copy=False yields slot VIEWS + release; with 2 slots and about 8
    batches the pass only progresses because releases recycle slots; a
    double release is harmless; an abandoned, never-released pass is
    reclaimed at the next pass."""
    files = _dataset(tmp_path, seed=21, none_reads=3)
    spec = dict(batch_size=2, buffer_size=256, dual=False, wire="int16")
    with jax_mp_reader.ReaderPool(
            num_workers=2, batch_spec=jax_hostbatch.BatchSpec(**spec),
            shm_slots=8) as pool:
        want = _collect(pool, files)

    with ReaderPool(num_workers=2, batch_spec=hostbatch.BatchSpec(**spec),
                    shm_slots=2, stall_timeout=30.0) as pool:
        got = {}
        for batch in pool.iter_batches(files, copy=False):
            assert len(batch) == 6
            ids, start, start_len, _e, _el, release = batch
            for i, read_id in enumerate(ids):
                got[read_id] = (start[i].copy(), int(start_len[i]), None, None)
            release()
            release()  # idempotent: a double release must not double-free
        _assert_same_batches(got, want)

        gen = pool.iter_batches(files, copy=False)
        next(gen)
        next(gen)
        gen.close()
        n3 = 0
        for batch in pool.iter_batches(files, copy=False):
            n3 += len(batch[0])
            batch[5]()
        assert n3 == len(want)


def test_mp_reader_decodes_pod5(tmp_path):
    """Worker processes route .pod5 through the pod5 parser even when the
    native (HDF5-only) reader is enabled."""
    rng = np.random.default_rng(8)
    reads = [(f"read_{i:04x}", rng.integers(200, 800, 3000).astype(np.int16))
             for i in range(3)]
    jax_pod5.write_pod5(tmp_path / "batch.pod5", reads)
    files = _dataset(tmp_path, seed=9, none_reads=0)
    assert any(f.endswith(".pod5") for f in files)

    want = dict(jax_mp_reader.iter_signals_mp(files, num_workers=2,
                                              use_native=True))
    got = dict(iter_signals_mp(files, num_workers=2, use_native=True))
    _assert_same_reads(got, want)
    for read_id, signal in reads:
        np.testing.assert_array_equal(got[read_id], signal)
    assert len(got) > len(reads)  # the fast5s came through too


def test_reader_pool_trim_preserves_batches(tmp_path):
    """Worker-side head/tail trimming leaves built batches bit-identical,
    and equal to the JAX package's batches of the full reads."""
    files = _dataset(tmp_path, seed=5)
    full = _h5py_reads(files)
    cfg = dict(scan_size=192, window=64, stride=64, trim_scan=64)
    buffer = PreprocessConfig(**cfg).buffer_size
    assert any(sig.size > 2 * buffer for sig in full.values())  # trim is real
    with ReaderPool(num_workers=2, trim_head=buffer, trim_tail=buffer) as pool:
        trimmed = dict(pool.iter_reads(files))

    order = sorted(full)
    ref = jax_executor.build_batch([(r, full[r]) for r in order],
                                   JaxPreprocessConfig(**cfg), len(order), True)
    got = executor.build_batch([(r, trimmed[r]) for r in order],
                               PreprocessConfig(**cfg), len(order), True)
    assert ref[0] == got[0]
    for a, b in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(a, b)


def test_reader_workers_import_no_torch(tmp_path):
    """A spawned worker, after a pass with the native reader, has loaded
    neither torch nor anything of JAX or the JAX package."""
    files = _dataset(tmp_path, seed=2, container="pod5")
    spec = hostbatch.BatchSpec(batch_size=4, buffer_size=256, dual=False,
                               wire="int16")
    with ReaderPool(num_workers=2, batch_spec=spec, shm_slots=4) as pool:
        assert len(_collect(pool, files)) == 14
        replies = pool.worker_modules()
    assert len(replies) == 2
    for modules in replies:
        assert "deepbinner_tpu_torch.runner.hostbatch" in modules
        assert "deepbinner_tpu_torch.utils.pod5" in modules
        foreign = [m for m in modules if m.split(".")[0] in
                   ("torch", "jax", "jaxlib", "flax", "deepbinner_tpu")]
        assert foreign == []


def test_dead_worker_raises_in_the_parent(tmp_path):
    """A worker that dies raises in the parent within seconds, not after
    the stall timeout."""
    files = _dataset(tmp_path, seed=12)
    with ReaderPool(num_workers=2, stall_timeout=300.0) as pool:
        pool._workers[1].terminate()
        pool._workers[1].join(timeout=10)
        with pytest.raises(RuntimeError, match="exited"):
            list(pool.iter_reads(files))


def test_ring_close_with_a_held_view():
    """Closing the ring while a consumer still holds a slot view neither
    raises nor leaves the segment's name behind."""
    spec = hostbatch.BatchSpec(batch_size=4, buffer_size=64, dual=True)
    ring = mp_reader._ShmRing(mp.get_context("spawn"), spec, 2)
    held = ring.views(ring.slots[0])
    held[0][:] = 7
    names = list(ring.names)
    ring.close()
    assert not ring.pinned
    for name in names:
        assert not os.path.exists(f"/dev/shm/{name}")
    assert int(held[0][0, 0]) == 7  # the held mapping is still valid
    del held
