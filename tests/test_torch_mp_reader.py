"""The port's reader worker pool against the JAX package's, case for case
with tests/test_mp_reader.py: the same batches, bit for bit per read id,
over fast5, multifast5 and pod5 directories, as the JAX pool builds them or
as the JAX package's ``build_batch_arrays`` builds them from the reads of
its ``iter_signals_mp``."""

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
from deepbinner_tpu_torch.runner.mp_reader import ReaderPool

# The geometry of the batches built from whole reads below: the simulated
# reads are longer than two buffers, so the workers read heads and tails.
SPEC = dict(batch_size=4, buffer_size=256, dual=True)


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


def _rows(out, ids, start, start_len, end, end_len):
    """Add {read_id: (start row, start len, end row, end len)} of one batch
    to ``out``."""
    assert not start[len(ids):].any()  # rows beyond the ids are padding
    for i, read_id in enumerate(ids):
        out[read_id] = (start[i].copy(), int(start_len[i]),
                        None if end is None else end[i].copy(),
                        None if end_len is None else int(end_len[i]))


def _collect(pool, files, **kwargs):
    """The rows of one pass of the port's pool, releasing each zero-copy
    slot once its rows are copied out."""
    out = {}
    for batch in pool.iter_batches(files, **kwargs):
        assert isinstance(batch, hostbatch.Batch)
        assert len(batch.paths) == len(batch.ids)
        _rows(out, batch.ids, batch.start, batch.start_len, batch.end,
              batch.end_len)
        if batch.release is not None:
            batch.release()
    return out


def _collect_jax(pool, files):
    """The rows of one pass of the JAX package's pool."""
    out = {}
    for batch in pool.iter_batches(files):
        _rows(out, *batch[:5])
    return out


def _built(reads, spec=SPEC):
    """The rows the JAX package's build_batch_arrays makes of ``reads``,
    one read a batch."""
    jax_spec = jax_hostbatch.BatchSpec(**spec)
    out = {}
    for read_id, signal in reads.items():
        _rows(out, *jax_hostbatch.build_batch_arrays([(read_id, signal)],
                                                     jax_spec))
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


def test_mp_reader_reads_everything(tmp_path):
    """Every read of the dataset comes in the pickled transport's batches
    as the JAX package builds it from its pool's reads; a garbage file is
    skipped and counted."""
    files = _dataset(tmp_path, seed=3)
    garbage = tmp_path / "fast5s" / "zz_garbage.fast5"
    garbage.write_bytes(b"junk")
    files = jax_fast5.find_signal_files(tmp_path)

    jax_stats, stats = jax_executor.ExecutorStats(), executor.ExecutorStats()
    reads = dict(jax_mp_reader.iter_signals_mp(files, num_workers=2,
                                               stats=jax_stats))
    assert any(s.size > 2 * SPEC["buffer_size"] for s in reads.values())
    with ReaderPool(hostbatch.BatchSpec(**SPEC), num_workers=2) as pool:
        got = _collect(pool, files, stats=stats)
    _assert_same_batches(got, _built(reads))
    assert stats.failed_files == jax_stats.failed_files == 1
    assert stats.failed_paths == [str(garbage)]


def test_mp_reader_empty_input():
    with ReaderPool(hostbatch.BatchSpec(**SPEC), num_workers=2,
                    shm_slots=2) as pool:
        assert list(pool.iter_batches([])) == []
    assert list(jax_mp_reader.iter_signals_mp([], num_workers=2)) == []


def test_reader_pool_multi_pass_and_abandon(tmp_path):
    """One pool serves several passes; an abandoned pass leaks nothing; each
    batch names the file each of its reads came from."""
    files = _dataset(tmp_path, seed=4)
    want = _built(dict(jax_mp_reader.iter_signals_mp(files, num_workers=2)))
    with ReaderPool(hostbatch.BatchSpec(**SPEC), num_workers=2,
                    shm_slots=6) as pool:
        _assert_same_batches(_collect(pool, files), want)
        gen = pool.iter_batches(files, copy=False)
        next(gen)
        gen.close()
        _assert_same_batches(_collect(pool, files, copy=False), want)
        paths = {read_id: path for batch in pool.iter_batches(files)
                 for read_id, path in zip(batch.ids, batch.paths)}
    assert sorted(paths) == sorted(want)
    for read_id, path in paths.items():
        assert read_id in dict(jax_fast5.read_signal_file(path))


def test_reader_pool_worker_built_batches(tmp_path):
    """Batch mode: worker-built batches carry exactly the dataset's reads,
    as the JAX pool's do."""
    files = _dataset(tmp_path, seed=6)
    full = _h5py_reads(files)
    with jax_mp_reader.ReaderPool(
            num_workers=2, batch_spec=jax_hostbatch.BatchSpec(**SPEC)) as pool:
        want = _collect_jax(pool, files)
    with ReaderPool(hostbatch.BatchSpec(**SPEC), num_workers=2) as pool:
        got = _collect(pool, files)
        n2 = sum(len(b.ids) for b in pool.iter_batches(files))  # persistent
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
        want = _collect_jax(pool, files)
    with ReaderPool(spec, num_workers=2, shm_slots=3) as pool:
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
        want = _collect_jax(pool, files)

    with ReaderPool(hostbatch.BatchSpec(**spec), num_workers=2,
                    shm_slots=2, stall_timeout=30.0) as pool:
        got = {}
        for batch in pool.iter_batches(files, copy=False):
            assert batch.release is not None and batch.end is None
            for i, read_id in enumerate(batch.ids):
                got[read_id] = (batch.start[i].copy(),
                                int(batch.start_len[i]), None, None)
            batch.release()
            batch.release()  # idempotent: a double release must not double-free
        _assert_same_batches(got, want)

        gen = pool.iter_batches(files, copy=False)
        next(gen)
        next(gen)
        gen.close()
        n3 = 0
        for batch in pool.iter_batches(files, copy=False):
            n3 += len(batch.ids)
            batch.release()
        del batch  # the last slot's views go before the slots do
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
    with ReaderPool(hostbatch.BatchSpec(**SPEC), num_workers=2,
                    use_native=True, shm_slots=6) as pool:
        got = _collect(pool, files, copy=False)
    _assert_same_batches(got, _built(want))
    _assert_same_batches({read_id: got[read_id] for read_id, _s in reads},
                         _built(dict(reads)))
    assert len(got) > len(reads)  # the fast5s came through too


def test_reader_workers_import_no_torch(tmp_path):
    """A spawned worker, after a pass with the native reader, has loaded
    neither torch nor anything of JAX or the JAX package."""
    files = _dataset(tmp_path, seed=2, container="pod5")
    spec = hostbatch.BatchSpec(batch_size=4, buffer_size=256, dual=False,
                               wire="int16")
    with ReaderPool(spec, num_workers=2, shm_slots=4) as pool:
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
    with ReaderPool(hostbatch.BatchSpec(**SPEC), num_workers=2,
                    stall_timeout=300.0, shm_slots=6) as pool:
        pool._workers[1].terminate()
        pool._workers[1].join(timeout=10)
        with pytest.raises(RuntimeError, match="exited"):
            list(pool.iter_batches(files))


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


_HEAP_CHECK = r"""
import json, sys
import numpy as np
from deepbinner_tpu_torch.runner import mp_reader

def on_heap(array):
    at = array.ctypes.data
    with open("/proc/self/maps") as maps:
        for line in maps:
            if line.rstrip().endswith("[heap]"):
                lo, hi = (int(x, 16) for x in line.split()[0].split("-"))
                if lo <= at < hi:
                    return True
    return False

before = on_heap(np.ones(4 << 20, np.uint8))
if sys.argv[1] == "set":
    mp_reader._keep_temporaries_on_the_heap()
after = on_heap(np.ones(8 << 20, np.uint8))
print(json.dumps({"before": before, "after": after}))
"""


@pytest.mark.parametrize("setting", ["default", "set"])
def test_worker_keeps_its_batch_temporaries_on_the_heap(setting):
    """A reader worker fixes glibc's thresholds, so a block of several MiB
    comes from the heap instead of a mapping of its own, as it does by
    default (glibc's threshold grows only to the largest block freed so
    far, here 4 MiB).  In a child process: the setting is the whole
    process's."""
    import json
    import subprocess
    import sys

    if not os.path.exists("/proc/self/maps"):
        pytest.skip("no /proc/self/maps here to find the heap")
    proc = subprocess.run(
        [sys.executable, "-c", _HEAP_CHECK, setting], capture_output=True,
        text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["before"] is False  # glibc maps a 4 MiB block by default
    assert got["after"] is (setting == "set")
