"""The port's `realtime` watcher (``--device cpu``) against the JAX one.

Mirrors the seven tests of ``tests/test_realtime.py`` (a fake MinKNOW
producer on a timer, the stop file, bounded watch state, the reader-pool
soak, garbage skipped but retried, a dead pool respawned, a poison file
isolated) and adds: the port and the JAX `realtime`, run on two copies of
the same incoming fast5 or pod5 files, leave the same ``out_dir`` tree; and
without ``--device cpu`` the port exits with "no CUDA device" here.
"""

import os
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deepbinner_tpu.cli.main import main as jax_main
from deepbinner_tpu.models.checkpoint import save_model
from deepbinner_tpu.models.network import NetworkConfig, init_params
from deepbinner_tpu_torch.cli import realtime as rt
from deepbinner_tpu_torch.cli.main import main
from deepbinner_tpu_torch.utils import simulate
from deepbinner_tpu_torch.utils.fast5 import write_single_read_fast5
from deepbinner_tpu_torch.utils.pod5 import write_pod5

TINY_NET = NetworkConfig(
    input_length=256, stem_features=8, block_features=(8,),
    inception_features=(16,), head_features=16,
)
GEOMETRY = ("--scan_size", "768", "--batch_size", "8")
ANY_CALL = ("--min_score", "0.0", "--score_diff", "0.0")


def _save_tiny(path, seed):
    _, variables = init_params(jax.random.PRNGKey(seed), TINY_NET)
    save_model(path, TINY_NET, variables, {"kit": "EXP-NBD103", "end": "start"})
    return str(path)


@pytest.fixture
def tiny_model(tmp_path):
    return _save_tiny(tmp_path / "starts.dbt", 0)


def _producer(in_dir, n_reads, delay_s):
    """Write fast5s on a timer, like MinKNOW finishing reads."""
    rng = np.random.default_rng(0)
    for i in range(n_reads):
        read = simulate.simulate_read(
            "EXP-NBD103", (i % 12) + 1, rng, genome_length=300
        )
        # write-then-rename so the watcher never sees a partial file
        final = os.path.join(in_dir, f"{read.read_id}.fast5")
        tmp = final + ".part"
        write_single_read_fast5(tmp, read.read_id, read.signal)
        os.replace(tmp, final)
        time.sleep(delay_s)


def _moved(out_dir, suffix=".fast5"):
    return [os.path.join(root, name)
            for root, _dirs, names in os.walk(out_dir)
            for name in names if name.endswith(suffix)]


def _stop_when_sorted(out_dir, n_files, stop, timeout_s=120):
    """A thread that writes the stop file once ``n_files`` are sorted (or
    after ``timeout_s``)."""

    def monitor():
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(_moved(out_dir, "")) >= n_files:
                break
            time.sleep(0.2)
        stop.write_text("")

    thread = threading.Thread(target=monitor, daemon=True)
    thread.start()
    return thread


def _realtime(in_dir, out_dir, model, *extra):
    main(["realtime", "--in_dir", str(in_dir), "--out_dir", str(out_dir),
          "-s", model, *GEOMETRY, "--device", "cpu", *extra])


def test_realtime_sorts_files(tmp_path, tiny_model):
    in_dir, out_dir, stop = tmp_path / "incoming", tmp_path / "sorted", tmp_path / "stop"
    in_dir.mkdir()
    n_reads = 6
    producer = threading.Thread(
        target=_producer, args=(str(in_dir), n_reads, 0.1), daemon=True
    )
    producer.start()
    watcher = _stop_when_sorted(out_dir, n_reads, stop)
    _realtime(in_dir, out_dir, tiny_model, *ANY_CALL, "--poll_interval", "0.2",
              "--stop_file", str(stop))
    producer.join(timeout=60)
    watcher.join(timeout=60)
    assert [f for f in os.listdir(in_dir) if f.endswith(".fast5")] == []
    assert len(_moved(out_dir)) == n_reads


def test_realtime_stop_file(tmp_path, tiny_model):
    in_dir = tmp_path / "incoming"
    in_dir.mkdir()
    stop = tmp_path / "stop"
    stop.write_text("")
    t0 = time.monotonic()
    _realtime(in_dir, tmp_path / "sorted", tiny_model, "--poll_interval", "0.1",
              "--stop_file", str(stop))
    assert time.monotonic() - t0 < 60  # exits promptly (warm-up included)


def test_watch_state_bounded():
    """Seen/attempt bookkeeping is pruned to the current directory listing,
    while abandoned (still-present) files stay remembered."""
    state = rt._WatchState()
    for i in range(1000):
        state.done.add(f"/in/read_{i}.fast5")
    for _ in range(rt._MAX_ATTEMPTS):
        state.record_attempt("/in/bad.fast5", unreadable=True)
    assert "/in/bad.fast5" in state.done  # abandoned after max attempts

    state.prune({"/in/bad.fast5", "/in/new.fast5"})
    assert state.done == {"/in/bad.fast5"}
    assert state.attempts == {"/in/bad.fast5": rt._MAX_ATTEMPTS}

    # A readable-but-unclassifiable file is given up on immediately.
    state.record_attempt("/in/new.fast5", unreadable=False)
    assert "/in/new.fast5" in state.done
    state.prune(set())
    assert not state.done and not state.attempts


def test_realtime_soak_reader_pool(tmp_path, tiny_model, monkeypatch):
    """Files arrive across many polls through the ReaderPool path; the
    classify process never decodes a signal file itself."""

    def poison(*_a, **_k):
        raise AssertionError("realtime decoded a file in the classify process")

    monkeypatch.setattr(rt, "read_signal_file", poison)
    monkeypatch.setattr(rt, "_classify_new_files", poison)

    in_dir, out_dir, stop = tmp_path / "incoming", tmp_path / "sorted", tmp_path / "stop"
    in_dir.mkdir()
    n_reads = 24
    producer = threading.Thread(
        target=_producer, args=(str(in_dir), n_reads, 0.1), daemon=True
    )
    producer.start()
    watcher = _stop_when_sorted(out_dir, n_reads, stop, timeout_s=180)
    _realtime(in_dir, out_dir, tiny_model, *ANY_CALL, "--poll_interval", "0.05",
              "--stop_file", str(stop), "--reader_processes", "2",
              "--no_native_reader")
    producer.join(timeout=60)
    watcher.join(timeout=60)
    assert [f for f in os.listdir(in_dir) if f.endswith(".fast5")] == []
    assert len(_moved(out_dir)) == n_reads


def test_realtime_skips_garbage_but_retries(tmp_path, tiny_model):
    """A persistently unreadable file is left in place, not moved."""
    in_dir = tmp_path / "incoming"
    in_dir.mkdir()
    (in_dir / "bad.fast5").write_bytes(b"never valid hdf5")
    (in_dir / "bad.pod5").write_bytes(b"never a pod5")
    rng = np.random.default_rng(1)
    read = simulate.simulate_read("EXP-NBD103", 3, rng, genome_length=300)
    write_single_read_fast5(in_dir / "good.fast5", read.read_id, read.signal)
    _realtime(in_dir, tmp_path / "sorted", tiny_model, *ANY_CALL,
              "--poll_interval", "0.05", "--max_batches", "1")
    assert not (in_dir / "good.fast5").exists()  # classified + moved
    assert (in_dir / "bad.fast5").exists()       # left in place, not moved
    assert (in_dir / "bad.pod5").exists()


def test_realtime_survives_reader_pool_death(tmp_path, tiny_model, monkeypatch):
    """A dead pool must not abort the watch: the loop respawns the workers
    and the files are sorted on a later scan."""
    real = rt._classify_new_files_pool
    fail_once = {"armed": True}

    def flaky(program, pool, new_files, args, counts, **kwargs):
        if fail_once["armed"]:
            fail_once["armed"] = False
            raise RuntimeError("reader pool stalled (simulated worker death)")
        return real(program, pool, new_files, args, counts, **kwargs)

    monkeypatch.setattr(rt, "_classify_new_files_pool", flaky)

    in_dir, out_dir, stop = tmp_path / "incoming", tmp_path / "sorted", tmp_path / "stop"
    in_dir.mkdir()
    n_reads = 4
    _producer(str(in_dir), n_reads, 0.0)  # all files present up front
    watcher = _stop_when_sorted(out_dir, n_reads, stop)
    _realtime(in_dir, out_dir, tiny_model, *ANY_CALL, "--poll_interval", "0.05",
              "--stop_file", str(stop), "--reader_processes", "1",
              "--no_native_reader")
    watcher.join(timeout=60)
    assert not fail_once["armed"], "the simulated failure never fired"
    assert len(_moved(out_dir)) == n_reads, "files lost after pool respawn"


def test_realtime_poison_file_isolated(tmp_path, tiny_model, monkeypatch):
    """A file that crashes the pool on every scan must not take the healthy
    files of its scan down with it: after a respawn the scan is retried one
    file at a time, so only the culprit is charged attempts."""
    real = rt._classify_new_files_pool
    crashes = {"n": 0}

    def flaky(program, pool, new_files, args, counts, **kwargs):
        if any(os.path.basename(p) == "poison.fast5" for p in new_files):
            crashes["n"] += 1
            raise RuntimeError("simulated native crash in a worker")
        return real(program, pool, new_files, args, counts, **kwargs)

    monkeypatch.setattr(rt, "_classify_new_files_pool", flaky)

    in_dir, out_dir, stop = tmp_path / "incoming", tmp_path / "sorted", tmp_path / "stop"
    in_dir.mkdir()
    n_reads = 3
    _producer(str(in_dir), n_reads, 0.0)  # healthy files, present up front
    (in_dir / "poison.fast5").write_bytes(b"crashes the pool, per flaky()")
    watcher = _stop_when_sorted(out_dir, n_reads, stop)
    _realtime(in_dir, out_dir, tiny_model, *ANY_CALL, "--poll_interval", "0.05",
              "--stop_file", str(stop), "--reader_processes", "1",
              "--no_native_reader")
    watcher.join(timeout=60)
    assert crashes["n"] >= 2, "the poison file never exercised the handler"
    assert len(_moved(out_dir)) == n_reads, "healthy files were abandoned"
    assert (in_dir / "poison.fast5").exists()  # never moved, only abandoned


def _incoming(directory, container):
    """Single-read files (and, for pod5, one three-read container), all
    present before the watch starts."""
    directory.mkdir()
    rng = np.random.default_rng(21)
    reads = [simulate.simulate_read("EXP-NBD103", b, rng, genome_length=400)
             for b in list(range(13)) + [5, 9]]
    for read in reads[:12]:
        if container == "fast5":
            write_single_read_fast5(directory / f"{read.read_id}.fast5",
                                    read.read_id, read.signal)
        else:
            write_pod5(directory / f"{read.read_id}.pod5",
                       [(read.read_id, read.signal)])
    if container == "pod5":
        write_pod5(directory / "multi.pod5",
                   [(r.read_id, r.signal) for r in reads[12:]])
    return len(os.listdir(directory))


def _tree(out_dir):
    return sorted(os.path.relpath(path, out_dir) for path in _moved(out_dir, ""))


@pytest.mark.parametrize("container", ["fast5", "pod5"])
def test_realtime_same_out_dir_tree_as_jax(tmp_path, capsys, container):
    # PRNGKey(6) spreads these reads over two calls (the multi-read pod5
    # holds both), where most seeds give one call for every read.
    model = _save_tiny(tmp_path / "varied.dbt", 6)
    n_files = _incoming(tmp_path / "in_jax", container)
    shutil.copytree(tmp_path / "in_jax", tmp_path / "in_port")
    argv = ["-s", model, *GEOMETRY, *ANY_CALL, "--poll_interval", "0.05",
            "--max_batches", "1"]
    jax_main(["realtime", "--in_dir", str(tmp_path / "in_jax"),
              "--out_dir", str(tmp_path / "out_jax"), *argv])
    capsys.readouterr()
    main(["realtime", "--in_dir", str(tmp_path / "in_port"),
          "--out_dir", str(tmp_path / "out_port"), *argv, "--device", "cpu"])
    want = _tree(tmp_path / "out_jax")
    assert len(want) == n_files
    assert len({os.path.dirname(p) for p in want}) > 1  # more than one bin
    assert _tree(tmp_path / "out_port") == want
    assert os.listdir(tmp_path / "in_port") == []
    if container == "pod5":
        assert "multi.pod5 holds reads with mixed calls" in capsys.readouterr().err


def test_realtime_default_device_is_the_card(tmp_path, tiny_model, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    (tmp_path / "incoming").mkdir()
    with pytest.raises(SystemExit) as exc:
        main(["realtime", "--in_dir", str(tmp_path / "incoming"),
              "--out_dir", str(tmp_path / "sorted"), "-s", tiny_model,
              *GEOMETRY, "--max_batches", "1"])
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
