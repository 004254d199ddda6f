"""The port's `classify` CLI (``--device cpu``) against the JAX CLI.

Same model file, same simulated fast5/pod5 directories: plain TSVs must be
byte-identical; verbose TSVs must have the same ids and calls, with each
probability within 1e-4 (``%.4f`` rounding of values that differ by ~1e-6
can move the last digit).
"""

import sys
import threading

import jax
import numpy as np
import pytest
import torch

from deepbinner_tpu.cli.main import main as jax_main
from deepbinner_tpu.models.checkpoint import save_model
from deepbinner_tpu.models.network import NetworkConfig, init_params
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.cli.main import main as port_main
from deepbinner_tpu_torch.runner import executor
from deepbinner_tpu_torch.utils import pod5 as port_pod5
from deepbinner_tpu_torch.utils.fast5 import find_signal_files, read_signal_file

TINY_NET = NetworkConfig(
    input_length=256, stem_features=8, block_features=(8,),
    inception_features=(16,), head_features=16,
)
GEOMETRY = ("--scan_size", "768", "--batch_size", "8")
DATASET = dict(kit="EXP-NBD103", reads_per_barcode=1, none_reads=2,
               genome_length=600, seed=11, write_fastq=False)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    paths = []
    for seed, end in ((0, "start"), (1, "end")):
        _, variables = init_params(jax.random.PRNGKey(seed), TINY_NET)
        path = root / f"{end}s.dbt"
        save_model(path, TINY_NET, variables, {"kit": "EXP-NBD103", "end": end})
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    out = {}
    for container in ("fast5", "multifast5", "pod5"):
        truth = simulate.make_dataset(root / container, container=container,
                                      reads_per_container=5, **DATASET)
        out[container] = (root / container / "fast5s", truth)
    return out


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def _both(dataset_dir, models, capsys, extra=(), dual=False, jax_extra=()):
    argv = ["classify", str(dataset_dir), "-s", models[0], *GEOMETRY, *extra]
    if dual:
        argv += ["-e", models[1]]
    want = _run(jax_main, argv + list(jax_extra), capsys)
    got = _run(port_main, argv + ["--device", "cpu"], capsys)
    return got, want


@pytest.mark.parametrize("container", ["fast5", "multifast5", "pod5"])
@pytest.mark.parametrize("dual", [False, True])
def test_plain_table_byte_identical(datasets, models, capsys, container, dual):
    directory, truth = datasets[container]
    # The JAX CLI reads pod5 on one thread: its shared zstd context is not
    # thread-safe (the fault the port's copy repairs).
    jax_extra = ("--num_readers", "1") if container == "pod5" else ()
    got, want = _both(directory, models, capsys, dual=dual, jax_extra=jax_extra)
    assert got == want
    assert len(got.splitlines()) == len(truth) + 1


@pytest.mark.parametrize("extra", [("--wire", "int16"), ("--wire", "int4"),
                                   ("--device_trim",), ("--combine", "best"),
                                   ("--min_score", "0", "--score_diff", "0"),
                                   ("--native_reader",), ("--no_native_reader",)])
def test_options_byte_identical(datasets, models, capsys, extra):
    got, want = _both(datasets["fast5"][0], models, capsys, extra=extra)
    assert got == want


@pytest.mark.parametrize("container,dual", [
    ("fast5", False), ("fast5", True), ("multifast5", False), ("pod5", True),
])
def test_reader_processes_byte_identical(datasets, models, capsys, container,
                                         dual):
    """--reader_processes 2: worker processes decode the files and build
    the batches, handed over in shared-memory slots; the JAX CLI reads with
    its threads (one for pod5, fault R1)."""
    directory, truth = datasets[container]
    argv = ["classify", str(directory), "-s", models[0], *GEOMETRY]
    if dual:
        argv += ["-e", models[1]]
    want = _run(jax_main, argv + ["--num_readers", "1"], capsys)
    got = _run(port_main, argv + ["--device", "cpu", "--reader_processes", "2",
                                  "--shm_slots", "3"], capsys)
    assert got == want
    assert len(got.splitlines()) == len(truth) + 1


def test_abandoned_pool_pass_leaves_no_worker(datasets, models, capsys):
    """Fault R2 for the pool: a pass abandoned mid-stream drops no read of
    the next pass, and close() leaves no worker alive."""
    from deepbinner_tpu_torch.cli.classify import StreamRunner, build_program
    from deepbinner_tpu_torch.cli.main import get_arguments

    directory, truth = datasets["fast5"]
    args = get_arguments(["classify", str(directory), "-s", models[0],
                          "--scan_size", "768", "--batch_size", "2",
                          "--device", "cpu", "--reader_processes", "2",
                          "--shm_slots", "6"])
    program, _ = build_program(args)
    stats = executor.ExecutorStats()
    runner = StreamRunner(program, args, stats)
    files = find_signal_files(directory)
    try:
        assert runner.pool is not None and not runner.pool.pinned
        results = runner.classify(files)
        next(results)
        results.close()
        assert not any(t.name == "classify-batch-feeder" and t.is_alive()
                       for t in threading.enumerate())
        again = [r.read_id for r in runner.classify(files)]
        assert sorted(again) == sorted(truth)
    finally:
        runner.close()
    assert not any(worker.is_alive() for worker in runner.pool._workers)
    capsys.readouterr()


@pytest.mark.parametrize("dual", [False, True])
def test_pallas_byte_identical(datasets, models, capsys, dual):
    """--pallas: the port's CUDA megakernel path (its plain version on the
    CPU) against the JAX CLI's Pallas megakernel (interpret mode)."""
    got, want = _both(datasets["fast5"][0], models, capsys, extra=("--pallas",),
                      dual=dual)
    assert got == want
    assert len(got.splitlines()) == len(datasets["fast5"][1]) + 1


@pytest.mark.parametrize("dual", [False, True])
def test_verbose_table_matches(datasets, models, capsys, dual):
    directory, truth = datasets["fast5"]
    got, want = _both(directory, models, capsys, extra=("--verbose",), dual=dual)
    got_rows = [line.split("\t") for line in got.splitlines()]
    want_rows = [line.split("\t") for line in want.splitlines()]
    assert got_rows[0] == want_rows[0]  # header
    assert len(got_rows) == len(truth) + 1
    n_calls = 4 if dual else 2
    for g, w in zip(got_rows[1:], want_rows[1:]):
        assert g[:n_calls] == w[:n_calls]
        np.testing.assert_allclose(np.asarray(g[n_calls:], float),
                                   np.asarray(w[n_calls:], float), atol=1e-4)


def test_shard_resume(datasets, models, capsys, tmp_path):
    """Kill-and-rerun with --shard_dir: byte-identical output, finished
    shards are not reclassified, a changed sharding or model is refused."""
    directory, _ = datasets["fast5"]
    argv = ["classify", str(directory), "-s", models[0], *GEOMETRY,
            "--device", "cpu"]
    plain = _run(port_main, argv, capsys)
    assert plain == _run(jax_main, argv[:-2], capsys)
    extra = ["--shard_dir", str(tmp_path / "shards"), "--shard_files", "2"]
    assert _run(port_main, argv + extra, capsys) == plain
    shards = sorted(p for p in (tmp_path / "shards").iterdir()
                    if p.name.startswith("shard_"))
    assert len(shards) > 2
    victim = shards[-1]
    victim.unlink()
    before = {p.name: p.stat().st_mtime_ns for p in shards[:-1]}
    assert _run(port_main, argv + extra, capsys) == plain
    assert victim.exists()
    for p in shards[:-1]:
        assert p.stat().st_mtime_ns == before[p.name]
    with pytest.raises(SystemExit):
        port_main(argv + ["--shard_dir", str(tmp_path / "shards"),
                          "--shard_files", "3"])
    other = argv.copy()
    other[3] = models[1]
    with pytest.raises(SystemExit):
        port_main(other + extra)
    capsys.readouterr()


def test_shard_retries_failed_files(datasets, models, capsys, tmp_path):
    directory, _ = datasets["fast5"]
    argv = ["classify", str(directory), "-s", models[0], *GEOMETRY,
            "--device", "cpu"]
    plain = _run(port_main, argv, capsys)
    victim = sorted(directory.iterdir())[0]
    original = victim.read_bytes()
    extra = ["--shard_dir", str(tmp_path / "shards"), "--shard_files", "4"]
    try:
        victim.write_bytes(b"not an hdf5 file")
        partial = _run(port_main, argv + extra, capsys)
        assert len(partial.splitlines()) == len(plain.splitlines()) - 1
        assert len(list((tmp_path / "shards").glob("*.failed"))) == 1
    finally:
        victim.write_bytes(original)
    assert _run(port_main, argv + extra, capsys) == plain
    assert not list((tmp_path / "shards").glob("*.failed"))


def test_all_unreadable_fails_loud(models, capsys, tmp_path):
    (tmp_path / "a.fast5").write_bytes(b"garbage")
    (tmp_path / "b.pod5").write_bytes(b"garbage")
    with pytest.raises(SystemExit):
        port_main(["classify", str(tmp_path), "-s", models[0], *GEOMETRY,
                   "--device", "cpu"])
    capsys.readouterr()


@pytest.mark.parametrize("argv", [
    ["train", "data.tsv", "--out", "m.dbt", "--dp", "64"],
    ["train", "data.tsv", "--out", "m.dbt", "--dp", "128", "--device", "cuda"],
    ["train", "data.tsv", "--out", "m.dbt", "--dp", "256", "--size", "tiny"],
])
def test_unported_subcommands_exit_nonzero(argv, capsys):
    """Every subcommand is ported, data-parallel training included; ``--dp``
    above the cards present exits non-zero, as the JAX CLI's mesh refuses
    more devices than it has."""
    with pytest.raises(SystemExit) as exc:
        port_main(argv)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "not ported yet" not in err
    assert f"--dp {argv[5]} exceeds the" in err and "card(s) present" in err


def test_device_count_above_one_is_refused(datasets, models, capsys,
                                           monkeypatch):
    """``--device_count`` above the cards of this process is refused, as the
    JAX CLI refuses more devices than the process can address (one card is
    made to show here; on ``--device cpu`` every count is entries of the
    CPU: tests/test_torch_cli_dp.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        port_main(["classify", str(datasets["fast5"][0]), "-s", models[0],
                   *GEOMETRY, "--device_count", "2"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "--device_count 2" in err and "this process has 1 card(s)" in err


def test_default_device_is_the_card(datasets, models, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(SystemExit) as exc:
        port_main(["classify", str(datasets["fast5"][0]), "-s", models[0],
                   *GEOMETRY])
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_pod5_threaded_readers_lose_no_read(tmp_path):
    """Fault R1 of the JAX package: one zstd context shared by the reader
    threads dropped reads.  The port's copy keeps one per thread."""
    rng = np.random.default_rng(0)
    expected = {}
    for f in range(12):
        reads = [(f"r{f}_{k}", rng.integers(200, 800, int(rng.integers(1000, 9000)))
                  .astype(np.int16)) for k in range(6)]
        port_pod5.write_pod5(tmp_path / f"b{f:02d}.pod5", reads, chunk_size=700)
        expected.update(reads)
    files = find_signal_files(tmp_path)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _attempt in range(6):
            stats = executor.ExecutorStats()
            got = dict(executor.iter_signals(files, num_readers=4, stats=stats,
                                             read_fn=read_signal_file))
            assert stats.failed_files == 0, stats.failed_errors
            assert sorted(got) == sorted(expected)
            for read_id, signal in expected.items():
                np.testing.assert_array_equal(got[read_id], signal)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.name == "classify-reader" and t.is_alive()
                   for t in threading.enumerate())
