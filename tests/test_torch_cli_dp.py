"""Data-parallel and multi-process `classify` of the port on the CPU, against
the JAX CLI.

``--device_count`` splits each batch over that many entries of the CPU (the
JAX CLI splits it over conftest's 8 virtual CPU devices); two port
processes joined by a gloo process group classify a file shard each, and
rank 0 prints the merged table.  Plain TSVs must be byte-identical in every
layout (tests/test_cli_dp.py, tests/test_dist_multiprocess.py).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deepbinner_tpu.cli.main import main as jax_main
from deepbinner_tpu.models.checkpoint import save_model
from deepbinner_tpu.models.network import NetworkConfig, init_params
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.cli.main import main as port_main
from deepbinner_tpu_torch.models.checkpoint import load_model
from deepbinner_tpu_torch.ops.calling import CallingConfig
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.parallel import dist
from deepbinner_tpu_torch.runner.executor import build_batch
from deepbinner_tpu_torch.runner.pipeline import (
    ClassifyConfig,
    ClassifyProgram,
    unpack_call_table,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NET = NetworkConfig(
    input_length=256, stem_features=8, block_features=(8,),
    inception_features=(16,), head_features=16,
)
TINY_PRE = PreprocessConfig(
    scan_size=768, window=256, stride=128, trim_scan=512,
    trim_window=64, trim_stride=16,
)
GEOMETRY = ("--scan_size", "768", "--batch_size", "8", "--min_score", "0.0",
            "--score_diff", "0.0")
LAUNCH_VARS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "DEEPBINNER_TPU_PROCESS_INDEX",
               "DEEPBINNER_TPU_PROCESS_COUNT")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    truth = simulate.make_dataset(
        root, kit="EXP-NBD103", reads_per_barcode=2, none_reads=2,
        genome_length=500, seed=13, write_fastq=False,
    )
    models = []
    for seed, end in ((6, "start"), (1, "end")):
        _, variables = init_params(jax.random.PRNGKey(seed), TINY_NET)
        path = root / f"{end}s.dbt"
        save_model(path, TINY_NET, variables, {"kit": "EXP-NBD103", "end": end})
        models.append(str(path))
    return root / "fast5s", models, truth


@pytest.fixture(scope="module")
def jax_table(setup):
    """The JAX CLI's table at --device_count 8 (conftest's virtual devices)."""
    directory, models, _truth = setup
    assert len(jax.devices()) == 8
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        jax_main(["classify", str(directory), "-s", models[0], *GEOMETRY,
                  "--device_count", "8"])
    return out.getvalue()


@pytest.mark.parametrize("count,used", [(1, 1), (2, 2), (4, 4), (3, 2)])
def test_device_count_tables_byte_identical(setup, jax_table, capsys,
                                            count, used):
    directory, models, truth = setup
    port_main(["classify", str(directory), "-s", models[0], *GEOMETRY,
               "--device", "cpu", "--device_count", str(count)])
    got = capsys.readouterr()
    assert got.out == jax_table
    assert len(got.out.splitlines()) == len(truth) + 1
    # 3 does not divide the batch of 8: the count drops to 2.
    assert (f"data-parallel over {used} device(s)" in got.err) == (used > 1)


def test_device_count_tables_call_more_than_one_class(jax_table):
    calls = {line.split("\t")[1] for line in jax_table.splitlines()[1:]}
    assert len(calls) > 1  # the comparison would be void on one call


def _reads(count: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", simulate.simulate_read(
        "EXP-NBD103", i % 13, rng, genome_length=600).signal)
        for i in range(count)]


@pytest.mark.parametrize("dual", [False, True])
def test_two_device_program_equals_one_device(setup, dual):
    _directory, models, _truth = setup
    model = load_model(models[0])[0]
    end = load_model(models[1])[0] if dual else None
    cfg = ClassifyConfig(TINY_PRE, CallingConfig(), dual_model=dual)
    one = ClassifyProgram(model, cfg, end_model=end, device="cpu")
    two = ClassifyProgram(model, cfg, end_model=end, devices=["cpu", "cpu"])
    assert two.devices == [torch.device("cpu")] * 2
    assert len(two.nets) == 2 and two.nets[0] is two.nets[1]  # folded once
    reads = _reads(8, seed=5)
    _ids, sig, lens, end_sig, end_lens = build_batch(reads, TINY_PRE, 8, dual)
    arrays = (sig, lens, end_sig, end_lens) if dual else (sig, lens)
    parts = two.upload(*arrays)
    assert [len(p) for p in parts if p is not None] == [2] * len(arrays)
    assert [t.shape[0] for t in parts[0]] == [4, 4]
    assert two.upload_events() == []  # the CPU: uploads are done on return
    want = unpack_call_table(one.call_packed(*arrays))
    got = unpack_call_table(two.call_packed(*arrays))
    np.testing.assert_array_equal(got.calls, want.calls)
    np.testing.assert_array_equal(got.start_calls, want.start_calls)
    np.testing.assert_array_equal(got.end_calls, want.end_calls)
    np.testing.assert_allclose(got.start_probs, want.start_probs, atol=2e-5)
    np.testing.assert_allclose(got.end_probs, want.end_probs, atol=2e-5)
    table = two(*arrays)  # the unpacked call gathers the same rows
    np.testing.assert_array_equal(table.calls.numpy(), want.calls)
    # Uneven splits and already-uploaded parts go through as well.
    odd = ClassifyProgram(model, cfg, end_model=end, devices=["cpu"] * 3)
    np.testing.assert_array_equal(
        unpack_call_table(odd.call_packed(*odd.upload(*arrays))).calls,
        want.calls)


def test_program_needs_a_device(setup):
    _directory, models, _truth = setup
    with pytest.raises(ValueError, match="at least one"):
        ClassifyProgram(load_model(models[0])[0], ClassifyConfig(TINY_PRE),
                        devices=[])


def _rank_env(rank: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"  # several processes share the host
    env.update(dist.rank_environ(rank, 2, port))
    return env


def _classify_argv(directory, model, *extra) -> list:
    return [sys.executable, "-m", "deepbinner_tpu_torch.cli.main", "classify",
            str(directory), "-s", model, *GEOMETRY, "--device", "cpu", *extra]


def _two_ranks(argv) -> list:
    """Run ``argv`` as two ranks of a gloo process group; [(out, err)] by
    rank.  One retry, as the JAX pair test has, and the first attempt's
    diagnostics are printed."""
    failure = None
    for attempt in range(2):
        port = dist.free_port()
        procs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=_rank_env(rank, port))
                 for rank in range(2)]
        outputs, failure = [], None
        try:
            for proc in procs:
                out, err = proc.communicate(timeout=300)
                outputs.append((out, err))
                if proc.returncode != 0 and failure is None:
                    failure = (f"rank failed (rc {proc.returncode}):\n"
                               f"stdout:\n{out[-1000:]}\nstderr:\n{err[-3000:]}")
        except subprocess.TimeoutExpired:
            failure = "a rank did not finish within 300 s"
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        if failure is None:
            return outputs
        print(f"[attempt {attempt}] {failure}", file=sys.stderr)
    raise AssertionError(failure)


def test_two_process_classify_matches_single_process(setup, jax_table):
    directory, models, _truth = setup
    single = subprocess.run(_classify_argv(directory, models[0]),
                            capture_output=True, text=True, timeout=300,
                            env=_rank_env(0, 0) | {"WORLD_SIZE": "1"})
    assert single.returncode == 0, single.stderr[-3000:]
    assert single.stdout == jax_table
    outputs = _two_ranks(_classify_argv(directory, models[0],
                                        "--device_count", "2"))
    for _out, err in outputs:
        assert "process group: rank" in err and "over gloo" in err
        assert "this host: " in err
        assert "data-parallel over 2 device(s)" in err
    assert outputs[0][0] == single.stdout
    assert outputs[1][0] == ""


def test_two_process_shard_dir_resumes(setup, jax_table, tmp_path):
    directory, models, _truth = setup
    argv = _classify_argv(directory, models[0], "--shard_dir",
                          str(tmp_path / "shards"), "--shard_files", "4")
    first = _two_ranks(argv)
    assert first[0][0] == jax_table and first[1][0] == ""
    names = sorted(os.listdir(tmp_path / "shards"))
    assert "manifest_h0000.json" in names and "manifest_h0001.json" in names
    assert any(n.startswith("shard_h0001_") for n in names)
    rerun = _two_ranks(argv)
    assert rerun[0][0] == jax_table and rerun[1][0] == ""
    for _out, err in rerun:
        assert "(this host; 0 classified in 0 batch(es) + " in err
        assert "resumed:" in err
