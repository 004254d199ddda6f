"""The port's parallel/{mesh,dist} against the JAX package's parallel/dist.

Two gloo ranks on the CPU, launched with torch's own variables (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), merge call tables and
verbose lines as the JAX module's two jax.distributed processes do
(tests/test_dist_multiprocess.py); the env-simulated sharding, the row
buffers and the layout rules are checked in this process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepbinner_tpu.parallel import dist as jax_dist
from deepbinner_tpu.parallel import mesh as jax_mesh
from deepbinner_tpu_torch.cli.main import main as port_main
from deepbinner_tpu_torch.parallel import dist, mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "DEEPBINNER_TPU_PROCESS_INDEX",
               "DEEPBINNER_TPU_PROCESS_COUNT")

_WORKER = r"""
import json, sys
from deepbinner_tpu_torch.parallel import dist

dist.maybe_initialize("cpu")
rank = int(sys.argv[1])
assert dist.process_count() == 2
assert dist.process_index() == rank
rows = [(f"read{i:03d}", f"barcode{(i % 12) + 1:02d}")
        for i in range(rank, 20, 2)]
lines = [f"read{i:03d}\tbarcode01\t0.99" for i in range(rank, 10, 2)]
if rank == 1:  # a larger payload on one rank: the gather pads to the widest
    lines.append("read999\tnone\t" + "0.5\t" * 40)
print("RESULT:" + json.dumps({
    "merged": dist.merge_call_tables(rows),
    "shard": dist.shard_files([f"f{i}.fast5" for i in range(11)]),
    "lines": dist.merge_lines(lines),
    "emit": dist.should_emit_table(),
}))
dist.shutdown()
"""


@pytest.fixture
def no_launch_env(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _rank_env(rank: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"  # several processes share the host
    env.update(dist.rank_environ(rank, 2, port))
    return env


def _run_ranks(argv_of, timeout: float = 240) -> list:
    """Start two ranks (``argv_of(rank)``), wait for both; on a failure or a
    timeout every rank is killed and the stderr of each is shown."""
    port = dist.free_port()
    procs = [subprocess.Popen(argv_of(rank), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=_rank_env(rank, port))
             for rank in range(2)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (_out, err) in zip(procs, outputs):
        assert proc.returncode == 0, f"rank failed:\n{err[-3000:]}"
    return outputs


def _result(out: str) -> dict:
    for line in out.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(f"no RESULT line in:\n{out[-2000:]}")


@pytest.fixture(scope="module")
def two_ranks():
    outputs = _run_ranks(lambda rank: [sys.executable, "-c", _WORKER,
                                       str(rank)])
    return [_result(out) for out, _err in outputs]


def test_two_ranks_merge_the_same_sorted_union(two_ranks):
    merged = [r["merged"] for r in two_ranks]
    assert merged[0] == merged[1]
    assert len(merged[0]) == 20 and merged[0] == sorted(merged[0])
    want = sorted((f"read{i:03d}", f"barcode{(i % 12) + 1:02d}")
                  for i in range(20))
    assert [tuple(r) for r in merged[0]] == want
    lines = [r["lines"] for r in two_ranks]
    assert lines[0] == lines[1] == sorted(lines[0])
    assert len(lines[0]) == 11
    assert [r["emit"] for r in two_ranks] == [True, False]


def test_two_ranks_shard_files_disjoint_and_covering(two_ranks):
    shards = [set(r["shard"]) for r in two_ranks]
    assert not shards[0] & shards[1]
    assert shards[0] | shards[1] == {f"f{i}.fast5" for i in range(11)}
    assert two_ranks[0]["shard"] == sorted(f"f{i}.fast5"
                                           for i in range(11))[0::2]


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_env_override_matches_jax_dist(no_launch_env, count):
    files = [f"run/{name}.pod5" for name in "qwertyuiopasdfg"]
    union = []
    for index in range(count):
        no_launch_env.setenv("DEEPBINNER_TPU_PROCESS_INDEX", str(index))
        no_launch_env.setenv("DEEPBINNER_TPU_PROCESS_COUNT", str(count))
        assert dist.process_index() == jax_dist.process_index() == index
        assert dist.process_count() == jax_dist.process_count() == count
        assert dist.shard_files(files) == jax_dist.shard_files(files)
        assert dist.should_emit_table() == jax_dist.should_emit_table()
        assert dist.is_primary_host() == jax_dist.is_primary_host()
        rows = [(f"r{index}{i}", "barcode01") for i in range(3)]
        assert dist.merge_call_tables(rows) == jax_dist.merge_call_tables(rows)
        lines = [f"r{index}\tx", f"r{index}\tx", "a\ty"]
        assert dist.merge_lines(lines) == jax_dist.merge_lines(lines)
        union += dist.shard_files(files)
    assert sorted(union) == sorted(files)


def test_no_group_is_one_process(no_launch_env):
    dist.maybe_initialize("cpu")  # no WORLD_SIZE: a no-op
    assert not torch.distributed.is_initialized()
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.group_rank_and_size() == (0, 1)
    assert dist.should_emit_table() and dist.is_primary_host()
    files = ["b.fast5", "a.fast5"]
    assert dist.shard_files(files) == files  # one process keeps its order
    dist.barrier()
    dist.shutdown()


@pytest.mark.parametrize("rows", [
    [],
    [("read001", "barcode01"), ("read002", "none")],
    [(f"é{i}", f"barcode{i % 12 + 1:02d}") for i in range(50)],
])
def test_encode_rows_round_trips_and_equals_jax(rows):
    width = len(json.dumps(rows).encode()) + 17
    buffer = dist._encode_rows(rows, width)
    assert buffer.dtype == np.uint8 and buffer.shape == (width + 8,)
    assert buffer.tobytes() == jax_dist._encode_rows(rows, width).tobytes()
    assert [tuple(r) for r in dist._decode_rows(buffer)] == rows
    assert dist._decode_rows(buffer) == jax_dist._decode_rows(buffer)
    with pytest.raises(ValueError):
        dist._encode_rows(rows + [("x" * width, "none")], width)


def test_process_group_that_fails_to_start_fails_the_run(no_launch_env,
                                                         tmp_path, capsys):
    no_launch_env.setenv("WORLD_SIZE", "2")
    no_launch_env.setenv("RANK", "0")  # MASTER_ADDR / MASTER_PORT missing
    with pytest.raises(SystemExit) as exc:
        port_main(["classify", str(tmp_path), "-s", "m.dbt", "--device", "cpu"])
    assert exc.value.code != 0
    assert "process group did not come up" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cards,local_world,local_rank,want", [
    (1, 1, 0, [0]),
    (4, 1, 0, [0, 1, 2, 3]),
    (4, 4, 2, [2]),
    (4, 2, 1, [1, 3]),
    (1, 2, 1, [0]),        # two ranks share the one card
    (2, 3, 2, [0]),
    (0, 2, 1, []),
])
def test_process_cards(no_launch_env, cards, local_world, local_rank, want):
    no_launch_env.setattr(torch.cuda, "device_count", lambda: cards)
    no_launch_env.setenv("LOCAL_WORLD_SIZE", str(local_world))
    no_launch_env.setenv("LOCAL_RANK", str(local_rank))
    assert mesh.process_cards() == want
    assert mesh.ranks_share_cards() == (local_world > cards)
    shared = local_world > cards
    assert dist.collective_backend("cuda") == (
        "gloo" if shared else "cpu:gloo,cuda:nccl")
    assert dist.collective_backend("cpu") == "gloo"


def test_local_devices(no_launch_env):
    no_launch_env.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.local_devices("cpu", 0) == [torch.device("cpu")]
    assert mesh.local_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh.local_devices("cuda", 0) == [torch.device("cuda", 0),
                                             torch.device("cuda", 1)]
    assert mesh.local_devices("cuda", 1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="has 2 card"):
        mesh.local_devices("cuda", 3)


@pytest.mark.parametrize("n,parts", [(8, 1), (8, 2), (8, 3), (256, 4),
                                     (5, 8), (0, 2)])
def test_split_rows(n, parts):
    bounds = mesh.split_rows(n, parts)
    assert len(bounds) == parts
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("size,multiple", [(5, 2), (6, 3), (1, 4), (7, 1)])
def test_pad_to_multiple_matches_jax(size, multiple):
    array = np.arange(size * 3, dtype=np.float32).reshape(size, 3)
    np.testing.assert_array_equal(mesh.pad_to_multiple(array, multiple),
                                  jax_mesh.pad_to_multiple(array, multiple))
