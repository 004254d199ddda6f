"""Data-parallel training of the port on the CPU: two gloo ranks follow one
process.

Every rank holds the same seeded global batches and takes its rows; the
step's draws are made at the global batch's shape, BatchNorm's statistics,
the loss denominator and the gradients are summed over the ranks
(tests/test_dist_train.py holds the JAX trainer's two processes to one).
The sums run in another order, so the bound is the five-step bound against
JAX (1e-4 relative), and the two ranks must end bit-identical.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deepbinner_tpu.models.checkpoint import load_model as jax_load_model
from deepbinner_tpu.train import trainer as jax_trainer
from deepbinner_tpu_torch.parallel import dist
from deepbinner_tpu_torch.train import data as data_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "DEEPBINNER_TPU_PROCESS_INDEX",
               "DEEPBINNER_TPU_PROCESS_COUNT")

# Five steps (the last with two weight-0 padding rows) and one evaluation
# of the tiny network, noise and dropout on; one process, or one rank of two.
_WORKER = r"""
import json
import numpy as np
from deepbinner_tpu_torch.parallel import dist
from deepbinner_tpu_torch.train.trainer import TINY_PRESET, TrainConfig, Trainer

dist.maybe_initialize("cpu")
rank, world = dist.group_rank_and_size()
cfg = TrainConfig(network=TINY_PRESET, batch_size=8, epochs=1,
                  test_fraction=0.0, seed=3)
assert cfg.network.noise_stddev > 0 and cfg.network.dropout_rate > 0
trainer = Trainer(cfg, "cpu", rank=rank, world=world)
rng = np.random.default_rng(11)            # the same stream on every rank
size = 2 * TINY_PRESET.input_length
losses = []
for step in range(5):
    signals = rng.normal(450, 50, (8, size)).astype(np.float32)
    labels = rng.integers(0, 13, 8).astype(np.int32)
    weights = np.ones(8, np.float32)
    if step == 4:
        weights[6:] = 0.0
    losses.append(float(trainer.run_train_step(signals, labels, weights)["loss"]))
eval_sig = rng.normal(450, 50, (15, size)).astype(np.float32)
eval_lab = rng.integers(0, 13, 15).astype(np.int32)
evaluation = trainer.run_eval(eval_sig, eval_lab, batch=6)  # 6, 6, 3 rows
print("RESULT:" + json.dumps({
    "rank": rank, "world": world, "losses": losses, "eval": evaluation,
    "state": {k: v.reshape(-1).tolist()
              for k, v in trainer.model.state_dict().items()},
}))
dist.shutdown()
"""


def _env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"  # several processes share the host
    env.update(extra)
    return env


def _run(argv_of, envs, timeout: float = 300) -> list:
    """Start one process per entry of ``envs`` and wait for all; on a
    timeout every process is killed.  Returns [(rc, out, err)]."""
    procs = [subprocess.Popen(argv_of(k), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env(env))
             for k, env in enumerate(envs)]
    try:
        outputs = [proc.communicate(timeout=timeout) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return [(proc.returncode, out, err)
            for proc, (out, err) in zip(procs, outputs)]


def _result(rc: int, out: str, err: str) -> dict:
    assert rc == 0, f"worker failed:\n{err[-3000:]}"
    for line in out.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(f"no RESULT line in:\n{out[-2000:]}")


@pytest.fixture(scope="module")
def runs():
    """(one process, [rank 0, rank 1]), all three started together."""
    port = dist.free_port()
    envs = [{}] + [dist.rank_environ(rank, 2, port) for rank in range(2)]
    results = [_result(*r) for r in _run(
        lambda _k: [sys.executable, "-c", _WORKER], envs)]
    return results[0], results[1:]


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def test_ranks_follow_one_process_losses(runs):
    single, ranks = runs
    assert single["world"] == 1 and [r["world"] for r in ranks] == [2, 2]
    assert [r["rank"] for r in ranks] == [0, 1]
    for rank in ranks:
        for got, want in zip(rank["losses"], single["losses"]):
            assert _rel(got, want) < 1e-4, (rank["losses"], single["losses"])
    assert len(set(single["losses"])) == 5  # the steps really trained


def test_ranks_follow_one_process_eval(runs):
    single, ranks = runs
    for rank in ranks:
        assert _rel(rank["eval"]["loss"], single["eval"]["loss"]) < 1e-4
        assert rank["eval"]["accuracy"] == single["eval"]["accuracy"]


def test_ranks_follow_one_process_running_statistics(runs):
    single, ranks = runs
    stats = [k for k in single["state"] if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * 9  # every unit of the tiny network
    for rank in ranks:
        for key in stats:
            np.testing.assert_allclose(rank["state"][key], single["state"][key],
                                       atol=1e-4, err_msg=key)
    # The statistics moved from their initial 0 and 1.
    assert any(abs(v) > 1e-3 for v in single["state"]["head_conv.mean"])
    assert any(abs(v - 1) > 1e-3 for v in single["state"]["stem1.var"])


def test_ranks_end_bit_identical(runs):
    _single, ranks = runs
    assert ranks[0]["state"] == ranks[1]["state"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["eval"] == ranks[1]["eval"]


def _cli(*argv) -> list:
    return [sys.executable, "-m", "deepbinner_tpu_torch.cli.main", *argv]


@pytest.fixture(scope="module")
def training_tsv(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_train")
    rng = np.random.default_rng(0)
    rows = [(int(label), rng.normal(450, 40, 320).astype(np.int16))
            for label in rng.integers(0, 13, 36)]
    path = root / "rows.tsv"
    data_io.write_samples(path, rows)
    return root, str(path)


def test_train_dp2_writes_one_model_jax_reads(training_tsv):
    root, data = training_tsv
    out, ckpt = root / "dp2.dbt", root / "ckpt"
    common = ("--size", "tiny", "--device", "cpu", "--batch_size", "8",
              "--test_fraction", "0.25")
    [(rc, _out, err)] = _run(lambda _k: _cli(
        "train", data, "--out", str(out), "--dp", "2", "--epochs", "2",
        "--checkpoint_dir", str(ckpt), *common), [{}])
    assert rc == 0, err[-3000:]
    assert "data-parallel: 2 ranks on this host" in err
    assert "(rank 0 of 2)" in err and "(rank 1 of 2)" in err
    assert err.count("saved model to") == 1  # rank 0 alone writes
    assert sorted(os.listdir(root)) == ["ckpt", "dp2.dbt", "rows.tsv"]
    assert sorted(os.listdir(ckpt)) == ["meta.json", "state.pt"]
    _model, _variables, cfg, meta = jax_load_model(str(out))
    assert cfg == jax_trainer.TINY_PRESET and meta["epochs"] == 2

    # Every rank reads the checkpoint on --resume.
    [(rc, _out, err)] = _run(lambda _k: _cli(
        "train", data, "--out", str(root / "dp2_resumed.dbt"), "--dp", "2",
        "--epochs", "3", "--resume", str(ckpt), *common), [{}])
    assert rc == 0, err[-3000:]
    assert err.count("resumed from") == 2
    assert err.count("epoch 3/3") == 2
    assert jax_load_model(str(root / "dp2_resumed.dbt"))[3]["epochs"] == 3


def test_a_failing_rank_fails_its_peer(training_tsv):
    """Rank 1 cannot read its data; it leaves the process group at once, and
    rank 0, waiting in the step's first collective, fails too (no hang)."""
    root, data = training_tsv
    port = dist.free_port()
    results = _run(lambda rank: _cli(
        "train", data if rank == 0 else str(root / "missing.tsv"),
        "--out", str(root / "never.dbt"), "--size", "tiny", "--device", "cpu",
        "--batch_size", "8", "--epochs", "1"),
        [dist.rank_environ(rank, 2, port) for rank in range(2)], timeout=120)
    assert [rc != 0 for rc, _o, _e in results] == [True, True]
    assert "missing.tsv" in results[1][2]
    assert "all_reduce" in results[0][2]  # it failed in a collective
    assert not (root / "never.dbt").exists()
