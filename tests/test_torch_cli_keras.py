"""The port's `classify` and `realtime` CLIs on Keras-HDF5 models against the
JAX CLI's.

The models are DemuxNet graphs at the tiny width written as Keras 2.2 HDF5
files (``scripts/demuxnet_as_keras.py`` and the writer of
test_torch_keras_import.py) from JAX's initial weights.  With one `.h5`
model or two (start and end), the plain TSV is byte-identical to the JAX
CLI's on the same files; ``--pallas`` on a `.h5` logs that it runs the
graph and gives the same TSV; `realtime` with a `.h5` model sorts the same
files into the same bins.
"""

import os
import shutil

import jax
import numpy as np
import pytest

from deepbinner_tpu.cli.main import main as jax_main
from deepbinner_tpu.models.checkpoint import save_model
from deepbinner_tpu.models.network import NetworkConfig, init_params
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.cli.main import main as port_main
from deepbinner_tpu_torch.utils.pod5 import write_pod5

pytest.importorskip("h5py")

from test_torch_keras_import import demuxnet_as_keras, write_keras22_h5  # noqa: E402

TINY_NET = NetworkConfig(
    input_length=256, stem_features=8, block_features=(8,),
    inception_features=(16,), head_features=16,
)
GEOMETRY = ("--scan_size", "768", "--batch_size", "8")
ANY_CALL = ("--min_score", "0.0", "--score_diff", "0.0")
FALLBACK = "--pallas only supports native .dbt models"


def _keras_model(path, seed):
    _, variables = init_params(jax.random.PRNGKey(seed), TINY_NET)
    config, weights = demuxnet_as_keras(TINY_NET, jax.device_get(variables))
    return write_keras22_h5(path, config, weights)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("keras_models")
    return [_keras_model(root / "starts.h5", 6), _keras_model(root / "ends.h5", 7)]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    out = {}
    for container in ("fast5", "pod5"):
        truth = simulate.make_dataset(
            root / container, container=container, reads_per_container=5,
            kit="EXP-NBD103", reads_per_barcode=1, none_reads=2,
            genome_length=600, seed=11, write_fastq=False)
        out[container] = (root / container / "fast5s", truth)
    return out


def _both(capsys, argv, jax_extra=()):
    """(port stdout, port stderr, JAX stdout) of one classify argv."""
    jax_main(argv + list(jax_extra))
    want = capsys.readouterr().out
    port_main(argv + ["--device", "cpu"])
    got = capsys.readouterr()
    return got.out, got.err, want


@pytest.mark.parametrize("container", ["fast5", "pod5"])
@pytest.mark.parametrize("dual", [False, True])
def test_keras_plain_table_byte_identical(datasets, models, capsys, container,
                                          dual):
    directory, truth = datasets[container]
    argv = ["classify", str(directory), "-s", models[0], *GEOMETRY, *ANY_CALL]
    if dual:
        argv += ["-e", models[1]]
    # The JAX CLI reads pod5 on one thread (fault R1).
    jax_extra = ("--num_readers", "1") if container == "pod5" else ()
    got, _err, want = _both(capsys, argv, jax_extra)
    assert got == want
    assert len(got.splitlines()) == len(truth) + 1
    calls = {line.split("\t")[1] for line in got.splitlines()[1:]}
    assert len(calls) > 1 or dual  # the single table is not one call for all


def test_pallas_on_keras_runs_the_graph(datasets, models, capsys):
    directory, _truth = datasets["fast5"]
    argv = ["classify", str(directory), "-s", models[0], "-e", models[1],
            *GEOMETRY, *ANY_CALL]
    plain, _err, _want = _both(capsys, argv)
    got, err, want = _both(capsys, argv + ["--pallas"])
    assert FALLBACK in err
    assert got == want == plain


def test_mixed_model_files_are_refused(datasets, models, capsys, tmp_path):
    """A `.dbt` start model with a `.h5` end model: the configs differ, so
    both CLIs refuse the pair."""
    _, variables = init_params(jax.random.PRNGKey(0), TINY_NET)
    dbt = str(tmp_path / "starts.dbt")
    save_model(dbt, TINY_NET, variables, {"kit": "EXP-NBD103"})
    argv = ["classify", str(datasets["fast5"][0]), "-s", dbt, "-e", models[1],
            *GEOMETRY]
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(argv + extra)
        assert exc.value.code != 0
        assert "different architectures" in capsys.readouterr().err


def _tree(out_dir):
    return sorted(os.path.relpath(os.path.join(root, name), out_dir)
                  for root, _dirs, names in os.walk(out_dir) for name in names)


def test_realtime_keras_same_bins_as_jax(models, tmp_path):
    incoming = tmp_path / "in_jax"
    incoming.mkdir()
    rng = np.random.default_rng(21)
    for barcode in range(13):
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=400)
        write_pod5(incoming / f"{read.read_id}.pod5",
                   [(read.read_id, read.signal)])
    shutil.copytree(incoming, tmp_path / "in_port")
    argv = ["-s", models[0], *GEOMETRY, *ANY_CALL, "--poll_interval", "0.05",
            "--max_batches", "1"]
    jax_main(["realtime", "--in_dir", str(incoming),
              "--out_dir", str(tmp_path / "out_jax"), *argv])
    port_main(["realtime", "--in_dir", str(tmp_path / "in_port"),
               "--out_dir", str(tmp_path / "out_port"), *argv,
               "--device", "cpu"])
    want = _tree(tmp_path / "out_jax")
    assert len(want) == 13
    assert len({os.path.dirname(p) for p in want}) > 1  # more than one bin
    assert _tree(tmp_path / "out_port") == want
    assert os.listdir(tmp_path / "in_port") == []
