"""The port's ``'model'`` axis (column-parallel K1 units), its forward entry
and its multi-device dry run, against the JAX package.

- the column rule (``parallel/mesh.split_axis``) against
  ``deepbinner_tpu.parallel.mesh.param_sharding`` leaf for leaf;
- each unit's column shards, gathered in rank order, against the whole
  unit (plain versions, 1e-6);
- the dry-run classify on an 8-entry CPU grid with ``model = 2`` against
  ``__graft_entry__._dryrun_classify`` on JAX's 8-device mesh: the same
  reads, equal calls, combined probabilities within 3e-5, and a permuted
  dense head that the check catches;
- ``entry()``'s step against ``__graft_entry__.entry()``'s at the flagship
  width, and the dry run's gloo training ranks against one process.
"""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from deepbinner_tpu.models.checkpoint import load_model as jax_load_model
from deepbinner_tpu.ops.calling import CallingConfig as JaxCallingConfig
from deepbinner_tpu.ops.preprocess import PreprocessConfig as JaxPreprocessConfig
from deepbinner_tpu.parallel import mesh as jax_mesh
from deepbinner_tpu.runner import pipeline as jax_pipeline
from deepbinner_tpu.utils import simulate as jax_simulate
from deepbinner_tpu_torch import entry as port_entry
from deepbinner_tpu_torch.models import kernel_apply
from deepbinner_tpu_torch.models.checkpoint import (
    load_model,
    model_from_flax_variables,
    to_flax_variables,
)
from deepbinner_tpu_torch.models.kernel_apply import (
    apply_inference_kernels,
    apply_inference_kernels_tp,
    fold_network,
    shard_network,
)
from deepbinner_tpu_torch.models.keras_import import KerasGraphModel
from deepbinner_tpu_torch.models.network import DemuxNet, NetworkConfig, init_weights
from deepbinner_tpu_torch.ops.calling import CallingConfig
from deepbinner_tpu_torch.ops.conv_kernel import conv1d_bn_relu_reference
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.parallel import mesh
from deepbinner_tpu_torch.runner.pipeline import ClassifyConfig, ClassifyProgram
from deepbinner_tpu_torch.train.trainer import TINY_PRESET, TrainConfig, Trainer

TINY_MODEL = port_entry.TINY_MODEL
TINY_NET = NetworkConfig(input_length=256, stem_features=8, block_features=(8,),
                         inception_features=(16,), head_features=16)
CONFIGS = {"tiny": TINY_NET, "flagship": NetworkConfig()}
CPU = torch.device("cpu")


def _port_model(name: str, seed: int = 0) -> DemuxNet:
    return init_weights(DemuxNet(CONFIGS[name]),
                        torch.Generator().manual_seed(seed))


def _jax_leaf(path) -> str:
    """A flax variables path → the port's state-dict name."""
    keys = [k.key for k in path]
    if keys[:2] == ["params", "classifier"]:
        return {"kernel": "classifier.weight", "bias": "classifier.bias"}[keys[2]]
    return ".".join(keys[1:-2] + [keys[-1]])


# -- the column rule ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("model", [2, 4])
def test_split_rule_matches_param_sharding(name, model):
    variables = to_flax_variables(_port_model(name))
    grid = jax_mesh.make_mesh(jax.devices()[:8], model=model)
    specs = jax_mesh.param_sharding(grid, variables)
    state = _port_model(name).state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "spec"))[0]
    assert len(leaves) == len(state)
    split = 0
    for path, sharding in leaves:
        leaf = _jax_leaf(path)
        tensor = state[leaf]
        axis = mesh.split_axis(leaf, tuple(tensor.shape), model)
        spec = tuple(sharding.spec)
        if "model" not in spec:
            assert axis is None, (leaf, spec)
            continue
        split += 1
        # JAX splits the trailing axis of its layout: the port's output axis.
        assert spec.index("model") == len(spec) - 1, (leaf, spec)
        assert axis == mesh.output_axis(leaf, tensor.dim()), (leaf, axis)
        shards = [mesh.shard_columns(tensor, axis, r, model) for r in range(model)]
        torch.testing.assert_close(torch.cat(shards, dim=axis), tensor,
                                   rtol=0, atol=0)
    # Every conv kernel; the 13-class head stays whole.
    assert split == len(_geometries(CONFIGS[name]))


def test_make_grid_checks_as_make_mesh():
    cpu = ["cpu"] * 8
    assert [len(row) for row in mesh.make_grid(cpu, model=2)] == [2] * 4
    assert [len(row) for row in mesh.make_grid(cpu, data=3, model=2)] == [2] * 3
    for kwargs, message in (({"model": 0}, ">= 1"), ({"model": 3}, "divisible"),
                            ({"data": 5, "model": 2}, "need 10 devices")):
        with pytest.raises(ValueError, match=message):
            mesh.make_grid(cpu, **kwargs)
    for kwargs in ({"model": 0}, {"model": 3}, {"data": 5, "model": 2}):
        with pytest.raises(ValueError):
            jax_mesh.make_mesh(jax.devices()[:8], **kwargs)


def test_undivided_columns_stay_whole():
    tensor = torch.arange(13 * 4, dtype=torch.float32).reshape(13, 4)
    assert mesh.split_axis("classifier.weight", (13, 4), 2) is None
    torch.testing.assert_close(mesh.shard_columns(tensor, 0, 1, 2), tensor)
    with pytest.raises(ValueError):
        mesh.shard_columns(tensor, 1, 2, 2)


# -- column-parallel units ------------------------------------------------------

def _geometries(config):
    """(scope, length, dilation, pool) of every unit, in order."""
    length = config.input_length
    units = [("stem1", length, 1, False), ("stem2", length, 1, True)]
    length //= 2
    for i in range(len(config.block_features)):
        units += [(f"block{i}_conv1", length, 1, False),
                  (f"block{i}_conv2", length, 1, True)]
        length //= 2
    for i in range(len(config.inception_features)):
        for branch, dilation in (("branch1x1", 1), ("branch3", 1),
                                 ("branch_dilated", 2 ** (i + 1)),
                                 ("branch_pool", 1)):
            units.append((f"inception{i}/{branch}", length, dilation, True))
        length //= 2
    units.append(("head_conv", length, 1, False))
    return units


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("model", [2, 4])
def test_gathered_shards_equal_the_whole_unit(name, model):
    net = fold_network(_port_model(name, seed=1), CPU)
    shards = [shard_network(net, r, model) for r in range(model)]
    gen = torch.Generator().manual_seed(2)
    assert len(_geometries(net.config)) == (15 if name == "flagship" else 9)
    for scope, length, dilation, pool in _geometries(net.config):
        kernel = net.units[scope][0]
        x = torch.randn((3, length, kernel.shape[1]), generator=gen)
        want = conv1d_bn_relu_reference(x, *net.units[scope],
                                        dilation=dilation, pool=pool)
        parts = []
        for shard in shards:
            weights = shard.units[scope]
            assert all(t.is_contiguous() for t in weights)
            assert weights[0].shape[2] == kernel.shape[2] // model
            parts.append(conv1d_bn_relu_reference(x, *weights,
                                                  dilation=dilation, pool=pool))
        torch.testing.assert_close(torch.cat(parts, dim=-1), want,
                                   rtol=0, atol=1e-6)
        assert scope in shards[0].split


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_column_parallel_network_matches_the_unit_path(name, monkeypatch):
    net = fold_network(_port_model(name, seed=1), CPU)
    windows = torch.randn((4, net.config.input_length),
                          generator=torch.Generator().manual_seed(3))
    want = apply_inference_kernels(net, windows)
    monkeypatch.setattr(kernel_apply, "GATHERS", 0)
    got = apply_inference_kernels_tp([shard_network(net, r, 2)
                                      for r in range(2)], windows)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert kernel_apply.GATHERS == len(_geometries(net.config))


def test_two_ranks_on_one_device_hold_their_own_shards():
    model, _cfg, _meta = load_model(TINY_MODEL)
    cfg = ClassifyConfig(PreprocessConfig(scan_size=768, window=256, stride=128),
                         CallingConfig())
    program = ClassifyProgram(model, cfg, devices=["cpu"] * 4, model=2)
    assert [len(row) for row in program.grid] == [2, 2]
    assert program.leaders == [CPU, CPU]
    start, end = program.nets[0]
    assert end is None and len(start) == 2
    lo, hi = (s.units["stem2"][0] for s in start)
    assert lo.shape[2] == hi.shape[2] == 4 and not torch.equal(lo, hi)
    assert program.nets[1] is program.nets[0]  # the same row, folded once


@pytest.mark.parametrize("kernel_path", ["fused", "split3", "hybrid"])
def test_model_axis_refuses_other_kernel_paths(kernel_path):
    model, _cfg, _meta = load_model(TINY_MODEL)
    cfg = ClassifyConfig(kernel_path=kernel_path)
    ClassifyProgram(model, cfg, devices=["cpu"] * 2)  # data parallel runs
    with pytest.raises(ValueError, match="model axis of 2"):
        ClassifyProgram(model, cfg, devices=["cpu"] * 2, model=2)


def test_model_axis_refuses_split_and_a_keras_graph():
    with pytest.raises(ValueError, match="unknown kernel_path"):
        ClassifyConfig(kernel_path="split")
    spec = importlib.util.spec_from_file_location(
        "demuxnet_as_keras", os.path.join(os.path.dirname(__file__), "..",
                                          "scripts", "demuxnet_as_keras.py"))
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    model, net_cfg, _meta = load_model(TINY_MODEL)
    graph = KerasGraphModel(*converter.demuxnet_as_keras(
        net_cfg, to_flax_variables(model)))
    cfg = ClassifyConfig()
    ClassifyProgram(graph, cfg, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="Keras graph"):
        ClassifyProgram(graph, cfg, devices=["cpu"] * 2, model=2)
    with pytest.raises(ValueError, match="Keras graph"):
        ClassifyProgram(model, dataclasses.replace(cfg, dual_model=True),
                        end_model=graph, devices=["cpu"] * 2, model=2)


# -- the dry run -------------------------------------------------------------------

def _jax_grid():
    return jax_mesh.make_mesh(jax.devices()[:8], model=2)


def _jax_reads(pre):
    """__graft_entry__._dryrun_classify's reads, built with the JAX package."""
    rng = np.random.default_rng(3)
    sig = np.zeros((16, pre.buffer_size), np.int16)
    lens = np.zeros((16,), np.int32)
    for i in range(16):
        read = jax_simulate.simulate_read("EXP-NBD103", i % 13, rng,
                                          genome_length=400)
        n = min(read.signal.size, pre.buffer_size)
        sig[i, :n] = read.signal[:n]
        lens[i] = n
    return sig, lens


@pytest.fixture(scope="module")
def port_dryrun():
    grid = mesh.make_grid(["cpu"] * 8, model=2)
    return port_entry._dryrun_classify(grid)


def test_dryrun_classify_matches_jax(port_dryrun):
    got = port_dryrun
    jax_calls, jax_truth, jax_params = ge._dryrun_classify(_jax_grid(), jax_mesh)
    model, variables, net_cfg, _meta = jax_load_model(TINY_MODEL)
    window = net_cfg.input_length
    pre = JaxPreprocessConfig(scan_size=3 * window, window=window,
                              stride=window // 2)
    sig, lens = _jax_reads(pre)
    np.testing.assert_array_equal(got.signal, sig)
    np.testing.assert_array_equal(got.lengths, lens)
    np.testing.assert_array_equal(got.truth, jax_truth)
    np.testing.assert_array_equal(got.calls, jax_calls)
    assert got.n_params == jax_params
    program = jax_pipeline.ClassifyProgram(
        model, jax_pipeline.ClassifyConfig(preprocess=pre,
                                           calling=JaxCallingConfig()),
        variables, mesh=_jax_grid())
    want = np.asarray(jax.device_get(program(sig, lens).start_probs))
    np.testing.assert_allclose(got.probs, want, rtol=0, atol=3e-5)
    dist = np.bincount(got.calls, minlength=13)
    assert int((dist > 0).sum()) >= 3, dist.tolist()
    assert (got.calls == got.truth).mean() >= 0.5


def _roll_classes(model: DemuxNet) -> DemuxNet:
    """test_graft_entry's mutation: roll the 12 barcode columns of the head."""
    idx = np.r_[0, np.roll(np.arange(1, 13), 1)]
    with torch.no_grad():
        model.classifier.weight.copy_(model.classifier.weight[idx])
        model.classifier.bias.copy_(model.classifier.bias[idx])
    return model


def test_dryrun_classify_catches_class_permutation(port_dryrun):
    grid = mesh.make_grid(["cpu"] * 8, model=2)
    mutated = port_entry._dryrun_classify(grid, mutate=_roll_classes)
    np.testing.assert_array_equal(mutated.truth, port_dryrun.truth)
    assert not np.array_equal(mutated.calls, port_dryrun.calls)
    base = (port_dryrun.calls == port_dryrun.truth).mean()
    assert (mutated.calls == port_dryrun.truth).mean() < base


def test_entry_matches_graft_entry():
    rows = 4
    jax_fn, (variables, signal, lengths) = ge.entry()
    want = jax.device_get(jax_fn(variables, signal[:rows], lengths[:rows]))
    fn, (net, port_signal, port_lengths) = port_entry.entry("cpu")
    assert port_signal.shape == tuple(signal.shape)
    assert torch.equal(port_signal, torch.zeros_like(port_signal))
    assert torch.equal(port_lengths, torch.from_numpy(np.array(lengths)))
    assert net.config == NetworkConfig()
    carried = fold_network(model_from_flax_variables(
        NetworkConfig(), jax.device_get(variables)), CPU)
    got = fn(carried, port_signal[:rows], port_lengths[:rows])
    np.testing.assert_array_equal(got.calls.numpy(), np.asarray(want.calls))
    np.testing.assert_allclose(got.start_probs.numpy(),
                               np.asarray(want.start_probs), rtol=0, atol=3e-5)
    # The port's own weights run through the same step.
    own = fn(net, port_signal[:rows], port_lengths[:rows])
    assert own.calls.shape == (rows,)
    assert torch.isfinite(own.start_probs).all()


def test_entry_needs_the_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(4)


def test_dryrun_multichip_train_ranks_follow_one_process(capsys):
    summary = port_entry.dryrun_multichip(8, device="cpu")
    assert summary["grid"] == {"data": 4, "model": 2}
    assert len(summary["losses"]) == 4
    cfg = TrainConfig(network=TINY_PRESET, batch_size=16, epochs=1,
                      test_fraction=0.0, seed=0)
    signals, labels = port_entry._train_batch(16)
    one = float(Trainer(cfg, "cpu").run_train_step(signals, labels)["loss"])
    for loss in summary["losses"]:
        assert np.isfinite(loss)
        assert abs(loss - one) <= 1e-4 * abs(one), (summary["losses"], one)
    assert summary["distinct"] >= 3 and summary["truth_match"] >= 0.5
    out = capsys.readouterr().out
    assert "dryrun classify ok: dp calls == tp calls on 16" in out
    assert "grid {'data': 4, 'model': 2}" in out


def test_model_axis_of_one_and_odd_counts():
    assert [port_entry.model_axis(n) for n in (1, 2, 3, 4, 6, 8)] == [1, 1, 1, 2, 2, 2]
    assert port_entry.dryrun_devices(3, "cpu") == [CPU] * 3
