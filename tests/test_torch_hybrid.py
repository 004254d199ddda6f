"""The port's hybrid composition against the JAX package's.

``apply_inference_kernels_hybrid`` runs the unit kernel only at the units
of a table (default ``HYBRID_KERNEL_UNITS``, the JAX table's scopes) and
the library's conv elsewhere; on the CPU every unit runs the plain
version.  It is held to JAX's ``apply_inference_pallas_hybrid`` (its
Pallas units in interpret mode) at 2e-5, to the unit composition with an
empty and with a full table, and a classify program on ``"hybrid"`` to the
same program on ``"unit"`` and to the JAX program with
``pallas_path="hybrid"``.  The card's version (kernel at the table, cuDNN
elsewhere) is in test_torch_cuda_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbinner_tpu.models import network as jax_network
from deepbinner_tpu.models import pallas_apply
from deepbinner_tpu.ops.calling import CallingConfig as JaxCallingConfig
from deepbinner_tpu.ops.preprocess import PreprocessConfig as JaxPreprocessConfig
from deepbinner_tpu.runner import executor as jax_executor
from deepbinner_tpu.runner import pipeline as jax_pipeline
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.models import kernel_apply
from deepbinner_tpu_torch.models.checkpoint import model_from_flax_variables
from deepbinner_tpu_torch.models.kernel_apply import (
    HYBRID_KERNEL_UNITS,
    apply_inference_kernels,
    apply_inference_kernels_hybrid,
    fold_network,
)
from deepbinner_tpu_torch.models.network import NetworkConfig, unit_scopes
from deepbinner_tpu_torch.ops.calling import CallingConfig
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.runner import executor
from deepbinner_tpu_torch.runner.pipeline import ClassifyConfig, ClassifyProgram

CPU = torch.device("cpu")
CONFIGS = {
    "tiny": dict(input_length=256, stem_features=8, block_features=(8,),
                 inception_features=(16,), head_features=16),
    # The flagship shape (2 blocks, 2 inceptions) at narrow widths.
    "flagship_shaped": dict(input_length=512, stem_features=16,
                            block_features=(16, 32),
                            inception_features=(32, 32), head_features=32),
}
PRE = dict(scan_size=768, window=256, stride=128, trim_scan=512,
           trim_window=64, trim_stride=16)


def _both(name, seed):
    """(JAX config, variables, port FoldedNet) of one config."""
    jax_cfg = jax_network.NetworkConfig(**CONFIGS[name])
    _model, variables = jax_network.init_params(jax.random.PRNGKey(seed), jax_cfg)
    variables = jax.device_get(variables)
    port = model_from_flax_variables(NetworkConfig(**CONFIGS[name]), variables)
    return jax_cfg, variables, fold_network(port, CPU)


def _windows(seed, batch, length):
    return np.random.default_rng(seed).normal(size=(batch, length)).astype(np.float32)


def test_table_is_the_jax_tables_scopes():
    assert HYBRID_KERNEL_UNITS == set(pallas_apply.HYBRID_PALLAS_UNITS)


@pytest.mark.parametrize("name,seed,batch", [("tiny", 1, 16),
                                             ("flagship_shaped", 3, 32)])
def test_hybrid_matches_jax_hybrid(name, seed, batch):
    jax_cfg, variables, net = _both(name, seed)
    x = _windows(seed, batch, jax_cfg.input_length)
    want = np.asarray(pallas_apply.apply_inference_pallas_hybrid(
        jax_cfg, variables, jnp.asarray(x), interpret=True))
    got = apply_inference_kernels_hybrid(net, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("table", ["empty", "full", "jax"])
def test_hybrid_equals_unit_composition(table, monkeypatch):
    """Whatever the table, every unit computes the same function: with no
    unit, all units or the JAX table on the kernel, the probabilities are
    the unit composition's; and the units in the table are the ones that
    go through the kernel's wrapper."""
    _jax_cfg, _variables, net = _both("flagship_shaped", 5)
    units = {"empty": frozenset(), "full": frozenset(unit_scopes(net.config)),
             "jax": HYBRID_KERNEL_UNITS}[table]
    calls = []
    wrapper = kernel_apply.fused_conv1d_bn_relu

    def counting(x, kernel, *args, **kwargs):
        calls.append(next(scope for scope, unit in net.units.items()
                          if unit[0] is kernel))
        return wrapper(x, kernel, *args, **kwargs)

    monkeypatch.setattr(kernel_apply, "fused_conv1d_bn_relu", counting)
    x = torch.from_numpy(_windows(6, 8, 512))
    got = apply_inference_kernels_hybrid(net, x, units=units)
    on_kernel = calls[:]
    calls.clear()
    want = apply_inference_kernels(net, x)
    assert calls == list(unit_scopes(net.config))  # the unit path: all 15
    assert set(on_kernel) == {s for s in unit_scopes(net.config)
                              if s in units or s.split("/")[-1] in units}
    if table == "jax":
        assert on_kernel == ["block0_conv2", "block1_conv2", "head_conv"]
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(11)
    out = []
    for barcode in list(range(1, 13)) + [0, 0]:
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=700)
        out.append((read.read_id, read.signal))
    return out


def _results(program, reads, stream):
    return {r.read_id: r for r in stream(program, iter(reads), batch_size=8)}


@pytest.mark.parametrize("dual", [False, True])
def test_hybrid_program_matches_unit_and_jax(reads, dual):
    fields = CONFIGS["tiny"]
    calling = dict(min_score=0.0, score_diff=0.0)
    trees = [jax.device_get(jax_network.init_params(
        jax.random.PRNGKey(seed), jax_network.NetworkConfig(**fields))[1])
        for seed in (6, 7)]
    start, end = [model_from_flax_variables(NetworkConfig(**fields), tree)
                  for tree in trees]

    def port(kernel_path):
        cfg = ClassifyConfig(PreprocessConfig(**PRE), CallingConfig(**calling),
                             dual_model=dual, kernel_path=kernel_path)
        return _results(ClassifyProgram(start, cfg, end_model=end if dual else None,
                                        device="cpu"),
                        reads, executor.classify_stream)

    jax_model, _ = jax_network.init_params(jax.random.PRNGKey(6),
                                           jax_network.NetworkConfig(**fields))
    jax_program = jax_pipeline.ClassifyProgram(
        jax_model, jax_pipeline.ClassifyConfig(
            JaxPreprocessConfig(**PRE), JaxCallingConfig(**calling),
            dual_model=dual, use_pallas=True, pallas_path="hybrid"),
        trees[0], trees[1] if dual else None)
    want = _results(jax_program, reads, jax_executor.classify_stream)
    hybrid, unit = port("hybrid"), port("unit")
    assert sorted(hybrid) == sorted(unit) == sorted(want)
    assert len({r.start_call for r in unit.values()}) > 1  # not one call for all
    for read_id, w in want.items():
        for got in (hybrid[read_id], unit[read_id]):
            assert (got.call, got.start_call, got.end_call) == \
                (w.call, w.start_call, w.end_call), read_id
            np.testing.assert_allclose(got.start_probs, w.start_probs, atol=3e-5)
            np.testing.assert_allclose(got.end_probs, w.end_probs, atol=3e-5)
