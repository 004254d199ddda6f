"""The port's classify program and executor against the JAX package's.

Same weights (carried by ``from_flax_variables``), same simulated reads:
calls must be equal and combined probabilities within 3e-5.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from deepbinner_tpu.models.network import NetworkConfig as JaxNetworkConfig
from deepbinner_tpu.models.network import init_params
from deepbinner_tpu.ops.calling import CallingConfig as JaxCallingConfig
from deepbinner_tpu.ops.preprocess import PreprocessConfig as JaxPreprocessConfig
from deepbinner_tpu.runner import executor as jax_executor
from deepbinner_tpu.runner import pipeline as jax_pipeline
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.models.checkpoint import model_from_flax_variables
from deepbinner_tpu_torch.models.network import NetworkConfig
from deepbinner_tpu_torch.ops.calling import CallingConfig
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.runner import executor
from deepbinner_tpu_torch.runner.pipeline import (
    ClassifyConfig,
    ClassifyProgram,
    pack_call_table,
    unpack_call_table,
)

NET = dict(input_length=256, stem_features=8, block_features=(8,),
           inception_features=(16,), head_features=16)
PRE = dict(scan_size=768, window=256, stride=128, trim_scan=512,
           trim_window=64, trim_stride=16)


@pytest.fixture(scope="module")
def weights():
    out = []
    for seed in (3, 4):
        model, variables = init_params(jax.random.PRNGKey(seed),
                                       JaxNetworkConfig(**NET))
        variables = jax.device_get(variables)
        out.append((model, variables,
                    model_from_flax_variables(NetworkConfig(**NET), variables)))
    return out


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(7)
    out = []
    for barcode in list(range(1, 13)) + [0, 0, 0]:
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=700)
        out.append((read.read_id, read.signal))
    out.append(("short_read", out[0][1][:200].copy()))
    return out


def _both_programs(weights, dual, host_trim, wire, calling_kw, kernel_path=None):
    jax_cfg = jax_pipeline.ClassifyConfig(
        JaxPreprocessConfig(**PRE, host_trim=host_trim, wire=wire),
        JaxCallingConfig(**calling_kw), dual_model=dual,
        use_pallas=kernel_path is not None, pallas_path=kernel_path)
    cfg = ClassifyConfig(PreprocessConfig(**PRE, host_trim=host_trim, wire=wire),
                         CallingConfig(**calling_kw), dual_model=dual,
                         kernel_path=kernel_path or "unit")
    (j_model, j_start, p_start), (_m, j_end, p_end) = weights
    jax_program = jax_pipeline.ClassifyProgram(
        j_model, jax_cfg, j_start, j_end if dual else None)
    program = ClassifyProgram(p_start, cfg, end_model=p_end if dual else None,
                              device="cpu")
    return jax_program, program


@pytest.mark.parametrize("dual,host_trim,wire,calling_kw", [
    (False, True, "int8", dict()),
    (False, False, "int16", dict(min_score=0.0, score_diff=0.0)),
    (False, True, "int4", dict(combine="best")),
    (True, True, "int8", dict(min_score=0.0, score_diff=0.0)),
    (True, False, "int16", dict(min_score=0.0, score_diff=0.0,
                                require_both=True)),
])
def test_call_table_matches_jax(weights, reads, dual, host_trim, wire, calling_kw):
    _assert_same_results(*_both_programs(weights, dual, host_trim, wire,
                                         calling_kw), reads)


@pytest.mark.parametrize("kernel_path", ["fused", "split3"])
@pytest.mark.parametrize("dual", [False, True])
def test_megakernel_paths_match_jax_pallas(weights, reads, kernel_path, dual):
    """kernel_path against the JAX program's use_pallas + pallas_path (the
    Pallas megakernel in interpret mode)."""
    calling_kw = dict(min_score=0.0, score_diff=0.0) if dual else {}
    _assert_same_results(*_both_programs(weights, dual, True, "int8", calling_kw,
                                         kernel_path=kernel_path), reads)


def test_unknown_kernel_path_is_refused():
    with pytest.raises(ValueError):
        ClassifyConfig(PreprocessConfig(**PRE), kernel_path="megakernel")


def _assert_same_results(jax_program, program, reads):
    want = {r.read_id: r for r in jax_executor.classify_stream(
        jax_program, iter(reads), batch_size=8)}
    got = {r.read_id: r for r in executor.classify_stream(
        program, iter(reads), batch_size=8)}
    assert sorted(got) == sorted(want)
    for read_id, w in want.items():
        g = got[read_id]
        assert (g.call, g.start_call, g.end_call) == \
            (w.call, w.start_call, w.end_call), read_id
        np.testing.assert_allclose(g.start_probs, w.start_probs, atol=3e-5,
                                   err_msg=read_id)
        np.testing.assert_allclose(g.end_probs, w.end_probs, atol=3e-5,
                                   err_msg=read_id)


def test_program_call_matches_packed(weights, reads):
    _jax_program, program = _both_programs(weights, True, True, "int8", {})
    batch = executor.build_batch(reads[:8], program.cfg.preprocess, 8, True)
    _ids, s, sl, e, el = batch
    table = program(s, sl, e, el)
    unpacked = unpack_call_table(program.call_packed(s, sl, e, el))
    for got, want in zip(unpacked, table):
        np.testing.assert_array_equal(got, want.numpy())
    packed = pack_call_table(table)
    assert packed.shape == (8, 3 + 2 * 13) and packed.dtype == torch.float32
    program.warm_up(8)


def test_program_defaults_to_the_card(weights):
    cfg = ClassifyConfig(PreprocessConfig(**PRE))
    if torch.cuda.is_available():
        assert ClassifyProgram(weights[0][2], cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            ClassifyProgram(weights[0][2], cfg)
    with pytest.raises(ValueError):
        ClassifyProgram(weights[0][2], dataclasses.replace(cfg, dual_model=True),
                        device="cpu")


def test_abandoned_pass_stops_feeder_and_closes_source(weights, reads):
    """Fault R2 of the JAX executor: an abandoned pass must not leave its
    prefetch feeder draining the old batch generator into the next pass."""
    _jax_program, program = _both_programs(weights, False, True, "int8", {})
    closed = []

    def source():
        try:
            while True:  # an endless pass: only abandonment ends it
                yield executor.build_batch(reads[:4], program.cfg.preprocess,
                                           4, False)
        finally:
            closed.append(True)

    results = executor.classify_batches(program, source(), in_flight=1,
                                        prefetch=2)
    first = next(results)
    assert first.read_id == reads[0][0]
    results.close()
    assert closed == [True]
    assert not any(t.name == "classify-batch-feeder" and t.is_alive()
                   for t in threading.enumerate())
    # The next pass gets every one of its reads.
    again = list(executor.classify_stream(program, iter(reads), batch_size=4))
    assert sorted(r.read_id for r in again) == sorted(r for r, _s in reads)


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_stream_unpacks_each_batch_once_in_order_on_a_host_tensor(
        weights, reads, monkeypatch, in_flight):
    """classify_batches hands ``executor.unpack_call_table`` one host tensor
    a batch, in the batches' order, and its rows are ``program(...)``'s
    for each batch, whatever the in-flight depth."""
    _jax_program, program = _both_programs(
        weights, True, True, "int8", dict(min_score=0.0, score_diff=0.0))
    batches = [executor.build_batch(reads[i:i + 4], program.cfg.preprocess, 4,
                                    True) for i in range(0, len(reads), 4)]
    unpack = executor.unpack_call_table
    handed = []

    def recorded(host):
        handed.append(host)
        return unpack(host)

    monkeypatch.setattr(executor, "unpack_call_table", recorded)
    got = list(executor.classify_batches(program, iter(batches),
                                         in_flight=in_flight))
    assert len(handed) == len(batches) == 4
    assert [r.read_id for r in got] == [read_id for read_id, _s in reads]
    for k, (host, batch) in enumerate(zip(handed, batches)):
        assert isinstance(host, torch.Tensor) and host.device.type == "cpu"
        table = program(*batch[1:])
        np.testing.assert_array_equal(host.numpy(),
                                      pack_call_table(table).numpy())
        for row, result in enumerate(got[4 * k: 4 * k + 4]):
            assert (result.call, result.start_call, result.end_call) == (
                table.calls[row], table.start_calls[row], table.end_calls[row])
            np.testing.assert_array_equal(result.start_probs,
                                          table.start_probs[row].numpy())
            np.testing.assert_array_equal(result.end_probs,
                                          table.end_probs[row].numpy())


def test_iter_signals_stops_readers_when_closed(tmp_path):
    files = [str(tmp_path / f"f{i}") for i in range(20)]

    def read_fn(path):
        return [(f"{path}:{k}", np.zeros(10, np.int16)) for k in range(50)]

    gen = executor.iter_signals(files, num_readers=4, queue_depth=4,
                                read_fn=read_fn)
    next(gen)
    gen.close()
    assert not any(t.name == "classify-reader" and t.is_alive()
                   for t in threading.enumerate())


@pytest.mark.parametrize("setting", ["allow_tf32", "high", "medium"])
def test_program_pins_tf32_off_and_gives_the_setting_back(weights, reads,
                                                          monkeypatch, setting):
    """Fault F1: whatever the host program set, the dense layer's call (and
    so every matmul of the program) runs with TF32 off for cuBLAS and
    cuDNN, and the caller's settings read as before after each call."""
    _jax_program, program = _both_programs(weights, False, True, "int8", {})
    _ids, sig, lengths, _e, _el = executor.build_batch(
        reads[:8], program.cfg.preprocess, 8, False)
    linear = torch.nn.functional.linear
    seen = []

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return linear(*args, **kwargs)

    def settings():
        return (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    monkeypatch.setattr(torch.nn.functional, "linear", spy)
    try:
        if setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision(setting)
        before = settings()
        assert before[1] and before[2]
        program(sig, lengths)
        assert settings() == before
        program.call_packed(sig, lengths)
        assert settings() == before
        program.warm_up(8)
        assert settings() == before
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = True
    assert len(seen) == 3 and set(seen) == {(False, False)}
