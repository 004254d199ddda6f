"""The plain reference against the port's plain CPU path, and the
comparison's handling of choices that rounding can tip."""

import os

import numpy as np
import pytest

from conftest import ROOT, TINY, small_cell


def test_load_dbt_gives_the_ports_weights():
    from benchmark.references.demuxnet import load_dbt
    from deepbinner_tpu_torch.models.checkpoint import load_model

    path = os.path.join(ROOT, "deepbinner_tpu/models/data/EXP-NBD103_read_ends.dbt")
    config, variables = load_dbt(path)
    model, net_config, _meta = load_model(path)
    assert config["stem_features"] == net_config.stem_features == 48
    kernel = variables["params"]["inception1"]["branch_dilated"]["conv"]["kernel"]
    assert np.array_equal(kernel, model.inception1.branch_dilated.kernel.detach().numpy())
    assert np.array_equal(variables["batch_stats"]["head_conv"]["bn"]["var"],
                          model.head_conv.var.numpy())


def _signals(sizes, seed=3):
    """Simulated reads of the given sizes: open pore, then squiggle."""
    from benchmark import sim

    rng = np.random.default_rng(seed)
    out = []
    for size in sizes:
        current = np.concatenate([sim.open_pore(rng, 400),
                                  sim.squiggle(sim.random_dna(rng, size // 8), rng)])
        out.append(sim.digitise(current)[:size])
    return out


@pytest.mark.parametrize("reverse", [False, True])
def test_host_path_equals_the_ports_batch_assembly(reverse):
    """Trim and int8 quantisation, bit for bit, at the shipped geometry,
    for reads shorter than a window, than the trim region, and longer."""
    from benchmark.references import demuxnet
    from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
    from deepbinner_tpu_torch.runner.executor import batch_spec_for
    from deepbinner_tpu_torch.runner.hostbatch import build_batch_arrays

    g = demuxnet.geometry({"scan_size": 6144, "batch_size": 32}, 1024)
    sizes = [300, 1024, 1500, 2100, 7000, 8192, 9000, 16384, 20000] * 3 + [50_000] * 5
    signals = _signals(sizes)
    keep = g.raw_size
    heads = np.zeros((32, keep), np.int16)
    tails = np.zeros((32, keep), np.int16)
    for k, signal in enumerate(signals):
        n = min(signal.size, keep)
        heads[k, :n], tails[k, :n] = signal[:n], signal[signal.size - n:]
    wire, lengths = demuxnet.wire_rows(tails if reverse else heads,
                                       np.array(sizes), g, reverse)
    spec = batch_spec_for(PreprocessConfig(host_trim=True, wire="int8"), 32,
                          dual=True)
    _ids, start, start_len, end, end_len = build_batch_arrays(
        [(str(k), s) for k, s in enumerate(signals)], spec)
    want, want_len = (end, end_len) if reverse else (start, start_len)
    assert np.array_equal(lengths, want_len)
    assert np.array_equal(wire, want)


@pytest.mark.parametrize("name", ["nbd103-amplicon", "rbk004-genomic"])
def test_reference_agrees_with_the_ports_plain_cpu_path(name):
    """The tiny model through the port's classify program on the CPU (the
    kernels' plain versions) against the reference, read by read."""
    from benchmark import compare, corpus
    from benchmark.references import demuxnet
    from deepbinner_tpu_torch.cli.classify import build_program
    from deepbinner_tpu_torch.cli.main import get_arguments
    from deepbinner_tpu_torch.runner.executor import batch_spec_for
    from deepbinner_tpu_torch.runner.hostbatch import build_batch_arrays

    cell = small_cell(name, reads=32)
    config = cell.config
    reference = demuxnet.Reference(config, ROOT, device="cpu")
    g = reference.geometry
    data = corpus.generate(cell.traffic, config["kit"], 9, "", g.raw_size,
                           write=False)
    argv = ["classify", ROOT, "-s", os.path.join(ROOT, TINY), "--device", "cpu",
            "--scan_size", str(g.scan_size), "--batch_size", "16"]
    if config.get("end_model"):
        argv += ["-e", os.path.join(ROOT, TINY)]
    program, _ = build_program(get_arguments(argv))
    spec = batch_spec_for(program.cfg.preprocess, 16, program.cfg.dual_model)
    calls, starts, ends = [], [], []
    for lo in range(0, 32, 16):
        reads = [(str(k), _kept(data, k)) for k in range(lo, lo + 16)]
        _ids, *arrays = build_batch_arrays(reads, spec)
        table = program(*arrays)
        calls += table.calls.tolist()
        starts.append(table.start_probs.numpy())
        ends.append(table.end_probs.numpy())
    expected = compare.Expected(reference.window_probs(data.heads, data.tails,
                                                       data.lengths),
                                config["classify"])
    numbers = expected.judge(np.arange(32), np.array(calls),
                             np.concatenate(starts), np.concatenate(ends))
    assert numbers["calls_differing"] == 0
    assert numbers["prob_gap"] < 1e-5
    assert len(set(calls)) > 1  # the tiny model tells barcodes apart


def _kept(data, k):
    """What a reader worker hands on of read k: the whole read where it is
    no longer than its kept head and tail, else the two of them."""
    size, keep = int(data.lengths[k]), data.heads.shape[1]
    if size <= keep:
        return data.heads[k, :size]
    if size <= 2 * keep:
        return np.concatenate([data.heads[k], data.tails[k, 2 * keep - size:]])
    return np.concatenate([data.heads[k], data.tails[k]])


def test_outcomes_take_tied_choices_both_ways():
    from benchmark import compare

    probs = np.full((5, 13), 0.01, np.float32)
    probs[1, 4] = 0.9
    probs[3, 4] = 0.9 + compare.TIE / 2   # the best window is a near tie
    probs[2, 4] = 0.5
    mask = np.array([True, True, True, True, False])
    outcomes = compare.combined_outcomes(probs, mask, "neighbour")
    # best 1 with neighbour 2; best 3 with neighbour 2 (4 is masked)
    assert len(outcomes) == 2
    strict, call = compare.decide(probs, mask, {"combine": "neighbour",
                                                "min_score": 0.5,
                                                "score_diff": 0.5})
    assert any(np.array_equal(strict, o) for o in outcomes)
    assert call == 4
    none = compare.combined_outcomes(probs, np.zeros(5, bool), "neighbour")
    assert none[0][0] == 1.0 and none[0][1:].sum() == 0


def test_calls_near_a_threshold_may_go_either_way():
    from benchmark import compare

    row = np.zeros(13, np.float32)
    row[7] = 0.5 + compare.TIE / 3
    assert compare.calls_of(row, 0.5, 0.5) == {0, 7}
    row[7] = 0.9
    assert compare.calls_of(row, 0.5, 0.5) == {7}
    row[7], row[2] = 0.6, 0.3
    assert compare.calls_of(row, 0.5, 0.5) == {0}
    assert compare.reconcile(3, 0, False) == 3
    assert compare.reconcile(3, 5, False) == 0
    assert compare.reconcile(3, 0, True) == 0
