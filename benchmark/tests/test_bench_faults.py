"""A run of a small cell on the CPU with the timed path broken underneath:
each fault a classify cell can have turns ``correct`` false, in a
``--trace 0`` run and in a ``--trace 1`` run (its two stretches and the
pool-only pass after its window)."""

import numpy as np
import pytest


def test_a_sound_run_is_correct(run_small):
    out = run_small("nbd103-amplicon")
    assert out["correct"] is True
    checks = out["checks"]
    assert checks["prob_gap"]["value"] < 1e-5
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["record"].rows > 0


def _alter_an_answer(monkeypatch):
    """One read's call in each batch changed where the program makes it."""
    from deepbinner_tpu_torch.runner import executor

    unpack = executor.unpack_call_table

    def altered(packed):
        table = unpack(packed)
        table.calls[0] = table.calls[0] % 12 + 1
        return table

    monkeypatch.setattr(executor, "unpack_call_table", altered)


def _half_the_batch(monkeypatch):
    """The program classifies the first half of each batch and hands the
    second half the first half's answers."""
    from deepbinner_tpu_torch.runner.pipeline import ClassifyProgram

    call = ClassifyProgram.call_packed

    def half(self, *arrays):
        packed = call(self, *arrays).clone()
        rows = packed.shape[0] // 2
        packed[rows: 2 * rows] = packed[:rows]
        return packed

    monkeypatch.setattr(ClassifyProgram, "call_packed", half)


def _rows_left_out(monkeypatch):
    """Every other read's row never comes."""
    from deepbinner_tpu_torch.runner import executor

    batches = executor.classify_batches

    def every_other(*args, **kwargs):
        for k, result in enumerate(batches(*args, **kwargs)):
            if k % 2 == 0:
                yield result

    monkeypatch.setattr(executor, "classify_batches", every_other)


def _probabilities_nudged(monkeypatch):
    """The combined probabilities off by 1e-3, the calls as they were."""
    from deepbinner_tpu_torch.runner import executor

    unpack = executor.unpack_call_table

    def nudged(packed):
        table = unpack(packed)
        table.start_probs[:] += np.float32(1e-3)
        return table

    monkeypatch.setattr(executor, "unpack_call_table", nudged)


@pytest.mark.parametrize("fault,failing", [
    (_alter_an_answer, "calls_differing"),
    (_half_the_batch, "prob_gap"),
    (_rows_left_out, "rows_misplaced"),
    (_probabilities_nudged, "prob_gap"),
])
def test_a_broken_timed_path_is_not_correct(run_small, monkeypatch, fault, failing):
    fault(monkeypatch)
    out = run_small("nbd103-amplicon", seed=2 ** 31 + 17)
    assert out["correct"] is False
    check = out["checks"][failing]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("fault,failing", [
    (_alter_an_answer, "calls_differing"),
    (_half_the_batch, "prob_gap"),
    (_rows_left_out, "rows_misplaced"),
    (_probabilities_nudged, "prob_gap"),
])
def test_a_broken_timed_path_is_not_correct_in_a_traced_run(
        run_small, monkeypatch, fault, failing):
    fault(monkeypatch)
    out = run_small("nbd103-amplicon", seed=2 ** 31 + 18, trace=True)
    assert out["correct"] is False
    check = out["checks"][failing]
    assert check["value"] > check["limit"]
    assert out["record"].pool_reads_per_s > 0
