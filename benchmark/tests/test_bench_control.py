"""The control on the card, at the cell's own size: the reference with
TF32 on in the program's place fails the cell's limits, the float32
reference against itself passes them.  Needs the card (about a minute a
cell); skips here.

    python -m pytest benchmark/tests/test_bench_control.py
"""

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nbd103-amplicon", "rbk004-genomic"])
def test_the_tf32_control_fails_the_limits(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32 on the card")
    from benchmark import control, harness

    cell = harness.load_cell(name)
    limit = cell.config["limits"]["prob_gap"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        line = control.readings(cell, seed)
        assert line["control_tf32"]["prob_gap"] > limit
        assert line["reference_again"]["prob_gap"] <= limit
        assert line["reference_again"]["calls_differing"] == 0
