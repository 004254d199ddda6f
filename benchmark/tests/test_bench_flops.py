"""Operations and bytes, against hand arithmetic and the bound the
bring-up runs used (3.30 ms for K1's 15 units at 2816 windows)."""

import os

import pytest

from conftest import ROOT

FLAGSHIP = {"input_length": 1024, "stem_features": 48, "block_features": [64, 96],
            "inception_features": [128, 128], "head_features": 128,
            "num_classes": 13}


def test_one_unit_by_hand():
    from benchmark import flops

    # block0_conv2 at 2816 windows: L 512, 64 → 64 channels, 3 taps, pool.
    unit = flops.Unit(2816, 512, 64, 64, 3, 1, True)
    assert unit.flops == 2 * 2816 * 512 * 3 * 64 * 64
    assert unit.bytes == 4 * (2816 * 512 * 64 + 2816 * 256 * 64 + 3 * 64 * 64 + 2 * 64)
    assert unit.bound_s == pytest.approx(unit.flops / 67e12)
    # A 1x1 branch moves more than it computes.
    narrow = flops.Unit(2816, 128, 96, 32, 1, 1, True)
    assert narrow.bound_s == pytest.approx(narrow.bytes / 3.35e12)


def test_k1_bound_at_the_flagship_batch():
    from benchmark import flops

    units = flops.units(FLAGSHIP, 2816)
    assert len(units) == 15
    assert [u.c_out for u in units] == [48, 48, 64, 64, 96, 96] + [32] * 8 + [128]
    assert [u.dilation for u in units if u.taps == 3 and u.c_in in (96, 128)] == [1, 1, 2, 1, 4, 1]
    assert sum(u.bound_s for u in units) * 1e3 == pytest.approx(3.30194, abs=1e-5)


def test_forward_operations_per_window():
    from benchmark import flops
    from benchmark.references.demuxnet import load_dbt

    network, _ = load_dbt(os.path.join(
        ROOT, "deepbinner_tpu/models/data/SQK-RBK004_read_starts.dbt"))
    per_window = flops.forward_flops_per_window(network)
    assert per_window == sum(u.flops for u in flops.units(FLAGSHIP, 1)) + 2 * 128 * 13
    assert 73e6 < per_window < 74e6
