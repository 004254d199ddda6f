"""The K1 tile planner (``ops/conv_kernel.plan_unit``) on the CPU.

The planner is plain Python: which output-channel tile, row tile, thread
count, inner loop and shared memory each unit geometry gets.  These tests
hold it to the flagship model's 15 units and to the ragged test cases, and
hold its constants and the wrapper's ctypes binding to the CUDA source they
mirror.  The kernel itself runs only on the card (test_torch_cuda_kernel.py).
"""

import ctypes
import os
import re

import pytest

from deepbinner_tpu_torch.models.checkpoint import load_model
from deepbinner_tpu_torch.ops import conv_kernel, kernel_build
from deepbinner_tpu_torch.ops.conv_kernel import UnitPlan, plan_unit

MODELS = os.path.join(os.path.dirname(__file__), "..", "deepbinner_tpu",
                      "models", "data")
START_MODEL = os.path.join(MODELS, "EXP-NBD103_read_starts.dbt")
SOURCE = os.path.join(kernel_build.CSRC, "conv1d_bn_relu.cu")

# (scope, L, C_in, C_out, taps, dilation) of the flagship start model's
# units, in execution order (test_flagship_geometry_is_the_model's).
FLAGSHIP = [
    ("stem1", 1024, 1, 48, 3, 1),
    ("stem2", 1024, 48, 48, 3, 1),
    ("block0_conv1", 512, 48, 64, 3, 1),
    ("block0_conv2", 512, 64, 64, 3, 1),
    ("block1_conv1", 256, 64, 96, 3, 1),
    ("block1_conv2", 256, 96, 96, 3, 1),
    ("inception0/branch1x1", 128, 96, 32, 1, 1),
    ("inception0/branch3", 128, 96, 32, 3, 1),
    ("inception0/branch_dilated", 128, 96, 32, 3, 2),
    ("inception0/branch_pool", 128, 96, 32, 1, 1),
    ("inception1/branch1x1", 64, 128, 32, 1, 1),
    ("inception1/branch3", 64, 128, 32, 3, 1),
    ("inception1/branch_dilated", 64, 128, 32, 3, 4),
    ("inception1/branch_pool", 64, 128, 32, 1, 1),
    ("head_conv", 32, 128, 128, 3, 1),
]
# (L, C_in, C_out, taps, dilation) of the card tests' ragged cases.
RAGGED = [(37, 12, 10, 5, 3), (200, 40, 70, 9, 8)]
_IDS = [g[0] for g in FLAGSHIP]


def _plan(geometry):
    _scope, length, c_in, c_out, taps, dilation = geometry
    return plan_unit(c_in, c_out, taps, dilation, length)


def test_flagship_geometry_is_the_model():
    model, config, _meta = load_model(START_MODEL)
    units = dict(model.named_modules())
    length = config.input_length
    got = []
    for scope, _l, *_rest in FLAGSHIP:
        unit = units[scope.replace("/", ".")]
        taps, c_in, c_out = unit.kernel.shape
        got.append((c_in, c_out, taps, unit.dilation))
    assert got == [g[2:] for g in FLAGSHIP]
    assert FLAGSHIP[0][1] == length


@pytest.mark.parametrize("geometry", FLAGSHIP, ids=_IDS)
def test_flagship_unit_wastes_no_column(geometry):
    plan = _plan(geometry)
    assert geometry[3] % plan.co_tile == 0


@pytest.mark.parametrize("geometry", FLAGSHIP, ids=_IDS)
def test_flagship_unit_fits_one_block(geometry):
    plan = _plan(geometry)
    assert plan.smem_bytes <= 232_448
    assert 128 <= plan.threads <= 384 and plan.threads <= 1024
    assert plan.threads == plan.row_tile // 8 * (plan.co_tile // 4)


@pytest.mark.parametrize("geometry", FLAGSHIP, ids=_IDS)
def test_flagship_unit_takes_the_window_loop(geometry):
    assert _plan(geometry).path == "window"


@pytest.mark.parametrize("length,c_in,c_out,taps,dilation", RAGGED)
def test_ragged_case_takes_the_generic_loop(length, c_in, c_out, taps,
                                            dilation):
    plan = plan_unit(c_in, c_out, taps, dilation, length)
    assert plan.path == "generic"
    assert plan.smem_bytes <= 232_448


def test_length_not_a_multiple_of_8_takes_the_generic_loop():
    assert plan_unit(64, 64, 3, 1, 36).path == "generic"
    assert plan_unit(64, 64, 3, 1, 40).path == "window"


def test_co_tile_computes_the_fewest_columns():
    for c_out in range(1, 200):
        plan = plan_unit(8, c_out, 3, 1, 64)
        columns = {t: -(-c_out // t) * t for t in conv_kernel.CO_TILES}
        fewest = min(columns.values())
        assert plan.co_tile == max(t for t, c in columns.items()
                                   if c == fewest), c_out


def test_shared_memory_is_weights_and_padded_rows():
    plan = plan_unit(128, 128, 3, 1, 32)
    assert plan == UnitPlan(64, 128, 256, "window",
                            4 * (3 * 32 * 64 + 130 * 33))


def test_plan_rejects_what_no_block_can_hold():
    with pytest.raises(ValueError):
        plan_unit(64, 64, 61, 8, 1024)
    with pytest.raises(ValueError):
        plan_unit(0, 64, 3, 1, 64)


def test_planner_constants_mirror_the_source():
    source = open(SOURCE).read()
    tiles = re.search(r"#define DEEPBINNER_CONV_TILES\(X\) (.*)", source)
    built = dict((int(a), int(b)) for a, b in
                 re.findall(r"X\((\d+), (\d+)\)", tiles.group(1)))
    assert built == conv_kernel.ROW_TILES
    window = set((int(a), int(b)) for a, b in re.findall(
        r"a\.taps == (\d+) && a\.dilation == (\d+)", source))
    assert window == conv_kernel.WINDOW_TAPS
    for name, value in (("kCiChunk", conv_kernel.CI_CHUNK),
                        ("kRows", conv_kernel.ROWS_PER_THREAD),
                        ("kCols", conv_kernel.COLS_PER_THREAD)):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         source).group(1) == str(value)
    assert re.search(r"kXStride = kCiChunk \+ 1;", source)  # odd row stride


def test_ctypes_binding_matches_the_c_signature(monkeypatch):
    """A stale argtypes list would pass garbage without an error."""
    source = open(SOURCE).read()
    params = re.search(r'extern "C" int deepbinner_conv1d_bn_relu\(([^)]*)\)',
                       source).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in params.split(",")]

    class Library:
        deepbinner_conv1d_bn_relu = type("Fn", (), {})()

    monkeypatch.setattr(kernel_build, "load", lambda name: Library)
    conv_kernel._launcher.cache_clear()
    try:
        fn = conv_kernel._launcher()
    finally:
        conv_kernel._launcher.cache_clear()
    assert fn.argtypes == want
    assert len(want) == 19
