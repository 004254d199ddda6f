"""The K1 tile planner (``ops/conv_kernel.plan_unit``) on the CPU.

The planner is plain Python: which output-channel tile, row tile, thread
count, loop, shared memory, stages and persistent-grid occupancy each unit
geometry gets.  These tests hold it to the flagship model's 15 units and
to the ragged test cases, and hold its constants and the wrapper's ctypes
binding to the CUDA source they mirror.  The kernel itself runs only on
the card (test_torch_cuda_kernel.py).
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


# The flagship units' blocks per SM: what the resident weights and the two
# stages leave of an SM's 228 KB for more blocks, up to 2.
FLAGSHIP_BLOCKS = dict.fromkeys(_IDS, 2)
FLAGSHIP_BLOCKS.update({"inception1/branch3": 1,
                        "inception1/branch_dilated": 1, "head_conv": 1})


@pytest.mark.parametrize("geometry", FLAGSHIP, ids=_IDS)
def test_flagship_unit_fits_one_block(geometry):
    plan = _plan(geometry)
    assert plan.smem_bytes <= 232_448
    assert 128 <= plan.threads <= 384 and plan.threads <= 1024
    assert plan.threads == plan.row_tile // 16 * (plan.co_tile // 4)
    assert plan.row_tile == conv_kernel.PIPELINED_ROW_TILES[plan.co_tile]


@pytest.mark.parametrize("geometry", FLAGSHIP, ids=_IDS)
def test_flagship_unit_takes_the_window_loop(geometry):
    """Every flagship unit takes the pipelined loop, with its two stages."""
    plan = _plan(geometry)
    assert plan.path == "pipelined"
    assert plan.stages == conv_kernel.STAGES == 2


@pytest.mark.parametrize("geometry", FLAGSHIP, ids=_IDS)
def test_flagship_unit_shared_memory_is_resident_weights_and_stages(geometry):
    """All of C_in's weights for the column tile, then two stages of the
    row tile and its halo, 16 channels a row and 4 floats of padding after
    every 8 rows."""
    _scope, _length, c_in, _c_out, taps, dilation = geometry
    plan = _plan(geometry)
    rows = plan.row_tile + (taps - 1) * dilation
    stage = rows * 16 + -(-rows // 8) * 4
    assert plan.smem_bytes == 4 * (taps * c_in * plan.co_tile + 2 * stage)
    assert conv_kernel.stage_floats(rows) == stage


@pytest.mark.parametrize("geometry", FLAGSHIP, ids=_IDS)
def test_flagship_unit_grid_fills_the_sms(geometry):
    """The persistent grid is sized for as many blocks as the SM's shared
    memory holds at the plan, up to the source's launch bound."""
    plan = _plan(geometry)
    assert plan.blocks_per_sm == FLAGSHIP_BLOCKS[geometry[0]]
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 233_472
    if plan.blocks_per_sm < conv_kernel.PIPELINED_BLOCKS:
        assert (plan.blocks_per_sm + 1) * (plan.smem_bytes + 1024) > 233_472


@pytest.mark.parametrize("length,c_in,c_out,taps,dilation", RAGGED)
def test_ragged_case_takes_the_generic_loop(length, c_in, c_out, taps,
                                            dilation):
    plan = plan_unit(c_in, c_out, taps, dilation, length)
    assert plan == conv_kernel.generic_plan(c_in, c_out, taps, dilation,
                                            length)
    assert (plan.path, plan.stages, plan.blocks_per_sm) == ("generic", 1, 0)
    assert plan.smem_bytes <= 232_448


def test_length_not_a_multiple_of_8_takes_the_generic_loop():
    assert plan_unit(64, 64, 3, 1, 36).path == "generic"
    assert plan_unit(64, 64, 3, 1, 40).path == "pipelined"


def test_co_tile_computes_the_fewest_columns():
    for c_out in range(1, 200):
        for length in (64, 36):  # both loops
            plan = plan_unit(8, c_out, 3, 1, length)
            columns = {t: -(-c_out // t) * t for t in conv_kernel.CO_TILES}
            fewest = min(columns.values())
            assert plan.co_tile == max(t for t, c in columns.items()
                                       if c == fewest), c_out


def test_shared_memory_is_weights_and_padded_rows():
    plan = plan_unit(128, 128, 3, 1, 32)
    assert plan == UnitPlan(64, 256, 256, "pipelined",
                            4 * (3 * 128 * 64 + 2 * (258 * 16 + 33 * 4)),
                            2, 1)
    generic = conv_kernel.generic_plan(128, 128, 3, 1, 32)
    assert generic == UnitPlan(64, 128, 256, "generic",
                               4 * (3 * 32 * 64 + 130 * 33), 1, 0)


def test_plan_rejects_what_no_block_can_hold():
    with pytest.raises(ValueError):
        plan_unit(64, 64, 61, 8, 1024)
    with pytest.raises(ValueError):
        plan_unit(0, 64, 3, 1, 64)


def test_weights_over_a_block_take_the_generic_loop():
    """3 x 512 x 64 resident weights (384 KB) fit no block: the generic
    loop stages them 32 channels at a time."""
    plan = plan_unit(512, 64, 3, 1, 64)
    assert plan == conv_kernel.generic_plan(512, 64, 3, 1, 64)
    assert plan_unit(256, 64, 3, 1, 64).path == "pipelined"


def test_planner_constants_mirror_the_source():
    source = open(SOURCE).read()
    for macro, mirror in (("DEEPBINNER_CONV_TILES", conv_kernel.ROW_TILES),
                          ("DEEPBINNER_PIPELINED_TILES",
                           conv_kernel.PIPELINED_ROW_TILES)):
        tiles = re.search(rf"#define {macro}\(X\) (.*)", source)
        built = dict((int(a), int(b)) for a, b in
                     re.findall(r"X\((\d+), (\d+)\)", tiles.group(1)))
        assert built == mirror, macro
    pipelined = set((int(a), int(b)) for a, b in re.findall(
        r"a\.taps == (\d+) && a\.dilation == (\d+)", source))
    assert pipelined == conv_kernel.WINDOW_TAPS
    for name, value in (("kCiChunk", conv_kernel.CI_CHUNK),
                        ("kRows", conv_kernel.ROWS_PER_THREAD),
                        ("kCols", conv_kernel.COLS_PER_THREAD),
                        ("kStageChannels", conv_kernel.STAGE_CHANNELS),
                        ("kStages", conv_kernel.STAGES),
                        ("kGroupPad", conv_kernel.GROUP_PAD),
                        ("kPipelinedBlocks", conv_kernel.PIPELINED_BLOCKS),
                        ("kPipeRows", conv_kernel.PIPELINED_ROWS),
                        ("kSmemMax", conv_kernel.SMEM_LIMIT)):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         source).group(1) == str(value), name
    assert re.search(r"kXStride = kCiChunk \+ 1;", source)  # odd row stride
    assert conv_kernel.GROUP_PAD % 4 == 0  # staged rows stay 16-byte aligned
    assert conv_kernel.STAGE_CHANNELS % 4 == 0
    assert conv_kernel.PIPELINED_ROWS % conv_kernel.ROWS_PER_THREAD == 0


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
    assert len(want) == 21
