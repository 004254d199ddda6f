"""The K2 segment planner (``ops/trunk_kernel.plan_segment``) on the CPU.

The planner is plain Python: which row tile (rows per thread) each pass of
the trunk megakernel takes, which inner loop each unit runs, and how much
shared memory a block needs.  These tests hold it to the flagship and tiny
models' five segments, and its constants, unit table and ctypes binding to
the CUDA source they mirror.  The kernel itself runs only on the card
(test_torch_cuda_kernel.py, which also checks the planner's shared memory
against the C side's count).
"""

import ctypes
import dataclasses
import os
import re

import pytest
import torch

from deepbinner_tpu_torch.models.checkpoint import load_model
from deepbinner_tpu_torch.models.kernel_apply import fold_network
from deepbinner_tpu_torch.ops import kernel_build, trunk_kernel
from deepbinner_tpu_torch.ops.trunk_kernel import (
    SEGMENTS,
    UnitGeometry,
    mega_unit_scopes,
    plan_pass,
    plan_segment,
    segment_geometry,
    weighted_lanes,
)

MODELS = os.path.join(os.path.dirname(__file__), "..", "deepbinner_tpu",
                      "models", "data")
MODEL_FILES = {"flagship": "EXP-NBD103_read_starts.dbt",
               "tiny": "TINY_dryrun.dbt"}
SOURCE = os.path.join(kernel_build.CSRC, "trunk_megakernel.cu")


def _source() -> str:
    with open(SOURCE) as handle:
        return handle.read()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source()).group(1))


@pytest.fixture(scope="module")
def models():
    loaded = {}
    for name, path in MODEL_FILES.items():
        model, config, _meta = load_model(os.path.join(MODELS, path))
        loaded[name] = (model, config)
    return loaded


@pytest.mark.parametrize("name", sorted(MODEL_FILES))
@pytest.mark.parametrize("segment", SEGMENTS)
def test_row_tiles_are_built_and_even_where_they_pool(models, name, segment):
    built = tuple(int(v) for v in re.findall(
        r"X\((\d+)\)", re.search(r"#define DEEPBINNER_TRUNK_ROW_TILES\(X\) (.*)",
                                 _source()).group(1)))
    plan = plan_segment(models[name][1], segment)
    for unit in plan.units:
        assert unit.row_tile in built
        if unit.units[0].pool:
            assert unit.row_tile % 2 == 0, unit.scopes
        assert unit.passes == -(-unit.items // plan.threads)
        assert 0 < unit.lanes <= 1 and 0 < unit.useful <= 1


@pytest.mark.parametrize("name", sorted(MODEL_FILES))
@pytest.mark.parametrize("segment", SEGMENTS)
def test_geometry_is_the_models(models, name, segment):
    model, config = models[name]
    geometry = segment_geometry(config, segment)
    assert [(u.scope, u.dilation) for u in geometry] == \
        mega_unit_scopes(config, segment)
    modules = dict(model.named_modules())
    for unit in geometry:
        module = modules[unit.scope.replace("/", ".")]
        assert tuple(module.kernel.shape) == (unit.taps, unit.c_in, unit.c_out)
        assert module.dilation == unit.dilation


@pytest.mark.parametrize("name", sorted(MODEL_FILES))
@pytest.mark.parametrize("segment", SEGMENTS)
def test_shared_memory_fits_one_block(models, name, segment):
    plan = plan_segment(models[name][1], segment)
    assert plan.smem_bytes <= _constant("kMaxSmem") == trunk_kernel.SMEM_LIMIT
    assert plan.smem_bytes % 16 == 0


@pytest.mark.parametrize("segment", SEGMENTS)
def test_each_inception_is_one_pass_and_the_window_loops_run(models, segment):
    """Every flagship unit with a "window" (K, d) runs that loop; each
    inception's four branches are one pass, its pool branch on pool3 loads."""
    plan = plan_segment(models["flagship"][1], segment)
    for unit in plan.units:
        if len(unit.units) == 4:
            assert unit.paths == ("window", "window", "window", "pool3")
            assert unit.units[0].scope.endswith("/branch1x1")
            assert unit.units[3].scope.endswith("/branch_pool")
        else:
            assert unit.paths == ("window",)
            assert not unit.units[0].scope.startswith("inception")


@pytest.mark.parametrize("segment", ["all", "late", "inc0", "late1"])
def test_flagship_inception_branches_fill_whole_warps(models, segment):
    plan = plan_segment(models["flagship"][1], segment)
    inceptions = [u for u in plan.units if len(u.units) == 4]
    assert inceptions
    for unit in inceptions:
        for branch in unit.units:
            items = -(-unit.rows // unit.row_tile) * -(-branch.c_out // 4)
            assert items % 32 == 0, (branch.scope, items)


def test_flagship_plan(models):
    """The planned row tiles, and the lanes used of each pass."""
    plan = plan_segment(models["flagship"][1], "all")
    assert (plan.tile, plan.threads) == (32, 512)
    assert [u.row_tile for u in plan.units] == [8, 6, 6, 4, 4, 8, 4, 2]
    assert [u.rows for u in plan.units] == [280, 138, 136, 66, 64, 128, 64, 32]
    assert [round(u.lanes, 3) for u in plan.units[5:]] == [1.0, 1.0, 1.0]


def _rule_before_the_planner(plan):
    """The row tile rule the kernel had before: RT 8 or 4, and each
    inception branch a pass of its own."""
    passes = []
    for unit in plan.units:
        for branch in unit.units:
            one = plan_pass([branch], unit.rows, unit.useful, row_tiles=(4, 8))
            share = branch.taps * branch.c_out / sum(
                b.taps * b.c_out for b in unit.units)
            passes.append(one._replace(flops=round(unit.flops * share)))
    return passes


def test_flagship_lanes_used(models):
    """FLOP-weighted lanes used of flagship "all": at least 0.75 with the
    planner, against 0.56 under the rule before it."""
    plan = plan_segment(models["flagship"][1], "all")
    before = _rule_before_the_planner(plan)
    assert [p.row_tile for p in before] == [8, 8, 8, 4, 4] + [4] * 9
    assert weighted_lanes(before) == pytest.approx(0.5645, abs=5e-4)
    assert plan.lanes >= 0.75
    assert plan.lanes == pytest.approx(weighted_lanes(plan.units))


def test_flagship_shared_memory_is_the_layouts():
    """make_plan's layout for flagship "all", worked by hand from the
    source's constants: the unit table, the weight stage, p0 (the late
    input), then p1 (the early tile's two buffers, or the late output)."""
    config = load_model(os.path.join(MODELS, MODEL_FILES["flagship"]))[1]
    slack, stage, ints = (_constant("kSlack"), _constant("kWFloats"),
                          _constant("kUnitInts"))
    assert _constant("kTile") == trunk_kernel.TILE == 32
    table = ints * 14                           # 14 units
    p0 = (128 + 2 * 2 + slack) * 97             # inception0 input, d = 2
    a_need = (282 + slack) * 49                 # stem2 input rows, 48 ch
    b_need = (140 + slack) * 49                 # block0_conv1 input
    late_out = (64 + 2 * 4 + slack) * 129       # inception0 output, d = 4
    p1 = max(-(-a_need // 4) * 4 + b_need, late_out)
    assert plan_segment(config, "all").smem_bytes == 4 * (table + stage + p0 + p1)


def test_planner_constants_mirror_the_source():
    source = _source()
    for name, value in (("kThreads", trunk_kernel.THREADS),
                        ("kTile", trunk_kernel.TILE),
                        ("kSlack", trunk_kernel.SLACK),
                        ("kWFloats", trunk_kernel.W_FLOATS),
                        ("kUnitInts", trunk_kernel.UNIT_INTS),
                        ("kMaxSmem", trunk_kernel.SMEM_LIMIT)):
        assert _constant(name) == value, name
    built = tuple(int(v) for v in re.findall(
        r"X\((\d+)\)", re.search(r"#define DEEPBINNER_TRUNK_ROW_TILES\(X\) (.*)",
                                 source).group(1)))
    assert built == trunk_kernel.ROW_TILES
    assert _constant("kMaxRowTile") == max(built)
    assert trunk_kernel.SLACK >= max(built) - 1  # a last row tile's overrun
    window = {(int(a), int(b)) for a, b in re.findall(
        r"u\.taps == (\d+) && u\.dil == (\d+)", source)}
    assert window == trunk_kernel.WINDOW_TAPS


def test_unit_table_stride_is_the_sources(models):
    """A stale stride would pass garbage through ctypes without an error."""
    source = _source()
    fields = re.search(r"struct Unit \{(.*?)\};", source, re.S).group(1)
    fields = re.sub(r"//[^\n]*", "", fields)
    assert len(re.findall(r"\w+\s*[,;]", fields)) == trunk_kernel.UNIT_INTS
    assert "units + kUnitInts * i" in source
    model, config = models["tiny"]
    packed = fold_network(model, torch.device("cpu")).trunk
    for segment in SEGMENTS:
        plan = plan_segment(config, segment)
        table = trunk_kernel._unit_table(packed, plan)
        units = [u for p in plan.units for u in p.units]
        assert len(table) == trunk_kernel.UNIT_INTS * len(units)
        assert table[trunk_kernel.UNIT_INTS - 1::trunk_kernel.UNIT_INTS] == [
            p.row_tile for p in plan.units for _u in p.units]


def test_plan_and_unit_table_are_built_once_per_segment(models):
    """A launch reuses the plan and the ctypes unit table of the first."""
    model, config = models["tiny"]
    packed = fold_network(model, torch.device("cpu")).trunk
    length = config.input_length
    plan = plan_segment(config, "all", length=length)
    assert plan_segment(config, "all", length=length) is plan
    args = trunk_kernel._plan_args(packed, config, "all", length, plan)
    assert trunk_kernel._plan_args(packed, config, "all", length, plan) is args
    assert list(args[5]) == trunk_kernel._unit_table(packed, plan)
    # Another plan (a card test hands the wrapper one) gets its own table.
    other = plan._replace(units=(plan.units[0]._replace(row_tile=4),)
                          + plan.units[1:])
    table = trunk_kernel._plan_args(packed, config, "all", length, other)[5]
    assert table[trunk_kernel.UNIT_INTS - 1] == 4


def test_unit_table_rejects_weights_that_are_not_the_configs(models):
    model, config = models["tiny"]
    packed = fold_network(model, torch.device("cpu")).trunk
    wide = dataclasses.replace(config, head_features=32)
    with pytest.raises(ValueError, match="head_conv"):
        trunk_kernel._unit_table(packed, plan_segment(wide, "late1"))


def test_plan_pass_picks_the_cheapest_row_tile():
    unit = UnitGeometry("head_conv", 128, 128, 3, 1, False)
    every = range(1, 9)
    assert plan_pass([unit], 32, 1.0, every).row_tile == 2  # 512 items, 1 pass
    assert plan_pass([unit], 32, 1.0, every, threads=1024).row_tile == 1
    # 138 rows of 16 groups: RT 5 and 6 take one pass, RT 6 fewer loads
    # per FMA (RT 8 takes one too, at a larger RT).
    block = UnitGeometry("block0_conv1", 48, 64, 3, 1, False)
    assert plan_pass([block], 138, 1.0, every).row_tile == 5
    assert plan_pass([block], 138, 1.0).row_tile == 6
    pooled = unit._replace(pool=True)
    assert plan_pass([pooled], 32, 1.0, row_tiles=(1, 3, 4)).row_tile == 4
    with pytest.raises(ValueError):
        plan_pass([pooled], 32, 1.0, row_tiles=(1, 3))


def test_ctypes_binding_matches_the_c_signature(monkeypatch):
    source = _source()
    want = {}
    for fn in ("deepbinner_trunk_segment", "deepbinner_trunk_smem_bytes"):
        params = re.search(rf"{fn}\(([^)]*)\)", source).group(1)
        want[fn] = [ctypes.POINTER(ctypes.c_int) if "int*" in p.replace(" ", "")
                    else ctypes.c_void_p if "*" in p else ctypes.c_int
                    for p in params.split(",")]

    class Library:
        deepbinner_trunk_segment = type("Fn", (), {})()
        deepbinner_trunk_smem_bytes = type("Fn", (), {})()

    monkeypatch.setattr(kernel_build, "load", lambda name: Library)
    trunk_kernel._library.cache_clear()
    try:
        lib = trunk_kernel._library()
    finally:
        trunk_kernel._library.cache_clear()
    for fn, types in want.items():
        assert list(getattr(lib, fn).argtypes) == types, fn


def test_ptxas_report_lists_device_functions():
    """K2's conv_pass instances are compiled on their own: their spills are
    reported beside the entry function's registers."""
    report = """ptxas info    : Function properties for _Z9conv_passILi4EEviii
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z12trunk_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z12trunk_kernelPKf
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 1364 bytes cmem[0]
"""
    records = {r["kernel"].split("<")[0].split("(")[0]: r
               for r in kernel_build.parse_ptxas(report)}
    assert {k.lstrip("_Z0123456789").startswith(("conv_pass", "trunk_kernel"))
            for k in records} == {True}
    entry = next(r for k, r in records.items() if "trunk_kernel" in k)
    function = next(r for k, r in records.items() if "conv_pass" in k)
    assert (entry["registers"], entry["spill_stores"]) == (128, 0)
    assert "registers" not in function
    assert (function["stack_frame"], function["spill_stores"]) == (0, 8)

