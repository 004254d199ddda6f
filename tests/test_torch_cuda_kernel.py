"""The CUDA kernels against their plain versions, and the classify program
on the card against the same program on the CPU.

Every test here needs a CUDA card and nvcc: they are marked ``cuda`` and
skip without one, but for the check that `train` exits non-zero without a
card, which runs anywhere.  The file imports no JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernel.py --noconftest -q
"""

import functools
import importlib.util
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from deepbinner_tpu_torch.models.checkpoint import load_model, to_flax_variables
from deepbinner_tpu_torch.models.keras_import import KerasGraphModel
from deepbinner_tpu_torch.models.kernel_apply import (
    HYBRID_KERNEL_UNITS,
    apply_inference_kernels,
    apply_inference_kernels_hybrid,
    fold_network,
    shard_network,
)
from deepbinner_tpu_torch.models.network import NetworkConfig
from deepbinner_tpu_torch.ops import conv_kernel, trunk_kernel
from deepbinner_tpu_torch.ops.calling import CallingConfig
from deepbinner_tpu_torch.ops.conv_kernel import (
    UnitPlan,
    conv1d_bn_relu_reference,
    fused_conv1d_bn_relu,
    generic_plan,
    launch_planned,
    plan_unit,
)
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.ops.trunk_kernel import (
    SEGMENTS,
    segment_input_channels,
    segment_spec,
    trunk_segment,
    trunk_segment_reference,
)
from deepbinner_tpu_torch.runner import executor
from deepbinner_tpu_torch.runner.executor import (
    MIN_SHM_SLOTS,
    batch_spec_for,
    build_batch,
    classify_batches,
    classify_stream,
)
from deepbinner_tpu_torch.runner.hostbatch import build_batch_arrays
from deepbinner_tpu_torch.runner.mp_reader import _ShmRing
from deepbinner_tpu_torch.runner.pipeline import (
    ClassifyConfig,
    ClassifyProgram,
    full_f32,
    unpack_call_table,
)
from deepbinner_tpu_torch.utils import simulate

pytestmark = pytest.mark.cuda

MODELS = os.path.join(os.path.dirname(__file__), "..", "deepbinner_tpu",
                      "models", "data")
TINY_MODEL = os.path.join(MODELS, "TINY_dryrun.dbt")
START_MODEL = os.path.join(MODELS, "EXP-NBD103_read_starts.dbt")
TOL = dict(atol=1e-4, rtol=1e-4)
FLAGSHIP_QUIET = NetworkConfig(noise_stddev=0.0, dropout_rate=0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's GEMMs
    return torch.device("cuda")


def _inputs(seed, n, length, c_in, c_out, taps, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(n, length, c_in)), rng.normal(size=(taps, c_in, c_out)),
              rng.normal(size=(c_out,)), rng.normal(size=(c_out,)))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.parametrize("taps,dilation,c_in,c_out,length,pool", [
    (3, 1, 1, 48, 1024, False),   # stem1
    (3, 1, 48, 48, 1024, True),   # stem2
    (3, 4, 128, 32, 64, True),    # inception1/branch_dilated
    (1, 1, 96, 32, 128, True),    # inception0/branch1x1
    (3, 1, 128, 128, 32, False),  # head_conv
    (5, 3, 12, 10, 37, False),    # ragged: odd L, C_out not a multiple of 4
    (9, 8, 40, 70, 200, True),    # wide halo: over 48 KB of shared memory
    # The rest of the 15 flagship units.
    (3, 1, 48, 64, 512, False),   # block0_conv1
    (3, 1, 64, 64, 512, True),    # block0_conv2
    (3, 1, 64, 96, 256, False),   # block1_conv1: two 48-channel tiles
    (3, 1, 96, 96, 256, True),    # block1_conv2
    (3, 1, 96, 32, 128, True),    # inception0/branch3 (and branch_pool's 1x1)
    (3, 2, 96, 32, 128, True),    # inception0/branch_dilated
    (1, 1, 128, 32, 64, True),    # inception1/branch1x1 and branch_pool
    (3, 1, 128, 32, 64, True),    # inception1/branch3
    # Short windows: a block's rows span several, so taps cross window
    # edges inside one block on either loop.
    (3, 1, 64, 96, 16, True),     # C_out 96 as two 48-channel tiles
    (3, 2, 8, 16, 16, True),
    (3, 4, 16, 32, 24, False),
    (3, 4, 16, 32, 36, False),    # L % 8 != 0: the generic loop
])
@pytest.mark.parametrize("relu", [True, False])
def test_kernel_matches_plain(cuda_device, taps, dilation, c_in, c_out, length,
                              pool, relu):
    arrays = _inputs(c_in + c_out, 37, length, c_in, c_out, taps, cuda_device)
    before = conv_kernel.LAUNCHES
    got = fused_conv1d_bn_relu(*arrays, dilation=dilation, pool=pool, relu=relu)
    assert conv_kernel.LAUNCHES == before + 1
    want = conv1d_bn_relu_reference(*arrays, dilation=dilation, pool=pool,
                                    relu=relu)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("taps,dilation,c_in,c_out,length", [
    (3, 1, 64, 96, 256), (3, 4, 128, 32, 64), (1, 1, 96, 32, 128),
    (3, 2, 8, 16, 16),
])
def test_generic_loop_matches_plain_where_the_window_loop_runs(
        cuda_device, taps, dilation, c_in, c_out, length):
    arrays = _inputs(7, 5, length, c_in, c_out, taps, cuda_device)
    plan = plan_unit(c_in, c_out, taps, dilation, length)
    assert plan.path == "pipelined"
    got = launch_planned(*arrays,
                         generic_plan(c_in, c_out, taps, dilation, length),
                         dilation=dilation, pool=True)
    want = conv1d_bn_relu_reference(*arrays, dilation=dilation, pool=True)
    torch.testing.assert_close(got, want, **TOL)


# (L, C_in, C_out, taps, dilation, pool) of the flagship start model's 15
# units (test_torch_conv_plan.FLAGSHIP's).
FLAGSHIP_UNITS = [
    (1024, 1, 48, 3, 1, False), (1024, 48, 48, 3, 1, True),
    (512, 48, 64, 3, 1, False), (512, 64, 64, 3, 1, True),
    (256, 64, 96, 3, 1, False), (256, 96, 96, 3, 1, True),
    (128, 96, 32, 1, 1, True), (128, 96, 32, 3, 1, True),
    (128, 96, 32, 3, 2, True), (128, 96, 32, 1, 1, True),
    (64, 128, 32, 1, 1, True), (64, 128, 32, 3, 1, True),
    (64, 128, 32, 3, 4, True), (64, 128, 32, 1, 1, True),
    (32, 128, 128, 3, 1, False),
]
FLAGSHIP_IDS = ["stem1", "stem2", "block0_conv1", "block0_conv2",
                "block1_conv1", "block1_conv2", "inception0/branch1x1",
                "inception0/branch3", "inception0/branch_dilated",
                "inception0/branch_pool", "inception1/branch1x1",
                "inception1/branch3", "inception1/branch_dilated",
                "inception1/branch_pool", "head_conv"]


def _unit_inputs(seed, n, length, c_in, c_out, taps, device):
    """Inputs of one unit with weights scaled to variance 1/fan_in."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, length, c_in), generator=gen, device=device)
    w = torch.randn((taps, c_in, c_out), generator=gen,
                    device=device) / (taps * c_in) ** 0.5
    scale = torch.rand((c_out,), generator=gen, device=device) + 0.5
    bias = torch.randn((c_out,), generator=gen, device=device)
    return [x, w, scale, bias]


# 2816 windows: one 256-read batch.  1409: at every flagship unit the row
# tiles do not divide evenly among the persistent blocks of an H100's 132
# SMs, and at L <= 128 the last row tile is ragged.
@pytest.mark.parametrize("n", [2816, 1409])
@pytest.mark.parametrize("length,c_in,c_out,taps,dilation,pool",
                         FLAGSHIP_UNITS, ids=FLAGSHIP_IDS)
def test_pipelined_loop_matches_plain_at_the_flagship_units(
        cuda_device, n, length, c_in, c_out, taps, dilation, pool):
    """The pipelined loop against the plain version, and against itself on
    a rerun, at each flagship unit's geometry."""
    arrays = _unit_inputs(length + c_in + c_out, n, length, c_in, c_out,
                          taps, cuda_device)
    plan = plan_unit(c_in, c_out, taps, dilation, length)
    assert plan.path == "pipelined"
    before = conv_kernel.LAUNCHES
    got = fused_conv1d_bn_relu(*arrays, dilation=dilation, pool=pool)
    again = fused_conv1d_bn_relu(*arrays, dilation=dilation, pool=pool)
    assert conv_kernel.LAUNCHES == before + 2
    want = conv1d_bn_relu_reference(*arrays, dilation=dilation, pool=pool)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)


@pytest.mark.parametrize("n", [2816, 1409])
@pytest.mark.parametrize("length,c_in", [(128, 96), (64, 128)])
def test_pipelined_loop_equals_generic_at_the_one_tap_units(
        cuda_device, n, length, c_in):
    """branch1x1 and branch_pool: with one tap both loops sum each output
    over C_in ascending, one fmaf at a time, so they agree bit for bit."""
    arrays = _unit_inputs(c_in, n, length, c_in, 32, 1, cuda_device)
    plan = plan_unit(c_in, 32, 1, 1, length)
    assert plan.path == "pipelined"
    got = launch_planned(*arrays, plan, pool=True)
    generic = launch_planned(*arrays, generic_plan(c_in, 32, 1, 1, length),
                             pool=True)
    assert torch.equal(got, generic)


_PIPELINED_48 = 4 * (3 * 8 * 48 + 2 * (130 * 32 + 17 * 4))  # C_in 8
_PIPELINED_5_TAPS = 4 * (5 * 8 * 48 + 2 * (132 * 32 + 17 * 4))
_GENERIC_48 = 4 * (3 * 32 * 48 + 130 * 33)


@pytest.mark.parametrize("plan", [
    UnitPlan(40, 128, 160, "generic", 4 * (3 * 32 * 40 + 130 * 33), 1, 0),  # no tile
    UnitPlan(48, 64, 96, "generic", 4 * (3 * 32 * 48 + 66 * 33), 1, 0),     # no rows
    UnitPlan(48, 128, 256, "generic", _GENERIC_48, 1, 0),                   # threads
    UnitPlan(48, 128, 192, "generic", 1024, 1, 0),                          # smem
    UnitPlan(48, 128, 192, "pipelined", _PIPELINED_5_TAPS, 2, 3),          # 5 taps
    UnitPlan(48, 128, 192, "pipelined", _PIPELINED_48, 3, 3),               # stages
    UnitPlan(48, 128, 192, "pipelined", _PIPELINED_48, 2, 0),               # no grid
    UnitPlan(48, 128, 192, "pipelined", _PIPELINED_48, 2, 4),               # occupancy
    UnitPlan(48, 128, 192, "pipelined", _GENERIC_48, 2, 3),                 # smem
    UnitPlan(48, 128, 192, "generic", _GENERIC_48, 2, 0),                   # stages
    UnitPlan(48, 128, 192, "generic", _GENERIC_48, 1, 3),                   # grid
])
def test_kernel_raises_for_a_plan_it_was_not_built_for(cuda_device,
                                                       monkeypatch, plan):
    """The C side returns an error and launches nothing; the wrapper raises
    and picks no other plan."""
    taps = 5 if plan.smem_bytes == _PIPELINED_5_TAPS else 3
    arrays = _inputs(3, 2, 16, 8, 48, taps, cuda_device)
    monkeypatch.setattr(conv_kernel, "plan_unit", lambda *args: plan)
    before = conv_kernel.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_conv1d_bn_relu(*arrays)
    assert conv_kernel.LAUNCHES == before


def test_kernel_is_deterministic(cuda_device):
    arrays = _inputs(0, 64, 256, 64, 96, 3, cuda_device)
    first = fused_conv1d_bn_relu(*arrays, pool=True)
    assert torch.equal(first, fused_conv1d_bn_relu(*arrays, pool=True))


@pytest.mark.parametrize("bad", ["non_contiguous", "float64", "device"])
def test_kernel_rejects_bad_inputs(cuda_device, bad):
    x, w, scale, bias = _inputs(1, 2, 8, 4, 4, 3, cuda_device)
    if bad == "non_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert not x.is_contiguous()
    elif bad == "float64":
        x = x.double()
    else:
        w = w.cpu()
    with pytest.raises((ValueError, TypeError)):
        fused_conv1d_bn_relu(x, w, scale, bias)


def _unit_geometries(config):
    """(scope, length, dilation, pool) of every unit of ``config``, in order."""
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


# Every flagship unit at model 2 and 4 (48, 64, 96, 32 and 128 columns all
# divide), and the tiny model's at model 2, as the 'model' axis splits them.
TINY_CONFIG = NetworkConfig(input_length=256, stem_features=8,
                            block_features=(8,), inception_features=(16,),
                            head_features=16)
SHARD_CASES = ([("flagship", m, i) for m in (2, 4)
                for i in range(len(_unit_geometries(NetworkConfig())))]
               + [("tiny", 2, i) for i in range(len(_unit_geometries(TINY_CONFIG)))])


@functools.lru_cache(maxsize=None)
def _folded(name):
    model, config, _meta = load_model(START_MODEL if name == "flagship"
                                      else TINY_MODEL)
    return fold_network(model, torch.device("cuda")), config


@pytest.mark.parametrize("name,model,index", SHARD_CASES)
def test_kernel_on_column_shards(cuda_device, record_property, name, model,
                                 index):
    """K1 on each rank's column shard of a unit (C_out 24, 16, 12, 8 at the
    flagship, 4 and 2 at the tiny model; widths under 4 take the scalar
    weight and store paths) against its plain version and a rerun; the
    rank-order gather against the unsharded K1, whose largest difference
    is recorded (``max_abs_diff_vs_whole``)."""
    net, config = _folded(name)
    scope, length, dilation, pool = _unit_geometries(config)[index]
    kernel = net.units[scope][0]
    assert kernel.shape[2] % model == 0
    gen = torch.Generator(device=cuda_device).manual_seed(index)
    x = torch.randn((37, length, kernel.shape[1]), generator=gen,
                    device=cuda_device)
    parts = []
    for rank in range(model):
        weights = shard_network(net, rank, model).units[scope]
        assert weights[0].shape[2] == kernel.shape[2] // model
        before = conv_kernel.LAUNCHES
        got = fused_conv1d_bn_relu(x, *weights, dilation=dilation, pool=pool)
        assert conv_kernel.LAUNCHES == before + 1
        want = conv1d_bn_relu_reference(x, *weights, dilation=dilation,
                                        pool=pool)
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, fused_conv1d_bn_relu(x, *weights,
                                                     dilation=dilation,
                                                     pool=pool))
        parts.append(got)
    whole = fused_conv1d_bn_relu(x, *net.units[scope], dilation=dilation,
                                 pool=pool)
    gathered = torch.cat(parts, dim=-1)
    diff = (gathered - whole).abs().max().item()
    record_property("max_abs_diff_vs_whole", diff)
    print(f"{name} {scope} model {model}: gathered vs whole K1 max abs "
          f"diff {diff}")
    torch.testing.assert_close(gathered, whole, **TOL)


def test_model_axis_program_on_the_card_matches_the_unit_path(cuda_device):
    """ClassifyProgram over [cuda] * 4 with model=2 (data 2 × model 2 on one
    card): the unit path's calls, combined probabilities within 1e-5, and
    2 × 2 × 9 K1 launches per batch."""
    model, net_cfg, _meta = load_model(TINY_MODEL)
    pre = PreprocessConfig(scan_size=768, window=net_cfg.input_length,
                           stride=net_cfg.input_length // 2, trim_scan=512,
                           host_trim=True, wire="int8")
    cfg = ClassifyConfig(pre, CallingConfig())
    reads = _tiny_program_reads()
    results, launches = {}, {}
    for layout, kwargs in (("unit", {"device": "cuda"}),
                           ("tp", {"devices": ["cuda"] * 4, "model": 2})):
        program = ClassifyProgram(model, cfg, **kwargs)
        before = conv_kernel.LAUNCHES
        results[layout] = {r.read_id: r for r in classify_stream(
            program, iter(reads), batch_size=8)}
        launches[layout] = conv_kernel.LAUNCHES - before
    assert launches == {"unit": 9 * 2, "tp": 36 * 2}  # 2 batches
    for read_id, want in results["unit"].items():
        got = results["tp"][read_id]
        assert got.call == want.call, read_id
        np.testing.assert_allclose(got.start_probs, want.start_probs,
                                   rtol=0, atol=1e-5)


def _segment_input(cfg, segment, n, device, seed=0):
    early, inc_lo, _hi, _head = segment_spec(cfg, segment)
    length = cfg.input_length
    if not early:
        length //= 2 ** (1 + len(cfg.block_features) + inc_lo)
    x = np.random.default_rng(seed).normal(
        size=(n, length, segment_input_channels(cfg, segment)))
    return torch.tensor(x, dtype=torch.float32, device=device)


@pytest.mark.parametrize("model_file", [START_MODEL, TINY_MODEL])
@pytest.mark.parametrize("segment", SEGMENTS)
def test_megakernel_matches_plain(cuda_device, model_file, segment):
    """Flagship widths and the tiny model (whose late1 has no inception),
    at a ragged N."""
    model, cfg, _meta = load_model(model_file)
    net = fold_network(model, cuda_device)
    x = _segment_input(cfg, segment, 37, cuda_device)
    before = trunk_kernel.LAUNCHES
    got = trunk_segment(x, net.trunk, cfg, segment)
    assert trunk_kernel.LAUNCHES == before + 1
    want = trunk_segment_reference(x, net.units, cfg, segment)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("model_file", [START_MODEL, TINY_MODEL])
@pytest.mark.parametrize("segment", ["inc0", "late1", "all"])
def test_megakernel_matches_plain_on_negative_inputs(cuda_device, model_file,
                                                     segment):
    """Inputs mostly below 0: the pool branch's window-3 max must pad with
    -inf, not with the buffers' zero rows."""
    model, cfg, _meta = load_model(model_file)
    net = fold_network(model, cuda_device)
    x = _segment_input(cfg, segment, 3, cuda_device, seed=2) - 2
    got = trunk_segment(x, net.trunk, cfg, segment)
    want = trunk_segment_reference(x, net.units, cfg, segment)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("model_file", [START_MODEL, TINY_MODEL])
@pytest.mark.parametrize("segment", SEGMENTS)
def test_planner_shared_memory_is_the_kernels(cuda_device, model_file,
                                              segment):
    model, cfg, _meta = load_model(model_file)
    net = fold_network(model, cuda_device)
    plan = trunk_kernel.plan_segment(cfg, segment)
    length = _segment_input(cfg, segment, 1, cuda_device).shape[1]
    assert trunk_kernel.shared_memory_bytes(net.trunk, cfg, segment,
                                            length) == plan.smem_bytes


@pytest.mark.parametrize("row_tile", [0, 3, 9])  # none of them built
def test_megakernel_raises_for_a_row_tile_it_was_not_built_for(
        cuda_device, monkeypatch, row_tile):
    """The C side returns an error and launches nothing; the wrapper raises
    and picks no other row tile."""
    model, cfg, _meta = load_model(TINY_MODEL)
    net = fold_network(model, cuda_device)
    plan = trunk_kernel.plan_segment(cfg, "all")
    stem2 = plan.units[0]._replace(row_tile=row_tile)  # stem2 pools
    bad = plan._replace(units=(stem2,) + plan.units[1:])
    monkeypatch.setattr(trunk_kernel, "plan_segment", lambda *a, **k: bad)
    x = _segment_input(cfg, "all", 2, cuda_device)
    before = trunk_kernel.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        trunk_segment(x, net.trunk, cfg, "all")
    assert trunk_kernel.LAUNCHES == before


def test_megakernel_is_deterministic(cuda_device):
    model, cfg, _meta = load_model(START_MODEL)
    net = fold_network(model, cuda_device)
    x = _segment_input(cfg, "all", 64, cuda_device)
    first = trunk_segment(x, net.trunk, cfg, "all")
    assert torch.equal(first, trunk_segment(x, net.trunk, cfg, "all"))


@pytest.mark.parametrize("bad", ["non_contiguous", "float64", "device"])
def test_megakernel_rejects_bad_inputs(cuda_device, bad):
    model, cfg, _meta = load_model(TINY_MODEL)
    net = fold_network(model, cuda_device)
    x = _segment_input(cfg, "all", 2, cuda_device)
    if bad == "non_contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
        assert not x.is_contiguous()
    elif bad == "float64":
        x = x.double()
    else:
        net = fold_network(model, torch.device("cpu"))
    with pytest.raises((ValueError, TypeError)):
        trunk_segment(x, net.trunk, cfg, "all")


def _tiny_program_reads():
    rng = np.random.default_rng(9)
    reads = []
    for barcode in list(range(1, 13)) + [0] * 4:
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=600)
        reads.append((read.read_id, read.signal))
    return reads


def test_fused_program_on_the_card_matches_the_cpu(cuda_device):
    """kernel_path="fused": one K1 and one K2 launch per batch on the card,
    the same calls as on the CPU."""
    model, net_cfg, _meta = load_model(TINY_MODEL)
    pre = PreprocessConfig(scan_size=768, window=net_cfg.input_length,
                           stride=net_cfg.input_length // 2, trim_scan=512,
                           host_trim=True, wire="int8")
    cfg = ClassifyConfig(pre, CallingConfig(), kernel_path="fused")
    reads = _tiny_program_reads()
    results = {}
    for device in ("cpu", "cuda"):
        program = ClassifyProgram(model, cfg, device=device)
        before = (conv_kernel.LAUNCHES, trunk_kernel.LAUNCHES)
        results[device] = {r.read_id: r for r in classify_stream(
            program, iter(reads), batch_size=8)}
        launches = (conv_kernel.LAUNCHES - before[0],
                    trunk_kernel.LAUNCHES - before[1])
        assert launches == ((0, 0) if device == "cpu" else (2, 2))  # 2 batches
    for read_id, want in results["cpu"].items():
        got = results["cuda"][read_id]
        assert got.call == want.call, read_id
        np.testing.assert_allclose(got.start_probs, want.start_probs, atol=1e-4)


def test_program_on_the_card_matches_the_cpu(cuda_device):
    """The whole classify program, card vs CPU: same calls, combined
    probabilities within 1e-4 (f32 sums in another order)."""
    model, net_cfg, _meta = load_model(TINY_MODEL)
    pre = PreprocessConfig(scan_size=768, window=net_cfg.input_length,
                           stride=net_cfg.input_length // 2, trim_scan=512,
                           host_trim=True, wire="int8")
    cfg = ClassifyConfig(pre, CallingConfig())
    reads = _tiny_program_reads()
    results = {}
    for device in ("cpu", "cuda"):
        program = ClassifyProgram(model, cfg, device=device)
        before = conv_kernel.LAUNCHES
        results[device] = {r.read_id: r for r in classify_stream(
            program, iter(reads), batch_size=8)}
        launches = conv_kernel.LAUNCHES - before
        assert launches == (0 if device == "cpu" else 9 * 2)  # 9 units, 2 batches
    for read_id, want in results["cpu"].items():
        got = results["cuda"][read_id]
        assert got.call == want.call, read_id
        np.testing.assert_allclose(got.start_probs, want.start_probs, atol=1e-4)


def test_hybrid_matches_unit_at_the_flagship_geometry(cuda_device):
    """kernel_path="hybrid" on the card: K1 at the three units of the table,
    cuDNN (TF32 off) at the other twelve, within 1e-4 of the unit path."""
    model, _cfg, _meta = load_model(START_MODEL)
    net = fold_network(model, cuda_device)
    windows = torch.tensor(np.random.default_rng(12).normal(size=(352, 1024)),
                           dtype=torch.float32, device=cuda_device)
    with full_f32(), torch.inference_mode():
        want = apply_inference_kernels(net, windows)
        before = conv_kernel.LAUNCHES
        got = apply_inference_kernels_hybrid(net, windows)
        assert conv_kernel.LAUNCHES - before == len(HYBRID_KERNEL_UNITS)
    torch.testing.assert_close(got, want, **TOL)


def _load_demuxnet_as_keras():
    spec = importlib.util.spec_from_file_location(
        "demuxnet_as_keras", os.path.join(os.path.dirname(__file__), "..",
                                          "scripts", "demuxnet_as_keras.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.demuxnet_as_keras


def test_keras_graph_on_the_card_matches_the_cpu(cuda_device):
    """The flagship as a Keras graph, classified on the card and on the
    CPU: the same calls, combined probabilities within 1e-4, and no
    launch of K1 or K2."""
    model, net_cfg, _meta = load_model(TINY_MODEL)
    graph = KerasGraphModel(*_load_demuxnet_as_keras()(
        net_cfg, to_flax_variables(model)))
    pre = PreprocessConfig(scan_size=768, window=net_cfg.input_length,
                           stride=net_cfg.input_length // 2, trim_scan=512,
                           host_trim=True, wire="int8")
    reads = _tiny_program_reads()
    results = {}
    for device in ("cpu", "cuda"):
        program = ClassifyProgram(graph, ClassifyConfig(pre, CallingConfig()),
                                  device=device)
        before = (conv_kernel.LAUNCHES, trunk_kernel.LAUNCHES)
        results[device] = {r.read_id: r for r in classify_stream(
            program, iter(reads), batch_size=8)}
        assert (conv_kernel.LAUNCHES, trunk_kernel.LAUNCHES) == before
    for read_id, want in results["cpu"].items():
        got = results["cuda"][read_id]
        assert got.call == want.call, read_id
        np.testing.assert_allclose(got.start_probs, want.start_probs, atol=1e-4)


def _tiny_program(device, batch_size=4):
    model, net_cfg, _meta = load_model(TINY_MODEL)
    pre = PreprocessConfig(scan_size=768, window=net_cfg.input_length,
                           stride=net_cfg.input_length // 2, trim_scan=512,
                           host_trim=True, wire="int8")
    program = ClassifyProgram(model, ClassifyConfig(pre, CallingConfig()),
                              device=device)
    return program, batch_spec_for(pre, batch_size, False)


def test_tf32_setting_does_not_move_the_call_table(cuda_device):
    """Fault F1: under torch.set_float32_matmul_precision("high") the packed
    call table is bit-identical to the one at "highest", and the process
    setting reads "high" again after the call."""
    program, _spec = _tiny_program(cuda_device)
    _ids, sig, lens, _e, _el = build_batch(_tiny_program_reads(),
                                           program.cfg.preprocess, 16, False)
    tables = {}
    try:
        for precision in ("high", "highest"):
            torch.set_float32_matmul_precision(precision)
            tables[precision] = program.call_packed(sig, lens).cpu()
            assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(tables["high"], tables["highest"])


def test_registered_slot_uploads_without_a_host_copy(cuda_device, monkeypatch):
    program, spec = _tiny_program(cuda_device)
    ring = _ShmRing(mp.get_context("spawn"), spec, 2, pin=True)
    try:
        views = ring.views(ring.slots[1])
        build_batch_arrays(_tiny_program_reads()[:4], spec, out=views)
        assert ring.pinned and torch.from_numpy(views[0]).is_pinned()

        def no_copy(self, *args, **kwargs):
            raise AssertionError("a registered slot was copied to pinned memory")

        monkeypatch.setattr(torch.Tensor, "pin_memory", no_copy)
        sig, lens, _e, _el = program.upload(*views)
        torch.cuda.synchronize()
        assert sig.device.type == "cuda"
        assert torch.equal(sig.cpu(), torch.from_numpy(views[0].copy()))
        assert torch.equal(lens.cpu(), torch.from_numpy(views[1].copy()))
        del views
    finally:
        ring.close()
    assert not ring.pinned


def test_released_slots_overwritten_at_once_give_the_same_calls(cuda_device):
    """Each slot is overwritten with 0x55 bytes the moment classify_batches
    releases it: an early release would change a call or a probability."""
    program, spec = _tiny_program(cuda_device)
    reads = _tiny_program_reads() * 3
    copied = [build_batch_arrays(reads[i:i + 4], spec)
              for i in range(0, len(reads), 4)]
    want = {r.read_id: r for r in classify_batches(program, iter(copied))}

    ring = _ShmRing(mp.get_context("spawn"), spec, 2, pin=True)
    released = []

    def release(slot):
        np.frombuffer(ring.slots[slot].buf, np.uint8)[:] = 0x55
        released.append(slot)
        ring.free.put(slot)

    def batches():
        for i in range(0, len(reads), 4):
            slot = ring.free.get(timeout=60)
            views = ring.views(ring.slots[slot])
            ids, *_arrays = build_batch_arrays(reads[i:i + 4], spec, out=views)
            yield (ids, *views, functools.partial(release, slot))

    try:
        got = {r.read_id: r for r in classify_batches(program, batches())}
    finally:
        ring.close()
    assert len(released) == len(copied)
    assert sorted(got) == sorted(want)
    for read_id, w in want.items():
        g = got[read_id]
        assert (g.call, g.start_call, g.end_call) == (w.call, w.start_call,
                                                      w.end_call)
        np.testing.assert_array_equal(g.start_probs, w.start_probs)


# About 50 ms of the card's clock (1.98 GHz at most on an H100).
SLEEP_CYCLES = 100_000_000


@pytest.mark.parametrize("layout", ["single", "dual", "split"])
def test_each_copy_back_waits_for_its_own_batch_alone(cuda_device, monkeypatch,
                                                      layout):
    """Each batch's step sleeps about 50 ms on the card before it runs, and
    the batches come through the reader pool's pinned slots.  When batch 0's
    first row is yielded, batch 1's step has not completed; every table
    ``unpack_call_table`` gets is pinned host memory; and the rows are
    bit-identical to a synchronous ``unpack_call_table(call_packed(...))``
    of each batch: one model, two, and one model over two grid rows (the
    copy made from the gathered table)."""
    dual = layout == "dual"
    model, net_cfg, _meta = load_model(TINY_MODEL)
    pre = PreprocessConfig(scan_size=768, window=net_cfg.input_length,
                           stride=net_cfg.input_length // 2, trim_scan=512,
                           host_trim=True, wire="int8")
    placement = ({"devices": [cuda_device] * 2} if layout == "split"
                 else {"device": cuda_device})
    program = ClassifyProgram(model, ClassifyConfig(pre, CallingConfig(),
                                                    dual_model=dual),
                              end_model=model if dual else None, **placement)
    spec = batch_spec_for(pre, 4, dual)
    reads = _tiny_program_reads() * 2
    starts = range(0, len(reads), 4)
    want = []
    for i in starts:
        _ids, *arrays = build_batch_arrays(reads[i:i + 4], spec)
        want.append(unpack_call_table(program.call_packed(*arrays)))

    call = program.call_packed
    stepped = []

    def slow(*arrays):
        torch.cuda._sleep(SLEEP_CYCLES)
        packed = call(*arrays)
        event = torch.cuda.Event()
        event.record()
        stepped.append(event)
        return packed

    unpack = executor.unpack_call_table
    handed = []

    def recorded(host):
        handed.append((host.device.type, host.is_pinned()))
        return unpack(host)

    monkeypatch.setattr(program, "call_packed", slow)
    monkeypatch.setattr(executor, "unpack_call_table", recorded)
    ring = _ShmRing(mp.get_context("spawn"), spec, MIN_SHM_SLOTS, pin=True)

    def batches():
        for i in starts:
            slot = ring.free.get(timeout=60)
            views = ring.views(ring.slots[slot])
            ids, *_arrays = build_batch_arrays(reads[i:i + 4], spec, out=views)
            yield (ids, *views, functools.partial(ring.free.put, slot))

    got, done_at_first_row = [], None
    try:
        for result in classify_batches(program, batches()):
            if not got:
                done_at_first_row = [event.query() for event in stepped]
            got.append(result)
    finally:
        ring.close()
    assert done_at_first_row == [True, False]
    assert handed == [("cpu", True)] * len(want)
    assert [r.read_id for r in got] == [read_id for read_id, _s in reads]
    for k, result in enumerate(got):
        table, row = want[k // 4], k % 4
        assert (result.call, result.start_call, result.end_call) == (
            table.calls[row], table.start_calls[row], table.end_calls[row])
        np.testing.assert_array_equal(result.start_probs, table.start_probs[row])
        np.testing.assert_array_equal(result.end_probs, table.end_probs[row])


def test_realtime_poll_on_the_card_matches_classify(cuda_device, tmp_path,
                                                    capsys):
    """One `realtime --max_batches 1` poll on a pod5 file with the flagship
    start model: the file goes to the bin of the call `classify` gives its
    read, after 15 K1 launches for the warm-up batch and 15 for the poll's."""
    from deepbinner_tpu_torch.cli.main import main
    from deepbinner_tpu_torch.utils.pod5 import write_pod5

    read = simulate.simulate_read("EXP-NBD103", 7, np.random.default_rng(13),
                                  genome_length=1200)
    in_dir = tmp_path / "incoming"
    in_dir.mkdir()
    write_pod5(in_dir / "one.pod5", [(read.read_id, read.signal)])
    main(["classify", str(in_dir), "-s", START_MODEL])
    rows = [line.split("\t") for line in capsys.readouterr().out.splitlines()]
    assert rows[1][0] == read.read_id
    before = conv_kernel.LAUNCHES
    main(["realtime", "--in_dir", str(in_dir), "--out_dir",
          str(tmp_path / "sorted"), "-s", START_MODEL, "--poll_interval", "0.1",
          "--max_batches", "1"])
    assert conv_kernel.LAUNCHES - before == 30
    assert (tmp_path / "sorted" / rows[1][1] / "one.pod5").exists()
    assert not (in_dir / "one.pod5").exists()


def _train_step_results(state, rows, offsets, device):
    """One Trainer step from ``state`` on ``device``: (loss, clipped
    gradients, new running statistics), on the CPU."""
    from deepbinner_tpu_torch.train import trainer as port_trainer

    cfg = port_trainer.TrainConfig(network=FLAGSHIP_QUIET, batch_size=len(rows[1]))
    trainer = port_trainer.Trainer(cfg, device)
    trainer.model.load_state_dict(state)
    metrics = trainer.run_train_step(*rows, offsets=offsets)
    grads = {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}
    stats = {n: b.cpu() for n, b in trainer.model.named_buffers()}
    return float(metrics["loss"]), grads, stats


def _float64_step(state, crops, labels, weights, device):
    """The step's forward, backward and clip in float64 on given crops."""
    from deepbinner_tpu_torch.models.network import DemuxNet
    from deepbinner_tpu_torch.train import trainer as port_trainer

    model = DemuxNet(FLAGSHIP_QUIET)
    model.load_state_dict(state)
    model = model.to(device, torch.float64)
    loss, _acc = port_trainer.forward_backward(
        model, crops.to(device, torch.float64), labels.to(device),
        weights.to(device, torch.float64))
    port_trainer.clip_by_global_norm_([p.grad for p in model.parameters()])
    return (float(loss), {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers()})


def _assert_step_close(got, want, grads=True):
    """Loss within 1e-5 relative, statistics within 1e-5 and (where asked)
    each gradient within 1e-4 of its tensor's largest |g|."""
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    for name, ref in want[2].items():
        assert float((got[2][name] - ref).abs().max()) <= 1e-5, name
    if grads:
        for name, ref in want[1].items():
            bound = 1e-4 * float(ref.abs().max())
            assert float((got[1][name] - ref).abs().max()) <= bound, name


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One flagship-width step (batch 8, offsets injected, noise and dropout
    at 0) from the same weights: in float64 on the same crops, the card
    computes the CPU's loss, gradients and statistics; the trainer's f32
    step on the card gives the CPU's loss and statistics, and with TF32
    asked for (matmul precision "high", cuDNN TF32 on) the card's own
    "highest" step, gradients included (the trainer pins TF32 off).  The
    f32 gradients are not held card against CPU: a ReLU or max-pool
    decision within rounding of a tie goes another way on each."""
    from deepbinner_tpu_torch.models.network import DemuxNet, init_weights
    from deepbinner_tpu_torch.train.trainer import augment_crop

    model = init_weights(DemuxNet(FLAGSHIP_QUIET), torch.Generator().manual_seed(0))
    state = model.state_dict()
    rng = np.random.default_rng(3)
    rows = (np.round(rng.normal(450, 60, (8, 1536))).astype(np.float32),
            rng.integers(0, 13, 8).astype(np.int32),
            np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32))
    offsets = rng.integers(0, 1536 - 1024 + 1, 8)
    same = (augment_crop(torch.from_numpy(rows[0]), 1024, offsets=offsets),
            torch.from_numpy(rows[1]).long(), torch.from_numpy(rows[2]))
    _assert_step_close(_float64_step(state, *same, cuda_device),
                       _float64_step(state, *same, "cpu"))
    want = _train_step_results(state, rows, offsets, "cpu")
    card = {}
    try:
        for precision, cudnn_tf32 in (("highest", False), ("high", True)):
            torch.set_float32_matmul_precision(precision)
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            card[precision] = _train_step_results(state, rows, offsets,
                                                  cuda_device)
            _assert_step_close(card[precision], want, grads=False)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
    _assert_step_close(card["high"], card["highest"])


def test_train_without_a_card_exits_nonzero(tmp_path):
    """`train` defaults to the card: with none visible it exits non-zero and
    says how to ask for the CPU.  (Runs with or without a card.)"""
    import subprocess
    import sys

    from deepbinner_tpu_torch.train import data as data_io

    data = tmp_path / "rows.tsv"
    data_io.write_samples(data, [(1, np.arange(300, dtype=np.int16))] * 4)
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run(
        [sys.executable, "-m", "deepbinner_tpu_torch.cli.main", "train",
         str(data), "--out", str(tmp_path / "m.dbt"), "--size", "tiny"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / "m.dbt").exists()
