"""The CUDA kernels against their plain versions, and the classify program
on the card against the same program on the CPU.

Every test here needs a CUDA card and nvcc: they are marked ``cuda`` and
skip without one.  The file imports no JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernel.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from deepbinner_tpu_torch.models.checkpoint import load_model
from deepbinner_tpu_torch.models.kernel_apply import fold_network
from deepbinner_tpu_torch.ops import conv_kernel, trunk_kernel
from deepbinner_tpu_torch.ops.calling import CallingConfig
from deepbinner_tpu_torch.ops.conv_kernel import (
    UnitPlan,
    conv1d_bn_relu_reference,
    fused_conv1d_bn_relu,
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
from deepbinner_tpu_torch.runner.executor import classify_stream
from deepbinner_tpu_torch.runner.pipeline import ClassifyConfig, ClassifyProgram
from deepbinner_tpu_torch.utils import simulate

pytestmark = pytest.mark.cuda

MODELS = os.path.join(os.path.dirname(__file__), "..", "deepbinner_tpu",
                      "models", "data")
TINY_MODEL = os.path.join(MODELS, "TINY_dryrun.dbt")
START_MODEL = os.path.join(MODELS, "EXP-NBD103_read_starts.dbt")
TOL = dict(atol=1e-4, rtol=1e-4)


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
    assert plan.path == "window"
    got = launch_planned(*arrays, plan._replace(path="generic"),
                         dilation=dilation, pool=True)
    want = conv1d_bn_relu_reference(*arrays, dilation=dilation, pool=True)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("plan", [
    UnitPlan(40, 128, 160, "generic", 4 * (3 * 32 * 40 + 130 * 33)),  # no tile
    UnitPlan(48, 64, 96, "generic", 4 * (3 * 32 * 48 + 66 * 33)),     # no rows
    UnitPlan(48, 128, 256, "generic", 4 * (3 * 32 * 48 + 130 * 33)),  # threads
    UnitPlan(48, 128, 192, "generic", 1024),                         # smem
    UnitPlan(48, 128, 192, "window", 4 * (5 * 32 * 48 + 132 * 33)),  # 5 taps
])
def test_kernel_raises_for_a_plan_it_was_not_built_for(cuda_device,
                                                       monkeypatch, plan):
    """The C side returns an error and launches nothing; the wrapper raises
    and picks no other plan."""
    taps = 5 if plan.path == "window" else 3
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
