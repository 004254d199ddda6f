#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deepbinner_tpu_torch/csrc`` (one
``nvcc`` per source, all started together), then drives the port and prints
one JSON line per phase:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, which optional packages import, the kernel build time.
2. ``kernel_unit`` / ``kernels``: the fused ConvBNReLU kernel (K1) at each
   of the 15 unit geometries of ``EXP-NBD103_read_starts.dbt`` at N = 2816
   windows (one 256-read batch), with its plan (``ops/conv_kernel.plan_unit``:
   output-channel tile, row tile, threads, inner loop, shared memory), held
   against its plain PyTorch version at atol and rtol 1e-4 and against
   itself (bit-identical rerun), with the kernel's, the "generic" loop's on
   the same tiles, the plain version's and a cuDNN yardstick's
   (``F.conv1d`` + affine + ReLU + pool, TF32 off) times and the unit's
   bound: the larger of its bytes over 3.35 TB/s and its FP32 operations
   over 67 TFLOP/s (H100 SXM data sheet).  The ``env`` line carries each
   kernel instance's registers and spills from the build's ptxas report.
3. ``megakernel_segment``: the trunk megakernel (K2) on each of the five
   segments (all, early, late, inc0, late1) at the same widths, N = 2816,
   held against its plain version at atol and rtol 1e-4 and against
   itself (bit-identical reruns), with the same three times and the bound,
   the plan (``ops/trunk_kernel.plan_segment``: early tile, threads, and
   per pass its row tile, loops, items, passes and lanes used; its shared
   memory must equal the C side's count) and K2's registers and spills.
4. ``classify``: the flagship start model through ``build_program`` (the
   CLI defaults: host trim, int8 wire, batch 256) and ``classify_stream`` on
   2048 simulated reads, the stock-model accuracy floor on 40 fresh-seed
   reads, and each kernel's launch count over the run.
5. ``dual``: the same with ``EXP-NBD103_read_ends.dbt`` as the end model.
6. ``classify_fused``: ``classify --pallas`` (stem1 on K1, the rest of the
   trunk in one K2 launch) on the same 2048 reads: calls equal to the
   ``classify`` phase's, the accuracy floor, 1 K1 + 1 K2 launch per batch;
   then ``cnn_ab``: the unit and fused CNN compositions timed in turns.
7. ``split3``: the three-launch trunk on the first 512 of those reads:
   calls equal to the ``classify`` phase's, 1 K1 + 3 K2 launches per batch.
8. ``cli``: the port's ``classify`` CLI on a small simulated fast5
   directory, when ``h5py`` imports.

Any failure raises, so the script exits non-zero and prints no success
line.  It needs a CUDA card and the repository's sources: without either it
exits non-zero before printing a result.  The last lines are the card's
``nvidia-smi`` name and power limit, the kernel summary as one JSON object,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.join(ROOT, "deepbinner_tpu_torch")
MODELS = os.path.join(ROOT, "deepbinner_tpu", "models", "data")
START_MODEL = os.path.join(MODELS, "EXP-NBD103_read_starts.dbt")
END_MODEL = os.path.join(MODELS, "EXP-NBD103_read_ends.dbt")
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")

BATCH = 256          # reads per batch (the CLI default)
WINDOWS = 2816       # 256 reads × 11 windows of 1024 at scan size 6144
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
FP32_FLOP_PER_S = 67e12      # H100 SXM, outside the tensor cores
TOL = 1e-4
KERNEL_REPLACES = {
    "conv1d_bn_relu": "deepbinner_tpu/ops/conv_pallas.py:113",
    "trunk_megakernel": "deepbinner_tpu/models/pallas_apply.py:162",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    """Build every csrc/*.cu at once, one nvcc each; seconds per kernel."""
    from deepbinner_tpu_torch.ops import kernel_build

    names = sorted(f[:-3] for f in os.listdir(kernel_build.CSRC)
                   if f.endswith(".cu"))
    errors = []

    def one(name: str) -> None:
        try:
            kernel_build.build(name)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    for name in names:
        kernel_build.load(name)
    return {name: kernel_build.BUILD_SECONDS[name] for name in names}


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def unit_geometries(config):
    """(scope, length, dilation, pool) of each unit, in execution order."""
    length = config.input_length
    units = [("stem1", length, 1, False), ("stem2", length, 1, True)]
    length //= 2
    for i in range(len(config.block_features)):
        units += [(f"block{i}_conv1", length, 1, False),
                  (f"block{i}_conv2", length, 1, True)]
        length //= 2
    for i in range(len(config.inception_features)):
        scope = f"inception{i}"
        units += [(f"{scope}/branch1x1", length, 1, True),
                  (f"{scope}/branch3", length, 1, True),
                  (f"{scope}/branch_dilated", length, 2 ** (i + 1), True),
                  (f"{scope}/branch_pool", length, 1, True)]
        length //= 2
    units.append(("head_conv", length, 1, False))
    return units


def phase_kernels(device) -> dict:
    """Kernel vs plain version at the 15 flagship unit geometries."""
    import torch
    import torch.nn.functional as F

    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.models.kernel_apply import fold_network
    from deepbinner_tpu_torch.ops.conv_kernel import (
        conv1d_bn_relu_reference,
        fused_conv1d_bn_relu,
        launch_planned,
        plan_unit,
    )

    model, config, _meta = load_model(START_MODEL)
    net = fold_network(model, device)
    gen = torch.Generator(device=device).manual_seed(0)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "bytes_bound_ms": 0.0, "ops_bound_ms": 0.0, "generic_ms": 0.0}
    worst = 0.0
    for scope, length, dilation, pool in unit_geometries(config):
        kernel, scale, bias = net.units[scope]
        taps, c_in, c_out = kernel.shape
        plan = plan_unit(c_in, c_out, taps, dilation, length)
        if c_out % plan.co_tile:
            raise AssertionError(f"{scope}: tile {plan.co_tile} wastes "
                                 f"columns of C_out {c_out}")
        x = torch.randn((WINDOWS, length, c_in), generator=gen, device=device)
        got = fused_conv1d_bn_relu(x, kernel, scale, bias, dilation=dilation,
                                   pool=pool)
        again = fused_conv1d_bn_relu(x, kernel, scale, bias,
                                     dilation=dilation, pool=pool)
        want = conv1d_bn_relu_reference(x, kernel, scale, bias,
                                         dilation=dilation, pool=pool)
        # The "generic" loop on the same tiles: the window loop's yardstick.
        generic = plan._replace(path="generic")
        got_generic = launch_planned(x, kernel, scale, bias, generic,
                                     dilation=dilation, pool=pool)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=TOL, rtol=TOL):
            raise AssertionError(f"{scope}: kernel disagrees with the plain "
                                 f"version, max abs err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"{scope}: K1 is not bit-identical from run "
                                 f"to run")
        generic_err = (got_generic - want).abs().max().item()
        if not torch.allclose(got_generic, want, atol=TOL, rtol=TOL):
            raise AssertionError(f"{scope}: the generic loop disagrees with "
                                 f"the plain version, max abs err "
                                 f"{generic_err}")
        worst = max(worst, err)
        del got, again, want, got_generic

        x_ncl = x.transpose(1, 2).contiguous()
        w_oik = kernel.permute(2, 1, 0).contiguous()
        halo = (taps - 1) // 2 * dilation

        def library():
            y = F.conv1d(x_ncl, w_oik, padding=halo, dilation=dilation)
            y = torch.relu(y * scale[:, None] + bias[:, None])
            return F.max_pool1d(y, 2) if pool else y

        ms = time_ms(lambda: fused_conv1d_bn_relu(
            x, kernel, scale, bias, dilation=dilation, pool=pool), 20)
        generic_ms = time_ms(lambda: launch_planned(
            x, kernel, scale, bias, generic, dilation=dilation, pool=pool), 20)
        plain_ms = time_ms(lambda: conv1d_bn_relu_reference(
            x, kernel, scale, bias, dilation=dilation, pool=pool), 5)
        library_ms = time_ms(library, 20)
        out_len = length // 2 if pool else length
        flops = 2 * WINDOWS * length * taps * c_in * c_out
        nbytes = 4 * (WINDOWS * length * c_in + WINDOWS * out_len * c_out
                      + taps * c_in * c_out + 2 * c_out)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        emit("kernel_unit", unit=scope, n=WINDOWS, length=length, c_in=c_in,
             c_out=c_out, taps=taps, dilation=dilation, pool=pool,
             co_tile=plan.co_tile, row_tile=plan.row_tile, path=plan.path,
             threads=plan.threads, smem_bytes=plan.smem_bytes,
             max_abs_err=err, bit_identical=True, ms=ms,
             generic_ms=generic_ms, generic_max_abs_err=generic_err,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
             gflop=flops / 1e9, mbytes=nbytes / 1e6)
        totals["ms"] += ms
        totals["generic_ms"] += generic_ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += library_ms
        totals["bound_ms"] += bound_ms
        totals["bytes_bound_ms" if bytes_ms > ops_ms else "ops_bound_ms"] += bound_ms
        del x, x_ncl
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, **totals}


def segment_units(config, segment: str):
    """(scope, length, dilation, pool) of each unit of a trunk segment."""
    from deepbinner_tpu_torch.ops.trunk_kernel import mega_unit_scopes

    scopes = {scope for scope, _d in mega_unit_scopes(config, segment)}
    return [g for g in unit_geometries(config) if g[0] in scopes]


def library_segment(x_ncl, weights, units, config, segment: str):
    """The cuDNN yardstick: the segment as F.conv1d + affine + ReLU + pool
    calls in PyTorch's (N, C, L) layout (TF32 off).  Never used by the port."""
    import torch
    import torch.nn.functional as F

    from deepbinner_tpu_torch.ops.trunk_kernel import segment_spec

    early, inc_lo, inc_hi, head = segment_spec(config, segment)

    def unit(scope, x, dilation=1, pool=False):
        _kernel, scale, bias = units[scope]
        w = weights[scope]
        y = F.conv1d(x, w, padding=(w.shape[2] - 1) // 2 * dilation,
                     dilation=dilation)
        y = torch.relu(y * scale[:, None] + bias[:, None])
        return F.max_pool1d(y, 2) if pool else y

    x = x_ncl
    if early:
        x = unit("stem2", x, pool=True)
        for i in range(len(config.block_features)):
            x = unit(f"block{i}_conv2", unit(f"block{i}_conv1", x), pool=True)
    for i in range(inc_lo, inc_hi):
        scope = f"inception{i}"
        x = torch.cat([
            unit(f"{scope}/branch1x1", x, pool=True),
            unit(f"{scope}/branch3", x, pool=True),
            unit(f"{scope}/branch_dilated", x, dilation=2 ** (i + 1), pool=True),
            unit(f"{scope}/branch_pool", F.max_pool1d(x, 3, 1, padding=1),
                 pool=True),
        ], dim=1)
    if head:
        return unit("head_conv", x).mean(dim=2)
    return x


def phase_megakernel(device) -> dict:
    """K2 vs its plain version on each trunk segment at flagship widths."""
    import torch

    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.models.kernel_apply import fold_network
    from deepbinner_tpu_torch.ops import kernel_build, trunk_kernel
    from deepbinner_tpu_torch.ops.trunk_kernel import (
        plan_segment,
        segment_input_channels,
        trunk_segment,
        trunk_segment_reference,
    )

    model, config, _meta = load_model(START_MODEL)
    net = fold_network(model, device)
    weights = {scope: kernel.permute(2, 1, 0).contiguous()
               for scope, (kernel, _s, _b) in net.units.items()}
    gen = torch.Generator(device=device).manual_seed(1)
    results = {}
    for segment in trunk_kernel.SEGMENTS:
        geometry = segment_units(config, segment)
        length = geometry[0][1]
        x = torch.randn((WINDOWS, length,
                         segment_input_channels(config, segment)),
                        generator=gen, device=device)
        got = trunk_segment(x, net.trunk, config, segment)
        again = trunk_segment(x, net.trunk, config, segment)
        want = trunk_segment_reference(x, net.units, config, segment)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=TOL, rtol=TOL):
            raise AssertionError(f"{segment}: K2 disagrees with the plain "
                                 f"version, max abs err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"{segment}: K2 is not bit-identical from "
                                 f"run to run")
        # The yardstick's own distance from the plain version, reported
        # only: it shows the cuDNN chain computes the same function.
        x_ncl = x.transpose(1, 2).contiguous()
        lib_out = library_segment(x_ncl, weights, net.units, config, segment)
        if lib_out.dim() == 3:
            lib_out = lib_out.transpose(1, 2)
        library_err = (lib_out - want).abs().max().item()
        del got, again, want, lib_out

        reps = 10 if segment in ("all", "early") else 20
        ms = time_ms(lambda: trunk_segment(x, net.trunk, config, segment),
                     reps)
        plain_ms = time_ms(lambda: trunk_segment_reference(
            x, net.units, config, segment), 3)
        library_ms = time_ms(lambda: library_segment(
            x_ncl, weights, net.units, config, segment), reps)
        flops = sum(2 * WINDOWS * unit_length * net.units[scope][0].numel()
                    for scope, unit_length, _d, _p in geometry)
        out_numel = math.prod(trunk_kernel.segment_output_shape(
            config, segment, WINDOWS, length))
        weight_numel = sum(t.numel() for scope, *_g in geometry
                           for t in net.units[scope])
        nbytes = 4 * (x.numel() + out_numel + weight_numel)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOP_PER_S * 1e3
        plan = plan_segment(config, segment, length=length)
        smem = trunk_kernel.shared_memory_bytes(net.trunk, config, segment,
                                                length)
        if smem != plan.smem_bytes:
            raise AssertionError(f"{segment}: the planner counts "
                                 f"{plan.smem_bytes} B of shared memory, "
                                 f"the kernel {smem}")
        results[segment] = dict(
            segment=segment, n=WINDOWS, length=length, units=len(geometry),
            max_abs_err=err, bit_identical=True, library_max_abs_err=library_err,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            gflop=flops / 1e9, mbytes=nbytes / 1e6, smem_bytes=smem,
            plan=dict(tile=plan.tile, threads=plan.threads,
                      lanes=plan.lanes,
                      units=[dict(unit=u.scopes[0].split("/")[0],
                                  row_tile=u.row_tile, paths=u.paths,
                                  rows=u.rows, items=u.items,
                                  passes=u.passes, lanes=u.lanes)
                             for u in plan.units]),
            ptxas=kernel_build.PTXAS.get("trunk_megakernel", []))
        emit("megakernel_segment", **results[segment])
        del x, x_ncl
        torch.cuda.empty_cache()
    return results


def _simulated_reads(count: int, seed: int, end: str = "start"):
    import numpy as np

    from deepbinner_tpu_torch.utils import simulate

    rng = np.random.default_rng(seed)
    reads, truth = [], {}
    for i in range(count):
        barcode = int(rng.integers(0, 13))
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=1200)
        signal = read.signal if end == "start" else read.signal[::-1].copy()
        reads.append((read.read_id, signal))
        truth[read.read_id] = barcode
    return reads, truth


def _build_program(end_model=None, extra=()):
    from deepbinner_tpu_torch.cli.classify import build_program
    from deepbinner_tpu_torch.cli.main import get_arguments

    argv = ["classify", ROOT, "-s", START_MODEL, *extra]
    if end_model:
        argv += ["-e", end_model]
    program, _net_cfg = build_program(get_arguments(argv))
    return program


def _run_stream(program, reads):
    """Classify ``reads`` through classify_stream.

    Returns (calls, stats, seconds, launches), where launches counts each
    kernel's launches over this stream alone (both counts are set to 0
    just before it).
    """
    import torch

    from deepbinner_tpu_torch.ops import conv_kernel, trunk_kernel
    from deepbinner_tpu_torch.runner.executor import ExecutorStats, classify_stream

    stats = ExecutorStats()
    conv_kernel.LAUNCHES = 0
    trunk_kernel.LAUNCHES = 0
    start = time.perf_counter()
    calls = {r.read_id: r.call for r in classify_stream(
        program, iter(reads), batch_size=BATCH, stats=stats)}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {"conv1d_bn_relu": conv_kernel.LAUNCHES,
                "trunk_megakernel": trunk_kernel.LAUNCHES}
    if len(calls) != len(reads):
        raise AssertionError(f"{len(reads)} reads in, {len(calls)} calls out")
    return calls, stats, seconds, launches


def _check_launches(launches: dict, batches: int, per_batch: dict,
                    what: str) -> None:
    want = {name: count * batches for name, count in per_batch.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {batches} "
                             f"batches; expected {want}")


def _score(calls, truth):
    exact = sum(1 for rid, t in truth.items() if calls[rid] == t)
    wrong = sum(1 for rid, t in truth.items() if calls[rid] not in (t, 0))
    return exact, wrong


def _accuracy_floor(program):
    """The stock-model accuracy floor of tests/test_stock_models.py: 3 reads
    per barcode + 4 none from seed 977, >= 38/40 exact, no wrong barcode."""
    import numpy as np

    from deepbinner_tpu_torch.utils import simulate

    rng = np.random.default_rng(977)
    floor_reads, floor_truth = [], {}
    for barcode in [b for b in range(1, 13) for _ in range(3)] + [0] * 4:
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=1200)
        floor_reads.append((read.read_id, read.signal))
        floor_truth[read.read_id] = barcode
    floor_calls, _s, _t, _l = _run_stream(program, floor_reads)
    floor_exact, floor_wrong = _score(floor_calls, floor_truth)
    if floor_wrong or floor_exact < 38:
        raise AssertionError(f"accuracy floor: {floor_exact}/40 exact, "
                             f"{floor_wrong} wrong barcodes")
    return floor_exact, floor_wrong


def _classify_phase(phase: str, program, reads, truth, per_batch: dict,
                    cnn) -> dict:
    """Stream ``reads``, check the launches and the accuracy floor, and time
    one batch on the host, on the device and in the CNN alone (``cnn``)."""
    import torch

    from deepbinner_tpu_torch.runner.executor import build_batch

    program.warm_up(BATCH)
    calls, stats, seconds, launches = _run_stream(program, reads)
    _check_launches(launches, stats.batches, per_batch, phase)
    exact, wrong = _score(calls, truth)
    floor_exact, floor_wrong = _accuracy_floor(program)

    start = time.perf_counter()
    _ids, sig, lens, _e, _el = build_batch(reads[:BATCH],
                                          program.cfg.preprocess, BATCH, False)
    host_batch_ms = (time.perf_counter() - start) * 1e3
    sig_dev = torch.from_numpy(sig).to(program.device)
    len_dev = torch.from_numpy(lens).to(program.device)
    batch_ms = time_ms(lambda: program.call_packed(sig_dev, len_dev), 5)
    windows = torch.randn((WINDOWS, 1024), device=program.device)
    with torch.inference_mode():
        cnn_ms = time_ms(lambda: cnn(program.start_net, windows), 5)
    emit(phase, reads=len(reads), batches=stats.batches,
         seconds=seconds, reads_per_s=len(reads) / seconds,
         launches=launches,
         launches_per_batch={k: v / stats.batches for k, v in launches.items()},
         exact=exact, wrong=wrong, floor_exact=floor_exact,
         floor_wrong=floor_wrong, device_batch_ms=batch_ms,
         cnn_batch_ms=cnn_ms, host_batch_ms=host_batch_ms,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return {"calls": calls, "launches": launches}


def phase_classify(reads, truth) -> dict:
    from deepbinner_tpu_torch.models.kernel_apply import apply_inference_kernels

    return _classify_phase("classify", _build_program(), reads, truth,
                           {"conv1d_bn_relu": 15, "trunk_megakernel": 0},
                           apply_inference_kernels)


def phase_classify_fused(reads, truth, unit_calls) -> dict:
    """classify --pallas: the same reads must get the unit path's calls."""
    from deepbinner_tpu_torch.models.kernel_apply import (
        apply_inference_kernels_fused,
    )

    program = _build_program(extra=["--pallas"])
    if program.cfg.kernel_path != "fused":
        raise AssertionError(f"--pallas gave kernel_path "
                             f"{program.cfg.kernel_path!r}")
    result = _classify_phase("classify_fused", program, reads, truth,
                             {"conv1d_bn_relu": 1, "trunk_megakernel": 1},
                             apply_inference_kernels_fused)
    _same_calls("classify_fused", result["calls"], unit_calls)
    emit("cnn_ab", **_cnn_ab(program))
    return result


def _cnn_ab(program, reps: int = 20) -> dict:
    """The unit and fused CNN compositions on one batch of windows, timed in
    turns (unit, fused, fused, unit), so that the two are compared within
    one call."""
    import torch

    from deepbinner_tpu_torch.models.kernel_apply import (
        apply_inference_kernels,
        apply_inference_kernels_fused,
    )

    windows = torch.randn((WINDOWS, 1024), device=program.device)
    paths = {"unit": apply_inference_kernels,
             "fused": apply_inference_kernels_fused}
    times = {"unit_ms": [], "fused_ms": []}
    with torch.inference_mode():
        for name in ("unit", "fused", "fused", "unit"):
            apply = paths[name]
            times[f"{name}_ms"].append(time_ms(
                lambda: apply(program.start_net, windows), reps))
    return times


def _same_calls(phase: str, calls: dict, unit_calls: dict) -> None:
    differ = [rid for rid, call in calls.items() if call != unit_calls[rid]]
    if differ:
        raise AssertionError(f"{phase}: {len(differ)} of {len(calls)} calls "
                             f"differ from the unit path's (e.g. {differ[:3]})")


def phase_split3(reads, unit_calls) -> None:
    import dataclasses

    program = _build_program()
    program.cfg = dataclasses.replace(program.cfg, kernel_path="split3")
    program.warm_up(BATCH)
    calls, stats, seconds, launches = _run_stream(program, reads)
    _check_launches(launches, stats.batches,
                    {"conv1d_bn_relu": 1, "trunk_megakernel": 3}, "split3")
    _same_calls("split3", calls, unit_calls)
    emit("split3", reads=len(reads), batches=stats.batches, seconds=seconds,
         reads_per_s=len(reads) / seconds, launches=launches,
         same_calls_as_unit=len(calls))


def phase_dual() -> None:
    program = _build_program(END_MODEL)
    program.warm_up(BATCH)
    reads, truth = _simulated_reads(512, seed=4096)
    calls, stats, seconds, launches = _run_stream(program, reads)
    _check_launches(launches, stats.batches,
                    {"conv1d_bn_relu": 30, "trunk_megakernel": 0}, "dual")
    exact, wrong = _score(calls, truth)
    if exact < 0.9 * len(reads):
        raise AssertionError(f"dual model: only {exact}/{len(reads)} exact")
    emit("dual", reads=len(reads), batches=stats.batches, seconds=seconds,
         reads_per_s=len(reads) / seconds, launches=launches,
         exact=exact, wrong=wrong)


def phase_cli() -> None:
    try:
        import h5py  # noqa: F401
    except ImportError as exc:
        emit("cli", ran=False, reason=f"h5py does not import ({exc}); the "
             "fast5 reader needs it")
        return
    import shutil

    from deepbinner_tpu_torch.cli.main import main as cli_main
    from deepbinner_tpu_torch.utils import simulate

    data_dir = os.path.join(WORK_DIR, "fast5_dataset")
    shutil.rmtree(data_dir, ignore_errors=True)
    truth = simulate.make_dataset(data_dir, kit="EXP-NBD103",
                                  reads_per_barcode=2, none_reads=4,
                                  genome_length=1200, seed=5,
                                  write_fastq=False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["classify", os.path.join(data_dir, "fast5s"), "-s",
                  START_MODEL, "-e", END_MODEL, "--batch_size", "16"])
    rows = [line.split("\t") for line in out.getvalue().splitlines()[1:]
            if line]
    if sorted(r[0] for r in rows) != sorted(truth):
        raise AssertionError("cli: rows do not match the simulated reads")
    calls = {r[0]: r[1] for r in rows}
    exact = sum(1 for rid, t in truth.items()
                if calls[rid] == ("none" if t == 0 else f"barcode{t:02d}"))
    emit("cli", ran=True, reads=len(truth), rows=len(rows), exact=exact)
    shutil.rmtree(data_dir, ignore_errors=True)


def main() -> int:
    if not os.path.isdir(PACKAGE):
        print(f"chip_smoke: {PACKAGE} is missing; run from a checkout of the "
              f"repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # TF32 off everywhere: the reference is f32.  Only the cuDNN yardstick
    # and the plain version's matmuls would otherwise use it.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi_line()

    packages = {}
    for name in ("h5py", "msgpack", "zstandard"):
        try:
            __import__(name)
            packages[name] = True
        except ImportError:
            packages[name] = False
    build_s = build_kernels()
    from deepbinner_tpu_torch.ops import kernel_build

    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], imports=packages,
         kernel_build_s=build_s, ptxas=kernel_build.PTXAS)

    kernels = phase_kernels(device)
    emit("kernels", kernels=[{"name": "conv1d_bn_relu", "parity": "ok",
                              "max_abs_err": kernels["max_abs_err"],
                              "geometries": 15, "ms": kernels["ms"],
                              "generic_ms": kernels["generic_ms"]}])
    segments = phase_megakernel(device)
    emit("kernels", kernels=[{"name": "trunk_megakernel", "parity": "ok",
                              "max_abs_err": max(r["max_abs_err"] for r in
                                                 segments.values()),
                              "segments": len(segments)}])
    reads, truth = _simulated_reads(2048, seed=2024)
    unit = phase_classify(reads, truth)
    phase_dual()
    fused = phase_classify_fused(reads, truth, unit["calls"])
    phase_split3(reads[:512], unit["calls"])
    phase_cli()

    # K2's numbers are those of the "all" segment, the one launch per batch
    # that classify --pallas makes; every segment's are on its own line.
    whole = segments["all"]
    summary = {"kernels": [{
        "name": "conv1d_bn_relu",
        "route": "cuda",
        "source": "deepbinner_tpu_torch/csrc/conv1d_bn_relu.cu",
        "replaces": KERNEL_REPLACES["conv1d_bn_relu"],
        "launches": unit["launches"]["conv1d_bn_relu"],
        "max_abs_err": kernels["max_abs_err"],
        "ms": kernels["ms"],
        "plain_ms": kernels["plain_ms"],
        "bound_ms": kernels["bound_ms"],
        "bound_by": ("operations" if kernels["ops_bound_ms"]
                     >= kernels["bytes_bound_ms"] else "bytes"),
        "library_ms": kernels["library_ms"],
    }, {
        "name": "trunk_megakernel",
        "route": "cuda",
        "source": "deepbinner_tpu_torch/csrc/trunk_megakernel.cu",
        "replaces": KERNEL_REPLACES["trunk_megakernel"],
        "launches": fused["launches"]["trunk_megakernel"],
        "max_abs_err": max(r["max_abs_err"] for r in segments.values()),
        "ms": whole["ms"],
        "plain_ms": whole["plain_ms"],
        "bound_ms": whole["bound_ms"],
        "bound_by": whole["bound_by"],
        "library_ms": whole["library_ms"],
    }]}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
