#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deepbinner_tpu_torch/csrc`` (one
``nvcc`` per source, all started together), then drives the port and prints
one JSON line per phase:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, the kernel build time, and the probe of what the machine can
   read signal files with: which of ``h5py``, ``zstandard``, ``pyarrow``
   and ``flatbuffers`` import, what ``ctypes.util.find_library`` returns
   for ``hdf5_serial``, ``hdf5`` and ``zstd``, the version of the zstd
   library the port's ctypes binding loads, and whether ``g++`` is on the
   path.
2. ``kernel_unit`` / ``kernels``: the fused ConvBNReLU kernel (K1) at each
   of the 15 unit geometries of ``EXP-NBD103_read_starts.dbt`` at N = 2816
   windows (one 256-read batch), with its plan (``ops/conv_kernel.plan_unit``:
   output-channel tile, row tile, threads, loop, shared memory, stages and
   blocks per SM), held against its plain PyTorch version at atol and rtol
   1e-4 and against itself (bit-identical rerun), with the kernel's, the
   "generic" loop's, the plain version's and a cuDNN yardstick's
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
8. ``keras``: the flagship start model expressed as a Keras 2.2 graph
   (``scripts/demuxnet_as_keras.py``: Conv1D, BatchNormalization and
   Activation per unit, the pools, Concatenate, GlobalAveragePooling1D,
   Dense(softmax)) and parsed by ``models/keras_import.KerasGraphModel``,
   run through a ``ClassifyProgram`` on the ``classify`` phase's 2048
   reads: calls equal to the unit path's on every read, combined
   probabilities within 1e-4, no launch of K1 or K2; the line carries the
   graph's and the unit path's reads/s, ``device_batch_ms`` and
   ``cnn_batch_ms``.
9. ``hybrid``: ``kernel_path="hybrid"`` (K1 at the JAX table's three
   units, cuDNN with TF32 off at the other twelve) on the same 2048
   reads: calls equal to the unit path's, 3 K1 launches per batch, the
   times beside the unit path's, and the units at which the
   ``kernel_unit`` lines put K1 ahead of the cuDNN yardstick.
10. ``tf32`` (fault F1): with ``torch.set_float32_matmul_precision("high")``
   one flagship batch's packed call table must be bit-identical to the one
   at ``"highest"``, and the process setting must read ``"high"`` after the
   call.
11. ``pool_ring``: the reader pool's shared-memory ring, without files: a
   ring of ``MIN_SHM_SLOTS`` slots registered as pinned memory, filled by
   ``build_batch_arrays(out=views)`` as a worker fills it, with the
   ``classify`` phase's 2048 reads, handed to ``classify_batches`` as
   6-tuples whose ``release`` overwrites the slot with 0x55 bytes.  The
   calls must equal the ``classify`` phase's, with one release and 15 K1
   launches per batch.
12. ``native``: the native fast5 reader (where the probe found g++ and an
    HDF5 runtime; held against h5py where it imports), the native vbz
    unpacker (where g++ is found; held against the numpy path), and the
    zstd binding (a vbz round trip of the same three signals through the
    system libzstd); a part the machine cannot build prints ``ran: false``
    with the probe's reason.
13. ``cli``: the port's CLI on pod5 files written here: ``simulate``
    writes 2048 reads in 8 pod5 containers, ``classify`` (start and end
    models, batch 256) reads them once with reader threads and once with
    the default worker pool, whose two tables must be byte-identical with
    one row per read, and ``bin`` sorts ``reads.fastq`` by that table
    twice, byte-identically, each read into the bin its row names.
14. ``realtime``: 256 single-read pod5 files, moved into the watched
    directory in drops of 64 every 0.5 s while ``realtime`` (the flagship
    start model, the CLI defaults: 2 reader workers on the card, batch
    256) polls every 0.2 s; every file must end in the bin that
    ``classify`` gave its read, with 15 K1 launches per classified batch
    (and per warm-up batch), and the seconds from each file's arrival to
    its move are reported.
15. ``train``: the training path on the card.  Training rows are built
    here with the recipe of ``scripts/train_models.py`` (the port's
    ``simulate_read``, EXP-NBD103 read starts, genome 2000, as many none
    reads as reads per barcode, ``extract_training_samples`` at signal size
    1536 and margin 128), written with ``write_samples``, then ``balance``
    and ``train`` run through the port's CLI at the flagship width (input
    1024, batch 256, lr 1e-3, a checkpoint directory).  Reported: samples,
    epochs, wall time, the median ms per train step from CUDA events after
    epoch 1, samples/s, each epoch's train loss and validation accuracy.
    Then: a run stopped after epoch 2 and resumed for epoch 3 restores the
    step, weights and Adam's moments bit for bit and repeats the
    uninterrupted run's epoch-3 loss bit for bit (the steps are
    deterministic); one flagship-width step at batch 32 (offsets injected,
    noise and dropout at 0) on the card against the CPU: in float64 on the
    same crops, loss 1e-5 relative, each gradient within 1e-4 of its
    largest |g|, running statistics 1e-5; the trainer's f32 step, loss and
    statistics at those bounds (its gradients reported), and with TF32
    asked for the card's own "highest" step at every bound; and
    the trained `.dbt`, loaded by ``load_model`` and run through
    ``build_program`` on the unit path (15 K1 launches per batch), meets the
    accuracy floor.  ``step_variants``: the trainer's step against the same
    step on cuDNN's default algorithms (time, and whether two runs repeat
    bit for bit), and the pinned step's top kernels by device time
    (``torch.profiler``).
16. ``dp_classify`` (after ``pool_ring``): ``ClassifyProgram(devices=
    [cuda:0, cuda:0])``, each batch's rows split in two and both halves
    run on the one card, on the ``classify`` phase's 2048 reads: calls equal
    to that phase's, 15 K1 launches per half batch (30 per batch); the
    same over ``kernel_path="fused"`` on the first 512 (1 K1 + 1 K2 per
    half); K1 held against its plain version at the half batch's 1408
    windows (``kernel_unit_shard`` lines); ``dp_pool_ring``: the
    ``pool_ring`` check on this program, a slot released only once the
    uploads of both halves are done.  With more than one card, also the
    CLI's ``--device_count 2``.
17. ``tp_classify`` (after ``dp_classify``): the ``'model'`` axis,
    ``ClassifyProgram(devices=[cuda:0] * 4, model=2)``: a data 2 × model 2
    grid on the one card, each unit's output features split in two column
    shards, K1 on each, gathered in rank order, on the ``classify`` phase's
    2048 reads: calls equal to that phase's on every read, combined
    probabilities within 1e-5, 60 K1 launches per batch, and the gathers
    and peer copies of one batch; then ``kernel_unit_tp`` lines and a
    ``tp_units`` total at model 2 and 4: K1 on each flagship unit's column
    shards at a data group's 1408 windows against its plain version
    (atol and rtol 1e-4) and a rerun (bit-identical), the rank-order
    gather against the unsharded K1 (largest difference; bit-identical or
    not), the shards' times beside the whole unit's and the bound.
18. ``dryrun``: ``deepbinner_tpu_torch/entry.py`` on the card: ``entry()``
    (the flagship classify step on 32 all-zero reads: calls of shape (32,),
    15 K1 launches, its time), then ``dryrun_multichip(4)`` on
    [cuda:0] * 4: one train step and an eval of the tiny network over two
    gloo ranks on the card (finite loss), then the tiny model's
    data-parallel and model-axis calls on 16 simulated reads, equal, over
    at least 3 classes.
19. ``dist_classify`` (after ``cli``): two ranks of the port's `classify`
    (``RANK``/``WORLD_SIZE`` as ``torchrun`` sets them; both on the one
    card, so the process group is gloo) over the ``cli`` phase's 8 pod5
    files, each with the default reader pool: rank 0's table must equal the
    single process's byte for byte, rank 1 prints none, each rank makes 15
    K1 launches per model per batch; then once more with ``--shard_dir``
    (manifests ``h0000`` and ``h0001``).
20. ``dp_train`` (after ``train``): two ranks of `train` on the one card
    (gloo on CUDA tensors) and one process, on the ``train`` phase's rows
    at the flagship width: the first 5 Trainer steps in float64, whose
    losses must agree within 1e-4 relative (the ranks' with each other bit
    for bit); then 6 epochs in f32 through the CLI: the ranks' weights,
    statistics and Adam state bit-identical after every epoch, the first 5
    f32 losses against one process's reported, rank 0's ``.dbt`` at the
    accuracy floor through K1; the median ms per step of each layout (the
    ranks' is gloo through one card, not NCCL's time).
21. ``processes``: once the phases end, passed or failed, every process
    the run started that still runs is stopped: reader workers and any
    other child are killed, and multiprocessing's resource tracker is
    stopped and waited for.  A reader worker or other child still alive
    at that point fails the run (a pool was left open).  The ranks of
    phases 19 and 20 run in sessions of their own, killed whole if one
    fails; the dry run's training ranks (phase 18) are spawned and joined
    by ``torch.multiprocessing``.

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
import re
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


def phase_kernels(device, n: int = WINDOWS, line: str = "kernel_unit") -> dict:
    """Kernel vs plain version at the 15 flagship unit geometries, on ``n``
    windows (one line each, named ``line``)."""
    import torch
    import torch.nn.functional as F

    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.models.kernel_apply import fold_network
    from deepbinner_tpu_torch.ops.conv_kernel import (
        conv1d_bn_relu_reference,
        fused_conv1d_bn_relu,
        generic_plan,
        launch_planned,
        plan_unit,
    )

    model, config, _meta = load_model(START_MODEL)
    net = fold_network(model, device)
    gen = torch.Generator(device=device).manual_seed(0)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "bytes_bound_ms": 0.0, "ops_bound_ms": 0.0, "generic_ms": 0.0}
    worst = 0.0
    units = {}
    for scope, length, dilation, pool in unit_geometries(config):
        kernel, scale, bias = net.units[scope]
        taps, c_in, c_out = kernel.shape
        plan = plan_unit(c_in, c_out, taps, dilation, length)
        if c_out % plan.co_tile:
            raise AssertionError(f"{scope}: tile {plan.co_tile} wastes "
                                 f"columns of C_out {c_out}")
        x = torch.randn((n, length, c_in), generator=gen, device=device)
        got = fused_conv1d_bn_relu(x, kernel, scale, bias, dilation=dilation,
                                   pool=pool)
        again = fused_conv1d_bn_relu(x, kernel, scale, bias,
                                     dilation=dilation, pool=pool)
        want = conv1d_bn_relu_reference(x, kernel, scale, bias,
                                         dilation=dilation, pool=pool)
        # The "generic" loop on the same tiles: the pipelined loop's yardstick.
        generic = generic_plan(c_in, c_out, taps, dilation, length)
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
        flops = 2 * n * length * taps * c_in * c_out
        nbytes = 4 * (n * length * c_in + n * out_len * c_out
                      + taps * c_in * c_out + 2 * c_out)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        emit(line, unit=scope, n=n, length=length, c_in=c_in,
             c_out=c_out, taps=taps, dilation=dilation, pool=pool,
             co_tile=plan.co_tile, row_tile=plan.row_tile, path=plan.path,
             threads=plan.threads, smem_bytes=plan.smem_bytes,
             stages=plan.stages, blocks_per_sm=plan.blocks_per_sm,
             max_abs_err=err, bit_identical=True, ms=ms,
             generic_ms=generic_ms, generic_max_abs_err=generic_err,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
             gflop=flops / 1e9, mbytes=nbytes / 1e6)
        units[scope] = {"ms": ms, "library_ms": library_ms}
        totals["ms"] += ms
        totals["generic_ms"] += generic_ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += library_ms
        totals["bound_ms"] += bound_ms
        totals["bytes_bound_ms" if bytes_ms > ops_ms else "ops_bound_ms"] += bound_ms
        del x, x_ncl
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, **totals, "units": units}


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


def _build_program(end_model=None, extra=(), start_model=START_MODEL):
    """The CLI's classify program on one card (``extra`` may ask for more
    with its own ``--device_count``)."""
    from deepbinner_tpu_torch.cli.classify import build_program
    from deepbinner_tpu_torch.cli.main import get_arguments

    argv = ["classify", ROOT, "-s", start_model, "--device_count", "1", *extra]
    if end_model:
        argv += ["-e", end_model]
    program, _net_cfg = build_program(get_arguments(argv))
    return program


def _run_stream(program, reads, probs=None):
    """Classify ``reads`` through classify_stream.

    Returns (calls, stats, seconds, launches), where launches counts each
    kernel's launches over this stream alone (both counts are set to 0
    just before it).  ``probs``, a dict, takes each read's combined start
    probabilities.
    """
    import torch

    from deepbinner_tpu_torch.ops import conv_kernel, trunk_kernel
    from deepbinner_tpu_torch.runner.executor import ExecutorStats, classify_stream

    stats = ExecutorStats()
    conv_kernel.LAUNCHES = 0
    trunk_kernel.LAUNCHES = 0
    start = time.perf_counter()
    calls = {}
    for result in classify_stream(program, iter(reads), batch_size=BATCH,
                                  stats=stats):
        calls[result.read_id] = result.call
        if probs is not None:
            probs[result.read_id] = result.start_probs
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


def _floor_reads():
    """The reads of the stock-model accuracy floor of
    tests/test_stock_models.py: 3 per barcode + 4 none from seed 977."""
    import numpy as np

    from deepbinner_tpu_torch.utils import simulate

    rng = np.random.default_rng(977)
    floor_reads, floor_truth = [], {}
    for barcode in [b for b in range(1, 13) for _ in range(3)] + [0] * 4:
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=1200)
        floor_reads.append((read.read_id, read.signal))
        floor_truth[read.read_id] = barcode
    return floor_reads, floor_truth


def _accuracy_floor(program):
    """The stock-model accuracy floor: >= 38/40 exact, no wrong barcode."""
    floor_reads, floor_truth = _floor_reads()
    floor_calls, _s, _t, _l = _run_stream(program, floor_reads)
    floor_exact, floor_wrong = _score(floor_calls, floor_truth)
    if floor_wrong or floor_exact < 38:
        raise AssertionError(f"accuracy floor: {floor_exact}/40 exact, "
                             f"{floor_wrong} wrong barcodes")
    return floor_exact, floor_wrong


def _classify_phase(phase: str, program, reads, truth, per_batch: dict,
                    cnn, unit: dict = None, prob_tol: float = None,
                    **extra) -> dict:
    """Stream ``reads``, check the launches and the accuracy floor, and time
    one batch on the device and in the CNN alone (``cnn``).

    With ``unit`` (the ``classify`` phase's result) the calls must equal
    the unit path's on every read, the combined probabilities must lie
    within ``prob_tol`` of its (where given; else the distance is only
    reported), and the line carries the unit path's times beside this
    path's.  ``extra`` fields go on the line as they are."""
    import numpy as np
    import torch

    from deepbinner_tpu_torch.runner.executor import build_batch

    torch.cuda.reset_peak_memory_stats()
    program.warm_up(BATCH)
    probs = {}
    calls, stats, seconds, launches = _run_stream(program, reads, probs)
    _check_launches(launches, stats.batches, per_batch, phase)
    if unit is not None:
        _same_calls(phase, calls, unit["calls"])
        prob_diff = max(float(np.abs(p - unit["probs"][rid]).max())
                        for rid, p in probs.items())
        if prob_tol is not None and prob_diff > prob_tol:
            raise AssertionError(f"{phase}: combined probabilities differ from "
                                 f"the unit path's by {prob_diff} > {prob_tol}")
        extra.update(same_calls_as_unit=len(calls),
                     max_prob_diff_vs_unit=prob_diff,
                     unit_reads_per_s=unit["reads_per_s"],
                     unit_device_batch_ms=unit["device_batch_ms"],
                     unit_cnn_batch_ms=unit["cnn_batch_ms"])
    exact, wrong = _score(calls, truth)
    floor_exact, floor_wrong = _accuracy_floor(program)

    _ids, sig, lens, _e, _el = build_batch(reads[:BATCH],
                                          program.cfg.preprocess, BATCH, False)
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
         cnn_batch_ms=cnn_ms,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)
    return {"calls": calls, "probs": probs, "launches": launches,
            "batches": stats.batches, "reads_per_s": len(reads) / seconds,
            "device_batch_ms": batch_ms, "cnn_batch_ms": cnn_ms}


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


def _keras_graph(model_file: str):
    """A `.dbt` model expressed as a Keras 2.2 graph
    (``scripts/demuxnet_as_keras.py``), parsed by the port's importer."""
    import importlib.util

    from deepbinner_tpu_torch.models.checkpoint import load_model, to_flax_variables
    from deepbinner_tpu_torch.models.keras_import import KerasGraphModel

    spec = importlib.util.spec_from_file_location(
        "demuxnet_as_keras", os.path.join(ROOT, "scripts", "demuxnet_as_keras.py"))
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    model, config, _meta = load_model(model_file)
    return KerasGraphModel(*converter.demuxnet_as_keras(
        config, to_flax_variables(model)))


def phase_keras(reads, truth, unit: dict) -> None:
    """The flagship as an imported Keras graph (no kernel of the port): the
    unit path's calls on every read, its probabilities within 1e-4."""
    import torch

    from deepbinner_tpu_torch.runner.pipeline import ClassifyProgram

    graph = _keras_graph(START_MODEL)
    cli = _build_program()  # the CLI defaults, on its device
    program = ClassifyProgram(graph, cli.cfg, device=cli.device)
    _classify_phase("keras", program, reads, truth,
                    {"conv1d_bn_relu": 0, "trunk_megakernel": 0},
                    lambda net, windows: torch.softmax(net(windows), dim=-1),
                    unit=unit, prob_tol=TOL, layers=len(graph.layers))


def phase_hybrid(reads, truth, unit: dict, kernels: dict) -> dict:
    """kernel_path="hybrid": K1 at the JAX table's units, cuDNN elsewhere;
    the unit path's calls, 3 K1 launches per batch.  The line also says at
    which units the ``kernel_unit`` lines put K1 ahead of the library."""
    import dataclasses

    from deepbinner_tpu_torch.models.kernel_apply import (
        HYBRID_KERNEL_UNITS,
        apply_inference_kernels_hybrid,
    )

    program = _build_program()
    program.cfg = dataclasses.replace(program.cfg, kernel_path="hybrid")
    ahead = [scope for scope, t in kernels["units"].items()
             if t["ms"] < t["library_ms"]]
    return _classify_phase(
        "hybrid", program, reads, truth,
        {"conv1d_bn_relu": len(HYBRID_KERNEL_UNITS), "trunk_megakernel": 0},
        apply_inference_kernels_hybrid, unit=unit,
        table=sorted(HYBRID_KERNEL_UNITS), k1_ahead_of_library=ahead,
        library_ahead_of_k1=[s for s in kernels["units"] if s not in ahead],
        k1_ahead_at_every_unit=len(ahead) == len(kernels["units"]))


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


def probe_readers() -> dict:
    """What this machine can read signal files with: fast5 needs h5py (or
    the native reader: g++ and an HDF5 runtime library), pod5 needs
    pyarrow and the system zstd library (the port's ctypes binding)."""
    import ctypes.util
    import shutil

    from deepbinner_tpu_torch.native import zstd

    imports = {}
    for name in ("h5py", "msgpack", "zstandard", "pyarrow", "flatbuffers"):
        try:
            __import__(name)
            imports[name] = True
        except ImportError:
            imports[name] = False
    try:
        zstd_version = zstd.version()
    except OSError as exc:
        zstd_version = f"not loaded: {exc}"
    return {"imports": imports,
            "find_library": {name: ctypes.util.find_library(name)
                             for name in ("hdf5_serial", "hdf5", "zstd")},
            "zstd_version": zstd_version,
            "gxx": shutil.which("g++")}


def phase_tf32(reads) -> None:
    """Fault F1: the classify program pins TF32 off for its own calls."""
    import torch

    from deepbinner_tpu_torch.runner.executor import build_batch
    from deepbinner_tpu_torch.runner.pipeline import (
        classify_step,
        pack_call_table,
    )

    program = _build_program()
    _ids, sig, lens, _e, _el = build_batch(reads[:BATCH],
                                           program.cfg.preprocess, BATCH, False)
    tables = {}
    try:
        for precision in ("high", "highest"):
            torch.set_float32_matmul_precision(precision)
            tables[precision] = program.call_packed(sig, lens).cpu()
            after = torch.get_float32_matmul_precision()
            if after != precision:
                raise AssertionError(f"tf32: the process setting reads "
                                     f"{after!r} after a call at {precision!r}")
        # The same step outside the program's pin, TF32 left on: reported
        # only, it shows what the pin keeps out.
        torch.set_float32_matmul_precision("high")
        with torch.inference_mode():
            loose = pack_call_table(classify_step(
                program.cfg, program.start_net, None,
                *program.upload(sig, lens))).cpu()
    finally:
        torch.set_float32_matmul_precision("highest")
    if not torch.equal(tables["high"], tables["highest"]):
        diff = (tables["high"] - tables["highest"]).abs().max().item()
        raise AssertionError(f"tf32: the call table at 'high' differs from "
                             f"the one at 'highest' by {diff}")
    emit("tf32", reads=BATCH, bit_identical=True,
         unpinned_max_abs_diff=(loose - tables["highest"]).abs().max().item())


def phase_pool_ring(reads, unit: dict, program=None,
                    phase: str = "pool_ring") -> None:
    """The reader pool's pinned shared-memory ring under classify_batches
    (``program``: the CLI-default one-device program unless given; a slot
    goes back only once the uploads to all its devices are done)."""
    import functools
    import multiprocessing as mp

    import numpy as np
    import torch

    from deepbinner_tpu_torch.ops import conv_kernel, trunk_kernel
    from deepbinner_tpu_torch.runner.executor import (
        MIN_SHM_SLOTS,
        ExecutorStats,
        batch_spec_for,
        classify_batches,
    )
    from deepbinner_tpu_torch.runner.hostbatch import (
        BatchScratch,
        build_batch_arrays,
    )
    from deepbinner_tpu_torch.runner.mp_reader import _ShmRing

    if program is None:
        program = _build_program()
    program.warm_up(BATCH)
    spec = batch_spec_for(program.cfg.preprocess, BATCH, False)
    ring = _ShmRing(mp.get_context("spawn"), spec, MIN_SHM_SLOTS, pin=True)
    releases = []

    def release(slot: int) -> None:
        # Garbage in the slot at once: a release before the upload is done
        # would show as a call that differs.
        np.frombuffer(ring.slots[slot].buf, np.uint8)[:] = 0x55
        releases.append(slot)
        ring.free.put(slot)

    def batches():
        scratch = BatchScratch(spec)
        for start in range(0, len(reads), BATCH):
            slot = ring.free.get(timeout=60)
            views = ring.views(ring.slots[slot])
            ids, *_arrays = build_batch_arrays(reads[start:start + BATCH], spec,
                                               out=views, scratch=scratch)
            yield (ids, *views, functools.partial(release, slot))

    try:
        probe = ring.views(ring.slots[0])[0]
        if not torch.from_numpy(probe).is_pinned():
            raise AssertionError(f"{phase}: a registered slot is not pinned")
        del probe
        stats = ExecutorStats()
        conv_kernel.LAUNCHES = 0
        trunk_kernel.LAUNCHES = 0
        start = time.perf_counter()
        calls = {r.read_id: r.call for r in classify_batches(
            program, batches(), stats=stats)}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {"conv1d_bn_relu": conv_kernel.LAUNCHES,
                    "trunk_megakernel": trunk_kernel.LAUNCHES}
        _check_launches(launches, stats.batches,
                        {"conv1d_bn_relu": 15 * len(program.devices),
                         "trunk_megakernel": 0}, phase)
        if len(releases) != stats.batches:
            raise AssertionError(f"{phase}: {len(releases)} releases for "
                                 f"{stats.batches} batches")
        if len(calls) != len(reads):
            raise AssertionError(f"{phase}: {len(reads)} reads in, "
                                 f"{len(calls)} calls out")
        _same_calls(phase, calls, unit["calls"])
        # One batch classified straight from a registered slot: the upload
        # from pinned memory is inside the timing.
        slot = ring.free.get(timeout=60)
        views = ring.views(ring.slots[slot])
        build_batch_arrays(reads[:BATCH], spec, out=views)
        batch_ms = time_ms(lambda: program.call_packed(views[0], views[1]), 5)
        del views
        ring.free.put(slot)
    finally:
        ring.close()
    emit(phase, devices=[str(d) for d in program.devices],
         reads=len(reads), batches=stats.batches,
         slots=MIN_SHM_SLOTS, releases=len(releases), seconds=seconds,
         reads_per_s=len(reads) / seconds, launches=launches,
         launches_per_batch={k: v / stats.batches for k, v in launches.items()},
         same_calls_as_classify=len(calls), device_batch_ms=batch_ms,
         classify_reads_per_s=unit["reads_per_s"],
         classify_device_batch_ms=unit["device_batch_ms"])


def phase_native(probe: dict) -> None:
    """Build the native readers where the probe says they can be built, and
    hold each against its Python path."""
    import numpy as np

    from deepbinner_tpu_torch.native import build, fast5_reader, vbz, zstd
    from deepbinner_tpu_torch.utils import pod5

    reason = build.missing("fast5_reader")
    if reason is None:
        start = time.perf_counter()
        fast5_reader.available()  # builds; a failed build raises
        fast5 = {"ran": True, "build_s": time.perf_counter() - start}
        if probe["imports"]["h5py"]:
            from deepbinner_tpu_torch.utils import fast5 as fast5_io
            from deepbinner_tpu_torch.utils import simulate

            data_dir = os.path.join(WORK_DIR, "native_dataset")
            simulate.make_dataset(data_dir, kit="EXP-NBD103",
                                  reads_per_barcode=1, none_reads=2,
                                  genome_length=600, seed=3, write_fastq=False,
                                  container="multifast5")
            files = fast5_io.find_all_fast5s(data_dir)
            want = {r: s for f in files for r, s in fast5_io.read_signal_file(f)}
            got = {r: s for f in files for r, s in fast5_reader.read_file(f)}
            if sorted(got) != sorted(want) or any(
                    not np.array_equal(got[r], want[r]) for r in want):
                raise AssertionError("native: the fast5 reader's reads differ "
                                     "from h5py's")
            fast5["reads_equal_to_h5py"] = len(got)
    else:
        fast5 = {"ran": False, "reason": reason}

    rng = np.random.default_rng(12)
    cases = [rng.integers(300, 700, 102_400).astype(np.int16),
             rng.integers(-32768, 32767, 4097).astype(np.int16),
             np.asarray([-1, 1, -32768, 32767, 0], np.int16)]
    reason = build.missing("vbz_decode")
    if reason is None:
        start = time.perf_counter()
        vbz.available()  # builds; a failed build raises
        build_s = time.perf_counter() - start
        for signal in cases:
            delta = np.diff(signal.astype(np.int32), prepend=0).astype(np.int16)
            raw = pod5.svb16_encode(pod5._zigzag_encode(delta))
            want = np.cumsum(pod5._zigzag_decode(
                pod5.svb16_decode(raw, signal.size)).astype(np.int64)
            ).astype(np.int16)
            got = vbz.unpack(raw, signal.size)
            if not (np.array_equal(got, want) and np.array_equal(got, signal)):
                raise AssertionError("native: the vbz unpacker differs from "
                                     "the numpy path")
        vbz_line = {"ran": True, "build_s": build_s, "cases": len(cases)}
    else:
        vbz_line = {"ran": False, "reason": reason}
    # The zstd stage through the system library (native/zstd.py): a full
    # vbz round trip of the same signals.  A missing libzstd raises.
    for signal in cases:
        payload = pod5.vbz_compress(signal)
        if not np.array_equal(pod5.vbz_decompress(payload, signal.size),
                              signal):
            raise AssertionError("native: a vbz round trip through libzstd "
                                 "changed the signal")
    zstd_line = {"ran": True, "version": zstd.version(), "cases": len(cases)}
    emit("native", fast5_reader=fast5, vbz_decode=vbz_line, zstd=zstd_line)


def _run_cli(argv) -> tuple:
    """One call of the port's CLI: (stdout, stderr, seconds).  Its stderr
    is echoed once the call returns or raises."""
    from deepbinner_tpu_torch.cli.main import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli_main(argv)
    finally:
        sys.stderr.write(err.getvalue())
    return out.getvalue(), err.getvalue(), time.perf_counter() - start


def _cli_throughput(stderr: str) -> float:
    """The reads/s that `classify` logs (its classify loop, model load
    and program build excluded)."""
    match = re.search(r"throughput: ([0-9.]+) reads/s", stderr)
    if match is None:
        raise AssertionError("classify logged no throughput line")
    return float(match.group(1))


def _check_pod5_readers(probe: dict, phase: str) -> None:
    if not probe["imports"]["pyarrow"]:
        raise RuntimeError(f"{phase}: pod5 needs pyarrow, which does not "
                           f"import here")
    if not probe["zstd_version"][:1].isdigit():
        raise RuntimeError(f"{phase}: pod5 needs the system zstd library: "
                           f"{probe['zstd_version']}")


def phase_cli(probe: dict) -> dict:
    """simulate → classify (threads, then the worker pool) → bin through
    the port's CLI, on pod5 files written here (kept for
    ``dist_classify``, which removes them)."""
    import collections
    import shutil

    from deepbinner_tpu_torch.utils import seqio, table

    _check_pod5_readers(probe, "cli")
    root = os.path.join(WORK_DIR, "cli")
    shutil.rmtree(root, ignore_errors=True)
    _out, _err, simulate_s = _run_cli([
        "simulate", root, "--container", "pod5", "--reads_per_barcode", "170",
        "--none_reads", "8", "--genome_length", "1200", "--seed", "5"])
    pod5_dir = os.path.join(root, "fast5s")
    containers = sorted(os.listdir(pod5_dir))
    truth = table.parse_classification_file(os.path.join(root, "truth.tsv"))
    if len(truth) != 2048 or len(containers) != 8:
        raise AssertionError(f"cli: simulate wrote {len(truth)} reads in "
                             f"{len(containers)} containers")
    tables, seconds, rates = {}, {}, {}
    for name, extra in (("threads", ["--reader_processes", "0"]),
                        ("pool", [])):
        tables[name], err, seconds[name] = _run_cli([
            "classify", pod5_dir, "-s", START_MODEL, "-e", END_MODEL,
            "--batch_size", str(BATCH), *extra])
        rates[name] = _cli_throughput(err)
    if tables["pool"] != tables["threads"]:
        raise AssertionError("cli: the worker pool's table differs from the "
                             "reader threads'")
    tsv = os.path.join(root, "calls.tsv")
    with open(tsv, "w") as handle:
        handle.write(tables["pool"])
    calls = table.parse_classification_file(tsv)
    rows = len(tables["pool"].splitlines()) - 1
    if rows != len(truth) or sorted(calls) != sorted(truth):
        raise AssertionError(f"cli: {rows} rows for {len(truth)} reads")
    exact = sum(1 for read_id, call in truth.items() if calls[read_id] == call)
    if exact < 0.9 * len(truth):
        raise AssertionError(f"cli: only {exact}/{len(truth)} exact")

    bins = []
    for run in range(2):
        out_dir = os.path.join(root, f"bins{run}")
        _run_cli(["bin", "--classes", tsv, "--reads",
                  os.path.join(root, "reads.fastq"), "--out_dir", out_dir])
        bins.append({name: open(os.path.join(out_dir, name), "rb").read()
                     for name in sorted(os.listdir(out_dir))})
    if bins[0] != bins[1]:
        raise AssertionError("cli: two bin runs wrote different bytes")
    binned = collections.Counter()
    for name in bins[0]:
        call = name.split(".")[0]
        for record in seqio.iterate_fastq(os.path.join(root, "bins0", name)):
            if calls[record[0]] != call:
                raise AssertionError(f"cli: {record[0]} is in {name}, its "
                                     f"row says {calls[record[0]]}")
            binned[call] += 1
    if binned != collections.Counter(calls.values()):
        raise AssertionError(f"cli: bin counts {dict(binned)} differ from the "
                             f"table's")
    emit("cli", ran=True, container="pod5", containers=len(containers),
         reads=len(truth), rows=rows, exact=exact, simulate_s=simulate_s,
         reads_per_s_threads=rates["threads"], reads_per_s_pool=rates["pool"],
         seconds_threads=seconds["threads"], seconds_pool=seconds["pool"],
         cpus=os.cpu_count(), tables_identical=True,
         bin_files=len(bins[0]), bin_counts=dict(sorted(binned.items())),
         bin_identical=True)
    return {"root": root, "pod5_dir": pod5_dir, "table": tables["pool"],
            "seconds_pool": seconds["pool"], "reads_per_s_pool": rates["pool"]}


def phase_realtime(probe: dict) -> None:
    """`realtime` on 256 single-read pod5 files that arrive in drops."""
    import collections
    import shutil
    import statistics

    from deepbinner_tpu_torch.cli import realtime as realtime_module
    from deepbinner_tpu_torch.cli.main import get_arguments
    from deepbinner_tpu_torch.ops import conv_kernel, trunk_kernel
    from deepbinner_tpu_torch.utils.pod5 import read_pod5

    _check_pod5_readers(probe, "realtime")
    root = os.path.join(WORK_DIR, "realtime")
    shutil.rmtree(root, ignore_errors=True)
    _run_cli(["simulate", os.path.join(root, "staging"), "--container", "pod5",
              "--reads_per_container", "1", "--reads_per_barcode", "21",
              "--none_reads", "4", "--genome_length", "1200", "--seed", "6"])
    staging = os.path.join(root, "staging", "fast5s")
    names = sorted(os.listdir(staging))
    tsv, _err, _s = _run_cli(["classify", staging, "-s", START_MODEL])
    expected = {read_id: call for read_id, call in (
        line.split("\t")[:2] for line in tsv.splitlines()[1:] if line)}
    want = {name: expected[read_pod5(os.path.join(staging, name))[0][0]]
            for name in names}
    if len(names) != 256:
        raise AssertionError(f"realtime: {len(names)} files staged")

    in_dir, out_dir = os.path.join(root, "in"), os.path.join(root, "out")
    stop = os.path.join(root, "stop")
    os.makedirs(in_dir)
    arrived, moved, errors = {}, {}, []

    def producer() -> None:
        for k in range(0, len(names), 64):
            for name in names[k:k + 64]:
                os.replace(os.path.join(staging, name),
                           os.path.join(in_dir, name))
                arrived[name] = time.monotonic()
            time.sleep(0.5)

    def monitor() -> None:
        deadline = time.monotonic() + 300
        while len(moved) < len(names):
            if time.monotonic() > deadline:
                errors.append(f"realtime: {len(moved)} of {len(names)} files "
                              f"sorted after 300 s")
                break
            for _dir, _sub, files in os.walk(out_dir):
                for name in files:
                    moved.setdefault(name, time.monotonic())
            time.sleep(0.02)
        with open(stop, "w"):
            pass

    pools = []
    make_pool = realtime_module._make_reader_pool

    def recording_pool(program, args):
        pool = make_pool(program, args)
        pools.append(0 if pool is None else pool.num_workers)
        return pool

    args = get_arguments(["realtime", "--in_dir", in_dir, "--out_dir", out_dir,
                          "-s", START_MODEL, "--poll_interval", "0.2",
                          "--stop_file", stop, "--device_count", "1"])
    threads = [threading.Thread(target=producer, daemon=True),
               threading.Thread(target=monitor, daemon=True)]
    realtime_module._make_reader_pool = recording_pool
    conv_kernel.LAUNCHES = 0
    trunk_kernel.LAUNCHES = 0
    try:
        for thread in threads:
            thread.start()
        stats = realtime_module.realtime(args)
    finally:
        realtime_module._make_reader_pool = make_pool
        for thread in threads:
            thread.join(timeout=330)
    launches = {"conv1d_bn_relu": conv_kernel.LAUNCHES,
                "trunk_megakernel": trunk_kernel.LAUNCHES}
    if errors:
        raise AssertionError(errors[0])
    if os.listdir(in_dir):
        raise AssertionError(f"realtime: {len(os.listdir(in_dir))} files "
                             f"left in the watched directory")
    misplaced = [name for name in names if not os.path.exists(
        os.path.join(out_dir, want[name], name))]
    if misplaced:
        raise AssertionError(f"realtime: {len(misplaced)} files not in the bin "
                             f"classify gave them (e.g. {misplaced[:3]})")
    if pools != [2]:
        raise AssertionError(f"realtime: reader pools made {pools}; expected "
                             f"one of 2 workers")
    # One warm-up batch at startup, then the watch's own batches.
    _check_launches(launches, stats.batches + 1,
                    {"conv1d_bn_relu": 15, "trunk_megakernel": 0}, "realtime")
    latency = [moved[name] - arrived[name] for name in names]
    emit("realtime", files=len(names), reads=stats.reads,
         batches=stats.batches, warm_up_batches=1, launches=launches,
         launches_per_batch={k: v / (stats.batches + 1)
                             for k, v in launches.items()},
         workers=pools[0], poll_s=0.2, drop_files=64, drop_every_s=0.5,
         arrival_to_move_s={"median": statistics.median(latency),
                            "max": max(latency)},
         bins=dict(sorted(collections.Counter(want.values()).items())))
    shutil.rmtree(root, ignore_errors=True)


TRAIN_READS_PER_BARCODE = 150
TRAIN_EPOCHS = 30
TRAIN_BATCH = 256
TRAIN_SIGNAL_SIZE = 1536   # 1.5 × the flagship input, as scripts/train_models.py
TRAIN_MARGIN = 128         # input // 8, as scripts/train_models.py
TRAIN_NONE_FRACTION = 0.2  # keeps the recipe's none rows (3 per none read)
STEP_BATCH = 32            # the card-vs-CPU step


def _training_rows(reads_per_barcode: int, seed: int) -> list:
    """Training rows by the recipe of scripts/train_models.py: simulated
    EXP-NBD103 reads (genome 2000; as many none reads as reads per barcode,
    each giving three none cuts), each keeping the rows of its own class."""
    import numpy as np

    from deepbinner_tpu_torch.train.prep import extract_training_samples
    from deepbinner_tpu_torch.utils import simulate

    rng = np.random.default_rng(seed)
    rows = []
    for barcode in [0] * reads_per_barcode + [
            b for b in range(1, 13) for _ in range(reads_per_barcode)]:
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=2000)
        samples = extract_training_samples(
            read.signal, read.sequence, (read.signal_start_of_bases, read.dwells),
            "EXP-NBD103", "start", signal_size=TRAIN_SIGNAL_SIZE,
            margin=TRAIN_MARGIN, none_rows=3 if barcode == 0 else 1)
        rows += [(label, signal) for label, signal in samples
                 if (label == 0) == (barcode == 0)]
    return rows


def _trainer_state(trainer) -> dict:
    """Copies of a trainer's step, weights and Adam state."""
    params = list(trainer.model.parameters())
    return {"step": trainer.step,
            "params": [p.detach().clone() for p in params],
            "moments": [{key: value.clone() for key, value in
                         trainer.optimizer.state[p].items()} for p in params]}


def _state_digest(trainer) -> str:
    """SHA-256 of a trainer's weights, statistics and Adam state, bytes in
    order: two trainers with the same digest hold the same bits."""
    import hashlib

    hasher = hashlib.sha256()
    state = _trainer_state(trainer)
    tensors = list(state["params"]) + [t for _n, t in
                                       trainer.model.named_buffers()]
    tensors += [v for moments in state["moments"]
                for _k, v in sorted(moments.items())]
    for tensor in tensors:
        hasher.update(tensor.detach().cpu().contiguous().numpy().tobytes())
    return hasher.hexdigest()


def _same_state(got: dict, want: dict) -> bool:
    import torch

    return (got["step"] == want["step"]
            and all(torch.equal(a, b) for a, b in zip(got["params"],
                                                      want["params"]))
            and all(a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                                 for k in a)
                    for a, b in zip(got["moments"], want["moments"])))


@contextlib.contextmanager
def _watch_trainer():
    """Record what the port's Trainer does inside a CLI call: each train
    step between two CUDA events with its loss, each evaluation, the last
    trainer, and its state right after a restore."""
    import torch

    from deepbinner_tpu_torch.train.trainer import Trainer

    record = {"steps": [], "evals": [], "digests": []}
    run_step, run_eval, restore = (Trainer.run_train_step, Trainer.run_eval,
                                   Trainer.restore_checkpoint)

    def watched_step(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = run_step(self, *args, **kwargs)
        end.record()
        record["steps"].append((start, end, metrics["loss"]))
        record["trainer"] = self
        return metrics

    def watched_eval(self, *args, **kwargs):
        result = run_eval(self, *args, **kwargs)
        record["evals"].append(result)
        record["digests"].append(_state_digest(self))
        return result

    def watched_restore(self, directory):
        epoch = restore(self, directory)
        record["restored"] = _trainer_state(self)
        return epoch

    Trainer.run_train_step = watched_step
    Trainer.run_eval = watched_eval
    Trainer.restore_checkpoint = watched_restore
    try:
        yield record
    finally:
        Trainer.run_train_step = run_step
        Trainer.run_eval = run_eval
        Trainer.restore_checkpoint = restore


def _epochs(record: dict) -> list:
    """Each epoch's train loss (the mean of its steps' losses, as the loop
    logs it) and validation accuracy, from a watched run."""
    import statistics

    per_epoch = len(record["steps"]) // len(record["evals"])
    losses = [float(loss) for _s, _e, loss in record["steps"]]
    return [{"train_loss": statistics.fmean(losses[k * per_epoch:
                                                    (k + 1) * per_epoch]),
             "val_accuracy": val["accuracy"], "val_loss": val["loss"]}
            for k, val in enumerate(record["evals"])]


def _train_argv(data: str, out: str, epochs: int, *extra) -> list:
    """`train` at the flagship width on one card (a rank of a process group
    ignores ``--dp``)."""
    return ["train", data, "--out", out, "--size", "full", "--epochs",
            str(epochs), "--batch_size", str(TRAIN_BATCH), "--learning_rate",
            "1e-3", "--dp", "1", *extra]


def _flagship_quiet():
    from deepbinner_tpu_torch.models.network import NetworkConfig

    return NetworkConfig(noise_stddev=0.0, dropout_rate=0.0)


def _step_on(device, state: dict, rows, offsets) -> tuple:
    """One flagship-width Trainer step (f32) from ``state``: (loss, clipped
    gradients, new running statistics), on the CPU."""
    from deepbinner_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(network=_flagship_quiet(),
                                  batch_size=STEP_BATCH), device)
    trainer.model.load_state_dict(state)
    loss = float(trainer.run_train_step(*rows, offsets=offsets)["loss"])
    return (loss, {n: p.grad.cpu() for n, p in trainer.model.named_parameters()},
            {n: b.cpu() for n, b in trainer.model.named_buffers()})


def _forward_backward_on(device, state: dict, crops, labels, weights,
                         dtype=None) -> tuple:
    """The step's forward, backward and clip on given crops (no optimiser):
    (loss, gradients, new running statistics), on the CPU."""
    import torch

    from deepbinner_tpu_torch.models.network import DemuxNet
    from deepbinner_tpu_torch.train.trainer import (
        clip_by_global_norm_,
        forward_backward,
    )

    dtype = dtype or torch.float32
    model = DemuxNet(_flagship_quiet())
    model.load_state_dict(state)
    model = model.to(device, dtype)
    loss, _accuracy = forward_backward(
        model, crops.to(device, dtype), labels.to(device),
        weights.to(device, dtype))
    clip_by_global_norm_([p.grad for p in model.parameters()])
    return (float(loss),
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers()})


def _step_error(got: tuple, want: tuple) -> dict:
    """How far one step is from another: the loss's relative error, each
    gradient's max error over its largest |g| (the worst tensor, and how
    many tensors exceed 1e-4), and the running statistics' max error."""
    loss, grads, stats = got
    by_tensor = {n: float((grads[n].double() - g.double()).abs().max()
                          / g.double().abs().max()) for n, g in want[1].items()}
    worst = max(by_tensor, key=by_tensor.get)
    return {"loss_rel": abs(loss - want[0]) / abs(want[0]),
            "grad_rel": by_tensor[worst], "grad_worst": worst,
            "grads_over_1e-4": sum(v > 1e-4 for v in by_tensor.values()),
            "stats_abs": max(float((stats[n].double() - b.double()).abs().max())
                             for n, b in want[2].items())}


def _within(error: dict, grads: bool = True) -> bool:
    """The bounds: loss 1e-5 relative, statistics 1e-5, and (where asked)
    every gradient within 1e-4 of its tensor's largest |g|."""
    return (error["loss_rel"] <= 1e-5 and error["stats_abs"] <= 1e-5
            and (not grads or error["grad_rel"] <= 1e-4))


def _card_vs_cpu_step(device) -> dict:
    """One flagship-width step at batch 32 on the card against the CPU.

    - ``float64``: the step's forward, backward and clip in float64 on the
      same crops on both: every bound, gradients included.  This is the
      check that the card computes the CPU's function.
    - ``float32`` (the trainer's own step, offsets injected, at "highest"
      and with TF32 asked for: "high", cuDNN TF32 on): the loss and the
      statistics within their bounds.  Its gradients are reported, not
      bounded: at batch 32 the f32 gradients of both devices are already
      farther than 1e-4 of their largest |g| from the float64 ones
      (``f32_vs_f64``), because a ReLU or max-pool decision that sits
      within rounding of a tie goes another way and BatchNorm's backward
      sums cancel.
    - ``pin``: the card's f32 step with TF32 asked for against the one at
      "highest": every bound, gradients included; ``unpinned`` is the same
      step outside the trainer's pin, reported only.
    """
    import numpy as np
    import torch

    from deepbinner_tpu_torch.models.network import DemuxNet, init_weights
    from deepbinner_tpu_torch.runner.pipeline import full_f32
    from deepbinner_tpu_torch.train.trainer import augment_crop

    model = init_weights(DemuxNet(_flagship_quiet()),
                         torch.Generator().manual_seed(0))
    state = model.state_dict()
    rng = np.random.default_rng(3)
    weights = np.ones(STEP_BATCH, np.float32)
    weights[STEP_BATCH - STEP_BATCH // 8:] = 0.0  # padding rows: in BN only
    rows = (np.round(rng.normal(450, 60, (STEP_BATCH, TRAIN_SIGNAL_SIZE))
                     ).astype(np.float32),
            rng.integers(0, 13, STEP_BATCH).astype(np.int32), weights)
    offsets = rng.integers(0, TRAIN_SIGNAL_SIZE - 1024 + 1, STEP_BATCH)
    cpu = torch.device("cpu")
    crops = augment_crop(torch.from_numpy(rows[0]), 1024, offsets=offsets)
    same = (crops, torch.from_numpy(rows[1]).long(), torch.from_numpy(weights))
    exact = {name: _forward_backward_on(dev, state, *same, dtype=torch.float64)
             for name, dev in (("cpu", cpu), ("card", device))}
    f32 = {"cpu": _step_on(cpu, state, rows, offsets)}
    try:
        for precision, cudnn_tf32 in (("highest", False), ("high", True)):
            torch.set_float32_matmul_precision(precision)
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            f32[precision] = _step_on(device, state, rows, offsets)
        # The same step outside the trainer's pin, TF32 still asked for.
        loose = _forward_backward_on(device, state, *same)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
    with full_f32():
        tight = _forward_backward_on(device, state, *same)
    result = {
        "batch": STEP_BATCH,
        "float64": _step_error(exact["card"], exact["cpu"]),
        "float32": {p: _step_error(f32[p], f32["cpu"])
                    for p in ("highest", "high")},
        "f32_vs_f64": {"cpu": _step_error(f32["cpu"], exact["cpu"]),
                       "card": _step_error(f32["highest"], exact["cpu"])},
        "pin": _step_error(f32["high"], f32["highest"]),
        "unpinned": _step_error(loose, tight),
    }
    if not (_within(result["float64"]) and _within(result["pin"])
            and all(_within(e, grads=False) for e in result["float32"].values())):
        raise AssertionError(f"train: the step on the card is off the "
                             f"CPU's: {result}")
    return result


def _timed_steps(device, batches, pinned: bool) -> tuple:
    """24 flagship steps from seed 0 on ``batches`` (4 of 256 rows), as the
    trainer runs them (``pinned``: TF32 off, cuDNN deterministic) or with
    cuDNN's default algorithms (TF32 off only): (median ms from CUDA events
    after 4 warm-up steps, the losses, the final weights)."""
    import statistics

    import numpy as np
    import torch

    from deepbinner_tpu_torch.models.network import NetworkConfig
    from deepbinner_tpu_torch.runner.pipeline import full_f32
    from deepbinner_tpu_torch.train.trainer import (
        TrainConfig,
        Trainer,
        step_generator,
        train_step,
    )

    trainer = Trainer(TrainConfig(network=NetworkConfig()), device)
    ones = torch.ones(TRAIN_BATCH, device=device)
    events, losses = [], []
    for k in range(24):
        signals, labels = batches[k % len(batches)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if pinned:
            metrics = trainer.run_train_step(signals, labels)
        else:
            with full_f32():
                metrics = train_step(
                    trainer.model, trainer.optimizer, 1024,
                    torch.from_numpy(signals).to(device),
                    torch.from_numpy(labels).to(device).long(), ones,
                    step_generator(1, k, device))
        end.record()
        events.append((start, end))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in events[4:]),
            np.asarray([float(x) for x in losses]),
            [p.detach().clone() for p in trainer.model.parameters()])


def _step_variants(device, rows) -> dict:
    """The trainer's step against the same step on cuDNN's default
    algorithms, in turns (pinned, default, default, pinned): time and
    whether two runs repeat bit for bit; then where the pinned step's
    device time goes (``torch.profiler``, 4 steps)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepbinner_tpu_torch.models.network import NetworkConfig
    from deepbinner_tpu_torch.train.trainer import TrainConfig, Trainer

    batches = [(np.stack([r[1] for r in rows[k:k + TRAIN_BATCH]]).astype(np.float32),
                np.asarray([r[0] for r in rows[k:k + TRAIN_BATCH]], np.int32))
               for k in range(0, 4 * TRAIN_BATCH, TRAIN_BATCH)]
    runs = {True: [], False: []}
    for pinned in (True, False, False, True):
        runs[pinned].append(_timed_steps(device, batches, pinned))

    def repeats(pair) -> bool:
        (_ms0, loss0, params0), (_ms1, loss1, params1) = pair
        return bool(np.array_equal(loss0, loss1)) and all(
            torch.equal(a, b) for a, b in zip(params0, params1))

    if not repeats(runs[True]):
        raise AssertionError("train: two runs of the trainer's steps differ")
    trainer = Trainer(TrainConfig(network=NetworkConfig()), device)
    for k in range(2):
        trainer.run_train_step(*batches[k])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(4):
            trainer.run_train_step(*batches[k])
        torch.cuda.synchronize()
    # Kernels only: an op's self device time counts its kernels again.
    kernels = [(e.self_device_time_total, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(t for t, _k in kernels)
    if total <= 0:
        raise AssertionError("train: torch.profiler saw no device time")
    top = sorted(kernels, reverse=True)[:4]
    return {"pinned_step_ms": [r[0] for r in runs[True]],
            "pinned_repeats": True,
            "default_cudnn_step_ms": [r[0] for r in runs[False]],
            "default_cudnn_repeats": repeats(runs[False]),
            "profile_kernel_ms_per_step": total / 4e3,
            "profile_top": [{"kernel": k[:80], "share": t / total}
                            for t, k in top]}


def phase_train(device) -> dict:
    """prep rows → balance → train through the port's CLI at the flagship
    width, resume, card against CPU, and the trained model on K1 (the rows
    are kept for ``dp_train``, which removes them)."""
    import shutil
    import statistics

    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.train.data import write_samples

    root = os.path.join(WORK_DIR, "train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    start = time.perf_counter()
    rows = _training_rows(TRAIN_READS_PER_BARCODE, seed=11)
    rows_s = time.perf_counter() - start
    prepped, balanced = (os.path.join(root, "prep.tsv"),
                         os.path.join(root, "balanced.tsv"))
    write_samples(prepped, rows)
    _run_cli(["balance", prepped, "--out", balanced, "--none_fraction",
              str(TRAIN_NONE_FRACTION), "--seed", "0"])
    with open(balanced) as handle:
        samples = sum(1 for _line in handle)

    model_path = os.path.join(root, "trained.dbt")
    with _watch_trainer() as record:
        _o, _e, train_s = _run_cli(_train_argv(
            balanced, model_path, TRAIN_EPOCHS, "--checkpoint_dir",
            os.path.join(root, "ckpt")))
    epochs = _epochs(record)
    per_epoch = len(record["steps"]) // len(epochs)
    step_ms = [s.elapsed_time(e) for s, e, _l in record["steps"][per_epoch:]]
    # Rows trained on (padding rows not counted): the loop's split and
    # augmentation factor (2, the CLI default).
    trained = (samples - max(1, int(samples * 0.1))) * 2 * len(epochs)

    # Resume: stopped after epoch 2, resumed for epoch 3.
    resume_dir = os.path.join(root, "resume")
    with _watch_trainer() as stopped:
        _run_cli(_train_argv(balanced, os.path.join(root, "two.dbt"), 2,
                             "--checkpoint_dir", resume_dir))
    with _watch_trainer() as resumed:
        _run_cli(_train_argv(balanced, os.path.join(root, "three.dbt"), 3,
                             "--resume", resume_dir))
    if not _same_state(resumed["restored"], _trainer_state(stopped["trainer"])):
        raise AssertionError("train: resume did not restore the step, weights "
                             "and Adam moments bit for bit")
    # The trainer's steps are deterministic (train/trainer.pinned), so the
    # resumed epoch must repeat the uninterrupted run's bit for bit.
    resumed_loss = _epochs(resumed)[0]["train_loss"]
    resume_rel = abs(resumed_loss - epochs[2]["train_loss"]) / epochs[2]["train_loss"]
    if len(resumed["evals"]) != 1 or resumed_loss != epochs[2]["train_loss"]:
        raise AssertionError(f"train: resumed epoch 3 loss {resumed_loss}, "
                             f"uninterrupted {epochs[2]['train_loss']}")

    step_errors = _card_vs_cpu_step(device)
    variants = _step_variants(device, rows)

    # The trained model on K1, through the classify program's unit path.
    _model, config, meta = load_model(model_path)
    program = _build_program(start_model=model_path)
    program.warm_up(BATCH)
    floor_reads, floor_truth = _floor_reads()
    calls, stats, _seconds, launches = _run_stream(program, floor_reads)
    _check_launches(launches, stats.batches,
                    {"conv1d_bn_relu": 15, "trunk_megakernel": 0}, "train")
    exact, wrong = _score(calls, floor_truth)
    if wrong or exact < 38:
        raise AssertionError(f"train: the trained model's accuracy floor: "
                             f"{exact}/40 exact, {wrong} wrong barcodes")
    line = dict(
        phase_s=time.perf_counter() - start, rows=len(rows), rows_s=rows_s,
        samples=samples,
        reads_per_barcode=TRAIN_READS_PER_BARCODE, epochs=len(epochs),
        steps=len(record["steps"]), steps_per_epoch=per_epoch,
        batch=TRAIN_BATCH, train_s=train_s,
        step_ms_median=statistics.median(step_ms),
        samples_per_s=trained / train_s,
        step_samples_per_s=TRAIN_BATCH / statistics.median(step_ms) * 1e3,
        epoch_train_loss=[e["train_loss"] for e in epochs],
        epoch_val_accuracy=[e["val_accuracy"] for e in epochs],
        best_val=meta["best_val"], input_length=config.input_length,
        resume={"state_bit_identical": True, "loss_bit_identical": True,
                "epoch3_loss": resumed_loss,
                "uninterrupted_epoch3_loss": epochs[2]["train_loss"],
                "rel": resume_rel},
        card_vs_cpu=step_errors, step_variants=variants,
        floor_exact=exact, floor_wrong=wrong,
        floor_launches=launches, floor_batches=stats.batches)
    emit("train", **line)
    return {**line, "root": root, "balanced": balanced,
            "step_ms": statistics.median(step_ms),
            "epoch_losses": [e["train_loss"] for e in epochs]}


DP_TRAIN_EPOCHS = 6     # 3 reach val acc 0.77-0.80 there, under the floor
DP_F64_STEPS = 5
RANK_TIMEOUT_S = 300


def _f64_steps(rows: str, out: str) -> None:
    """The first DP_F64_STEPS flagship Trainer steps (batch TRAIN_BATCH,
    noise and dropout on) in float64, as one process or as this rank of
    the process group; their losses, as JSON, to ``out``.  In float64 the
    order of the ranks' sums moves a loss by about 1e-12, so this holds the
    data-parallel algebra (global draws, SyncBN, global loss and
    gradients) to one process's without the f32 rounding that Adam's first
    steps amplify."""
    import numpy as np
    import torch

    from deepbinner_tpu_torch.models.network import NetworkConfig
    from deepbinner_tpu_torch.parallel import dist, mesh
    from deepbinner_tpu_torch.train import trainer as trainer_module
    from deepbinner_tpu_torch.train.data import load_training_set
    from deepbinner_tpu_torch.train.trainer import TrainConfig, Trainer

    def normalise64(x):  # ops.preprocess.normalise without its cast to f32
        x = x.double()
        std = x.std(dim=-1, keepdim=True, correction=0)
        return (x - x.mean(dim=-1, keepdim=True)) / (std + 1e-8)

    dist.maybe_initialize("cuda")
    normalise = trainer_module.normalise
    ok = False
    try:
        rank, world = dist.group_rank_and_size()
        device = torch.device("cuda", mesh.process_cards()[0])
        trainer = Trainer(TrainConfig(network=NetworkConfig(),
                                      batch_size=TRAIN_BATCH), device,
                          rank=rank, world=world)
        trainer.model.double()  # the optimiser keeps the same parameters
        trainer._put = lambda array, dtype: torch.as_tensor(array).to(
            device, torch.float64 if dtype == torch.float32 else dtype)
        trainer_module.normalise = normalise64
        signals, labels = load_training_set(rows)
        order = np.random.default_rng(0).permutation(len(labels))
        losses = []
        for step in range(DP_F64_STEPS):
            batch = order[step * TRAIN_BATCH:(step + 1) * TRAIN_BATCH]
            metrics = trainer.run_train_step(signals[batch].astype(np.float64),
                                             labels[batch])
            losses.append(float(metrics["loss"]))
        with open(out, "w") as handle:
            json.dump({"losses": losses, "dtype": str(
                next(trainer.model.parameters()).dtype)}, handle)
        ok = True
    finally:
        trainer_module.normalise = normalise
        dist.shutdown(ok)


def rank_main() -> None:
    """One rank of the ``dist_classify`` / ``dp_train`` phases, started by
    :func:`_run_ranks` in a child process: the port's CLI on ``argv``, then
    the rank's kernel launches and train steps, as JSON, to ``out`` (or,
    for ``f64_steps ROWS``, :func:`_f64_steps`).

        python -c "import chip_smoke; chip_smoke.rank_main()" OUT ARGV...
    """
    import torch

    from deepbinner_tpu_torch.cli.main import main as cli_main
    from deepbinner_tpu_torch.ops import conv_kernel, trunk_kernel

    out, *argv = sys.argv[1:]
    if argv[0] == "f64_steps":
        _f64_steps(argv[1], out)
        return
    conv_kernel.LAUNCHES = 0
    trunk_kernel.LAUNCHES = 0
    with _watch_trainer() as record:
        cli_main(argv)
    torch.cuda.synchronize()
    with open(out, "w") as handle:
        json.dump({"launches": {"conv1d_bn_relu": conv_kernel.LAUNCHES,
                                "trunk_megakernel": trunk_kernel.LAUNCHES},
                   "step_ms": [s.elapsed_time(e)
                               for s, e, _l in record["steps"]],
                   "losses": [float(l) for _s, _e, l in record["steps"]],
                   "evals": record["evals"], "digests": record["digests"]},
                  handle)


def _run_ranks(name: str, argv: list, world: int = 2) -> list:
    """``world`` ranks of the port's CLI on this host, as ``torchrun
    --nproc_per_node world`` would start them, all on the one card (so the
    process group is gloo).  Each rank runs in a session of its own, which
    is killed whole (reader workers included) if the rank fails or
    outlives ``RANK_TIMEOUT_S``.  Returns each rank's (stdout, stderr,
    seconds, rank_main's JSON)."""
    import signal

    from deepbinner_tpu_torch.parallel import dist

    port = dist.free_port()
    procs, outs = [], []
    start = time.perf_counter()
    for rank in range(world):
        out = os.path.join(WORK_DIR, f"{name}_rank{rank}.json")
        env = dict(os.environ, PYTHONPATH=ROOT, **dist.rank_environ(rank, world,
                                                                    port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.rank_main()",
             out, *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True))
        outs.append(out)
    results, failure = [], None
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=RANK_TIMEOUT_S)
            results.append([stdout, stderr, time.perf_counter() - start])
            if proc.returncode != 0 and failure is None:
                failure = (f"{name}: rank {rank} exited {proc.returncode}:\n"
                           f"{stderr[-4000:]}")
    except subprocess.TimeoutExpired:
        failure = f"{name}: a rank ran past {RANK_TIMEOUT_S} s"
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    for stdout, stderr, _s in results:
        sys.stderr.write(stderr)
    if failure:
        raise AssertionError(failure)
    for result, out in zip(results, outs):
        with open(out) as handle:
            result.append(json.load(handle))
        os.unlink(out)
    return results


def _logged_batches(stderr: str) -> int:
    match = re.search(r"classified in (\d+) batch\(es\)", stderr)
    if match is None:
        raise AssertionError("classify logged no batch count")
    return int(match.group(1))


def phase_dist_classify(cli: dict) -> None:
    """Two ranks of the port's `classify` (gloo, both on the one card,
    the default reader pool each) over the ``cli`` phase's pod5 files:
    rank 0's table must be the single process's, byte for byte; rank 1
    prints none.  Then once more with ``--shard_dir``."""
    import shutil

    argv = ["classify", cli["pod5_dir"], "-s", START_MODEL, "-e", END_MODEL,
            "--batch_size", str(BATCH)]
    shard_dir = os.path.join(cli["root"], "shards")
    runs = {}
    for name, extra in (("plain", []), ("shard_dir", ["--shard_dir",
                                                      shard_dir])):
        ranks = _run_ranks(f"dist_classify_{name}", argv + extra)
        if ranks[0][0] != cli["table"]:
            raise AssertionError(f"dist_classify ({name}): rank 0's table "
                                 f"differs from the single process's")
        if ranks[1][0] != "":
            raise AssertionError(f"dist_classify ({name}): rank 1 printed "
                                 f"{len(ranks[1][0])} bytes")
        for rank, (_out, err, _s, result) in enumerate(ranks):
            if "over gloo (ranks share a card)" not in err:
                raise AssertionError(f"dist_classify: rank {rank} is not on "
                                     f"gloo for ranks sharing the card")
            # Two models: 15 K1 launches per model per batch.
            _check_launches(result["launches"], _logged_batches(err),
                            {"conv1d_bn_relu": 30, "trunk_megakernel": 0},
                            f"dist_classify ({name}) rank {rank}")
        runs[name] = {
            "seconds": [r[2] for r in ranks],
            "reads_per_s_logged": [_cli_throughput(r[1]) for r in ranks],
            "batches": [_logged_batches(r[1]) for r in ranks],
            "launches": [r[3]["launches"] for r in ranks]}
    manifests = sorted(n for n in os.listdir(shard_dir)
                       if n.startswith("manifest_"))
    if manifests != ["manifest_h0000.json", "manifest_h0001.json"]:
        raise AssertionError(f"dist_classify: manifests {manifests}")
    emit("dist_classify", ranks=2, files=len(os.listdir(cli["pod5_dir"])),
         rows=len(cli["table"].splitlines()) - 1, table_identical=True,
         manifests=manifests, single_seconds_pool=cli["seconds_pool"],
         single_reads_per_s_pool=cli["reads_per_s_pool"], **runs)
    shutil.rmtree(cli["root"], ignore_errors=True)


def phase_dp_classify(device, reads, unit: dict) -> None:
    """ClassifyProgram over [cuda:0, cuda:0]: each batch split in two, both
    halves on the one card, the tables gathered (unit path, and fused on
    the first 512 reads); then the same program under the pinned slot
    ring.  K1 at the half batch's shape.  With more than one card, also
    ``--device_count 2`` through ``build_program``."""
    import dataclasses

    import torch

    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.runner.pipeline import ClassifyProgram

    model = load_model(START_MODEL)[0]
    cfg = _build_program().cfg
    program = ClassifyProgram(model, cfg, devices=[device, device])
    program.warm_up(BATCH)
    calls, stats, seconds, launches = _run_stream(program, reads)
    _check_launches(launches, stats.batches,
                    {"conv1d_bn_relu": 30, "trunk_megakernel": 0},
                    "dp_classify")
    _same_calls("dp_classify", calls, unit["calls"])
    _ids, sig, lens, _e, _el = _build_batch(reads, cfg)
    batch_ms = time_ms(lambda: program.call_packed(sig, lens), 5)
    # classify --pallas over the two shards: 1 K1 + 1 K2 launch per shard.
    fused = ClassifyProgram(model, dataclasses.replace(cfg, kernel_path="fused"),
                            devices=[device, device])
    fused.warm_up(BATCH)
    fused_calls, fused_stats, _fs, fused_launches = _run_stream(fused,
                                                                reads[:512])
    _check_launches(fused_launches, fused_stats.batches,
                    {"conv1d_bn_relu": 2, "trunk_megakernel": 2},
                    "dp_classify (fused)")
    _same_calls("dp_classify (fused)", fused_calls, unit["calls"])
    shard = phase_kernels(device, n=WINDOWS // 2, line="kernel_unit_shard")
    phase_pool_ring(reads, unit, program=program, phase="dp_pool_ring")
    multi_card = "not run: 1 card"
    if torch.cuda.device_count() > 1:
        real = _build_program(extra=["--device_count", "2"])
        if len(set(real.devices)) != 2:
            raise AssertionError(f"--device_count 2 gave {real.devices}")
        real.warm_up(BATCH)
        real_calls, real_stats, real_s, real_launches = _run_stream(real, reads)
        _check_launches(real_launches, real_stats.batches,
                        {"conv1d_bn_relu": 30, "trunk_megakernel": 0},
                        "dp_classify --device_count 2")
        _same_calls("dp_classify --device_count 2", real_calls, unit["calls"])
        multi_card = {"devices": [str(d) for d in real.devices],
                      "seconds": real_s, "reads_per_s": len(reads) / real_s}
    emit("dp_classify", devices=[str(d) for d in program.devices],
         reads=len(reads), batches=stats.batches, seconds=seconds,
         reads_per_s=len(reads) / seconds, launches=launches,
         launches_per_batch={k: v / stats.batches for k, v in launches.items()},
         same_calls_as_classify=len(calls), device_batch_ms=batch_ms,
         classify_device_batch_ms=unit["device_batch_ms"],
         fused_launches=fused_launches, fused_batches=fused_stats.batches,
         shard_windows=WINDOWS // 2, shard_k1_max_abs_err=shard["max_abs_err"],
         shard_k1_ms=shard["ms"], shard_k1_bound_ms=shard["bound_ms"],
         multi_card=multi_card)


TP_MODEL = 2     # the 'model' axis of tp_classify, as the dry run builds it


def _tp_units(device, model: int, n: int = WINDOWS // 2) -> dict:
    """K1 on each flagship unit's column shards at ``model`` ranks, on the
    ``n`` windows of one data group: each shard against its plain version
    (atol and rtol 1e-4) and a rerun (bit-identical), the rank-order gather
    against the unsharded K1 (the largest difference, and whether it is
    bit-identical), the shards' times beside the whole unit's and the
    shards' bound (one ``kernel_unit_tp`` line per unit)."""
    import torch

    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.models.kernel_apply import fold_network, shard_network
    from deepbinner_tpu_torch.ops.conv_kernel import (
        conv1d_bn_relu_reference,
        fused_conv1d_bn_relu,
        plan_unit,
    )

    dbt_model, config, _meta = load_model(START_MODEL)
    net = fold_network(dbt_model, device)
    shards = [shard_network(net, rank, model) for rank in range(model)]
    gen = torch.Generator(device=device).manual_seed(1)
    totals = {"ms": 0.0, "whole_ms": 0.0, "bound_ms": 0.0}
    worst_err, worst_diff, identical = 0.0, 0.0, True
    for scope, length, dilation, pool in unit_geometries(config):
        c_in = net.units[scope][0].shape[1]
        x = torch.randn((n, length, c_in), generator=gen, device=device)
        whole = fused_conv1d_bn_relu(x, *net.units[scope], dilation=dilation,
                                     pool=pool)
        parts, err = [], 0.0
        for shard in shards:
            weights = shard.units[scope]
            got = fused_conv1d_bn_relu(x, *weights, dilation=dilation, pool=pool)
            again = fused_conv1d_bn_relu(x, *weights, dilation=dilation,
                                         pool=pool)
            want = conv1d_bn_relu_reference(x, *weights, dilation=dilation,
                                            pool=pool)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, atol=TOL, rtol=TOL):
                raise AssertionError(f"tp {scope}: K1 on a {weights[0].shape[2]}"
                                     f"-column shard disagrees with the plain "
                                     f"version")
            if not torch.equal(got, again):
                raise AssertionError(f"tp {scope}: K1 on a shard is not "
                                     f"bit-identical from run to run")
            err = max(err, (got - want).abs().max().item())
            parts.append(got)
        gathered = torch.cat(parts, dim=-1)
        diff = (gathered - whole).abs().max().item()
        same = bool(torch.equal(gathered, whole))
        if not torch.allclose(gathered, whole, atol=TOL, rtol=TOL):
            raise AssertionError(f"tp {scope}: the gathered shards differ from "
                                 f"the unsharded K1 by {diff}")

        def run_shards():
            for shard in shards:
                fused_conv1d_bn_relu(x, *shard.units[scope], dilation=dilation,
                                     pool=pool)

        ms = time_ms(run_shards, 20)
        whole_ms = time_ms(lambda: fused_conv1d_bn_relu(
            x, *net.units[scope], dilation=dilation, pool=pool), 20)
        taps, _c, c_out = net.units[scope][0].shape
        width = shards[0].units[scope][0].shape[2]
        plan = plan_unit(c_in, width, taps, dilation, length)
        out_len = length // 2 if pool else length
        # The gathered unit's bound: its input read once, its output written
        # once (each shard launch reads the whole input again).
        nbytes = 4 * (n * length * c_in + n * out_len * c_out
                      + taps * c_in * c_out + 2 * c_out)
        flops = 2 * n * length * taps * c_in * c_out
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
        emit("kernel_unit_tp", unit=scope, model=model, n=n, length=length,
             c_in=c_in, c_out=c_out, shard_c_out=width, co_tile=plan.co_tile,
             row_tile=plan.row_tile, path=plan.path, max_abs_err=err,
             gathered_max_abs_diff_vs_whole=diff, gathered_bit_identical=same,
             ms=ms, whole_ms=whole_ms, bound_ms=bound_ms)
        worst_err, worst_diff = max(worst_err, err), max(worst_diff, diff)
        identical = identical and same
        totals["ms"] += ms
        totals["whole_ms"] += whole_ms
        totals["bound_ms"] += bound_ms
        del x, whole, parts, gathered
    torch.cuda.empty_cache()
    return {"model": model, "max_abs_err": worst_err,
            "gathered_max_abs_diff_vs_whole": worst_diff,
            "gathered_bit_identical": identical, **totals}


def phase_tp_classify(device, reads, truth, unit: dict) -> dict:
    """ClassifyProgram over [cuda:0] * 4 with model=2: a data 2 × model 2
    grid on the one card, every unit on column shards (the unit path only),
    on the ``classify`` phase's 2048 reads: calls equal to that phase's,
    combined probabilities within 1e-5, 60 K1 launches per batch; the
    gathers and peer copies of one batch; K1 at the shards' widths."""
    import torch

    from deepbinner_tpu_torch.models import kernel_apply
    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.parallel.mesh import split_rows
    from deepbinner_tpu_torch.runner.pipeline import ClassifyProgram

    model = load_model(START_MODEL)[0]
    cfg = _build_program().cfg
    program = ClassifyProgram(model, cfg, devices=[device] * 4, model=TP_MODEL)
    grid = [[str(d) for d in row] for row in program.grid]
    program.warm_up(BATCH)
    _ids, sig, lens, _e, _el = _build_batch(reads, cfg)
    kernel_apply.GATHERS = kernel_apply.PEER_COPIES = 0
    program.call_packed(sig, lens).cpu()
    gathers, copies = kernel_apply.GATHERS, kernel_apply.PEER_COPIES

    def cnn(_net, windows):
        rows = split_rows(windows.shape[0], len(program.nets))
        return [kernel_apply.apply_inference_kernels_tp(nets[0], windows[lo:hi])
                for (lo, hi), nets in zip(rows, program.nets)]

    result = _classify_phase(
        "tp_classify", program, reads, truth,
        {"conv1d_bn_relu": 4 * 15, "trunk_megakernel": 0}, cnn, unit=unit,
        prob_tol=1e-5, grid=grid, gathers_per_batch=gathers,
        peer_copies_per_batch=copies)
    for model_axis in (TP_MODEL, 4):
        shard = _tp_units(device, model_axis)
        emit("tp_units", **shard)
    return result


def phase_dryrun(device) -> dict:
    """The port's top-level entry points on the card: ``entry()`` (the flagship
    classify step on 32 all-zero reads; 15 K1 launches, calls of shape
    (32,)), then ``dryrun_multichip(4)`` on [cuda:0] * 4 (two training
    ranks over gloo on the one card, then the tiny model's data-parallel
    and model-axis calls, which must be equal and spread)."""
    import torch

    from deepbinner_tpu_torch import entry as port_entry
    from deepbinner_tpu_torch.ops import conv_kernel

    fn, example = port_entry.entry(device)
    conv_kernel.LAUNCHES = 0
    out = fn(*example)
    torch.cuda.synchronize()
    entry_launches = conv_kernel.LAUNCHES
    if tuple(out.calls.shape) != (port_entry.ENTRY_BATCH,):
        raise AssertionError(f"dryrun: entry() calls of shape "
                             f"{tuple(out.calls.shape)}")
    if not bool(torch.isfinite(out.start_probs).all()):
        raise AssertionError("dryrun: entry() gave non-finite probabilities")
    if entry_launches != 15:
        raise AssertionError(f"dryrun: entry() made {entry_launches} K1 "
                             f"launches, expected 15")
    entry_ms = time_ms(lambda: fn(*example), 5)
    start = time.perf_counter()
    conv_kernel.LAUNCHES = 0
    summary = port_entry.dryrun_multichip(4, device=device.type)
    torch.cuda.synchronize()
    launches = conv_kernel.LAUNCHES
    if launches == 0:
        raise AssertionError("dryrun: the classify check launched no K1")
    emit("dryrun", entry_calls_shape=list(out.calls.shape),
         entry_launches=entry_launches, entry_ms=entry_ms,
         dryrun_seconds=time.perf_counter() - start,
         dryrun_k1_launches=launches,
         **{k: v for k, v in summary.items() if k not in ("calls", "truth")})
    return summary


def _build_batch(reads, cfg):
    from deepbinner_tpu_torch.runner.executor import build_batch

    return build_batch(reads[:BATCH], cfg.preprocess, BATCH, False)


def phase_dp_train(train: dict) -> None:
    """Two ranks of `train` (gloo on CUDA tensors, both on the one card)
    and one process on the ``train`` phase's rows at the flagship width:
    the first 5 steps in float64 within 1e-4 relative of one process's;
    then DP_TRAIN_EPOCHS epochs in f32 through the CLI, the ranks' state
    bit-identical after every epoch, the first 5 f32 losses reported, one
    ``.dbt`` at the accuracy floor through K1."""
    import shutil
    import statistics

    root = train["root"]
    f64_single = os.path.join(root, "f64_single.json")
    _f64_steps(train["balanced"], f64_single)
    with open(f64_single) as handle:
        single_f64 = json.load(handle)
    f64_ranks = _run_ranks("dp_train_f64", ["f64_steps", train["balanced"]])
    if {r[3]["dtype"] for r in f64_ranks} | {single_f64["dtype"]} != {
            "torch.float64"}:
        raise AssertionError("dp_train: the float64 steps ran in another dtype")
    f64 = {"single": single_f64["losses"],
           "ranks": [r[3]["losses"] for r in f64_ranks]}
    f64["rel"] = [abs(got - want) / abs(want) for got, want in
                  zip(f64["ranks"][0], f64["single"])]
    if (len(f64["ranks"][0]) != DP_F64_STEPS or max(f64["rel"]) > 1e-4
            or f64["ranks"][0] != f64["ranks"][1]):
        raise AssertionError(f"dp_train: float64 steps {f64}")

    single_out = os.path.join(root, "dp_single.dbt")
    ranks_out = os.path.join(root, "dp_ranks.dbt")
    with _watch_trainer() as single:
        _run_cli(_train_argv(train["balanced"], single_out, DP_TRAIN_EPOCHS))
    ranks = _run_ranks("dp_train", _train_argv(
        train["balanced"], ranks_out, DP_TRAIN_EPOCHS))
    single_losses = [float(l) for _s, _e, l in single["steps"]]
    rank_results = [r[3] for r in ranks]
    for rank, result in enumerate(rank_results):
        if "(rank %d of 2)" % rank not in ranks[rank][1]:
            raise AssertionError(f"dp_train: rank {rank} did not train as "
                                 f"rank {rank} of 2")
        if len(result["losses"]) != len(single_losses):
            raise AssertionError(f"dp_train: rank {rank} took "
                                 f"{len(result['losses'])} steps, one "
                                 f"process {len(single_losses)}")
    # Reported, not bound: in f32 the ranks' sums round otherwise, and
    # AdamW's first steps move every weight by about lr whatever the size
    # of its gradient, so a near-zero gradient whose sign flips moves it by
    # 2 lr (5.6e-4 relative by step 4 at batch 256 on an H100).
    rel = [abs(got - want) / abs(want) for got, want in
           zip(rank_results[0]["losses"][:5], single_losses[:5])]
    if rank_results[0]["digests"] != rank_results[1]["digests"]:
        raise AssertionError("dp_train: the ranks' states differ after an "
                             "epoch")
    if rank_results[0]["losses"] != rank_results[1]["losses"]:
        raise AssertionError("dp_train: the ranks logged other losses")
    if os.path.exists(ranks_out + ".tmp") or not os.path.exists(ranks_out):
        raise AssertionError("dp_train: rank 0 wrote no .dbt")
    program = _build_program(start_model=ranks_out)
    program.warm_up(BATCH)
    floor_reads, floor_truth = _floor_reads()
    calls, stats, _seconds, launches = _run_stream(program, floor_reads)
    _check_launches(launches, stats.batches,
                    {"conv1d_bn_relu": 15, "trunk_megakernel": 0}, "dp_train")
    exact, wrong = _score(calls, floor_truth)
    if wrong or exact < 38:
        raise AssertionError(f"dp_train: the ranks' model's accuracy floor: "
                             f"{exact}/40 exact, {wrong} wrong barcodes")
    per_epoch = len(single_losses) // DP_TRAIN_EPOCHS
    single_ms = [s.elapsed_time(e) for s, e, _l in single["steps"][per_epoch:]]
    emit("dp_train", epochs=DP_TRAIN_EPOCHS, steps=len(single_losses),
         batch=TRAIN_BATCH, f64_first5_rel=f64["rel"],
         f64_single_losses=f64["single"], f64_rank_losses=f64["ranks"][0],
         f32_first5_rel=rel,
         single_losses=single_losses, rank_losses=rank_results[0]["losses"],
         single_val_accuracy=[e["accuracy"] for e in single["evals"]],
         rank_val_accuracy=[e["accuracy"] for e in rank_results[0]["evals"]],
         ranks_bit_identical_each_epoch=True,
         single_step_ms_median=statistics.median(single_ms),
         rank_step_ms_median=[statistics.median(r["step_ms"][per_epoch:])
                              for r in rank_results],
         rank_step_note="two ranks sharing one card over gloo (host copies "
                        "and TCP on localhost): not NCCL's time",
         rank_seconds=[r[2] for r in ranks],
         floor_exact=exact, floor_wrong=wrong, floor_launches=launches)
    shutil.rmtree(root, ignore_errors=True)


def _child_pids() -> list:
    """This process's live child processes, read from /proc."""
    me, pids = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as handle:
                stat = handle.read()
        except OSError:
            continue
        # Fields after the command name: state, ppid, ...
        if int(stat[stat.rfind(")") + 2:].split()[1]) == me:
            pids.append(int(entry))
    return pids


def stop_child_processes() -> dict:
    """Stop every process this run started that still runs.

    Reader workers that outlived their pool are terminated.  Then
    multiprocessing's resource tracker, which the first spawned worker or
    shared-memory slot starts, is stopped: it ignores SIGTERM and exits
    only once the pipe it reads is closed, which otherwise happens after
    this process has exited.  Any other child left is killed.  Returns what
    was found, by kind.
    """
    import multiprocessing
    import signal
    from multiprocessing import resource_tracker

    workers = multiprocessing.active_children()
    for child in workers:
        child.terminate()
    for child in workers:
        child.join(timeout=5)
        if child.is_alive():
            child.kill()
            child.join()
    tracker = resource_tracker._resource_tracker  # noqa: SLF001 — no public stop
    had_tracker = tracker._pid is not None  # noqa: SLF001
    tracker._stop()  # noqa: SLF001 — closes its pipe and waits for it
    others = _child_pids()
    for pid in others:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return {"workers": [child.name for child in workers],
            "resource_tracker": had_tracker, "others": others}


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
    # TF32 off everywhere: the reference is f32.  The classify program pins
    # it off for its own calls (runner/pipeline.full_f32); the cuDNN
    # yardstick and the plain versions called here directly need it too.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    try:
        summary = run_phases(torch.device("cuda"), smi)
    finally:
        stopped = stop_child_processes()
    emit("processes", **stopped)
    if stopped["workers"] or stopped["others"]:
        raise AssertionError(f"processes left running after the phases: "
                             f"{stopped}")
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(device, smi: str) -> dict:
    """Every phase in turn; returns the kernel summary."""
    import torch

    probe = probe_readers()
    build_s = build_kernels()
    from deepbinner_tpu_torch.ops import kernel_build

    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], probe=probe,
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
    phase_keras(reads, truth, unit)
    hybrid = phase_hybrid(reads, truth, unit, kernels)
    phase_tf32(reads)
    phase_pool_ring(reads, unit)
    phase_dp_classify(device, reads, unit)
    tp = phase_tp_classify(device, reads, truth, unit)
    phase_dryrun(device)
    phase_native(probe)
    phase_dist_classify(phase_cli(probe))
    phase_realtime(probe)
    phase_dp_train(phase_train(device))

    # K2's numbers are those of the "all" segment, the one launch per batch
    # that classify --pallas makes; every segment's are on its own line.
    whole = segments["all"]
    summary = {"kernels": [{
        "name": "conv1d_bn_relu",
        "route": "cuda",
        "source": "deepbinner_tpu_torch/csrc/conv1d_bn_relu.cu",
        "replaces": KERNEL_REPLACES["conv1d_bn_relu"],
        "launches": unit["launches"]["conv1d_bn_relu"],
        "launches_per_batch": {
            "unit": unit["launches"]["conv1d_bn_relu"] / unit["batches"],
            "hybrid": (hybrid["launches"]["conv1d_bn_relu"]
                       / hybrid["batches"]),
            "tp": tp["launches"]["conv1d_bn_relu"] / tp["batches"]},
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
    return summary


if __name__ == "__main__":
    sys.exit(main())
